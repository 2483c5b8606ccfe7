"""Precomputed workload-family -> Pareto-frontier index for serving.

A campaign answers "what is the frontier for THESE workloads" offline; the
serving layer answers "what should I buy for THIS workload" online.  The
``FrontierIndex`` is the artifact between the two: built once from a
completed campaign (or its checkpoint), it maps each evaluated workload
family to its exact offline frontier, so a selection query on a known
family is a lookup — no sweep, no device, and the answer is *identical* to
the offline campaign pick by construction.

A workload family is keyed by its HxA-census feature vector — the same six
``costmodel.WL_COLS`` scalars (flops, hbm_bytes, collective_bytes,
wire_bytes, base_chips, state_gb_per_device) the fused sweep packs per
workload — so "same family" means "the cost model cannot tell them apart".
Lookup is O(log n): families are sorted by a 1-D projection of their
normalized log-features, a query binary-searches the projection
(``np.searchsorted``) and scans a constant-size window around the
insertion point with the full distance.  An exact hit (relative tolerance
``match_rtol``) always lands inside the window because equal vectors have
equal projections; for novel workloads ``nearest`` returns the closest
family in the window plus its distance, which the engine uses only as a
hint — novel answers are recomputed, never served from a neighbor.

The index file is the reference package's (``repro.serving``), key for
key, with one key more: ``"dtype"``, the precision of the tier that built
it (the port names its tier and its dtype apart, see
``dse_campaign.config``).  An index written here loads in the reference,
which ignores the extra key; an index written by the reference loads here,
its evaluator name mapped through ``REFERENCE_EVALUATORS``.  Like
checkpoints, the index stamps ``costmodel.SIM_MODEL_VERSION`` and refuses
to load across a mismatch: an index built under an old cost model would
serve answers no current campaign could reproduce.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel, dse
from repro_torch.device import DEFAULT_DEVICE, DeviceLike
from repro_torch.dse_campaign import store
from repro_torch.dse_campaign.config import EVALUATORS, REFERENCE_EVALUATORS
from repro_torch.dse_campaign.frontier import (candidate_from_dict,
                                               candidate_to_dict)
from repro_torch.dse_campaign.runner import (Campaign, workload_from_dict,
                                             workload_to_dict)

INDEX_SCHEMA_VERSION = 1

# entries scanned around the searchsorted insertion point; exact matches
# need only the equal-projection run, the margin covers nearest-neighbor
# lookups whose true neighbor projects slightly off
LOOKUP_WINDOW = 8


def family_key(wl: dse.Workload) -> np.ndarray:
    """The workload's family feature vector — ``costmodel.WL_COLS`` order,
    float64.  One definition shared by index build and query so the two
    cannot disagree on what a family is."""
    return np.asarray(
        [wl.base_analysis["flops"], wl.base_analysis["hbm_bytes"],
         wl.base_analysis["collective_bytes"], wl.base_analysis["wire_bytes"],
         wl.base_chips, wl.state_gb_per_device], np.float64)


@dataclasses.dataclass(frozen=True)
class IndexEntry:
    """One workload family: its key vector, the workload it came from, and
    the family's exact offline frontier (canonical-order arrays)."""

    arch: str
    shape: str
    family: np.ndarray                     # family_key vector
    workload: dse.Workload
    candidates: Tuple[dse.Candidate, ...]  # frontier members
    energy_j: np.ndarray
    latency_s: np.ndarray
    indices: np.ndarray                    # global space indices
    feasible_count: int

    def frontier(self) -> dse.ParetoFrontier:
        """The stored frontier in ``dse.ParetoFrontier`` form."""
        return dse.ParetoFrontier(
            workload=self.workload, candidates=tuple(self.candidates),
            energy_j=self.energy_j.copy(), latency_s=self.latency_s.copy(),
            indices=self.indices.copy(),
            feasible_count=self.feasible_count)


class FrontierIndex:
    """Versioned family -> frontier map with O(log n) lookup.

    Build with ``from_campaign`` / ``from_checkpoint``, persist with
    ``save`` / ``load``.  The index also carries the campaign's space,
    constraint, ``SimConfig`` dicts, its evaluator tier and that tier's
    ``dtype`` (``"float64"`` / ``"float32"``), so a ``SelectionEngine`` can
    reconstruct the exact evaluation setup for novel-workload
    mini-campaigns without a side channel.  The device is not part of it.
    """

    def __init__(self, entries: Sequence[IndexEntry], space_dict: Dict,
                 constraint_dict: Dict, sim_dict: Dict, evaluator: str,
                 dtype: str = "float64"):
        self.entries = list(entries)
        self.space_dict = dict(space_dict)
        self.constraint_dict = dict(constraint_dict)
        self.sim_dict = dict(sim_dict)
        self.evaluator = evaluator
        self.dtype = dtype
        self._build_lookup()

    # -- lookup structure ---------------------------------------------------

    def _build_lookup(self) -> None:
        n = len(self.entries)
        feats = np.log1p(np.abs(np.stack(
            [e.family for e in self.entries]))) if n else np.zeros((0, 6))
        lo = feats.min(axis=0) if n else np.zeros(6)
        span = (feats.max(axis=0) - lo) if n else np.ones(6)
        span = np.where(span > 0, span, 1.0)
        self._feat_lo, self._feat_span = lo, span
        self._feats = (feats - lo) / span          # [n, 6] in [0, 1]
        proj = self._feats.sum(axis=1)
        self._order = np.argsort(proj, kind="stable")
        self._proj = proj[self._order]

    def _normalize(self, key: np.ndarray) -> np.ndarray:
        return (np.log1p(np.abs(key)) - self._feat_lo) / self._feat_span

    def _window(self, key: np.ndarray) -> np.ndarray:
        """Entry positions (into ``self.entries``) worth a full-distance
        check for ``key`` — the sorted-projection window."""
        if not self.entries:
            return np.empty(0, np.int64)
        q = self._normalize(key).sum()
        pos = int(np.searchsorted(self._proj, q))
        lo = max(0, pos - LOOKUP_WINDOW)
        hi = min(len(self._order), pos + LOOKUP_WINDOW)
        return self._order[lo:hi]

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def keys(self) -> List[Tuple[str, str]]:
        """(arch, shape) of every indexed family."""
        return [(e.arch, e.shape) for e in self.entries]

    def lookup(self, wl: dse.Workload, match_rtol: float = 1e-9
               ) -> Optional[IndexEntry]:
        """The entry whose family vector matches ``wl`` elementwise within
        ``match_rtol`` (and zero absolute tolerance — a family with a zero
        component only matches an exact zero), or ``None``.  A JSON
        round-trip preserves float64 exactly, so workloads that built the
        index always hit."""
        key = family_key(wl)
        for i in self._window(key):
            e = self.entries[i]
            if np.allclose(e.family, key, rtol=match_rtol, atol=0.0):
                return e
        return None

    def nearest(self, wl: dse.Workload) -> Tuple[Optional[IndexEntry], float]:
        """(closest-family entry, Euclidean distance in normalized log
        feature space) within the lookup window; ``(None, inf)`` on an
        empty index.  A distance of 0.0 is an exact family hit."""
        key = family_key(wl)
        win = self._window(key)
        if not win.size:
            return None, float("inf")
        q = self._normalize(key)
        d = np.linalg.norm(self._feats[win] - q, axis=1)
        best = int(np.argmin(d))
        return self.entries[int(win[best])], float(d[best])

    # -- build --------------------------------------------------------------

    @classmethod
    def from_campaign(cls, campaign: Campaign) -> "FrontierIndex":
        """Build the index from a COMPLETE campaign — a partial sweep would
        bake half-space frontiers into served answers, so it is refused."""
        if campaign.next_tile < campaign.space.n_tiles():
            raise ValueError(
                f"campaign is incomplete ({campaign.next_tile}/"
                f"{campaign.space.n_tiles()} tiles): an index built now "
                "would serve partial-space frontiers")
        entries = []
        for wl in campaign.workloads:
            fr = campaign.frontiers[(wl.arch, wl.shape)]
            front = fr.as_pareto_frontier(wl)
            entries.append(IndexEntry(
                arch=wl.arch, shape=wl.shape, family=family_key(wl),
                workload=wl, candidates=tuple(front.candidates),
                energy_j=np.asarray(front.energy_j, np.float64),
                latency_s=np.asarray(front.latency_s, np.float64),
                indices=np.asarray(front.indices, np.int64),
                feasible_count=int(front.feasible_count)))
        return cls(entries, campaign.space.to_dict(),
                   dataclasses.asdict(campaign.constraint),
                   dataclasses.asdict(campaign.sim), campaign.evaluator,
                   campaign.config.dtype_name)

    @classmethod
    def from_checkpoint(cls, path: str, device: DeviceLike = DEFAULT_DEVICE
                        ) -> "FrontierIndex":
        """Build from a campaign checkpoint file of this package.  Goes
        through ``Campaign.from_checkpoint`` on ``device`` (nothing is
        evaluated there: the index reads the folded frontiers), so the
        checkpoint's ``SIM_MODEL_VERSION`` gate (and its upgrade error
        message) applies before any frontier is indexed.  A reference
        checkpoint reaches this package as a reference-built index,
        through ``from_dict``."""
        return cls.from_campaign(Campaign.from_checkpoint(path, device=device))

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> Dict:
        return {
            "index_schema_version": INDEX_SCHEMA_VERSION,
            "sim_model_version": costmodel.SIM_MODEL_VERSION,
            "space": self.space_dict,
            "constraint": self.constraint_dict,
            "sim": self.sim_dict,
            "evaluator": self.evaluator,
            "dtype": self.dtype,
            "entries": [{
                "arch": e.arch, "shape": e.shape,
                "family": e.family.tolist(),
                "workload": workload_to_dict(e.workload),
                "candidates": [candidate_to_dict(c) for c in e.candidates],
                "energy_j": e.energy_j.tolist(),
                "latency_s": e.latency_s.tolist(),
                "indices": e.indices.tolist(),
                "feasible_count": e.feasible_count,
            } for e in self.entries],
        }

    def save(self, path: str) -> str:
        """Persist atomically (tmp + fsync + rename, like checkpoints)."""
        store.atomic_write_json(self.to_dict(), path)
        return path

    @classmethod
    def from_dict(cls, d: Dict) -> "FrontierIndex":
        """An index from its JSON dict — this package's, or the reference
        package's (no ``"dtype"`` key: its evaluator name is mapped onto
        the port's tiers, ``"fast"`` onto ``"fast"``)."""
        schema = d.get("index_schema_version")
        if schema != INDEX_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported frontier-index schema version {schema!r}")
        version = d.get("sim_model_version")
        if version != costmodel.SIM_MODEL_VERSION:
            raise ValueError(
                f"frontier index was built under cost-model version "
                f"{version!r} but this build is "
                f"{costmodel.SIM_MODEL_VERSION}; serving its frontiers "
                "would answer queries with a cost model this build cannot "
                "reproduce.  Rebuild the index from a current-model "
                "campaign checkpoint (launch/serve.py --mode build-index)")
        evaluator, dtype = d["evaluator"], d.get("dtype")
        if dtype is None:
            evaluator, dtype = REFERENCE_EVALUATORS.get(
                evaluator, (evaluator, "float64"))
        if evaluator not in EVALUATORS:
            raise ValueError(f"frontier index names evaluator "
                             f"{d['evaluator']!r}, known neither here "
                             f"{EVALUATORS} nor in the reference "
                             f"{sorted(REFERENCE_EVALUATORS)}")
        entries = [IndexEntry(
            arch=ed["arch"], shape=ed["shape"],
            family=np.asarray(ed["family"], np.float64),
            workload=workload_from_dict(ed["workload"]),
            candidates=tuple(candidate_from_dict(c)
                             for c in ed["candidates"]),
            energy_j=np.asarray(ed["energy_j"], np.float64),
            latency_s=np.asarray(ed["latency_s"], np.float64),
            indices=np.asarray(ed["indices"], np.int64),
            feasible_count=int(ed["feasible_count"]),
        ) for ed in d["entries"]]
        return cls(entries, d["space"], d["constraint"], d["sim"], evaluator,
                   dtype)

    @classmethod
    def load(cls, path: str) -> "FrontierIndex":
        """Load a saved index; refuses schema or cost-model version
        mismatches with an explicit rebuild hint."""
        with open(path) as f:
            return cls.from_dict(json.load(f))
