"""Incremental energy/latency Pareto frontiers for streaming campaigns.

``dse.pareto_search`` computes a frontier in one shot over a fully
materialized space.  ``StreamingFrontier`` maintains the same frontier
incrementally: each evaluated tile is merged into the running skyline via
``dse.pareto_mask`` on (current frontier) u (new feasible points).  Because
Pareto(Pareto(A) u B) == Pareto(A u B) — dominance is transitive, and the
repo's duplicate semantics (equal points never dominate each other) carry
through the union — the streamed result is *identical* to the one-shot
frontier on the concatenated space, while resident state stays
O(frontier + tile) instead of O(space).

Merges are idempotent and commutative: points are identified by their global
candidate index (re-merging an already-seen index is a no-op), and the final
frontier set does not depend on tile order.  Every merge appends a
``FrontierSnapshot`` to the trajectory — frontier size, a hypervolume proxy,
and the best-per-constraint extremes — which campaigns persist for
regression tracking across changes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dse


def hypervolume_2d(energy_j, latency_s, ref_energy_j, ref_latency_s) -> float:
    """Area dominated by an (energy, latency) point set up to a reference
    point — the 2D-minimization rectangle sweep.  The single definition the
    streaming frontier's trajectory proxy AND the benchmark's cross-evaluator
    comparison both compute with, so the two hypervolume gates cannot drift.
    Points outside the ref box contribute zero."""
    e = np.asarray(energy_j, np.float64)
    l = np.asarray(latency_s, np.float64)
    if ref_energy_j is None or not e.size:
        return 0.0
    inside = (e < ref_energy_j) & (l < ref_latency_s)
    if not inside.any():
        return 0.0
    e, l = e[inside], l[inside]
    order = np.lexsort((e, l))             # latency asc (energy desc)
    e, l = e[order], l[order]
    right = np.append(l[1:], ref_latency_s)
    return float(np.sum((ref_energy_j - e) * (right - l)))


def hypervolume_gain_2d(energy_j, latency_s, front_energy_j, front_latency_s,
                        ref_energy_j, ref_latency_s,
                        chunk: int = 8192) -> np.ndarray:
    """Per-candidate hypervolume gain: for each (energy, latency) point,
    ``hypervolume_2d(front u {p}) - hypervolume_2d(front)`` against the same
    ref point — the exact marginal contribution of each candidate,
    vectorized over N candidates at once.

    gain(p) = area of p's dominated rectangle minus its overlap with the
    current frontier's staircase.  The overlap is computed by clipping each
    frontier step into p's rectangle: with the frontier sorted by latency
    ascending (energy strictly descending after dedup), the clipped corners
    ``ce = max(fe, e)`` stay non-increasing and ``cl = max(fl, l)``
    non-decreasing, so the overlap is a sum of disjoint vertical strips
    ``(ref_e - ce_j) * (cl_{j+1} - cl_j)`` (with ``cl_{K+1} = ref_l``),
    each term clipped at zero.  Candidates are processed in ``chunk``-sized
    blocks to bound the N x K intermediate."""
    e = np.asarray(energy_j, np.float64)
    l = np.asarray(latency_s, np.float64)
    gains = np.zeros(e.shape[0], np.float64)
    if ref_energy_j is None or not e.size:
        return gains
    inside = (e < ref_energy_j) & (l < ref_latency_s)
    if not inside.any():
        return gains
    # canonical staircase of the current frontier: inside-box, latency asc,
    # strict running-min energy dedup (ties/dominated steps add no area)
    fe = np.asarray(front_energy_j, np.float64)
    fl = np.asarray(front_latency_s, np.float64)
    fin = (fe < ref_energy_j) & (fl < ref_latency_s)
    fe, fl = fe[fin], fl[fin]
    if fe.size:
        order = np.lexsort((fe, fl))
        fe, fl = fe[order], fl[order]
        run_min = np.minimum.accumulate(fe)
        keep = np.concatenate([[True], fe[1:] < run_min[:-1]])
        fe, fl = fe[keep], fl[keep]
    idx = np.flatnonzero(inside)
    for s in range(0, idx.size, max(int(chunk), 1)):
        sel = idx[s:s + chunk]
        ce_full = (ref_energy_j - e[sel]) * (ref_latency_s - l[sel])
        if fe.size:
            ce = np.maximum(fe[None, :], e[sel, None])       # [n, K]
            cl = np.maximum(fl[None, :], l[sel, None])
            cl_next = np.concatenate(
                [cl[:, 1:], np.full((sel.size, 1), ref_latency_s)], axis=1)
            strips = (np.clip(ref_energy_j - ce, 0.0, None)
                      * np.clip(cl_next - cl, 0.0, None))
            overlap = strips.sum(axis=1)
        else:
            overlap = 0.0
        gains[sel] = np.maximum(ce_full - overlap, 0.0)
    return gains


def _merge_intervals(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Coalesce [start, end) intervals — the one implementation of the
    ``_seen`` invariant both merge entry points claim indices through."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


@dataclasses.dataclass(frozen=True)
class FrontierSnapshot:
    """Trajectory point recorded after one merge."""

    tile: int
    evaluated: int               # cumulative candidates evaluated
    feasible: int                # cumulative feasible candidates seen
    frontier_size: int
    best_energy_j: float         # best-per-constraint extremes
    best_latency_s: float
    hypervolume: float           # proxy vs the frontier's fixed ref point

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class StreamingFrontier:
    """Running energy/latency skyline over a streamed candidate space.

    The reference point for the hypervolume proxy is pinned at the first
    merge that contains feasible points (max energy/latency of that merge),
    so trajectory values are comparable across snapshots — and across a
    checkpoint/resume boundary, since the ref point rides in ``state_dict``.
    """

    def __init__(self, ref_energy_j: Optional[float] = None,
                 ref_latency_s: Optional[float] = None):
        self.candidates: List[dse.Candidate] = []
        self.energy_j = np.empty(0, np.float64)
        self.latency_s = np.empty(0, np.float64)
        self.indices = np.empty(0, np.int64)     # global candidate indices
        self.evaluated = 0
        self.feasible_seen = 0
        self.ref_energy_j = ref_energy_j
        self.ref_latency_s = ref_latency_s
        self.trajectory: List[FrontierSnapshot] = []
        # seen global indices as merged [start, end) intervals — O(intervals)
        # not O(space), and a contiguous tile stream is ONE growing interval
        self._seen: List[Tuple[int, int]] = []

    def __len__(self) -> int:
        return len(self.candidates)

    def _claim_novel(self, indices: np.ndarray) -> np.ndarray:
        """Mask of indices not seen by any earlier merge; marks them seen.

        Keeps ``evaluated``/``feasible_seen`` exact under re-merged tiles
        (idempotence covers the accounting, not just the frontier set).
        """
        if not self._seen:
            novel = np.ones(indices.shape, bool)
        else:
            starts = np.asarray([s for s, _ in self._seen], np.int64)
            ends = np.asarray([e for _, e in self._seen], np.int64)
            pos = np.searchsorted(starts, indices, side="right") - 1
            novel = ~((pos >= 0) & (indices < ends[np.maximum(pos, 0)]))
        new_idx = np.unique(indices[novel])
        if new_idx.size:
            brk = np.flatnonzero(np.diff(new_idx) > 1)
            new_starts = new_idx[np.concatenate([[0], brk + 1])]
            new_ends = new_idx[np.concatenate([brk, [new_idx.size - 1]])] + 1
            self._seen = _merge_intervals(
                self._seen + list(zip(new_starts.tolist(),
                                      new_ends.tolist())))
        return novel

    def _fold(self, new_cands: List[dse.Candidate], new_e: np.ndarray,
              new_l: np.ndarray, new_i: np.ndarray) -> None:
        """Fold already-feasible, already-novel points into the skyline —
        the union / dedup-by-index / pareto core shared by ``merge`` and
        ``merge_reduced`` so the two entry points cannot diverge."""
        # union: current frontier first so dedup-by-index keeps it
        all_cands = self.candidates + new_cands
        all_e = np.concatenate([self.energy_j, new_e])
        all_l = np.concatenate([self.latency_s, new_l])
        all_i = np.concatenate([self.indices, new_i])
        _, first = np.unique(all_i, return_index=True)
        first.sort()
        all_e, all_l, all_i = all_e[first], all_l[first], all_i[first]
        all_cands = [all_cands[i] for i in first]
        mask = dse.pareto_mask(all_e, all_l, np.ones(len(all_i), bool))
        sel = np.flatnonzero(mask)
        # canonical order: latency, then energy, then global index —
        # identical regardless of the merge order that produced the set
        order = sel[np.lexsort((all_i[sel], all_e[sel], all_l[sel]))]
        self.candidates = [all_cands[i] for i in order]
        self.energy_j = all_e[order]
        self.latency_s = all_l[order]
        self.indices = all_i[order]

    def _snapshot(self, tile: int) -> None:
        self.trajectory.append(FrontierSnapshot(
            tile=tile, evaluated=self.evaluated, feasible=self.feasible_seen,
            frontier_size=len(self),
            best_energy_j=float(self.energy_j.min()) if len(self) else float("inf"),
            best_latency_s=float(self.latency_s.min()) if len(self) else float("inf"),
            hypervolume=self.hypervolume()))

    def merge(self, candidates: Sequence[dse.Candidate], energy_j, latency_s,
              feasible=None, indices=None, tile: int = -1) -> int:
        """Fold one evaluated tile into the skyline; returns the new size.

        ``indices`` are the candidates' global positions in the space (used
        for idempotent dedup and for reporting); when omitted they are
        assigned sequentially from the running ``evaluated`` counter.
        Re-merging already-seen indices is a full no-op: neither the frontier
        set nor the evaluated/feasible accounting changes.
        """
        energy_j = np.asarray(energy_j, np.float64)
        latency_s = np.asarray(latency_s, np.float64)
        n = len(candidates)
        if energy_j.shape != (n,) or latency_s.shape != (n,):
            raise ValueError(f"shape mismatch: {n} candidates vs "
                             f"{energy_j.shape}/{latency_s.shape} scores")
        feasible = (np.ones(n, bool) if feasible is None
                    else np.asarray(feasible, bool))
        indices = (np.arange(self.evaluated, self.evaluated + n, dtype=np.int64)
                   if indices is None else np.asarray(indices, np.int64))
        novel = self._claim_novel(indices)
        self.evaluated += int(novel.sum())
        keep = np.flatnonzero(feasible & novel)
        self.feasible_seen += int(keep.size)

        if self.ref_energy_j is None and keep.size:
            self.ref_energy_j = float(energy_j[keep].max())
            self.ref_latency_s = float(latency_s[keep].max())

        if keep.size:
            self._fold([candidates[i] for i in keep], energy_j[keep],
                       latency_s[keep], indices[keep])
        self._snapshot(tile)
        return len(self)

    def _span_overlap(self, lo: int, hi: int) -> int:
        """How many indices of [lo, hi) an earlier merge already claimed."""
        return sum(max(0, min(hi, e) - max(lo, s)) for s, e in self._seen)

    def _claim_span(self, lo: int, hi: int) -> None:
        self._seen = _merge_intervals(self._seen + [(lo, hi)])

    def merge_reduced(self, candidates: Sequence[dse.Candidate], energy_j,
                      latency_s, indices, *, span: Tuple[int, int],
                      n_feasible: int, ref_energy_j: Optional[float] = None,
                      ref_latency_s: Optional[float] = None,
                      tile: int = -1) -> int:
        """Fold a pre-reduced tile — any FEASIBLE SUPERSET of its Pareto
        survivors plus the tile aggregates — into the skyline; identical
        outcome to ``merge`` on the raw tile arrays.

        The fused on-device evaluator (``kernels.ops.dse_sweep``, or its
        plain form ``costmodel.sweep_workloads_reduced``) discards dominated
        points on the device,
        so the host only sees the survivors (the exact skyline, or a
        conservative screen superset of it — extra dominated points are
        eliminated by the fold's own ``pareto_mask``).  Identity with the
        raw merge holds because (a) dominance is transitive — a tile point
        dominated inside its own tile can never enter the union skyline,
        whether or not it rides along in ``candidates`` — and (b) the
        aggregates reproduce the raw path's accounting exactly: ``span`` is
        the tile's global index interval [lo, hi) (claimed whole for
        idempotence), ``n_feasible`` the tile's feasible count, and
        ``ref_*`` the tile's feasible maxima that pin the hypervolume
        reference point on the first feasible merge.  Re-merging a fully
        seen span is a no-op (snapshot only, like ``merge``); partially
        seen spans are refused — tiles are the dedup unit of the reduced
        path.
        """
        lo, hi = int(span[0]), int(span[1])
        if hi <= lo:
            raise ValueError(f"empty span [{lo}, {hi})")
        energy_j = np.asarray(energy_j, np.float64)
        latency_s = np.asarray(latency_s, np.float64)
        indices = np.asarray(indices, np.int64)
        n = len(candidates)
        if energy_j.shape != (n,) or latency_s.shape != (n,) or \
                indices.shape != (n,):
            raise ValueError(f"shape mismatch: {n} survivors vs "
                             f"{energy_j.shape}/{latency_s.shape}/"
                             f"{indices.shape}")
        if n > hi - lo or int(n_feasible) > hi - lo:
            raise ValueError(f"{n} survivors / {n_feasible} feasible exceed "
                             f"span [{lo}, {hi})")
        if indices.size and (indices.min() < lo or indices.max() >= hi):
            raise ValueError(f"survivor indices outside span [{lo}, {hi})")
        overlap = self._span_overlap(lo, hi)
        if overlap == hi - lo:
            self._snapshot(tile)                 # re-merged tile: no-op
            return len(self)
        if overlap:
            raise ValueError(
                f"span [{lo}, {hi}) partially overlaps already-merged "
                "indices; reduced merges dedup whole tiles — re-merge the "
                "exact tile or use merge() with per-point indices")
        self._claim_span(lo, hi)
        self.evaluated += hi - lo
        self.feasible_seen += int(n_feasible)
        if self.ref_energy_j is None and int(n_feasible) > 0:
            self.ref_energy_j = float(ref_energy_j)
            self.ref_latency_s = float(ref_latency_s)
        if n:
            self._fold(list(candidates), energy_j, latency_s, indices)
        self._snapshot(tile)
        return len(self)

    def hypervolume(self) -> float:
        """Area dominated by the frontier up to the fixed reference point
        (``hypervolume_2d``).  Exact for the 2D minimization given the ref
        point; a *proxy* overall because the ref point is pinned from early
        data rather than the true nadir.
        """
        return hypervolume_2d(self.energy_j, self.latency_s,
                              self.ref_energy_j, self.ref_latency_s)

    def as_pareto_frontier(self, workload: dse.Workload) -> dse.ParetoFrontier:
        """The running skyline in ``dse.ParetoFrontier`` form (sorted by
        latency, like ``pareto_search`` output)."""
        return dse.ParetoFrontier(
            workload=workload,
            candidates=tuple(self.candidates),
            energy_j=self.energy_j.copy(),
            latency_s=self.latency_s.copy(),
            indices=self.indices.copy(),
            feasible_count=self.feasible_seen)

    # -- persistence --------------------------------------------------------

    def state_dict(self) -> Dict:
        """JSON-serializable full state (skyline, aggregates, claimed spans,
        trajectory); ``from_state`` inverts it exactly."""
        return {
            "candidates": [candidate_to_dict(c) for c in self.candidates],
            "energy_j": self.energy_j.tolist(),
            "latency_s": self.latency_s.tolist(),
            "indices": self.indices.tolist(),
            "evaluated": self.evaluated,
            "feasible_seen": self.feasible_seen,
            "ref_energy_j": self.ref_energy_j,
            "ref_latency_s": self.ref_latency_s,
            "seen_intervals": [list(iv) for iv in self._seen],
            "trajectory": [s.as_dict() for s in self.trajectory],
        }

    @classmethod
    def from_state(cls, state: Dict) -> "StreamingFrontier":
        """Rebuild a frontier from ``state_dict`` output; subsequent merges
        continue exactly as if the frontier had never been serialized."""
        fr = cls(ref_energy_j=state["ref_energy_j"],
                 ref_latency_s=state["ref_latency_s"])
        fr.candidates = [candidate_from_dict(d) for d in state["candidates"]]
        fr.energy_j = np.asarray(state["energy_j"], np.float64)
        fr.latency_s = np.asarray(state["latency_s"], np.float64)
        fr.indices = np.asarray(state["indices"], np.int64)
        fr.evaluated = state["evaluated"]
        fr.feasible_seen = state["feasible_seen"]
        fr._seen = [(int(s), int(e)) for s, e in state["seen_intervals"]]
        fr.trajectory = [FrontierSnapshot(**s) for s in state["trajectory"]]
        return fr


def canonical_frontier(front: dse.ParetoFrontier):
    """(candidates, energy, latency, indices) in the canonical
    (latency, energy, index) order — the one total order both streamed and
    one-shot frontiers can be compared under."""
    order = np.lexsort((front.indices, front.energy_j, front.latency_s))
    return ([front.candidates[i] for i in order], front.energy_j[order],
            front.latency_s[order], front.indices[order])


def frontiers_identical(a: dse.ParetoFrontier, b: dse.ParetoFrontier) -> bool:
    """Exact (bitwise) frontier equality under the canonical order — the
    single definition the benchmark gate, the resume example, and the tests
    all compare with."""
    ca, ea, la, ia = canonical_frontier(a)
    cb, eb, lb, ib = canonical_frontier(b)
    return (ca == cb and np.array_equal(ea, eb) and np.array_equal(la, lb)
            and np.array_equal(ia, ib))


def candidate_to_dict(c: dse.Candidate) -> Dict:
    """JSON-serializable form of a ``dse.Candidate`` (checkpoints, BENCH
    artifacts); ``candidate_from_dict`` inverts it."""
    return {"chip": c.chip, "n_chips": int(c.n_chips),
            "mesh": list(c.mesh), "freq_mhz": float(c.freq_mhz)}


def candidate_from_dict(d: Dict) -> dse.Candidate:
    """Inverse of ``candidate_to_dict``."""
    return dse.Candidate(d["chip"], d["n_chips"], tuple(d["mesh"]),
                         d["freq_mhz"])
