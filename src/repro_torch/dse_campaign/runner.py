"""Campaign orchestrator: resumable, bounded-memory DSE over mega-spaces.

A ``Campaign`` sweeps a set of workloads across a ``SpaceSpec``, tile by
tile.  Two tile engines exist (see ``config.py`` for how they map onto the
reference's tiers):

* ``"torch"`` — the per-workload loop, float64: each tile is materialized,
  evaluated per workload as tensor ops on the device, constraint-masked and
  raw-merged into that workload's ``StreamingFrontier``.  Bitwise-identical
  to one-shot ``pareto_search``; the exact oracle.

* ``"fast"`` — the same per-workload loop with the trained predictors in
  place of the simulator (``dse.predict_space``).

* ``"cuda"`` — the fused zero-copy pipeline: tiles stream as array-only
  batches (no per-candidate python objects), padded to ``chunk_size`` with
  a validity mask, packed into ONE contiguous staging buffer that crosses to
  the device in one copy, and ALL workloads are evaluated in a single fused
  launch per tile (``repro_torch.kernels.ops.dse_sweep``: the hand-written
  sweep and screen kernels on a CUDA device, their plain PyTorch versions
  on the CPU).  The launch also reduces each workload's tile to its screen
  survivors on the device, so the host receives O(survivors) instead of
  O(tile) and merges via ``StreamingFrontier.merge_reduced`` (proven
  identical to the raw merge); ``Candidate`` objects are materialized
  lazily for survivors only.  A prefetch thread stages the next tile's
  numpy arrays while the device evaluates the current one; all CUDA work
  stays on the consuming thread.

The tile engine itself lives in ``TileEvaluator``, and a reduced tile is a
``TileReduction`` — a pure function of (campaign config, tile span).  With
``config.adaptive`` set it also carries the seeded training subsample the
adaptive campaign's surrogates learn from.

Peak candidate memory is one tile regardless of space size.

Checkpointing is by tile index: the campaign state (spec, workloads,
frontiers, trajectory, next tile) round-trips through JSON, so an
interrupted sweep resumes exactly where it stopped and converges to the
same frontier a fresh run produces — on the fused engine too, because the
reduced merge reproduces the raw merge's accounting exactly.
``state_from_reference`` carries a reference-package campaign state across
into this package.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import costmodel, dataset, dse
from repro_torch.dse_campaign import store
from repro_torch.dse_campaign.config import (EVALUATORS, REFERENCE_EVALUATORS,
                                             CampaignConfig,
                                             _CAMPAIGN_KEYWORDS,
                                             _EVALUATOR_KEYWORDS,
                                             coerce_config)
from repro_torch.dse_campaign.frontier import StreamingFrontier
from repro_torch.dse_campaign.space import SpaceSpec
from repro_torch.hw import CHIP_TABLE
from repro_torch.telemetry import coerce_telemetry

WorkloadKey = Tuple[str, str]


def workload_to_dict(wl: dse.Workload) -> Dict:
    """The JSON shape of a ``Workload`` used by checkpoints."""
    return {"arch": wl.arch, "shape": wl.shape,
            "base_analysis": dict(wl.base_analysis),
            "base_chips": wl.base_chips,
            "state_gb_per_device": wl.state_gb_per_device}


def workload_from_dict(d: Dict) -> dse.Workload:
    """Inverse of ``workload_to_dict``."""
    return dse.Workload(arch=d["arch"], shape=d["shape"],
                        base_analysis=d["base_analysis"],
                        base_chips=d["base_chips"],
                        state_gb_per_device=d["state_gb_per_device"])


@dataclasses.dataclass
class TileStat:
    """Wall-clock accounting for one evaluated tile (all workloads).

    ``candidates`` counts per-workload candidate evaluations
    (``len(tile) * n_workloads``); ``wall_s`` is the tile's evaluation wall.
    Stats survive checkpoint/resume, so summing them stays consistent with
    the campaign's evaluated counters.
    """

    tile: int
    candidates: int
    wall_s: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CampaignResult:
    """Final (or interrupted) campaign state returned by ``Campaign.run``.

    ``frontiers`` / ``trajectories`` are per-(arch, shape) workload;
    ``tiles_done`` counts completed tiles.
    """

    frontiers: Dict[WorkloadKey, dse.ParetoFrontier]
    trajectories: Dict[WorkloadKey, List]
    tile_stats: List[TileStat]
    space_size: int
    tiles_done: int
    n_tiles: int
    wall_s: float

    @property
    def complete(self) -> bool:
        """True once every tile of the space has folded into the frontiers."""
        return self.tiles_done >= self.n_tiles

    @property
    def candidates_evaluated(self) -> int:
        """Per-workload candidate evaluations across all runs (tile_stats
        survives resume)."""
        return sum(s.candidates for s in self.tile_stats)

    @property
    def sweep_wall_s(self) -> float:
        """Total tile-evaluation wall across ALL runs of this campaign —
        ``tile_stats`` survives checkpoint/resume, so unlike ``wall_s`` (this
        ``run`` call only) it stays consistent with ``candidates_evaluated``
        on a resumed campaign."""
        return sum(s.wall_s for s in self.tile_stats)

    @property
    def candidates_per_sec(self) -> float:
        """Per-workload candidate evaluations per second of sweep wall."""
        return self.candidates_evaluated / max(self.sweep_wall_s, 1e-9)


@dataclasses.dataclass(frozen=True)
class TileReduction:
    """One evaluated tile reduced to exactly what a frontier merge needs.

    Per workload ``w``: ``surv_gidx[w]`` (global candidate indices into the
    space), ``surv_energy[w]`` / ``surv_latency[w]`` (float64 scores), the
    tile's exact feasible count ``n_feasible[w]``, and the tile's feasible
    maxima ``ref_energy_j[w]`` / ``ref_latency_s[w]`` (``None`` when the
    tile has no feasible point).

    Invariants:

    * ``surv_gidx[w] ⊆ [lo, hi)`` and holds a FEASIBLE SUPERSET of the
      tile's per-workload Pareto skyline, so
      ``StreamingFrontier.merge_reduced`` recovers the exact skyline and
      reproduces the raw merge's accounting bitwise;
    * the payload is O(survivors), not O(tile);
    * it is a pure function of (space, workloads, constraint, sim,
      evaluator, dtype) and the tile span — no cross-tile state.

    Adaptive campaigns additionally carry a seeded training subsample:
    ``sample_lidx`` (LOCAL indices into the tile, shared by all workloads —
    candidate features are workload-independent) plus per-workload
    ``sample_energy`` / ``sample_latency`` rows the surrogates train on.
    The subsample is seeded by ``(adaptive.seed, lo)``, so it is a pure
    function of config x span like everything else here.  ``None`` (exact
    campaigns) keeps the payload unchanged.
    """

    lo: int
    hi: int
    surv_gidx: Tuple[np.ndarray, ...]
    surv_energy: Tuple[np.ndarray, ...]
    surv_latency: Tuple[np.ndarray, ...]
    n_feasible: Tuple[int, ...]
    ref_energy_j: Tuple[Optional[float], ...]
    ref_latency_s: Tuple[Optional[float], ...]
    sample_lidx: Optional[np.ndarray] = None
    sample_energy: Optional[Tuple[np.ndarray, ...]] = None
    sample_latency: Optional[Tuple[np.ndarray, ...]] = None

    @property
    def n_workloads(self) -> int:
        """Workload count W (every per-workload tuple has this length)."""
        return len(self.surv_gidx)

    @property
    def n_survivors(self) -> int:
        """Total survivors across workloads — the payload's size is
        O(this), never O(tile)."""
        return int(sum(g.size for g in self.surv_gidx))


class _TilePrefetcher:
    """Double-buffered tile staging: a worker thread materializes the next
    tile(s) of a ``SpaceSpec.tiles`` generator while the main thread drives
    the device on the current one.  The worker does numpy-only work (it
    never touches CUDA — device copies and launches stay on the consuming
    thread, on its current stream); ``close()`` unblocks and retires it when
    iteration stops early (max_tiles)."""

    _END = object()

    def __init__(self, it, depth: int = 1):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, it):
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as exc:  # re-raised on the consuming thread
            self._err = exc
        self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()


class TileEvaluator:
    """The one-tile engine behind ``Campaign``.

    Holds everything needed to turn a tile span of a ``SpaceSpec`` into a
    ``TileReduction``: the workload set, constraint, ``SimConfig``, the
    evaluator tier and its ``device`` / ``dtype``.  ``reduce_tile`` is
    side-effect free with respect to the campaign (no frontier state lives
    here).

    Constructed from a ``CampaignConfig``; ``config.evaluator`` selects the
    engine:

    * ``"torch"`` — float64 per-workload simulator as tensor ops on
      ``config.device``, bitwise-identical to one-shot ``pareto_search``
      (reproduces the reference's ``"numpy"`` tier);
    * ``"cuda"`` — the fused sweep: one hand-written kernel launch for all
      workloads x the tile that sweeps, screens and compacts, and one copy
      of its result to the host.  ``config.dtype=float64`` holds the exact
      tier's frontier candidate set (the reference's fused-kernel tier in
      float64),
      ``float32`` is the fast tier (the reference's ``"jit"`` / compiled
      tier).  On ``device="cpu"`` the same path runs the kernels' plain
      PyTorch versions;
    * ``"fast"`` — trained predictors (``config.power_model`` /
      ``cycles_model``) through ``dse.predict_space``, per workload, float64
      on the host around the models' own device.

    ``fused_launches`` counts fused multi-workload sweeps (``sweep_reduced``
    calls) over this evaluator's lifetime; it is a view over the
    evaluator's telemetry counter (``evaluator_fused_launches_total``).
    Pass ``telemetry=`` to share a registry/tracer with the caller, or omit
    it for a private ``NullTelemetry`` (counters still count, tracing is
    free).
    """

    def __init__(self, workloads: Sequence[dse.Workload], config=None,
                 telemetry=None, **keywords):
        cfg = coerce_config("TileEvaluator", config, keywords,
                            _EVALUATOR_KEYWORDS)
        keys = [(wl.arch, wl.shape) for wl in workloads]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate (arch, shape) workload keys: {keys}")
        self.config = cfg
        self.workloads = list(workloads)
        self.space = cfg.resolved_space
        self.constraint = cfg.resolved_constraint
        self.evaluator = cfg.evaluator
        self.sim = cfg.sim
        self.device = cfg.device
        self.dtype = cfg.dtype
        self.max_survivors = int(cfg.max_survivors)
        self.power_model = cfg.power_model
        self.cycles_model = cfg.cycles_model
        self.adaptive = cfg.adaptive
        self.train_sample = 0 if cfg.adaptive is None \
            else int(cfg.adaptive.train_sample)
        self.telemetry = coerce_telemetry(telemetry)
        # held series: the hot path pays one attribute read, not a dict hit
        self._c_fused = self.telemetry.counter("evaluator_fused_launches_total")
        self._c_candidates = self.telemetry.counter(
            "evaluator_candidates_total")
        self._c_survivors = self.telemetry.counter(
            "evaluator_survivors_total")
        self._staging: Optional[torch.Tensor] = None
        self._results = None        # the reused pinned result buffer

    @property
    def fused_launches(self) -> int:
        """Fused sweeps so far — a view over the telemetry counter."""
        return int(self._c_fused.value)

    @property
    def fused(self) -> bool:
        """Whether tiles go through the fused multi-workload reduced path."""
        return self.evaluator == "cuda"

    @property
    def workload_keys(self) -> List[WorkloadKey]:
        """(arch, shape) keys in workload order — the order every
        ``TileReduction`` tuple and frontier dict is indexed by."""
        return [(wl.arch, wl.shape) for wl in self.workloads]

    # -- per-workload evaluation (the exact float64 tier, the fast tier) ----

    def evaluate_workload(self, wl: dse.Workload, batch: dse.CandidateBatch
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(energy_j, latency_s, feasible) for one workload on one tile, as
        host arrays."""
        if self.evaluator == "fast":
            return self._evaluate_fast(wl, batch)
        res, feasible = dse.evaluate_workload_tile(
            wl, batch, self.constraint, sim=self.sim, dtype=self.dtype,
            device=self.device)
        return (res.energy_j.cpu().numpy(), res.latency_s.cpu().numpy(),
                feasible.cpu().numpy())

    def _evaluate_fast(self, wl: dse.Workload, batch: dse.CandidateBatch):
        """Predictor fast path via ``dse.predict_space`` (same scoring as
        ``fast_path_search``).  Workload shapes suffixed with a pod tag
        resolve to their base shape."""
        cfg = get_config(wl.arch)
        shape = SHAPES[wl.shape.split(":", 1)[0]]
        energy, latency, feasible, _, _ = dse.predict_space(
            cfg, shape, self.power_model, self.cycles_model, batch,
            self.constraint)
        return energy, latency, feasible

    # -- fused zero-copy sweep ----------------------------------------------

    @functools.cached_property
    def wl_cols(self) -> np.ndarray:
        """Packed [W, len(WL_COLS)] per-workload scalar matrix (cached)."""
        return np.asarray(
            [[wl.base_analysis["flops"], wl.base_analysis["hbm_bytes"],
              wl.base_analysis["collective_bytes"],
              wl.base_analysis["wire_bytes"], wl.base_chips,
              wl.state_gb_per_device] for wl in self.workloads],
            np.float64)

    @functools.cached_property
    def wl_cols_device(self) -> torch.Tensor:
        """``wl_cols`` on the device in the tier's dtype — copied once per
        evaluator, not per tile."""
        return torch.as_tensor(self.wl_cols).to(
            device=self.device, dtype=self.dtype).contiguous()

    def padded_tile_arrays(self, batch: dse.CandidateBatch) -> Dict:
        """The tile's packed columns padded to ``chunk_size`` with a validity
        mask — every tile presents the SAME shapes to the device (one
        staging buffer, one kernel grid).  Padding lanes copy lane 0 (safe
        arithmetic — no zero divides) with ``valid = 0``."""
        n = len(batch)
        target = max(self.space.chunk_size, n)
        pad = target - n

        def padarr(a):
            a = np.asarray(a)
            return a if pad == 0 else np.concatenate(
                [a, np.repeat(a[:1], pad, axis=0)])

        valid = np.ones(target, np.float64)
        valid[n:] = 0.0
        arrays = {
            "n_chips": padarr(batch.n_chips),
            "freq_mhz": padarr(batch.freq_mhz),
            "mesh_pod": padarr(batch.pod_axis()),
            "mesh_data": padarr(batch.mesh_data),
            "mesh_model": padarr(batch.mesh_model),
            "valid": valid,
        }
        arrays.update({k: padarr(batch.chip_cols[k])
                       for k in costmodel.SWEEP_GATHER_FIELDS})
        return arrays

    def _stage(self, arrays: Dict) -> torch.Tensor:
        """Pack the padded columns into one contiguous [18, chunk] tensor in
        the tier's dtype and move it to the device in ONE copy.  On a CUDA
        device the host side is a pinned buffer reused across tiles (safe:
        each tile ends in a device-to-host read before the next is packed)
        and the copy is ``non_blocking``."""
        if self.device.type != "cuda":
            return costmodel.pack_cand_cols(arrays, self.dtype)
        n = len(arrays["valid"])
        shape = (len(costmodel.CAND_COLS), n)
        if self._staging is None or tuple(self._staging.shape) != shape:
            self._staging = torch.empty(shape, dtype=self.dtype,
                                        pin_memory=True)
        costmodel.pack_cand_cols(arrays, self.dtype, out=self._staging)
        return self._staging.to(self.device, non_blocking=True)

    def sweep_reduced(self, batch: dse.CandidateBatch
                      ) -> costmodel.SweepReduced:
        """ONE fused sweep: all workloads x one padded tile, screened and
        compacted on the device.  Spans wrap the host-side stages only —
        ``pad`` (array staging + the host-to-device copy) and ``launch``
        (kernel dispatch and the device-to-host read of the survivors,
        which is where the host waits for the device).  The result's arrays
        are views into a pinned buffer this evaluator reuses: valid until
        its next ``sweep_reduced``."""
        from repro_torch.kernels import dse_sweep, ops
        if self._results is None:
            self._results = dse_sweep.ResultBuffer()
        self._c_fused.inc()
        with self.telemetry.span("pad", n=len(batch)):
            cand = self._stage(self.padded_tile_arrays(batch))
        with self.telemetry.span("launch", evaluator=self.evaluator,
                                 n=len(batch)):
            return ops.dse_sweep(
                cand, self.wl_cols_device, sim=self.sim,
                constraint=self.constraint,
                max_survivors=self.max_survivors,
                host_buffer=self._results)

    # -- the normalized reduction -------------------------------------------

    def _tile_sample_lidx(self, n: int, lo: int) -> Optional[np.ndarray]:
        """Seeded training-subsample indices for the tile at ``lo`` (local,
        sorted, without replacement), or ``None`` when the campaign is not
        adaptive.  Seeded by ``(adaptive.seed, lo)`` so the draw depends
        only on config x span — never on in which round the tile was
        evaluated."""
        if self.train_sample <= 0:
            return None
        k = min(self.train_sample, n)
        rng = np.random.default_rng((self.adaptive.seed, lo))
        return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)

    @staticmethod
    def _reduce_rows(energy: np.ndarray, latency: np.ndarray,
                     feasible: np.ndarray, lo: int):
        """Host-side reduction of one workload's raw tile rows: exact
        feasible Pareto survivors + the aggregates ``merge_reduced`` needs to
        reproduce the raw merge's accounting."""
        e = np.asarray(energy, np.float64)
        l = np.asarray(latency, np.float64)
        feas = np.asarray(feasible, bool)
        loc = np.flatnonzero(dse.pareto_mask(e, l, feas))
        n_feas = int(feas.sum())
        ref_e = float(e[feas].max()) if n_feas else None
        ref_l = float(l[feas].max()) if n_feas else None
        return (lo + loc.astype(np.int64), e[loc], l[loc], n_feas,
                ref_e, ref_l)

    def reduce_tile(self, batch: dse.CandidateBatch, lo: int
                    ) -> TileReduction:
        """Evaluate one tile for ALL workloads and reduce it to a
        ``TileReduction``.

        The fused evaluator keeps the on-device screen survivors (a feasible
        superset of the tile skyline, cast to float64 exactly); a workload
        whose screened set overflowed ``max_survivors`` — and the
        per-workload evaluator — is reduced host-side to the exact feasible
        Pareto set instead (the overflow reads that workload's full rows
        back from the device, the only time they cross).  Either way the
        fold through ``StreamingFrontier.merge_reduced`` equals the raw
        full-tile merge.

        With ``config.adaptive`` set, the reduction also carries the tile's
        seeded training subsample (see ``TileReduction``): the per-workload
        path reads it off each workload's evaluation; the fused path reads
        it off the sweep's full rows (``SweepReduced.energy_full``), which
        the fused kernel does not write — so an adaptive tile launches the
        sweep kernel alone once more (counted in its ``LAUNCHES``), then
        moves the [W, train_sample] sample to the host in one copy.
        """
        n = len(batch)
        cols = {"gidx": [], "e": [], "l": [], "nf": [], "re": [], "rl": []}
        lidx = self._tile_sample_lidx(n, lo)
        samp_e: List[np.ndarray] = []
        samp_l: List[np.ndarray] = []

        def add(gidx, e, l, nf, re, rl):
            cols["gidx"].append(gidx)
            cols["e"].append(e)
            cols["l"].append(l)
            cols["nf"].append(nf)
            cols["re"].append(re)
            cols["rl"].append(rl)

        if self.fused:
            red = self.sweep_reduced(batch)
            if lidx is not None:
                with self.telemetry.span("sample", n=lidx.size):
                    e, l = red.energy_full, red.latency_full
                    at = torch.from_numpy(lidx).to(e.device)
                    samp = torch.stack([e[:, at], l[:, at]]).double()
                    samp = samp.cpu().numpy()
                samp_e, samp_l = list(samp[0]), list(samp[1])
            with self.telemetry.span("compact", n=n):
                for wi in range(len(self.workloads)):
                    if red.overflowed(wi):
                        add(*self._reduce_rows(*red.full_rows(wi, n), lo))
                        continue
                    k = int(red.n_survivors[wi])
                    nf = int(red.n_feasible[wi])
                    add(lo + red.surv_idx[wi][:k].astype(np.int64),
                        red.surv_energy[wi][:k].astype(np.float64),
                        red.surv_latency[wi][:k].astype(np.float64), nf,
                        float(red.ref_energy[wi]) if nf else None,
                        float(red.ref_latency[wi]) if nf else None)
        else:
            for wl in self.workloads:
                with self.telemetry.span("launch", evaluator=self.evaluator,
                                         workload=f"{wl.arch}|{wl.shape}"):
                    energy, latency, feasible = \
                        self.evaluate_workload(wl, batch)
                if lidx is not None:
                    samp_e.append(np.asarray(energy, np.float64)[lidx])
                    samp_l.append(np.asarray(latency, np.float64)[lidx])
                with self.telemetry.span("compact", n=n):
                    add(*self._reduce_rows(energy, latency, feasible, lo))
        tr = TileReduction(
            lo=lo, hi=lo + n,
            surv_gidx=tuple(cols["gidx"]), surv_energy=tuple(cols["e"]),
            surv_latency=tuple(cols["l"]), n_feasible=tuple(cols["nf"]),
            ref_energy_j=tuple(cols["re"]), ref_latency_s=tuple(cols["rl"]),
            sample_lidx=lidx,
            sample_energy=tuple(samp_e) if lidx is not None else None,
            sample_latency=tuple(samp_l) if lidx is not None else None)
        self._c_candidates.inc(n * len(self.workloads))
        self._c_survivors.inc(tr.n_survivors)
        return tr


class Campaign:
    """Streaming multi-workload DSE campaign over a ``SpaceSpec``.

    Constructed from a ``CampaignConfig`` (``Campaign(workloads, config)``),
    or in short form from a ``SpaceSpec`` plus config fields as keywords.
    ``config.evaluator`` / ``config.dtype`` / ``config.device`` select the
    tile engine (see ``TileEvaluator``).

    Invariant: the final frontier depends only on (space, workloads,
    constraint, sim, evaluator, dtype) — never on tile size, tile order or
    interruption points.
    """

    def __init__(self, workloads: Sequence[dse.Workload], config=None,
                 telemetry=None, **keywords):
        cfg = coerce_config("Campaign", config, keywords, _CAMPAIGN_KEYWORDS)
        self.telemetry = coerce_telemetry(telemetry)
        self.engine = TileEvaluator(workloads, cfg,
                                    telemetry=self.telemetry)
        self.checkpoint_every = int(cfg.checkpoint_every)
        self.frontiers: Dict[WorkloadKey, StreamingFrontier] = {
            k: StreamingFrontier() for k in self.engine.workload_keys}
        self.tile_stats: List[TileStat] = []
        self.next_tile = 0

    # -- config views (the engine owns the config; Campaign owns the state) -

    @property
    def config(self) -> CampaignConfig:
        return self.engine.config

    @property
    def workloads(self) -> List[dse.Workload]:
        return self.engine.workloads

    @property
    def space(self) -> SpaceSpec:
        return self.engine.space

    @property
    def constraint(self) -> dse.Constraint:
        return self.engine.constraint

    @property
    def evaluator(self) -> str:
        return self.engine.evaluator

    @property
    def sim(self) -> costmodel.SimConfig:
        return self.engine.sim

    @property
    def max_survivors(self) -> int:
        return self.engine.max_survivors

    @property
    def fused(self) -> bool:
        """Whether tiles go through the fused multi-workload reduced path."""
        return self.engine.fused

    # -- construction -------------------------------------------------------

    @classmethod
    def from_artifacts(cls, art_dir: str, config=None,
                       **kwargs) -> "Campaign":
        """Sweep ALL cached dry-run workloads under ``art_dir``: the port's
        own (``launch.dryrun``, ``card1``) or the reference's (``pod1`` /
        ``pod2``).  ``config`` is a ``CampaignConfig``; extra keyword
        arguments go to the constructor.  Each artifact's census
        (``base_analysis``) is loaded ONCE per (arch, shape) cell and reused
        across every tile of the sweep.  Colliding (arch, shape) cells from
        different pods are disambiguated by suffixing the shape with the pod
        tag."""
        arts = dataset.load_dryrun_artifacts(art_dir)
        if not arts:
            raise FileNotFoundError(f"no dry-run artifacts in {art_dir}")
        seen = {}
        for (arch, shape, pod), art in sorted(arts.items()):
            key = (arch, shape) if (arch, shape) not in seen else (
                arch, f"{shape}:{pod}")
            seen[key] = dse.Workload(
                arch=key[0], shape=key[1],
                base_analysis={k: art["hxa"][k] for k in
                               ("flops", "hbm_bytes", "collective_bytes",
                                "wire_bytes")},
                base_chips=art["roofline"]["n_chips"],
                state_gb_per_device=art["memory"]["state_gb_per_device"])
        return cls(list(seen.values()), config, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "Campaign":
        """Rebuild an interrupted campaign from its checkpoint file; the
        next ``run`` continues at the first unevaluated tile.

        Space, workloads, constraint, ``SimConfig``, evaluator and dtype are
        all restored from the checkpoint into a ``CampaignConfig``; extra
        keyword arguments override config fields on the rebuilt config
        (``device`` is not stored — a checkpoint resumes on whatever device
        the caller names, the card by default).  Fitted predictor models
        cannot be serialized, so resuming an ``evaluator="fast"`` campaign
        requires re-passing the SAME ``power_model`` / ``cycles_model`` as
        keywords (``CampaignConfig`` refuses the resume without them);
        supplying retrained models would splice two predictors into one
        frontier undetected.  A checkpoint written under a different
        ``costmodel.SIM_MODEL_VERSION`` is refused: its folded-in tiles and
        the tiles a resume would evaluate come from incomparable cost
        models.

        Corrupt checkpoints do not crash the resume: ``store.load_checkpoint``
        verifies the integrity CRC, quarantines a bad file to ``*.corrupt``
        and falls back to the newest valid generation; only when no copy on
        disk verifies does a ``CheckpointCorruptionError`` surface.
        """
        state = store.load_checkpoint(path)
        return cls.from_state(state, source=path, **kwargs)

    @classmethod
    def from_state(cls, state: Dict, source: str = "<state>",
                   **kwargs) -> "Campaign":
        """Rebuild a campaign from an already-loaded ``state_dict``."""
        ckpt_model = state.get("sim_model_version")
        if ckpt_model != costmodel.SIM_MODEL_VERSION:
            raise ValueError(
                f"checkpoint {source} was written under cost-model version "
                f"{ckpt_model!r} but this build is "
                f"{costmodel.SIM_MODEL_VERSION}; resuming would splice two "
                "incomparable cost models into one frontier.  To upgrade, "
                "re-run the campaign from scratch under the current model "
                "(and rebuild any FrontierIndex derived from this "
                "checkpoint)")
        if state["evaluator"] not in EVALUATORS:
            raise ValueError(
                f"checkpoint {source} names evaluator "
                f"{state['evaluator']!r}, not one of {EVALUATORS}; a "
                "reference-package state goes through state_from_reference")
        workloads = [workload_from_dict(w) for w in state["workloads"]]
        telemetry = kwargs.pop("telemetry", None)
        fields = dict(
            space=SpaceSpec.from_dict(state["space"]),
            evaluator=state["evaluator"],
            dtype=state.get("dtype", "float64"),
            constraint=dse.Constraint(**state["constraint"]),
            sim=costmodel.SimConfig(**state["sim"]))
        unknown = set(kwargs) - {f.name for f in
                                 dataclasses.fields(CampaignConfig)}
        if unknown:
            raise TypeError(f"from_state: unexpected keyword "
                            f"arguments {sorted(unknown)}")
        fields.update(kwargs)
        camp = cls(workloads, CampaignConfig(**fields), telemetry=telemetry)
        camp.next_tile = state["next_tile"]
        camp.tile_stats = [TileStat(**s) for s in state["tile_stats"]]
        for key_str, fr_state in state["frontiers"].items():
            arch, shape = key_str.split("|", 1)
            camp.frontiers[(arch, shape)] = StreamingFrontier.from_state(fr_state)
        return camp

    # -- folding ------------------------------------------------------------

    def merge_reduction(self, tr: TileReduction, tile_no: int = -1) -> None:
        """Fold one ``TileReduction`` into every workload's frontier, with
        survivor ``Candidate`` objects materialized lazily from the space.

        Idempotent at tile granularity: re-folding an already-folded tile
        (a replayed tile after a resume) changes neither the frontier nor
        its accounting."""
        for wi, wl in enumerate(self.workloads):
            gidx = tr.surv_gidx[wi]
            self.frontiers[(wl.arch, wl.shape)].merge_reduced(
                self.space.candidates_at(gidx), tr.surv_energy[wi],
                tr.surv_latency[wi], gidx, span=(tr.lo, tr.hi),
                n_feasible=tr.n_feasible[wi],
                ref_energy_j=tr.ref_energy_j[wi],
                ref_latency_s=tr.ref_latency_s[wi], tile=tile_no)

    # -- the sweep ----------------------------------------------------------

    def run(self, checkpoint_path: Optional[str] = None,
            max_tiles: Optional[int] = None) -> CampaignResult:
        """Sweep tiles from ``next_tile`` on; returns the (possibly partial)
        campaign result.  ``max_tiles`` bounds THIS call (interruption point
        for resume demos/tests); with a ``checkpoint_path`` (defaulting to
        ``config.checkpoint_path``) the state is persisted every
        ``checkpoint_every`` tiles and at the end."""
        if checkpoint_path is None:
            checkpoint_path = self.config.checkpoint_path
        tel = self.telemetry
        clock = tel.clock
        c_tiles = tel.counter("campaign_tiles_total")
        c_ckpt = tel.counter("campaign_checkpoint_writes_total")
        t_start = clock()
        done_this_call = 0
        fused = self.fused
        engine = self.engine
        tiles = _TilePrefetcher(self.space.tiles(
            start_tile=self.next_tile, with_candidates=not fused))
        try:
            for tile_no, lo, batch in tiles:
                if max_tiles is not None and done_this_call >= max_tiles:
                    break
                t0 = clock()
                with tel.span("tile_eval", tile=tile_no, n=len(batch)):
                    if fused:
                        tr = engine.reduce_tile(batch, lo)
                        with tel.span("merge", tile=tile_no):
                            self.merge_reduction(tr, tile_no)
                    else:
                        indices = np.arange(lo, lo + len(batch),
                                            dtype=np.int64)
                        for wl in self.workloads:
                            with tel.span(
                                    "launch", evaluator=engine.evaluator,
                                    workload=f"{wl.arch}|{wl.shape}"):
                                energy, latency, feasible = \
                                    engine.evaluate_workload(wl, batch)
                            with tel.span("merge", tile=tile_no):
                                self.frontiers[(wl.arch, wl.shape)].merge(
                                    batch.candidates, energy, latency,
                                    feasible, indices=indices, tile=tile_no)
                        engine._c_candidates.inc(
                            len(batch) * len(self.workloads))
                c_tiles.inc()
                self.tile_stats.append(TileStat(
                    tile=tile_no,
                    candidates=len(batch) * len(self.workloads),
                    wall_s=clock() - t0))
                self.next_tile = tile_no + 1
                done_this_call += 1
                if checkpoint_path and (self.next_tile % self.checkpoint_every == 0):
                    with tel.span("checkpoint_write", tile=tile_no):
                        store.save_checkpoint(self.state_dict(),
                                              checkpoint_path)
                    c_ckpt.inc()
        finally:
            tiles.close()
        if checkpoint_path:
            with tel.span("checkpoint_write", tile=self.next_tile - 1):
                store.save_checkpoint(self.state_dict(), checkpoint_path)
            c_ckpt.inc()
        return self._result(clock() - t_start)

    def _result(self, wall_s: float, tiles_done: Optional[int] = None
                ) -> CampaignResult:
        wl_by_key = {(wl.arch, wl.shape): wl for wl in self.workloads}
        return CampaignResult(
            frontiers={k: fr.as_pareto_frontier(wl_by_key[k])
                       for k, fr in self.frontiers.items()},
            trajectories={k: list(fr.trajectory)
                          for k, fr in self.frontiers.items()},
            tile_stats=list(self.tile_stats),
            space_size=len(self.space),
            tiles_done=self.next_tile if tiles_done is None else tiles_done,
            n_tiles=self.space.n_tiles(),
            wall_s=wall_s)

    # -- persistence --------------------------------------------------------

    def state_dict(self) -> Dict:
        """Full JSON-serializable campaign state (schema version 1), stamped
        with ``SIM_MODEL_VERSION`` so ``from_checkpoint`` can refuse to splice
        two cost models into one frontier.  The device is deliberately not
        part of it."""
        return {
            "version": 1,
            "sim_model_version": costmodel.SIM_MODEL_VERSION,
            "space": self.space.to_dict(),
            "workloads": [workload_to_dict(wl) for wl in self.workloads],
            "constraint": dataclasses.asdict(self.constraint),
            "sim": dataclasses.asdict(self.sim),
            "evaluator": self.evaluator,
            "dtype": self.config.dtype_name,
            "next_tile": self.next_tile,
            "tile_stats": [s.as_dict() for s in self.tile_stats],
            "frontiers": {f"{arch}|{shape}": fr.state_dict()
                          for (arch, shape), fr in self.frontiers.items()},
        }


def state_from_reference(state: Dict, chip_table: Optional[Dict] = None,
                         source: str = "<reference state>",
                         **kwargs) -> Campaign:
    """Carry a campaign of the reference package (``repro``) across.

    ``state`` is what the reference hands out as plain data — its
    ``Campaign.state_dict()`` (the JSON dict a reference checkpoint holds:
    ``SpaceSpec.to_dict()``, ``workload_to_dict`` rows, frontier states,
    next tile).  The result is a ``Campaign`` of this package positioned at
    the same tile, so a half-finished reference sweep is finished here.
    Evaluator names are mapped onto the port's tiers (``"numpy"`` ->
    ``"torch"``; ``"pallas"`` -> ``"cuda"`` float64; ``"jit"`` -> ``"cuda"``
    float32; a ``"fast"`` campaign has no counterpart here).
    ``chip_table``, when given, is the reference's chip-table columns as
    numpy arrays (``{field: array}``, plus optionally
    ``"names"``); the state is refused unless they equal this package's
    registry, since candidate indices and costs would otherwise not mean the
    same thing.  A ``sim_model_version`` other than this build's is refused
    like any checkpoint.  ``kwargs`` override config fields (``device=``).
    An adaptive campaign's state (an ``"adaptive"`` key) is refused: its
    surrogates would have to be rebuilt by replaying its rounds, which this
    function does not do.
    """
    if state.get("adaptive"):
        raise ValueError(f"{source} is an adaptive campaign's state; "
                         "carrying one across is not supported")
    ckpt_model = state.get("sim_model_version")
    if ckpt_model != costmodel.SIM_MODEL_VERSION:
        raise ValueError(
            f"{source} was written under cost-model version {ckpt_model!r} "
            f"but this build is {costmodel.SIM_MODEL_VERSION}; the two cost "
            "models are not comparable")
    ref_eval = state["evaluator"]
    if ref_eval not in REFERENCE_EVALUATORS:
        raise ValueError(f"{source}: reference evaluator {ref_eval!r} has no "
                         f"counterpart here (known: "
                         f"{sorted(REFERENCE_EVALUATORS)})")
    if ref_eval == "jit" and not state.get("pipeline", False):
        raise ValueError(f"{source}: the reference's unfused per-workload "
                         "float32 loop (evaluator='jit', pipeline=False) "
                         "has no counterpart here")
    if chip_table is not None:
        names = chip_table.get("names")
        if names is not None and tuple(names) != tuple(CHIP_TABLE.names):
            raise ValueError(f"{source}: chip registry differs: "
                             f"{tuple(names)} vs {CHIP_TABLE.names}")
        for field, col in chip_table.items():
            if field == "names":
                continue
            if not np.array_equal(np.asarray(col, np.float64),
                                  getattr(CHIP_TABLE, field)):
                raise ValueError(f"{source}: chip-table column {field!r} "
                                 "differs from this package's registry")
    evaluator, dtype = REFERENCE_EVALUATORS[ref_eval]
    ported = {k: v for k, v in state.items() if k != "pipeline"}
    ported["evaluator"] = evaluator
    ported["dtype"] = dtype
    return Campaign.from_state(ported, source=source, **kwargs)
