"""Design Space Exploration — the slow path, the fast path and Pareto
search on tensors.

Counterpart of ``repro.core.dse``: identify the most appropriate
accelerator slice (generation, chip count, mesh shape, DVFS frequency) for
a given (arch, shape) workload, under power / latency / capacity
constraints.  Two exploration modes mirror the paper's comparison:

  * slow path — run the calibrated simulator on every candidate: the space
    is packed struct-of-arrays on the host (``CandidateBatch``, numpy: it is
    index arithmetic, built by ``SpaceSpec.slice``); evaluation moves the
    columns to ``device`` and runs ``costmodel.simulate_batch`` there as
    tensor ops.  ``slow_path_search_scalar`` preserves the per-candidate
    python loop as the agreement oracle.
  * fast path — rank ALL candidates with the trained predictors
    (``repro_torch.core.predictors``, which predict on their own device) in
    one batched call over the ``features.extract_batch`` design matrix, then
    verify only the top-k with the slow path (``predict_space``,
    ``fast_path_search``).  ``surrogate_features`` / ``predict_tile_scores``
    are the adaptive campaign's per-tile surrogate inputs.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import costmodel, features
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.hw import (CHIP_TABLE, CHIPS, ChipTable, frequency_sweep,
                            get_chip, normalize_mesh)


@dataclasses.dataclass(frozen=True)
class Candidate:
    chip: str
    n_chips: int
    mesh: Tuple[int, ...]
    freq_mhz: float


@dataclasses.dataclass
class Constraint:
    max_power_w: Optional[float] = None      # whole-slice power budget
    max_latency_s: Optional[float] = None
    min_hbm_fit: bool = True                 # state must fit HBM


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: ndarray fields
class CandidateBatch:
    """The design space packed struct-of-arrays (host numpy) for batch
    evaluation.

    ``candidates`` keeps the scalar view; the arrays are what the tensor
    paths consume.  ``mesh_data``/``mesh_model`` are the trailing two mesh
    extents (1 for unmeshed edge parts).  Array-only batches
    (``candidates=None``, e.g. ``SpaceSpec.slice(with_candidates=False)``)
    serve the fused campaign path, which materializes ``Candidate`` objects
    lazily for frontier survivors only.
    """

    candidates: Optional[Tuple[Candidate, ...]]
    chip_idx: np.ndarray                     # int32 [N] -> CHIP_TABLE row
    n_chips: np.ndarray                      # int64 [N]
    mesh_data: np.ndarray                    # int64 [N], mesh[-2] or 1
    mesh_model: np.ndarray                   # int64 [N], mesh[-1]
    freq_mhz: np.ndarray                     # float64 [N]
    mesh_pod: Optional[np.ndarray] = None    # int64 [N], prod(mesh[:-2]) or 1
    chip_cols: Optional[Dict[str, np.ndarray]] = None  # CHIP_TABLE.gather cache

    @classmethod
    def from_candidates(cls, space: Sequence[Candidate],
                        table: ChipTable = CHIP_TABLE) -> "CandidateBatch":
        space = tuple(space)
        chip_idx = table.indices([c.chip for c in space])
        axes = [normalize_mesh(c.mesh) for c in space]   # (pod, data, model)
        return cls(
            candidates=space,
            chip_idx=chip_idx,
            n_chips=np.asarray([c.n_chips for c in space], np.int64),
            mesh_data=np.asarray([a[1] for a in axes], np.int64),
            mesh_model=np.asarray([a[2] for a in axes], np.int64),
            freq_mhz=np.asarray([c.freq_mhz for c in space], np.float64),
            mesh_pod=np.asarray([a[0] for a in axes], np.int64),
            chip_cols=table.gather(chip_idx))

    def __len__(self) -> int:
        return int(np.shape(self.chip_idx)[0])

    def __getitem__(self, i: int) -> Candidate:
        if self.candidates is None:
            raise TypeError("array-only CandidateBatch (candidates=None); "
                            "materialize candidates from the owning SpaceSpec")
        return self.candidates[i]

    def pod_axis(self) -> np.ndarray:
        """The leading (pod) mesh extents; all-ones for batches built
        without ``mesh_pod``."""
        if self.mesh_pod is not None:
            return self.mesh_pod
        return np.ones(len(self), np.int64)

    def hbm_bytes(self, table: ChipTable = CHIP_TABLE) -> np.ndarray:
        """Per-candidate HBM capacity, from the gather cache when present."""
        if self.chip_cols is not None:
            return self.chip_cols["hbm_bytes"]
        return table.hbm_bytes[self.chip_idx]


SpaceLike = Union[Sequence[Candidate], CandidateBatch]


def as_batch(space: SpaceLike) -> CandidateBatch:
    if isinstance(space, CandidateBatch):
        return space
    return CandidateBatch.from_candidates(space)


def default_space(freq_points: int = 12) -> List[Candidate]:
    """The accelerator design space: generation x slice size x DVFS point."""
    out = []
    meshes = [(4, 4), (8, 8), (8, 16), (16, 16), (2, 16, 16)]
    for chip_name, chip in CHIPS.items():
        if chip.ici_bw == 0:
            meshes_c = [(1, 1)]
        else:
            meshes_c = meshes
        for mesh in meshes_c:
            n = int(np.prod(mesh))
            for f in frequency_sweep(chip_name, freq_points):
                out.append(Candidate(chip_name, n, mesh, f))
    return out


def default_space_batch(freq_points: int = 12) -> CandidateBatch:
    """``default_space`` packed as a ``CandidateBatch`` (list rides along in
    ``.candidates``)."""
    return CandidateBatch.from_candidates(default_space(freq_points))


def _scale_analysis(base_analysis: Dict, base_chips: int, cand: Candidate) -> Dict:
    """First-order rescale of a compiled census to a different slice size
    (scalar python form of ``costmodel.scale_census``).

    flops/bytes scale ~1/chips (data/model parallel split); collective bytes
    grow with ring size: x (n-1)/n relative to base ring.  Also emits
    ``coll_payload_bytes`` — the payload with the base census's global ring
    factor un-applied — which the topology-aware simulator splits across
    mesh axes by its ``SimConfig.coll_model_frac``.
    """
    r = base_chips / cand.n_chips
    nb, nc = base_chips, cand.n_chips
    ring = ((nc - 1) / nc) / max((nb - 1) / nb, 1e-9) if nc > 1 else 0.0
    return {
        "flops": base_analysis["flops"] * r,
        "hbm_bytes": base_analysis["hbm_bytes"] * r,
        "collective_bytes": base_analysis["collective_bytes"] * r * ring,
        "wire_bytes": base_analysis["wire_bytes"] * r * ring,
        "coll_payload_bytes":
            base_analysis["wire_bytes"] * r / max((nb - 1) / nb, 1e-9),
    }


def _scale_analysis_batch(base_analysis: Dict, base_chips,
                          n_chips: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``_scale_analysis`` over a whole candidate tensor at once — a thin
    alias of ``costmodel.scale_census`` (the single home of the scaling
    arithmetic, shared with the fused sweep), so the scalar oracle matches
    the float64 tensor path bitwise.  ``base_analysis`` values and
    ``base_chips`` may be scalars or tensors broadcast against ``n_chips``."""
    return costmodel.scale_census(base_analysis, base_chips, n_chips)


def feasibility_mask(batch: CandidateBatch, sim: costmodel.SimBatch,
                     constraint: Constraint, state_gb_per_device: float,
                     base_chips: int,
                     table: ChipTable = CHIP_TABLE) -> torch.Tensor:
    """Vectorized constraint check: HBM fit, slice power budget, latency.
    Runs on the device and in the dtype of ``sim``'s tensors."""
    like = sim.latency_s
    conv = costmodel._converter(like.device, like.dtype)
    n_chips = conv(batch.n_chips)
    ok = torch.ones(len(batch), dtype=torch.bool, device=like.device)
    if constraint.min_hbm_fit:
        state_pd = state_gb_per_device * base_chips / n_chips
        ok &= state_pd * 1e9 <= conv(batch.hbm_bytes(table)) * 0.9
    if constraint.max_power_w is not None:
        ok &= sim.power_w * n_chips <= constraint.max_power_w
    if constraint.max_latency_s is not None:
        ok &= sim.latency_s <= constraint.max_latency_s
    return ok


# Feature layout the adaptive-campaign surrogates train on.  Candidate
# geometry first, then the chip-table columns the cost model actually
# consumes — every column is a pure function of the candidate index, so
# features computed from ``SpaceSpec.slice`` on any host/process are
# bitwise identical (the property adaptive resume and the distributed
# adaptive path rely on).
SURROGATE_FEATURES: Tuple[str, ...] = (
    "n_chips", "freq_mhz", "mesh_pod", "mesh_data", "mesh_model",
    "peak_flops_bf16", "hbm_bw", "hbm_bytes", "ici_bw",
    "tdp_watts", "idle_watts", "ici_hop_s",
)

_CHIP_FEATURES = SURROGATE_FEATURES[5:]


def surrogate_features(batch: CandidateBatch,
                       table: ChipTable = CHIP_TABLE) -> np.ndarray:
    """Pack a candidate batch into the ``[N, F]`` float32 feature matrix the
    adaptive campaign's forests consume (column order =
    ``SURROGATE_FEATURES``)."""
    cols = batch.chip_cols if batch.chip_cols is not None \
        else table.gather(batch.chip_idx)
    feats = [np.asarray(batch.n_chips, np.float64),
             np.asarray(batch.freq_mhz, np.float64),
             np.asarray(batch.pod_axis(), np.float64),
             np.asarray(batch.mesh_data, np.float64),
             np.asarray(batch.mesh_model, np.float64)]
    feats += [np.asarray(cols[f], np.float64) for f in _CHIP_FEATURES]
    return np.stack(feats, axis=1).astype(np.float32)


def predict_tile_scores(energy_model, latency_model, batch: CandidateBatch,
                        table: ChipTable = CHIP_TABLE
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Tile-level surrogate scoring entry point: one batched forest inference
    per model over the whole tile.  Returns ``(e_mu, e_sd, l_mu, l_sd)`` in
    LOG space (the forests train on log targets).  Models without a
    ``predict_log_stats`` surface degrade to ``log(predict)`` with zero
    spread, so point predictors still work (no exploration term)."""
    X = surrogate_features(batch, table)
    out = []
    for model in (energy_model, latency_model):
        stats = getattr(model, "predict_log_stats", None)
        if stats is not None:
            mu, sd = stats(X)
        else:
            mu = np.log(np.maximum(np.asarray(model.predict(X), np.float64),
                                   1e-300))
            sd = np.zeros_like(mu)
        out += [np.asarray(mu, np.float64), np.asarray(sd, np.float64)]
    return out[0], out[1], out[2], out[3]


class BatchSearchResults(Mapping):
    """Per-candidate results of a batched sweep, as a lazy
    ``{cand: {"sim": SimResult, "feasible": bool}}`` mapping.  The
    underlying tensors stay available as ``.sim`` / ``.feasible``."""

    def __init__(self, batch: CandidateBatch, sim: costmodel.SimBatch,
                 feasible: torch.Tensor):
        self.batch = batch
        self.sim = sim
        self.feasible = feasible
        self._index: Optional[Dict[Candidate, int]] = None
        self._cache: Dict[int, Dict] = {}

    def __getitem__(self, cand: Candidate) -> Dict:
        if self._index is None:
            self._index = {c: i for i, c in enumerate(self.batch.candidates)}
        i = self._index[cand]
        if i not in self._cache:
            self._cache[i] = {"sim": self.sim.result(i),
                              "feasible": bool(self.feasible[i])}
        return self._cache[i]

    def __iter__(self):
        return iter(self.batch.candidates)

    def __len__(self) -> int:
        return len(self.batch)


def evaluate_space(base_analysis: Dict, base_chips: int, batch: CandidateBatch,
                   sim: costmodel.SimConfig = costmodel.SimConfig(),
                   dtype=torch.float64, device=DEFAULT_DEVICE
                   ) -> costmodel.SimBatch:
    """Scale the base census to every candidate and simulate the whole space
    in one pass of tensor ops on ``device``.  The batch's mesh axes feed the
    topology-aware collective model, so same-chip-count factorizations
    score differently."""
    device, dtype = resolve(device, dtype)
    n_chips = costmodel._converter(device, dtype)(batch.n_chips)
    ana = _scale_analysis_batch(base_analysis, base_chips, n_chips)
    return costmodel.simulate_batch(ana, batch.chip_idx, n_chips,
                                    batch.freq_mhz, sim=sim,
                                    gathered=batch.chip_cols,
                                    mesh_pod=batch.pod_axis(),
                                    mesh_data=batch.mesh_data,
                                    mesh_model=batch.mesh_model,
                                    dtype=dtype, device=device)


def evaluate_workload_tile(workload: "Workload", batch: CandidateBatch,
                           constraint: "Constraint" = None,
                           sim: costmodel.SimConfig = costmodel.SimConfig(),
                           dtype=torch.float64, device=DEFAULT_DEVICE
                           ) -> Tuple[costmodel.SimBatch, torch.Tensor]:
    """Evaluate one candidate tile for one workload: (SimBatch, feasible).

    The tile-friendly composition of ``evaluate_space`` + ``feasibility_mask``
    that streaming campaigns call per chunk — evaluating a space tile by
    tile through this function is exactly equivalent to one big
    ``evaluate_space`` call on the concatenated batch.  ``dtype`` picks the
    precision tier (float64 when bitwise agreement with ``pareto_search``
    matters)."""
    if constraint is None:
        constraint = Constraint()
    res = evaluate_space(workload.base_analysis, workload.base_chips, batch,
                         sim=sim, dtype=dtype, device=device)
    feasible = feasibility_mask(batch, res, constraint,
                                workload.state_gb_per_device,
                                workload.base_chips)
    return res, feasible


def slow_path_search(arch: str, shape_name: str, base_analysis: Dict,
                     base_chips: int, state_gb_per_device: float,
                     space: SpaceLike,
                     constraint: Constraint = Constraint(),
                     objective: str = "energy",
                     device=DEFAULT_DEVICE
                     ) -> Tuple[Candidate, Mapping, float]:
    """Exhaustive simulator sweep (the paper's 'slow' baseline), evaluated as
    ONE batched pass.  Returns (best, per-candidate results, wall_seconds)."""
    t0 = time.perf_counter()
    batch = as_batch(space)
    if not len(batch):
        return None, {}, time.perf_counter() - t0
    res = evaluate_space(base_analysis, base_chips, batch, device=device)
    feasible = feasibility_mask(batch, res, constraint, state_gb_per_device,
                                base_chips)
    score = res.energy_j if objective == "energy" else res.latency_s
    score = torch.where(feasible, score, float("inf"))
    i = int(torch.argmin(score))
    best = batch.candidates[i] if bool(torch.isfinite(score[i])) else None
    results = BatchSearchResults(batch, res, feasible)
    return best, results, time.perf_counter() - t0


def slow_path_search_scalar(arch: str, shape_name: str, base_analysis: Dict,
                            base_chips: int, state_gb_per_device: float,
                            space: SpaceLike,
                            constraint: Constraint = Constraint(),
                            objective: str = "energy") -> Tuple[Candidate, Dict, float]:
    """The per-candidate python loop, kept as the agreement oracle for
    ``slow_path_search``.  Each candidate passes its ``mesh`` into the scalar
    simulator, mirroring the batched path's topology threading."""
    if isinstance(space, CandidateBatch):
        space = space.candidates
    t0 = time.perf_counter()
    best, best_score, results = None, float("inf"), {}
    for cand in space:
        chip = get_chip(cand.chip)
        ana = _scale_analysis(base_analysis, base_chips, cand)
        res = costmodel.simulate(ana, chip, cand.n_chips,
                                 freq_mhz=cand.freq_mhz, mesh=cand.mesh)
        state_pd = state_gb_per_device * base_chips / cand.n_chips
        fits = state_pd * 1e9 <= chip.hbm_bytes * 0.9
        ok = ((not constraint.min_hbm_fit or fits)
              and (constraint.max_power_w is None
                   or res.power_w * cand.n_chips <= constraint.max_power_w)
              and (constraint.max_latency_s is None
                   or res.latency_s <= constraint.max_latency_s))
        score = (res.energy_j if objective == "energy" else res.latency_s)
        results[cand] = {"sim": res, "feasible": ok}
        if ok and score < best_score:
            best, best_score = cand, score
    return best, results, time.perf_counter() - t0


def predict_space(cfg, shape, power_model, cycles_model, batch: CandidateBatch,
                  constraint: Constraint = Constraint()
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
    """The fast path's shared scoring core: predictor-based
    (energy_j, latency_s, feasible, power_w_per_chip, cycles) for a batch.

    Single home for the prediction arithmetic and constraint masks so
    ``fast_path_search`` and campaign fast-path tiles cannot diverge.
    """
    X = features.extract_batch(cfg, shape, batch.chip_idx, batch.n_chips,
                               batch.mesh_data, batch.mesh_model,
                               batch.freq_mhz)
    p_watts = np.asarray(power_model.predict(X))     # per chip
    p_cycles = np.asarray(cycles_model.predict(X))
    n = batch.n_chips.astype(np.float64)
    lat = p_cycles / (batch.freq_mhz * 1e6)
    energy = p_watts * n * lat
    feasible = np.ones(len(batch), bool)
    if constraint.max_power_w is not None:
        feasible &= (p_watts * n) <= constraint.max_power_w
    if constraint.max_latency_s is not None:
        feasible &= lat <= constraint.max_latency_s
    if constraint.min_hbm_fit:
        need = cfg.param_count() * 2 * (3.0 if shape.kind == "train" else 1.0)
        feasible &= need / n <= batch.hbm_bytes() * 0.9
    return energy, lat, feasible, p_watts, p_cycles


def fast_path_search(arch: str, shape_name: str, power_model, cycles_model,
                     space: SpaceLike,
                     constraint: Constraint = Constraint(),
                     objective: str = "energy",
                     verify_top_k: int = 5,
                     slow_verify=None) -> Tuple[Candidate, Dict, float]:
    """Predictor-ranked search (the paper's fast path).

    The design matrix comes from ``features.extract_batch`` (one vector pass,
    no per-candidate Python), predictions and constraint masks are array ops,
    and only the top-k survivors are optionally re-verified with the
    simulator (callable ``slow_verify(cand) -> SimResult``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    batch = as_batch(space)
    energy, lat, feasible, p_watts, p_cycles = predict_space(
        cfg, shape, power_model, cycles_model, batch, constraint)
    score = energy if objective == "energy" else lat
    score = np.where(feasible, score, np.inf)
    order = np.argsort(score)
    elapsed = time.perf_counter() - t0
    top = [batch.candidates[i] for i in order[:verify_top_k]
           if np.isfinite(score[i])]
    if not top:
        return None, {}, elapsed
    best = top[0]
    if slow_verify is not None:
        verified = [(slow_verify(c), c) for c in top]
        key = ((lambda rc: rc[0].energy_j) if objective == "energy"
               else (lambda rc: rc[0].latency_s))
        best = min(verified, key=key)[1]
    details = {"predicted_power_w": p_watts, "predicted_cycles": p_cycles,
               "order": order[:verify_top_k]}
    return best, details, elapsed


# --- Multi-objective / multi-workload sweep -----------------------------------


@dataclasses.dataclass(frozen=True)
class Workload:
    """One (arch, shape) cell to sweep: its compiled census + footprint."""

    arch: str
    shape: str
    base_analysis: Dict
    base_chips: int
    state_gb_per_device: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: ndarray fields
class ParetoFrontier:
    """Energy/latency frontier of one workload over the candidate space
    (host-side: a frontier is tens of points)."""

    workload: Workload
    candidates: Tuple[Candidate, ...]        # frontier members
    energy_j: np.ndarray                     # [F], aligned with candidates
    latency_s: np.ndarray                    # [F]
    indices: np.ndarray                      # [F] rows into the swept batch
    feasible_count: int

    def __len__(self) -> int:
        return len(self.candidates)


def pareto_mask(energy: np.ndarray, latency: np.ndarray,
                feasible: np.ndarray) -> np.ndarray:
    """Non-dominated feasible points of the (energy, latency) minimization,
    as a boolean mask (host numpy — the frontier fold's exact skyline).

    Skyline sweep — sort by (latency, energy) and keep the running energy
    minimum — O(N log N) time, O(N) memory.  j dominates i iff j is
    feasible, <= on both axes, strictly better on one; equal
    (energy, latency) duplicates do not dominate each other.
    """
    e = np.asarray(energy, np.float64)
    l = np.asarray(latency, np.float64)
    feas = np.asarray(feasible, bool)
    mask = np.zeros(e.shape, bool)
    idx = np.flatnonzero(feas)
    if idx.size == 0:
        return mask
    order = np.lexsort((e[idx], l[idx]))
    es, ls = e[idx][order], l[idx][order]
    # min energy over all strictly-smaller latencies (inf for the first group)
    first = np.searchsorted(ls, ls, side="left")
    prefix_min = np.minimum.accumulate(es)
    best_before = np.where(first > 0, prefix_min[np.maximum(first - 1, 0)],
                           np.inf)
    # survive: not beaten by a faster point (strict latency, <= energy) and
    # tied-latency points only if they hold the group's energy minimum
    nondom = (es < best_before) & (es <= es[first])
    mask[idx[order[nondom]]] = True
    return mask


def pareto_search(workloads: Union[Workload, Sequence[Workload]],
                  space: SpaceLike,
                  constraint: Constraint = Constraint(),
                  device=DEFAULT_DEVICE
                  ) -> Dict[Tuple[str, str], ParetoFrontier]:
    """Multi-objective DSE: the energy/latency Pareto frontier per workload.

    Every workload is evaluated over the whole space in float64 tensor ops
    on ``device`` (``evaluate_workload_tile``); the skyline itself is taken
    on the host.  Returns ``{(arch, shape): ParetoFrontier}``.
    """
    if isinstance(workloads, Workload):
        workloads = [workloads]
    keys = [(wl.arch, wl.shape) for wl in workloads]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate (arch, shape) workload keys in {keys}; "
                         "disambiguate (e.g. suffix the shape with the pod "
                         "tag) — results are keyed by (arch, shape)")
    batch = as_batch(space)
    out = {}
    for wl in workloads:
        res, feas = evaluate_workload_tile(wl, batch, constraint,
                                           device=device)
        energy = res.energy_j.cpu().numpy()
        latency = res.latency_s.cpu().numpy()
        feasible = feas.cpu().numpy()
        mask = pareto_mask(energy, latency, feasible)
        idx = np.flatnonzero(mask)
        order = idx[np.argsort(latency[idx])]
        out[(wl.arch, wl.shape)] = ParetoFrontier(
            workload=wl,
            candidates=tuple(batch.candidates[i] for i in order),
            energy_j=energy[order],
            latency_s=latency[order],
            indices=order,
            feasible_count=int(feasible.sum()))
    return out
