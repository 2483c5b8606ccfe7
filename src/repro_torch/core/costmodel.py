"""Analytical ground-truth simulator: latency (cycles) + power + energy.

Counterpart of ``repro.core.costmodel`` on ``torch`` tensors.  The model is
a deterministic, calibrated analytical model over a compiled census (the
"slow-accurate path"): census -> three roofline terms -> partial-overlap
latency -> CMOS power.

Latency model:
  t_comp = flops / (peak * f/f_nominal)       t_mem = hbm_bytes / hbm_bw
  t_coll -- topology-aware when the candidate's mesh is known: the collective
  payload splits into a data-parallel share (hierarchical ring all-reduce over
  the pod x data axes) and a model-parallel share (all-gather/reduce-scatter
  on the model axis), each axis costing

      t_axis = bytes_axis * (k - 1)/k / (ici_bw * links_axis)
               + 2 * (k - 1) * hop_s

  with per-axis link counts from ``hw.axis_link_counts``.  Without a mesh the
  fixed mesh-less approximation ``wire_bytes / (ici_bw * MESHLESS_LINKS)``
  applies.
  latency = max(t) + (1 - overlap) * (sum(t) - max(t))

Power model (per chip):
  P = P_idle + (TDP - P_idle) * (w_mxu*u_mxu + w_hbm*u_hbm + w_ici*u_ici)
      * (f/f_max)^3            [DVFS cubic]

Two precision tiers, chosen by the ``dtype`` every entry point takes:
float64 is the exact tier (the oracle the campaign frontiers are held to),
float32 the fast one.  Expressions keep one fixed association — the sum of
the three roofline times is ``(t_comp + t_mem) + t_coll``, the cube is
``x*x*x`` — because the hand-written CUDA sweep kernel
(``repro_torch.kernels``) repeats them operation by operation and is held
bitwise to the tensor code here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.hw import (CHIP_TABLE, ChipSpec, ChipTable, as_float_tensor,
                            axis_link_counts, get_chip, normalize_mesh)

# default fraction of the collective payload attributed to model-parallel
# collectives; the remainder is the data-parallel all-reduce share.  The
# split happens in ONE place (``collective_payload``).
COLL_MODEL_FRAC = 0.5

# bump when the cost model's arithmetic changes on purpose.  Checkpoints
# stamp this number and refuse to load across a mismatch.  The port keeps
# the reference's version so artifacts of the two packages stay comparable.
SIM_MODEL_VERSION = 3

# link count of the fixed mesh-less approximation
MESHLESS_LINKS = 2


@dataclasses.dataclass(frozen=True)
class SimConfig:
    overlap: float = 0.8
    w_mxu: float = 0.55
    w_hbm: float = 0.30
    w_ici: float = 0.15
    coll_model_frac: float = COLL_MODEL_FRAC


@dataclasses.dataclass(frozen=True)
class SimResult:
    t_compute: float
    t_memory: float
    t_collective: float
    latency_s: float
    cycles: float
    utilization: float
    power_w: float               # per chip
    energy_j: float              # whole slice
    bottleneck: str

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def wire_bytes(analysis: Dict):
    """Collective wire-bytes of a census, with the documented fallback chain
    (wire_bytes -> collective_bytes -> 0) shared by every simulate variant."""
    return analysis.get("wire_bytes", analysis.get("collective_bytes", 0.0))


def _raw_payload(analysis: Dict, n_chips):
    """Un-ring-factored collective payload bytes per device.

    Prefers the ``coll_payload_bytes`` key that ``scale_census`` emits;
    otherwise derives it from ``wire_bytes`` by un-applying the whole-slice
    ring factor (n-1)/n that first-order scaling applied."""
    n = as_float_tensor(n_chips)
    if "coll_payload_bytes" in analysis:
        return as_float_tensor(analysis["coll_payload_bytes"], n)
    wire = as_float_tensor(wire_bytes(analysis), n)
    ring = torch.where(n > 1, (n - 1.0) / torch.clamp(n, min=1.0), 1.0)
    return wire / ring


def collective_payload(analysis: Dict, n_chips, frac: float):
    """(data_bytes, model_bytes) collective payload split for a candidate.

    The ONLY place the data/model split happens, so the simulating
    ``SimConfig.coll_model_frac`` is always honored."""
    payload = _raw_payload(analysis, n_chips)
    return payload * (1.0 - frac), payload * frac


def _axis_collective_time(payload, extent, links, ici_bw, hop_s):
    """Ring time of one mesh axis: bandwidth term + per-step hop latency.

    t = payload * (k-1)/k / (ici_bw * links) + 2*(k-1)*hop_s
    (reduce-scatter + all-gather, k-1 ring steps each).  Inactive axes
    (k <= 1), axes moving zero bytes, linkless chips, and zero-bandwidth
    chips contribute 0; every divide is guarded so dead lanes never see a
    zero denominator."""
    payload = as_float_tensor(payload)
    k = as_float_tensor(extent, payload)
    links = as_float_tensor(links, payload)
    bw = as_float_tensor(ici_bw, payload)
    live = (k > 1) & (links > 0) & (bw > 0) & (payload > 0)
    denom = torch.where(live, bw * torch.where(links > 0, links, 1.0), 1.0)
    t_bw = payload * (k - 1.0) / torch.clamp(k, min=1.0) / denom
    t_hop = 2.0 * (k - 1.0) * hop_s
    return torch.where(live, t_bw + t_hop, 0.0)


def topology_collective_time(p_data, p_model, mesh_pod, mesh_data, mesh_model,
                             ici_bw, ici_links, links_per_axis, hop_s):
    """Topology-aware collective time over the (pod, data, model) mesh axes.

    The model-parallel payload rides the model axis; the data-parallel
    payload does a hierarchical ring all-reduce: a full ring over the data
    axis, then the pod axis on the 1/k_data shard that survives the first
    reduce-scatter stage."""
    p_data = as_float_tensor(p_data)
    lp, ld, lm = axis_link_counts(mesh_pod, mesh_data, mesh_model,
                                  ici_links, links_per_axis)
    kd = as_float_tensor(mesh_data, p_data)
    return (_axis_collective_time(p_data, mesh_data, ld, ici_bw, hop_s)
            + _axis_collective_time(p_data / torch.clamp(kd, min=1.0),
                                    mesh_pod, lp, ici_bw, hop_s)
            + _axis_collective_time(p_model, mesh_model, lm, ici_bw, hop_s))


def roofline_terms(analysis: Dict, chip: ChipSpec, n_chips: int) -> Dict:
    """The roofline contract.  ``analysis`` holds PER-DEVICE numbers, so
    term = per_device_quantity / per_chip_rate == global / (chips * rate)."""
    t_comp = analysis["flops"] / chip.peak_flops_bf16
    t_mem = analysis["hbm_bytes"] / chip.hbm_bw
    t_coll = (analysis["collective_bytes"] / chip.ici_bw
              if chip.ici_bw else 0.0)
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    return {**terms, "dominant": dom,
            "hlo_flops_per_device": analysis["flops"],
            "hlo_bytes_per_device": analysis["hbm_bytes"],
            "collective_bytes_per_device": analysis["collective_bytes"],
            "n_chips": n_chips}


def simulate(analysis: Dict, chip: ChipSpec, n_chips: int,
             freq_mhz: Optional[float] = None,
             sim: SimConfig = SimConfig(), mesh=None) -> SimResult:
    """Slow-accurate scalar path: deterministic latency/power of one
    candidate, in python floats on the host (the ground truth the tensor
    paths are tested against).

    With ``mesh`` the collective term is the topology-aware per-axis model,
    run through the same tensor helpers as ``simulate_batch`` on 0-d float64
    tensors, so scalar and batch agree bitwise; without it the fixed
    mesh-less ``MESHLESS_LINKS`` approximation applies."""
    if freq_mhz is None:
        freq_mhz = chip.nominal_freq_mhz
    chip_f = chip.at_frequency(freq_mhz)
    t_comp = analysis["flops"] / chip_f.peak_flops_bf16
    t_mem = analysis["hbm_bytes"] / chip_f.hbm_bw
    wire = wire_bytes(analysis)
    if mesh is not None:
        pod, data, model = normalize_mesh(mesh)
        p_d, p_m = collective_payload(analysis, n_chips, sim.coll_model_frac)
        t_coll = float(topology_collective_time(
            p_d, p_m, pod, data, model, chip_f.ici_bw, chip_f.ici_links,
            chip_f.ici_links_per_axis, chip_f.ici_hop_s))
    else:
        t_coll = (wire / (chip_f.ici_bw * MESHLESS_LINKS)
                  if chip_f.ici_bw else 0.0)

    ts = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(ts, key=ts.get)
    t_max = ts[dom]
    latency = t_max + (1.0 - sim.overlap) * (sum(ts.values()) - t_max)
    latency = max(latency, 1e-9)

    u_mxu = t_comp / latency
    u_hbm = t_mem / latency
    u_ici = t_coll / latency
    util = sim.w_mxu * u_mxu + sim.w_hbm * u_hbm + sim.w_ici * u_ici
    power = chip.dynamic_power(freq_mhz, util)
    cycles = latency * freq_mhz * 1e6
    return SimResult(
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        latency_s=latency, cycles=cycles, utilization=u_mxu,
        power_w=power, energy_j=power * latency * n_chips,
        bottleneck=dom)


def simulate_by_name(analysis: Dict, chip_name: str, n_chips: int,
                     freq_mhz: Optional[float] = None, mesh=None) -> SimResult:
    return simulate(analysis, get_chip(chip_name), n_chips, freq_mhz,
                    mesh=mesh)


# --- Batched (struct-of-arrays) path ------------------------------------------
# Same arithmetic as ``simulate`` applied to whole candidate tensors at once:
# chip properties are gathered from CHIP_TABLE by index, every step is an
# elementwise tensor op.

BOTTLENECKS = ("compute", "memory", "collective")

# the chip-table columns simulate_batch actually gathers
SIM_GATHER_FIELDS = ("nominal_freq_mhz", "min_freq_mhz", "max_freq_mhz",
                     "peak_flops_bf16", "hbm_bw", "ici_bw", "tdp_watts",
                     "idle_watts", "ici_links", "ici_links_per_axis",
                     "ici_hop_s")


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class SimBatch:
    """``SimResult`` over N candidates, field-per-tensor."""

    t_compute: torch.Tensor
    t_memory: torch.Tensor
    t_collective: torch.Tensor
    latency_s: torch.Tensor
    cycles: torch.Tensor
    utilization: torch.Tensor
    power_w: torch.Tensor              # per chip
    energy_j: torch.Tensor             # whole slice
    bottleneck_idx: torch.Tensor       # index into BOTTLENECKS

    def __len__(self) -> int:
        return int(self.latency_s.shape[0])

    def bottleneck(self, i: int) -> str:
        return BOTTLENECKS[int(self.bottleneck_idx[i])]

    def result(self, i: int) -> SimResult:
        """Materialize one row as the scalar dataclass."""
        return SimResult(
            t_compute=float(self.t_compute[i]),
            t_memory=float(self.t_memory[i]),
            t_collective=float(self.t_collective[i]),
            latency_s=float(self.latency_s[i]),
            cycles=float(self.cycles[i]),
            utilization=float(self.utilization[i]),
            power_w=float(self.power_w[i]),
            energy_j=float(self.energy_j[i]),
            bottleneck=self.bottleneck(i))


def _converter(device: torch.device, dtype: torch.dtype):
    """``x -> tensor(device, dtype)`` for numpy arrays, scalars and tensors
    (integer extents are lifted to ``dtype`` exactly)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)
    return conv


def simulate_batch(analysis: Dict, chip_idx, n_chips,
                   freq_mhz=None, sim: SimConfig = SimConfig(),
                   table: ChipTable = CHIP_TABLE,
                   gathered: Optional[Dict] = None,
                   mesh_pod=None, mesh_data=None, mesh_model=None,
                   dtype=torch.float64, device=DEFAULT_DEVICE) -> SimBatch:
    """Vectorized ``simulate`` over tensors of candidates.

    ``analysis`` holds per-device tensors (or scalars, broadcast) of flops /
    hbm_bytes / collective_bytes / wire_bytes (plus the optional
    ``coll_payload_bytes`` un-split collective payload); ``chip_idx``
    indexes ``table``; ``n_chips`` / ``freq_mhz`` are per-candidate.  Inputs
    may be numpy arrays or tensors; everything is moved to ``device`` in
    ``dtype`` first.  With ``mesh_data``/``mesh_model`` (and optionally
    ``mesh_pod``) the collective term is the topology-aware per-axis model;
    without them the fixed mesh-less approximation applies.  float64 agrees
    with the scalar path bitwise; ``dtype=torch.float32`` is the fast tier
    (~1e-6 relative).  ``gathered`` (the ``SIM_GATHER_FIELDS`` columns,
    e.g. from ``table.gather(chip_idx)``) skips the per-call column gathers.
    """
    device, dtype = resolve(device, dtype)
    conv = _converter(device, dtype)
    n_chips = conv(n_chips)
    if gathered is None:
        gathered = table.gather(np.asarray(chip_idx))
    gathered = {f: conv(gathered[f]) for f in SIM_GATHER_FIELDS}
    nominal = gathered["nominal_freq_mhz"]
    f_min = gathered["min_freq_mhz"]
    f_max = gathered["max_freq_mhz"]
    freq_in = nominal if freq_mhz is None else conv(freq_mhz)
    freq = torch.minimum(torch.maximum(freq_in, f_min), f_max)

    peak = gathered["peak_flops_bf16"] * (freq / nominal)
    hbm_bw = gathered["hbm_bw"]
    ici_bw = gathered["ici_bw"]

    ana = {k: conv(v) for k, v in analysis.items()}
    flops = ana["flops"]
    hbm_bytes = ana["hbm_bytes"]

    t_comp = flops / peak
    t_mem = hbm_bytes / hbm_bw
    if mesh_model is not None:
        if mesh_data is None:
            raise ValueError("mesh_model without mesh_data; pass both "
                             "trailing mesh axes (mesh_pod is optional)")
        mesh_model = conv(mesh_model)
        mesh_data = conv(mesh_data)
        mesh_pod = (torch.ones_like(mesh_model) if mesh_pod is None
                    else conv(mesh_pod))
        p_d, p_m = collective_payload(ana, n_chips, sim.coll_model_frac)
        t_coll = topology_collective_time(
            p_d, p_m, mesh_pod, mesh_data, mesh_model, ici_bw,
            gathered["ici_links"], gathered["ici_links_per_axis"],
            gathered["ici_hop_s"])
    else:
        wire = conv(wire_bytes(ana))
        has_ici = ici_bw > 0
        t_coll = torch.where(
            has_ici,
            wire / (torch.where(has_ici, ici_bw, 1.0) * MESHLESS_LINKS),
            0.0)

    t_comp, t_mem, t_coll = torch.broadcast_tensors(t_comp, t_mem, t_coll)
    ts = torch.stack([t_comp, t_mem, t_coll])      # BOTTLENECKS order
    dom = torch.argmax(ts, dim=0)                  # ties: first maximum
    t_max = torch.maximum(torch.maximum(t_comp, t_mem), t_coll)
    # fixed association (t_comp + t_mem) + t_coll, as the CUDA kernel sums
    latency = t_max + (1.0 - sim.overlap) * (((t_comp + t_mem) + t_coll)
                                             - t_max)
    latency = torch.clamp(latency, min=1e-9)

    # same association as the scalar path: w * (t/latency), summed in order
    util = (sim.w_mxu * (t_comp / latency) + sim.w_hbm * (t_mem / latency)
            + sim.w_ici * (t_coll / latency))
    util = torch.clamp(util, 0.0, 1.0)
    tdp = gathered["tdp_watts"]
    idle = gathered["idle_watts"]
    fr = freq / f_max
    power = idle + (tdp - idle) * util * (fr * fr * fr)
    power = torch.minimum(power, tdp)

    # cycles use the caller's (unclamped) frequency, matching ``simulate``
    cycles = latency * freq_in * 1e6
    return SimBatch(
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        latency_s=latency, cycles=cycles, utilization=t_comp / latency,
        power_w=power, energy_j=power * latency * n_chips,
        bottleneck_idx=dom)


def scale_census(base_analysis: Dict, base_chips, n_chips) -> Dict:
    """First-order rescale of a compiled census to other slice sizes.

    The single home of the scaling arithmetic shared by
    ``dse._scale_analysis_batch``, the fused sweep below and (operation by
    operation) the CUDA sweep kernel.  flops/bytes scale ~1/chips;
    collective bytes ride the ring factor; the emitted
    ``coll_payload_bytes`` un-applies the base census's global ring factor
    so the topology-aware simulator can split it per mesh axis.
    ``n_chips`` is a floating tensor; ``base_chips`` and the census values
    are tensors broadcastable against it, or scalars.
    """
    nc = as_float_tensor(n_chips)
    bc = as_float_tensor(base_chips, nc)
    r = bc / nc
    ring_base = torch.clamp((bc - 1.0) / bc, min=1e-9)
    ring = torch.where(nc > 1, ((nc - 1.0) / nc) / ring_base, 0.0)
    return {
        "flops": base_analysis["flops"] * r,
        "hbm_bytes": base_analysis["hbm_bytes"] * r,
        "collective_bytes": base_analysis["collective_bytes"] * r * ring,
        "wire_bytes": base_analysis["wire_bytes"] * r * ring,
        "coll_payload_bytes": base_analysis["wire_bytes"] * r / ring_base,
    }


# --- Fused sweep reduction (per-tile skyline pre-reduction) -------------------
# A campaign tile's full energy/latency rows exist only so the streaming
# frontier can discard >99% of them.  The helpers below do that discard on
# the device: the constraint-feasible screen survivors of the tile plus the
# scalar aggregates the frontier accounting needs are everything the host
# has to see — O(survivors) transfer instead of O(tile).

# chip-table columns the fused sweep gathers: the simulate set plus the HBM
# capacity the feasibility check reads
SWEEP_GATHER_FIELDS = SIM_GATHER_FIELDS + ("hbm_bytes",)

# per-workload scalar column order of the packed [W, 6] workload matrix
WL_COLS = ("flops", "hbm_bytes", "collective_bytes", "wire_bytes",
           "base_chips", "state_gb_per_device")

# packed candidate-column order of the [len(CAND_COLS), N] matrix the fused
# sweep consumes: batch axes first, then the gathered chip-table columns
CAND_COLS = ("n_chips", "freq_mhz", "mesh_pod", "mesh_data", "mesh_model",
             "valid") + SWEEP_GATHER_FIELDS


def skyline_reduce(energy, latency, feasible):
    """(keep, n_feasible, ref_energy, ref_latency) of one evaluated tile.

    ``keep`` marks the feasible Pareto survivors of the (energy, latency)
    minimization — the same set ``dse.pareto_mask`` selects, computed with
    static shapes on tensors: infeasible rows are mapped to +inf sort keys
    instead of being compacted away.  ``ref_*`` are the feasible maxima
    (-inf when the tile has no feasible point).
    """
    e = torch.as_tensor(energy)
    l = torch.as_tensor(latency)
    feas = torch.as_tensor(feasible).to(device=e.device, dtype=torch.bool)
    inf = float("inf")
    e_key = torch.where(feas, e, inf)
    l_key = torch.where(feas, l, inf)
    # lexicographic (latency, energy) order from two stable sorts
    order = torch.argsort(e_key, stable=True)
    order = order[torch.argsort(l_key[order], stable=True)]
    es, ls = e_key[order], l_key[order]
    first = torch.searchsorted(ls, ls, right=False)
    prefix = torch.cummin(es, dim=0).values
    best_before = torch.where(first > 0, prefix[torch.clamp(first - 1, min=0)],
                              inf)
    # survive: strictly faster points all cost more energy, and tied-latency
    # points only if they hold the group's energy minimum (equal duplicates
    # never dominate each other — both stay, matching dse.pareto_mask)
    nondom = (es < best_before) & (es <= es[first]) & feas[order]
    keep = torch.zeros_like(feas)
    keep[order] = nondom
    return (keep, feas.sum(), torch.where(feas, e, -inf).max(),
            torch.where(feas, l, -inf).max())


def sweep_feasibility(power_w, latency_s, n_chips, hbm_bytes, base_chips,
                      state_gb_per_device, valid, max_power_w, max_latency_s,
                      min_hbm_fit: bool):
    """``dse.feasibility_mask`` arithmetic in broadcast, padding-aware form.

    ``valid`` masks tile padding lanes (always infeasible); ``max_power_w`` /
    ``max_latency_s`` of ``None`` skip their comparison exactly like the
    per-workload constraint path, so the float64 tiers agree bitwise."""
    ok = valid > 0
    nc = n_chips
    if min_hbm_fit:
        state_pd = state_gb_per_device * base_chips / nc
        ok = ok & (state_pd * 1e9 <= hbm_bytes * 0.9)
    if max_power_w is not None:
        ok = ok & (power_w * nc <= max_power_w)
    if max_latency_s is not None:
        ok = ok & (latency_s <= max_latency_s)
    return ok


# convex-weight probe spread of the on-device dominance screen: each weight
# w picks the feasible argmin of w*(e/e_min) + (l/l_min) — a point ON the
# tile skyline — and everything strictly dominated by a probe is screened
# out.  Geometric spread covers frontier slopes across four decades.
_PROBE_WEIGHTS = np.geomspace(1e-2, 1e2, 8)


def _sweep_rows(cols: Dict, wl: Dict, sim: SimConfig, max_power_w,
                max_latency_s, min_hbm_fit: bool):
    """(energy, latency, feasible) as [W, N] tensors: every workload row of
    ``wl`` ([W, 1] tensors keyed by ``WL_COLS``) against every candidate
    lane of ``cols`` ([1, N] tensors keyed by ``CAND_COLS``).  The tensor
    form of what the CUDA sweep kernel computes per (workload, lane)."""
    like = cols["n_chips"]
    ana = scale_census(wl, wl["base_chips"], like)
    b = simulate_batch(ana, None, like, cols["freq_mhz"], sim=sim,
                       gathered=cols, mesh_pod=cols["mesh_pod"],
                       mesh_data=cols["mesh_data"],
                       mesh_model=cols["mesh_model"],
                       dtype=like.dtype, device=like.device)
    feas = sweep_feasibility(
        b.power_w, b.latency_s, like, cols["hbm_bytes"], wl["base_chips"],
        wl["state_gb_per_device"], cols["valid"], max_power_w, max_latency_s,
        min_hbm_fit)
    e, l, feas = torch.broadcast_tensors(b.energy_j, b.latency_s, feas)
    return e.contiguous(), l.contiguous(), feas.contiguous()


def _screen_rows(energy, latency, feasible):
    """Per-workload-row conservative dominance screen of [W, N] sweeps, the
    tensor form (and plain version) of the CUDA screen kernel.  Returns
    (keep, n_surv, n_feas, ref_e, ref_l) with ``keep`` the [W, N] survivor
    mask.

    The screen is CONSERVATIVE: probes are real feasible points (argmins of
    convex (energy, latency) weightings, i.e. skyline members), and a
    skyline point is dominated by nothing — so the surviving set is always
    a superset of the exact ``skyline_reduce`` set, and the frontier fold
    (``StreamingFrontier.merge_reduced`` -> ``dse.pareto_mask``) recovers
    the exact skyline from it.  Everything here is elementwise / reduction
    work — no sort, no prefix scan.  All dominance comparisons run in the
    sweep dtype against probe values gathered from the same tensors, so
    screening decisions are exact in any precision.  ``argmin`` ties go to
    the lowest lane; a row without a feasible lane probes lane 0 and keeps
    nothing."""
    e, l, feas = energy, latency, feasible
    inf = float("inf")
    wts = torch.as_tensor(_PROBE_WEIGHTS).to(device=e.device, dtype=e.dtype)
    e_lo = torch.where(feas, e, inf).amin(dim=1, keepdim=True)      # [W, 1]
    l_lo = torch.where(feas, l, inf).amin(dim=1, keepdim=True)
    score = (wts[None, :, None] * (e / e_lo)[:, None, :]
             + (l / l_lo)[:, None, :])                               # [W,P,N]
    pi = torch.where(feas[:, None, :], score, inf).argmin(dim=2)     # [W, P]
    ep = e.gather(1, pi)[:, :, None]                                 # [W,P,1]
    lp = l.gather(1, pi)[:, :, None]
    e3, l3 = e[:, None, :], l[:, None, :]
    dom = (e3 >= ep) & (l3 >= lp) & ((e3 > ep) | (l3 > lp))
    keep = feas & ~dom.any(dim=1)
    return (keep, keep.sum(dim=1), feas.sum(dim=1),
            torch.where(feas, e, -inf).amax(dim=1),
            torch.where(feas, l, -inf).amax(dim=1))


def _compact_rows_host(keep, energy, latency, max_survivors: int):
    """numpy survivor compaction of screened [W, N] rows: (surv_idx, surv_e,
    surv_l) as [W, K] with ascending lanes, rows past the row's survivor
    count zero-filled.  The straightforward loop ``_compact_rows_device`` is
    held against."""
    keep = np.asarray(keep)
    energy = np.asarray(energy)
    latency = np.asarray(latency)
    w_count, n = keep.shape
    k = min(int(max_survivors), n)
    surv_idx = np.zeros((w_count, k), np.int64)
    surv_e = np.zeros((w_count, k), energy.dtype)
    surv_l = np.zeros((w_count, k), latency.dtype)
    for w in range(w_count):
        pos = np.flatnonzero(keep[w])[:k]
        surv_idx[w, :pos.size] = pos
        surv_e[w, :pos.size] = energy[w, pos]
        surv_l[w, :pos.size] = latency[w, pos]
    return surv_idx, surv_e, surv_l


def _compact_rows_device(keep, energy, latency, max_survivors: int):
    """Tensor survivor compaction (cumsum-rank scatter) on whatever device
    the rows live on, same contract as ``_compact_rows_host``: only the
    [W, K] result has to cross to the host."""
    w_count, n = keep.shape
    k = min(int(max_survivors), n)
    lane = torch.arange(n, device=keep.device).expand(w_count, n)
    rank = torch.cumsum(keep, dim=1) - 1
    # lanes that are dropped, or ranked past K, all land in a spill column
    tgt = torch.where(keep & (rank < k), rank, k)
    pos = torch.zeros((w_count, k + 1), dtype=torch.int64,
                      device=keep.device).scatter_(1, tgt, lane)[:, :k]
    filled = (torch.arange(k, device=keep.device)[None, :]
              < keep.sum(dim=1, keepdim=True))
    pos = torch.where(filled, pos, 0)
    return (pos, torch.where(filled, energy.gather(1, pos), 0.0),
            torch.where(filled, latency.gather(1, pos), 0.0))


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: array fields
class SweepReduced:
    """Reduced result of one fused (all-workloads x tile) sweep.

    ``surv_*`` are the screened tile survivors (a feasible superset of the
    tile's Pareto skyline) on the host — all a frontier merge needs.  The
    full [W, N] rows are not kept: ``rows`` gives them, on the device the
    sweep ran on, at most once per result (``energy_full``,
    ``latency_full``, ``feasible_full``).  Where the sweep never wrote them
    (the fused kernel), ``rows`` runs the sweep kernel again for this tile;
    it is read only through ``full_rows`` on the (rare) overflow fallback,
    when a workload's screened set exceeds ``max_survivors``.  So a normal
    tile moves only the [W, K] survivors and four [W] aggregates to the
    host."""

    surv_idx: np.ndarray         # int64 [W, K] lane indices into the tile
    surv_energy: np.ndarray      # [W, K], rows past n_survivors are fill
    surv_latency: np.ndarray     # [W, K]
    n_survivors: np.ndarray      # int64 [W] (may exceed K: overflow)
    n_feasible: np.ndarray       # int64 [W]
    ref_energy: np.ndarray       # [W] feasible max (-inf if none)
    ref_latency: np.ndarray      # [W]
    max_survivors: int
    # () -> (energy, latency, feasible bool), each [W, N]
    rows: Callable[[], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

    @functools.cached_property
    def _rows(self):
        return self.rows()

    @property
    def energy_full(self) -> torch.Tensor:
        return self._rows[0]

    @property
    def latency_full(self) -> torch.Tensor:
        return self._rows[1]

    @property
    def feasible_full(self) -> torch.Tensor:
        return self._rows[2]

    def overflowed(self, w: int) -> bool:
        return int(self.n_survivors[w]) > self.max_survivors

    def full_rows(self, w: int, n: Optional[int] = None):
        """(energy, latency, feasible) of workload row ``w`` (first ``n``
        lanes) as host numpy arrays — the lazy device-to-host read."""
        sl = slice(None) if n is None else slice(0, int(n))
        return (self.energy_full[w, sl].cpu().numpy(),
                self.latency_full[w, sl].cpu().numpy(),
                self.feasible_full[w, sl].cpu().numpy())


def build_sweep_reduced(out, max_survivors: int) -> SweepReduced:
    """Assemble a ``SweepReduced`` from a sweep-and-screen output tuple
    (keep, n_surv, n_feas, ref_e, ref_l, e_full, l_full, feas_full), all
    tensors on one device — the plain path and the kernels' ``general``
    launch plan.

    Compaction runs where the rows live (``_compact_rows_device``); four
    small copies bring the survivors and the aggregates to the host, and the
    first of them is the tile's synchronisation point.
    """
    keep, n_surv, n_feas, ref_e, ref_l, e_full, l_full, feas_full = out
    surv_idx, surv_e, surv_l = _compact_rows_device(
        keep, e_full, l_full, max_survivors)
    counts = torch.stack([n_surv, n_feas]).cpu().numpy()
    refs = torch.stack([ref_e, ref_l]).cpu().numpy()
    vals = torch.stack([surv_e, surv_l]).cpu().numpy()
    full = (e_full, l_full, feas_full)
    return SweepReduced(
        surv_idx=surv_idx.cpu().numpy(), surv_energy=vals[0],
        surv_latency=vals[1], n_survivors=counts[0], n_feasible=counts[1],
        ref_energy=refs[0], ref_latency=refs[1],
        max_survivors=int(max_survivors), rows=lambda: full)


def pack_cand_cols(arrays: Dict, dtype=torch.float64,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack the ``CAND_COLS`` entries of ``arrays`` (equal-length numpy
    arrays) into one contiguous host [len(CAND_COLS), N] tensor of ``dtype``
    — the single buffer a tile's host-to-device copy moves.  ``out`` reuses
    a (pinned) staging buffer of that shape."""
    n = len(arrays[CAND_COLS[0]])
    if out is None:
        out = torch.empty((len(CAND_COLS), n), dtype=dtype)
    elif tuple(out.shape) != (len(CAND_COLS), n) or out.dtype != dtype:
        raise ValueError(f"staging buffer {tuple(out.shape)}/{out.dtype} "
                         f"does not fit [{len(CAND_COLS)}, {n}]/{dtype}")
    view = out.numpy()
    for i, k in enumerate(CAND_COLS):
        view[i, :] = arrays[k]
    return out


def split_cols(cand_cols: torch.Tensor, wl_cols: torch.Tensor):
    """Packed matrices -> (``CAND_COLS`` dict of [1, N] rows, ``WL_COLS``
    dict of [W, 1] columns), as views."""
    if cand_cols.dim() != 2 or cand_cols.shape[0] != len(CAND_COLS):
        raise ValueError(f"cand_cols must be [{len(CAND_COLS)}, N] "
                         f"({CAND_COLS}), got {tuple(cand_cols.shape)}")
    if wl_cols.dim() != 2 or wl_cols.shape[1] != len(WL_COLS):
        raise ValueError(f"wl_cols must be [W, {len(WL_COLS)}] ({WL_COLS}), "
                         f"got {tuple(wl_cols.shape)}")
    cols = {k: cand_cols[i:i + 1, :] for i, k in enumerate(CAND_COLS)}
    wl = {k: wl_cols[:, i:i + 1] for i, k in enumerate(WL_COLS)}
    return cols, wl


def sweep_workloads_reduced(wl_cols, chip_cols: Dict, n_chips, freq_mhz,
                            mesh_pod, mesh_data, mesh_model, valid,
                            sim: SimConfig = SimConfig(),
                            max_power_w=None, max_latency_s=None,
                            min_hbm_fit: bool = True,
                            max_survivors: int = 2048,
                            dtype=torch.float64,
                            device=DEFAULT_DEVICE) -> SweepReduced:
    """The fused campaign evaluator in plain tensor ops.

    One call evaluates ALL ``W`` workloads on one (padded) candidate tile —
    census scaling, topology-aware simulation, constraint masking and the
    per-tile conservative dominance screen — and hands the host only
    O(survivors).  It is at once the counterpart of the reference's fused
    float32 sweep (``dtype=torch.float32``) and the plain version of the
    CUDA kernel path (``repro_torch.kernels.ops.dse_sweep``), which computes
    the same thing in one hand-written launch.  ``chip_cols`` needs the
    ``SWEEP_GATHER_FIELDS`` columns; ``wl_cols`` is the packed [W, 6]
    ``WL_COLS`` matrix; inputs are numpy arrays.
    """
    device, dtype = resolve(device, dtype)
    wl_np = np.asarray(wl_cols, np.float64)
    if wl_np.ndim != 2 or wl_np.shape[1] != len(WL_COLS):
        raise ValueError(f"wl_cols must be [W, {len(WL_COLS)}] ({WL_COLS})")
    arrays = {"n_chips": n_chips, "freq_mhz": freq_mhz, "mesh_pod": mesh_pod,
              "mesh_data": mesh_data, "mesh_model": mesh_model,
              "valid": valid}
    arrays.update({k: chip_cols[k] for k in SWEEP_GATHER_FIELDS})
    cand = pack_cand_cols(arrays, dtype).to(device)
    wl_t = torch.as_tensor(wl_np).to(device=device, dtype=dtype)
    cols, wl = split_cols(cand, wl_t)
    e, l, feas = _sweep_rows(cols, wl, sim, max_power_w, max_latency_s,
                             bool(min_hbm_fit))
    return build_sweep_reduced(_screen_rows(e, l, feas) + (e, l, feas),
                               int(max_survivors))
