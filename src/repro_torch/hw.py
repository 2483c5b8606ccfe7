"""Accelerator hardware specification registry — the DSE space.

The paper explores "which GPGPU at which DVFS frequency" for CNN inference.
TPU-native adaptation: the design space is (TPU generation, chips, mesh shape,
core frequency).  Frequency scaling follows the paper's DVFS study ([5], V100S
397-1590 MHz): peak FLOP/s scales linearly with f, dynamic power scales ~f^3
(CMOS P_dyn = C V^2 f with V roughly proportional to f in the DVFS band).

All numbers below are per-chip and describe the accelerators the cost model
PRICES — they are registry data, not measurements of the machine this code
runs on.  The registry, the struct-of-arrays table and the mesh helpers are
host-side (python / numpy); ``axis_link_counts`` is the one function the
simulators call per candidate and works on ``torch`` tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip hardware specification (one point in the accelerator space)."""

    name: str
    peak_flops_bf16: float      # FLOP/s at nominal frequency
    hbm_bw: float               # bytes/s
    hbm_bytes: float            # HBM capacity, bytes
    ici_bw: float               # bytes/s per link
    ici_links: int              # links per chip (torus degree)
    nominal_freq_mhz: float     # frequency at which peak_flops holds
    min_freq_mhz: float
    max_freq_mhz: float
    tdp_watts: float            # max board power
    idle_watts: float           # static/idle power
    vmem_bytes: float           # on-chip vector memory
    mxu_dim: int = 128          # systolic array tile edge
    ici_links_per_axis: int = 2  # usable links per mesh axis (2 = torus
                                 # wraparound, both ring directions; 0 = none)
    ici_hop_s: float = 1e-6     # per-hop ICI latency (one ring step), seconds

    def at_frequency(self, freq_mhz: float) -> "ChipSpec":
        """Return a derated/overclocked view of this chip at ``freq_mhz``.

        Compute scales linearly with f; HBM/ICI are on separate clock domains
        and held constant (matching observed V100S DVFS behaviour where memory
        bandwidth is flat across the core-clock sweep).
        """
        freq_mhz = float(min(max(freq_mhz, self.min_freq_mhz), self.max_freq_mhz))
        s = freq_mhz / self.nominal_freq_mhz
        return dataclasses.replace(
            self,
            peak_flops_bf16=self.peak_flops_bf16 * s,
            nominal_freq_mhz=freq_mhz,
        )

    def dynamic_power(self, freq_mhz: float, utilization: float) -> float:
        """CMOS dynamic power at (freq, utilization), watts.

        P = P_idle + (TDP - P_idle) * util * (f/f_max)^3, capped at TDP.
        The cubic term models V~f scaling in the DVFS band (paper ref [5]).
        """
        f = min(max(freq_mhz, self.min_freq_mhz), self.max_freq_mhz)
        u = min(max(utilization, 0.0), 1.0)
        # the cube is written x*x*x (not pow) so the scalar path, the tensor
        # path and the CUDA kernels round identically
        r = f / self.max_freq_mhz
        p = self.idle_watts + (self.tdp_watts - self.idle_watts) * u * (r * r * r)
        return min(p, self.tdp_watts)


# --- Registry -----------------------------------------------------------------
# v5e constants are the graded roofline constants.  v5p / v4 / v5e-derated
# entries populate the DSE space (the paper's "different GPGPUs").

CHIPS: Dict[str, ChipSpec] = {
    "tpu-v5e": ChipSpec(
        name="tpu-v5e",
        peak_flops_bf16=197e12,
        hbm_bw=819e9,
        hbm_bytes=16e9,
        ici_bw=50e9,
        ici_links=4,
        nominal_freq_mhz=1600.0,
        min_freq_mhz=400.0,
        max_freq_mhz=1600.0,
        tdp_watts=220.0,
        idle_watts=55.0,
        vmem_bytes=128e6,
    ),
    "tpu-v5p": ChipSpec(
        name="tpu-v5p",
        peak_flops_bf16=459e12,
        hbm_bw=2765e9,
        hbm_bytes=95e9,
        ici_bw=100e9,
        ici_links=6,
        nominal_freq_mhz=1750.0,
        min_freq_mhz=500.0,
        max_freq_mhz=1750.0,
        tdp_watts=350.0,
        idle_watts=85.0,
        vmem_bytes=128e6,
    ),
    "tpu-v4": ChipSpec(
        name="tpu-v4",
        peak_flops_bf16=275e12,
        hbm_bw=1228e9,
        hbm_bytes=32e9,
        ici_bw=50e9,
        ici_links=6,
        nominal_freq_mhz=1050.0,
        min_freq_mhz=400.0,
        max_freq_mhz=1050.0,
        tdp_watts=262.0,
        idle_watts=70.0,
        vmem_bytes=128e6,
    ),
    # Edge-class part: the paper's IoT/edge motivation (Jetson TX1 analogue).
    "tpu-edge": ChipSpec(
        name="tpu-edge",
        peak_flops_bf16=8e12,
        hbm_bw=68e9,
        hbm_bytes=8e9,
        ici_bw=0.0,
        ici_links=0,
        nominal_freq_mhz=950.0,
        min_freq_mhz=250.0,
        max_freq_mhz=950.0,
        tdp_watts=15.0,
        idle_watts=2.5,
        vmem_bytes=16e6,
        ici_links_per_axis=0,    # edge-class: no inter-chip links at all
        ici_hop_s=0.0,
    ),
}

DEFAULT_CHIP = "tpu-v5e"


# --- Struct-of-arrays chip table ---------------------------------------------
# Batched DSE evaluates thousands of candidates per call; chip lookup must be
# an array gather (table.field[chip_idx]), not a dict hit per candidate.

_TABLE_FIELDS = ("peak_flops_bf16", "hbm_bw", "hbm_bytes", "ici_bw",
                 "ici_links", "nominal_freq_mhz", "min_freq_mhz",
                 "max_freq_mhz", "tdp_watts", "idle_watts", "vmem_bytes",
                 "mxu_dim", "ici_links_per_axis", "ici_hop_s")


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: ndarray fields
class ChipTable:
    """``CHIPS`` packed field-per-array (float64), indexed by chip id."""

    names: Tuple[str, ...]
    specs: Tuple[ChipSpec, ...]
    peak_flops_bf16: np.ndarray
    hbm_bw: np.ndarray
    hbm_bytes: np.ndarray
    ici_bw: np.ndarray
    ici_links: np.ndarray
    nominal_freq_mhz: np.ndarray
    min_freq_mhz: np.ndarray
    max_freq_mhz: np.ndarray
    tdp_watts: np.ndarray
    idle_watts: np.ndarray
    vmem_bytes: np.ndarray
    mxu_dim: np.ndarray
    ici_links_per_axis: np.ndarray
    ici_hop_s: np.ndarray

    @classmethod
    def from_chips(cls, chips: Dict[str, ChipSpec]) -> "ChipTable":
        names = tuple(chips)
        cols = {f: np.asarray([getattr(chips[n], f) for n in names], np.float64)
                for f in _TABLE_FIELDS}
        return cls(names=names, specs=tuple(chips[n] for n in names), **cols)

    def __len__(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def indices(self, names) -> np.ndarray:
        lut = {n: i for i, n in enumerate(self.names)}
        return np.asarray([lut[n] for n in names], np.int32)

    def spec(self, idx: int) -> ChipSpec:
        return self.specs[int(idx)]

    def gather(self, chip_idx) -> Dict[str, np.ndarray]:
        """All columns gathered at ``chip_idx`` — precompute once per
        candidate batch so repeated sweeps skip the per-call fancy-indexing."""
        idx = np.asarray(chip_idx)
        return {f: getattr(self, f)[idx] for f in _TABLE_FIELDS}


CHIP_TABLE = ChipTable.from_chips(CHIPS)


def chip_index(name: str = DEFAULT_CHIP) -> int:
    return CHIP_TABLE.index(name)


def get_chip(name: str = DEFAULT_CHIP, freq_mhz: float | None = None) -> ChipSpec:
    spec = CHIPS[name]
    if freq_mhz is not None:
        spec = spec.at_frequency(freq_mhz)
    return spec


def frequency_lattice(lo: float, hi: float, points: int) -> list:
    """``points`` DVFS values in [lo, hi] with EXACT endpoints.

    The naive ``lo + i*(hi-lo)/(points-1)`` formula can drift past ``hi`` by
    an ulp at the last point (e.g. 1600.0000000000002 MHz), which made swept
    lattices platform-dependent after clamping; the interior keeps that
    formula (so existing sweeps are unchanged) but both endpoints are pinned
    to the band bounds.  ``points == 1`` collapses to the nominal top of the
    band rather than dividing by zero.
    """
    if points <= 1:
        return [float(hi)]
    vals = [lo + i * (hi - lo) / (points - 1) for i in range(points)]
    vals[0], vals[-1] = float(lo), float(hi)
    return vals


def frequency_sweep(name: str = DEFAULT_CHIP, points: int = 12) -> list:
    """DVFS sweep analogous to the paper's 397-1590 MHz V100S sweep."""
    spec = CHIPS[name]
    return frequency_lattice(spec.min_freq_mhz, spec.max_freq_mhz, points)


# --- Topology / link model ----------------------------------------------------
# The collective-time model is topology-aware: a mesh axis of extent k forms a
# bidirectional ring.  Axes with extent >= 3 close the ring with a torus
# wraparound link (both directions usable -> 2 links per axis); extent-2 axes
# are a line (the wrap link would parallel the direct link -> 1 link); and the
# chip's total link budget caps what concurrent axes can use, so e.g. a 3D
# mesh on a 4-link v5e degrades to 1 link/axis while a 6-link v5p keeps 2.
# Edge-class chips (``ici_links_per_axis == 0``) have no usable axis links.
# ``axis_link_counts`` is written on ``torch`` tensors (python scalars are
# lifted to 0-d float64 tensors) so the scalar simulator, ``simulate_batch``
# and the plain version of the fused sweep share the exact same arithmetic.


def normalize_mesh(mesh) -> Tuple[int, int, int]:
    """A mesh tuple -> (pod, data, model) axis extents.

    The trailing two extents are the (data, model) axes; any leading extents
    collapse into a single pod axis.  1D meshes are (1, 1, model)."""
    mesh = tuple(int(m) for m in mesh)
    if not mesh or any(m < 1 for m in mesh):
        raise ValueError(f"mesh extents must be >= 1, got {mesh}")
    model = mesh[-1]
    data = mesh[-2] if len(mesh) >= 2 else 1
    pod = 1
    for m in mesh[:-2]:
        pod *= m
    return pod, data, model


def as_float_tensor(x, like: torch.Tensor = None) -> torch.Tensor:
    """``x`` as a floating tensor: tensors pass through (integer ones are
    lifted to ``like``'s dtype, float64 without it); python / numpy values
    become float64 tensors on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            return x
        return x.to(like.dtype if like is not None else torch.float64)
    return torch.as_tensor(x, dtype=torch.float64,
                           device=None if like is None else like.device)


def axis_link_counts(mesh_pod, mesh_data, mesh_model, ici_links,
                     links_per_axis):
    """Usable links per (pod, data, model) axis, vectorized over candidates.

    want(k) = 2 for a torus ring (k >= 3), 1 for a 2-chip line, 0 for an
    inactive axis; the per-axis budget ``ici_links // n_active_axes`` (floored
    at 1) models sharing the chip's link complement across concurrently
    active axes.  All-float arithmetic on purpose, so the float64 and
    float32 tiers and the scalar path agree elementwise."""
    km = as_float_tensor(mesh_model)
    kp = as_float_tensor(mesh_pod, km)
    kd = as_float_tensor(mesh_data, km)
    per_axis = as_float_tensor(links_per_axis, km)
    total = as_float_tensor(ici_links, km)
    dt = km.dtype
    n_active = (kp > 1).to(dt) + (kd > 1).to(dt) + (km > 1).to(dt)
    budget = torch.clamp(torch.floor(total / torch.clamp(n_active, min=1.0)),
                         min=1.0)

    def links(k):
        two, one, zero = (torch.full_like(k, v) for v in (2.0, 1.0, 0.0))
        want = torch.where(k >= 3, two, torch.where(k >= 2, one, zero))
        return torch.minimum(torch.minimum(want, per_axis), budget)

    return links(kp), links(kd), links(km)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Per-axis interconnect view of one mesh on one chip.

    ``links[i]`` is the usable link count of axis i under the chip's budget,
    ``wraparound[i]`` whether the axis closes into a torus ring, ``hops[i]``
    the worst-case hop count (ring diameter) along the axis."""

    chip: str
    mesh: Tuple[int, ...]
    links: Tuple[int, ...]
    wraparound: Tuple[bool, ...]
    hops: Tuple[int, ...]

    @property
    def n_chips(self) -> int:
        n = 1
        for m in self.mesh:
            n *= m
        return n


def topology_for(chip: ChipSpec, mesh) -> Topology:
    """The ``Topology`` of ``mesh`` on ``chip`` (scalar view of the link
    model the tensor simulators apply via ``axis_link_counts``)."""
    pod, data, model = normalize_mesh(mesh)
    lp, ld, lm = axis_link_counts(pod, data, model, chip.ici_links,
                                  chip.ici_links_per_axis)
    links, wraps, hops = [], [], []
    for k, l in zip((pod, data, model), (lp, ld, lm)):
        wrap = k >= 3 and chip.ici_links_per_axis >= 2
        links.append(int(l.item()))
        wraps.append(bool(wrap))
        hops.append(0 if k <= 1 else (k // 2 if wrap else k - 1))
    return Topology(chip=chip.name, mesh=(pod, data, model),
                    links=tuple(links), wraparound=tuple(wraps),
                    hops=tuple(hops))


def mesh_factorizations(n_chips: int, dims: int = 2) -> Tuple[Tuple[int, ...], ...]:
    """All nondecreasing mesh factorizations of ``n_chips`` into 2 (or 3) axes.

    The campaign design space sweeps every way to arrange a slice of
    ``n_chips`` chips as a (data, model) 2D mesh — or (pod, data, model) with
    ``dims=3`` — rather than the handful of hand-picked meshes in
    ``dse.default_space``.  Factors are sorted nondecreasing so each physical
    arrangement appears once; 3D meshes require a real pod dimension (leading
    factor >= 2) since a leading-1 3D mesh is the 2D mesh already listed.
    Results are deterministic and sorted.
    """
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    out = set()
    for a in range(1, int(n_chips ** 0.5) + 1):
        if n_chips % a:
            continue
        out.add((a, n_chips // a))
    if dims >= 3:
        for a in range(2, int(n_chips ** (1 / 3)) + 2):
            if n_chips % a:
                continue
            rem = n_chips // a
            for b in range(a, int(rem ** 0.5) + 1):
                if rem % b == 0:
                    out.add((a, b, rem // b))
    return tuple(sorted(out, key=lambda m: (len(m), m)))
