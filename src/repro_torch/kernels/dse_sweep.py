"""The DSE-sweep kernels: wrappers, plain versions, launch plan, launch counts.

Three hand-written CUDA kernels (``csrc/dse_sweep.cu``) carry the campaign's
per-tile work on the card:

* ``sweep_reduce`` — the tile in ONE cluster launch: all workloads x one
  packed candidate tile swept, screened and compacted to the survivors,
  written as one packed buffer (``packed_layout``) that crosses to the host
  in one copy; replaces the reference's TPU kernel ``_sweep_kernel`` and the
  ``jnp`` screen and compaction fused behind it;
* ``dse_sweep`` — the sweep alone, ``[W, N]`` energy / latency / feasible
  rows (census scaling -> roofline/DVFS simulation -> constraint mask);
* ``screen_rows`` — the per-row conservative dominance screen of such rows.

``plan`` picks, by shape alone, how a tile runs: ``fused`` (the cluster
kernel) for every tile whose row slices fit a CTA's shared memory — both
campaign tiles, N 4096 and 65536, in both dtypes — else ``general``
(``dse_sweep``, ``screen_rows``, then the compaction as tensor code).  The
fused variant never writes the ``[W, N]`` rows; the overflow fallback gets
them by launching ``dse_sweep`` for that tile, lazily
(``SweepReduced.rows``).

Beside each kernel stands its plain PyTorch version (``sweep_reduce_plain``,
``dse_sweep_plain``, ``screen_rows_plain`` — thin names over the tensor
code in ``repro_torch.core.costmodel``).  A wrapper takes the plain version
ONLY for tensors that lie on the CPU; for CUDA tensors it launches its
kernel or raises — there is no fallback.  Each wrapper counts its launches
per dtype in ``LAUNCHES`` (``"sweep_reduce_f64"`` ...), incremented exactly
where the kernel is launched.  The CUDA library is built and loaded inside
the first launching call, never at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.costmodel import CAND_COLS, WL_COLS

SOURCE = "dse_sweep.cu"
N_PROBES = len(costmodel._PROBE_WEIGHTS)

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

# launches per (kernel, dtype) since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {f"{k}_{s}": 0
                            for k in ("sweep_reduce", "dse_sweep",
                                      "screen_rows")
                            for s in _SUFFIX.values()}

FUSED = "fused"
GENERAL = "general"
# SMs of an H100 SXM: the plan's default card
H100_SMS = 132
FUSED_THREADS = 512         # threads of a fused CTA: one lane each, ...
FUSED_WIDE_THREADS = 1024   # ... or 1024 once a CTA owns WIDE_LANES lanes
WIDE_LANES = 4096
MAX_CLUSTER = 16            # CTAs of a cluster (above 8: non-portable)
PORTABLE_CLUSTER = 8
# dynamic shared memory a fused CTA may take: the H100's 232,448 bytes a
# block, less room for the kernel's static shared memory
FUSED_SMEM_MAX = 232_448 - 4096
GRID_Y_MAX = 65_535         # workload rows ride gridDim.y
SWEEP_THREADS = 256         # threads of a dse_sweep block


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


class _SweepParams(ctypes.Structure):
    """Mirror of ``struct SweepParams`` in ``csrc/dse_sweep.cu``."""

    _fields_ = [("one_minus_overlap", ctypes.c_double),
                ("w_mxu", ctypes.c_double), ("w_hbm", ctypes.c_double),
                ("w_ici", ctypes.c_double), ("frac_data", ctypes.c_double),
                ("frac_model", ctypes.c_double),
                ("max_power_w", ctypes.c_double),
                ("max_latency_s", ctypes.c_double),
                ("has_max_power", ctypes.c_int),
                ("has_max_latency", ctypes.c_int),
                ("min_hbm_fit", ctypes.c_int)]


class _ScreenParams(ctypes.Structure):
    """Mirror of ``struct ScreenParams``."""

    _fields_ = [("weights", ctypes.c_double * N_PROBES)]


class _FusedParams(ctypes.Structure):
    """Mirror of ``struct FusedParams``."""

    _fields_ = [("sweep", _SweepParams), ("screen", _ScreenParams)]


@functools.lru_cache(maxsize=4)
def _screen_params(dtype: torch.dtype) -> _ScreenParams:
    """The screen's probe weights, rounded to the sweep dtype here as the
    plain version's ``as_tensor(...).to(dtype)`` rounds them."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    wts = costmodel._PROBE_WEIGHTS.astype(np_dt).astype(np.float64)
    return _ScreenParams((ctypes.c_double * N_PROBES)(*wts.tolist()))


@functools.lru_cache(maxsize=256)
def _params(sim: costmodel.SimConfig, max_power_w, max_latency_s,
            min_hbm_fit: bool, dtype: torch.dtype) -> _FusedParams:
    """The kernels' parameter structs, built once per (sim, constraint,
    dtype); ``.sweep`` is ``dse_sweep``'s."""
    sweep = _SweepParams(
        1.0 - sim.overlap, sim.w_mxu, sim.w_hbm, sim.w_ici,
        1.0 - sim.coll_model_frac, sim.coll_model_frac,
        0.0 if max_power_w is None else float(max_power_w),
        0.0 if max_latency_s is None else float(max_latency_s),
        int(max_power_w is not None), int(max_latency_s is not None),
        int(bool(min_hbm_fit)))
    return _FusedParams(sweep, _screen_params(dtype))


# --- the launch plan -----------------------------------------------------------


class Field(NamedTuple):
    """One field of the packed result: where it starts (bytes), its torch
    and numpy dtypes, its shape and its size in bytes."""
    offset: int
    dtype: torch.dtype
    np_dtype: np.dtype
    shape: Tuple[int, ...]
    nbytes: int


_NP_DTYPE = {torch.float64: np.dtype(np.float64),
             torch.float32: np.dtype(np.float32),
             torch.int64: np.dtype(np.int64)}


def packed_layout(w: int, k: int, dtype: torch.dtype
                  ) -> Tuple[Dict[str, Field], int]:
    """The packed result buffer of one fused tile: name -> ``Field``, in
    this order — the four [W] aggregates, then [W, K] lane indices,
    energies and latencies — and its size in bytes.  Every field starts on
    a multiple of its item size."""
    specs = (("n_survivors", torch.int64, (w,)),
             ("n_feasible", torch.int64, (w,)),
             ("ref_energy", dtype, (w,)), ("ref_latency", dtype, (w,)),
             ("surv_idx", torch.int64, (w, k)),
             ("surv_energy", dtype, (w, k)),
             ("surv_latency", dtype, (w, k)))
    layout, at = {}, 0
    for name, dt, shape in specs:
        np_dt = _NP_DTYPE[dt]
        assert at % np_dt.itemsize == 0, (name, at)
        size = np_dt.itemsize * math.prod(shape)
        layout[name] = Field(at, dt, np_dt, shape, size)
        at += size
    return layout, at


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one tile of W workload rows x N lanes runs.  ``fused``: a grid of
    ``grid`` = (C, W) CTAs in clusters of ``clusters`` = C, each owning
    ``lanes`` lanes of a row with ``threads`` threads and ``smem_bytes`` of
    dynamic shared memory.  ``general``: ``dse_sweep`` on ``grid`` blocks of
    ``SWEEP_THREADS``, ``screen_rows`` on W blocks, then the compaction as
    tensor code (``clusters``, ``lanes``, ``smem_bytes`` 0).  ``k`` =
    min(``max_survivors``, N) is the survivor slots a row, ``layout`` /
    ``nbytes`` the packed result (``packed_layout``).  Plans are cached:
    read them, do not change them."""
    variant: str
    w: int
    n: int
    max_survivors: int
    k: int
    clusters: int
    lanes: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int]
    blocks_per_sm: float
    layout: Dict[str, Field]
    nbytes: int

    @property
    def portable(self) -> bool:
        """Whether the cluster size is within the portable limit (8)."""
        return self.clusters <= PORTABLE_CLUSTER


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fused_smem(lanes: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a fused CTA owning ``lanes`` lanes: energy
    and latency in ``dtype`` and a flag byte each, rounded up to 16 (the
    kernel's ``fused_smem``)."""
    size = 8 if dtype == torch.float64 else 4
    return _cdiv(lanes * (2 * size + 1), 16) * 16


@functools.lru_cache(maxsize=1024)
def plan(w: int, n: int, dtype: torch.dtype, max_survivors: int,
         sms: int = H100_SMS) -> Plan:
    """The launch plan of one tile of ``w`` workload rows x ``n`` lanes in
    ``dtype`` keeping ``max_survivors`` survivors a row, on a card of
    ``sms`` SMs.  A pure function of its arguments: builds and loads
    nothing.  The cluster takes C = the power of two that gives each of
    512 CTA threads about one lane, at most 16; a CTA that owns 4096 lanes
    or more takes 1024 threads (at N=65536, W=6 on an H100 at 700 W: 0.0425
    against 0.0449 device ms in float64, 0.0313 against 0.0365 in float32).
    A tile whose slices then need more shared memory than a CTA has (N past
    ~215k in float64, ~406k in float32) is ``general``."""
    if dtype not in _SUFFIX:
        raise TypeError(f"no K1 variant for {dtype}")
    if w < 1 or n < 1:
        raise ValueError(f"empty sweep: W={w}, N={n}")
    if w > GRID_Y_MAX:
        raise ValueError(f"W={w} exceeds the kernels' grid limit "
                         f"({GRID_Y_MAX})")
    if max_survivors < 0:
        raise ValueError(f"max_survivors must be >= 0, got {max_survivors}")
    max_survivors = int(max_survivors)
    k = min(max_survivors, n)
    layout, nbytes = packed_layout(w, k, dtype)
    c = min(MAX_CLUSTER, 1 << (_cdiv(n, FUSED_THREADS) - 1).bit_length())
    lanes = _cdiv(_cdiv(n, c), 32) * 32
    smem = fused_smem(lanes, dtype)
    if smem > FUSED_SMEM_MAX or n >= 2 ** 31 - 1:
        grid = (_cdiv(n, SWEEP_THREADS), w)
        return Plan(GENERAL, w, n, max_survivors, k, 0, 0, SWEEP_THREADS, 0,
                    grid, grid[0] * w / sms, layout, nbytes)
    threads = FUSED_WIDE_THREADS if lanes >= WIDE_LANES \
        else min(FUSED_THREADS, lanes)
    return Plan(FUSED, w, n, max_survivors, k, c, lanes, threads, smem,
                (c, w), c * w / sms, layout, nbytes)


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n


def plan_for(cand_cols: torch.Tensor, wl_cols: torch.Tensor,
             max_survivors: int) -> Plan:
    """``plan`` for these tensors, with the SM count of their card
    (``H100_SMS`` off the card)."""
    w, n = int(wl_cols.shape[0]), int(cand_cols.shape[1])
    sms = (_sm_count(cand_cols.device) if cand_cols.device.type == "cuda"
           else H100_SMS)
    return plan(w, n, cand_cols.dtype, int(max_survivors), sms)


_bound = None


def _library():
    """The loaded kernel library with ``argtypes`` set (pointers and the
    stream as ``c_void_p``, extents as ``c_int64`` — without them ctypes
    would pass 32-bit ints and cut the pointers)."""
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("dse_sweep_f64", "dse_sweep_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                           ctypes.POINTER(_SweepParams), ci, vp]
            fn.restype = ci
        for name in ("screen_rows_f64", "screen_rows_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 8 + [i64, i64,
                                      ctypes.POINTER(_ScreenParams), ci, vp]
            fn.restype = ci
        for name in ("sweep_reduce_f64", "sweep_reduce_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 9 + [i64, i64, i64, ci, ci, ci, i64,
                                      ctypes.POINTER(_FusedParams), ci, vp]
            fn.restype = ci
        lib.sweep_reduce_max_clusters.argtypes = [
            ci, i64, i64, ci, ci, ci, i64, ci, ctypes.POINTER(ci)]
        lib.sweep_reduce_max_clusters.restype = ci
        lib.dse_error_string.argtypes = [ci]
        lib.dse_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.dse_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: {msg} "
                           f"(cudaError {code})")


def _require(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --- K1: the sweep -------------------------------------------------------------


def _validate_tile(cand_cols: torch.Tensor, wl_cols: torch.Tensor
                   ) -> Tuple[int, int]:
    """Raises on a tile neither version takes; returns (W, N)."""
    if cand_cols.dim() != 2 or cand_cols.shape[0] != len(CAND_COLS):
        raise ValueError(f"cand_cols must be [{len(CAND_COLS)}, N] "
                         f"({CAND_COLS}), got {tuple(cand_cols.shape)}")
    dtype, device = cand_cols.dtype, cand_cols.device
    if dtype not in _SUFFIX:
        raise TypeError(f"cand_cols: expected float64 or float32, got {dtype}")
    n = int(cand_cols.shape[1])
    if wl_cols.dim() != 2:
        raise ValueError(f"wl_cols must be [W, {len(WL_COLS)}]")
    w = int(wl_cols.shape[0])
    _require(cand_cols, "cand_cols", dtype, device)
    _require(wl_cols, "wl_cols", dtype, device, (w, len(WL_COLS)))
    if n < 1 or w < 1:
        raise ValueError(f"empty sweep: W={w}, N={n}")
    return w, n


def dse_sweep_plain(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
                    sim: costmodel.SimConfig = costmodel.SimConfig(),
                    max_power_w: Optional[float] = None,
                    max_latency_s: Optional[float] = None,
                    min_hbm_fit: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep kernel: ``scale_census`` +
    ``simulate_batch`` + ``sweep_feasibility`` on broadcast
    ``[W, 1] x [1, N]`` tensors.  Returns (energy, latency, feasible) as
    ``[W, N]`` (feasible is ``torch.bool``)."""
    cols, wl = costmodel.split_cols(cand_cols, wl_cols)
    return costmodel._sweep_rows(cols, wl, sim, max_power_w, max_latency_s,
                                 bool(min_hbm_fit))


def dse_sweep(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
              sim: costmodel.SimConfig = costmodel.SimConfig(),
              max_power_w: Optional[float] = None,
              max_latency_s: Optional[float] = None,
              min_hbm_fit: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(energy, latency, feasible) ``[W, N]`` of all workload rows of
    ``wl_cols`` ``[W, len(WL_COLS)]`` against the packed candidate tile
    ``cand_cols`` ``[len(CAND_COLS), N]`` (float64 or float32, contiguous,
    same device).  CUDA tensors launch the hand-written kernel; CPU tensors
    take the plain version."""
    w, n = _validate_tile(cand_cols, wl_cols)
    dtype, device = cand_cols.dtype, cand_cols.device
    if device.type == "cpu":
        return dse_sweep_plain(cand_cols, wl_cols, sim=sim,
                               max_power_w=max_power_w,
                               max_latency_s=max_latency_s,
                               min_hbm_fit=min_hbm_fit)
    if w > GRID_Y_MAX:
        raise ValueError(f"W={w} exceeds the kernel's grid limit "
                         f"({GRID_Y_MAX})")
    lib = _library()
    energy = torch.empty((w, n), dtype=dtype, device=device)
    latency = torch.empty((w, n), dtype=dtype, device=device)
    feasible = torch.empty((w, n), dtype=torch.bool, device=device)
    params = _params(sim, max_power_w, max_latency_s, bool(min_hbm_fit),
                     dtype)
    name = f"dse_sweep_{_SUFFIX[dtype]}"
    code = getattr(lib, name)(
        cand_cols.data_ptr(), wl_cols.data_ptr(), energy.data_ptr(),
        latency.data_ptr(), feasible.data_ptr(), w, n,
        ctypes.byref(params.sweep), device.index, _stream(device))
    LAUNCHES[name] += 1
    _check(lib, code, name)
    return energy, latency, feasible


# --- K1a: the screen -----------------------------------------------------------


def screen_rows_plain(energy: torch.Tensor, latency: torch.Tensor,
                      feasible: torch.Tensor):
    """Plain PyTorch version of the screen kernel (``costmodel._screen_rows``):
    (keep, n_surv, n_feas, ref_e, ref_l)."""
    return costmodel._screen_rows(energy, latency, feasible)


def screen_rows(energy: torch.Tensor, latency: torch.Tensor,
                feasible: torch.Tensor):
    """Per-row conservative dominance screen of ``[W, N]`` sweep rows:
    (keep ``[W, N]`` bool, n_surv ``[W]`` int64, n_feas ``[W]`` int64,
    ref_e ``[W]``, ref_l ``[W]``), ``ref_*`` being the feasible maxima
    (``-inf`` for a row without a feasible lane).  CUDA tensors launch the
    hand-written kernel; CPU tensors take the plain version."""
    dtype, device = energy.dtype, energy.device
    if dtype not in _SUFFIX:
        raise TypeError(f"energy: expected float64 or float32, got {dtype}")
    if energy.dim() != 2:
        raise ValueError("energy must be [W, N]")
    w, n = (int(s) for s in energy.shape)
    _require(energy, "energy", dtype, device)
    _require(latency, "latency", dtype, device, (w, n))
    _require(feasible, "feasible", torch.bool, device, (w, n))
    if n < 1 or w < 1:
        raise ValueError(f"empty screen: W={w}, N={n}")
    if device.type == "cpu":
        return screen_rows_plain(energy, latency, feasible)
    lib = _library()
    keep = torch.empty((w, n), dtype=torch.bool, device=device)
    n_surv = torch.empty((w,), dtype=torch.int64, device=device)
    n_feas = torch.empty((w,), dtype=torch.int64, device=device)
    ref_e = torch.empty((w,), dtype=dtype, device=device)
    ref_l = torch.empty((w,), dtype=dtype, device=device)
    name = f"screen_rows_{_SUFFIX[dtype]}"
    code = getattr(lib, name)(
        energy.data_ptr(), latency.data_ptr(), feasible.data_ptr(),
        keep.data_ptr(), n_surv.data_ptr(), n_feas.data_ptr(),
        ref_e.data_ptr(), ref_l.data_ptr(), w, n,
        ctypes.byref(_screen_params(dtype)), device.index, _stream(device))
    LAUNCHES[name] += 1
    _check(lib, code, name)
    return keep, n_surv, n_feas, ref_e, ref_l


# --- the fused tile: sweep, screen and compaction in one launch ---------------


def pack(values: Dict[str, torch.Tensor], p: Plan,
         device: torch.device) -> torch.Tensor:
    """``values`` (``packed_layout``'s names, tensors of its shapes) written
    into one uint8 buffer of ``p.nbytes`` on ``device``, as the fused
    kernel writes it."""
    buf = torch.empty(p.nbytes, dtype=torch.uint8, device=device)
    for name, f in p.layout.items():
        buf[f.offset:f.offset + f.nbytes].view(f.dtype).view(f.shape).copy_(
            values[name])
    return buf


def unpack(buf: np.ndarray, p: Plan,
           rows: Callable[[], Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]
           ) -> costmodel.SweepReduced:
    """The ``SweepReduced`` of a packed host buffer (uint8 numpy): its
    fields are views into ``buf``, valid as long as ``buf`` is not
    rewritten."""
    out = {name: buf[f.offset:f.offset + f.nbytes].view(f.np_dtype)
           .reshape(f.shape) for name, f in p.layout.items()}
    return costmodel.SweepReduced(max_survivors=p.max_survivors, rows=rows,
                                  **out)


def sweep_reduce_plain(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
                       sim: costmodel.SimConfig = costmodel.SimConfig(),
                       max_power_w: Optional[float] = None,
                       max_latency_s: Optional[float] = None,
                       min_hbm_fit: bool = True,
                       max_survivors: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: the sweep's, the screen's
    and the compaction's plain versions in turn, packed as the kernel packs
    its result (``packed_layout``), on the inputs' device."""
    w, n = _validate_tile(cand_cols, wl_cols)
    p = plan(w, n, cand_cols.dtype, int(max_survivors))
    e, l, f = dse_sweep_plain(cand_cols, wl_cols, sim=sim,
                              max_power_w=max_power_w,
                              max_latency_s=max_latency_s,
                              min_hbm_fit=min_hbm_fit)
    keep, n_surv, n_feas, ref_e, ref_l = screen_rows_plain(e, l, f)
    idx, se, sl = costmodel._compact_rows_device(keep, e, l, p.k)
    return pack({"n_survivors": n_surv, "n_feasible": n_feas,
                 "ref_energy": ref_e, "ref_latency": ref_l, "surv_idx": idx,
                 "surv_energy": se, "surv_latency": sl}, p, cand_cols.device)


def _launch_fused(cand_cols: torch.Tensor, wl_cols: torch.Tensor, p: Plan,
                  params: _FusedParams) -> torch.Tensor:
    """One launch of the fused kernel planned as ``p``; returns its packed
    result on the device (not synchronised)."""
    dtype, device = cand_cols.dtype, cand_cols.device
    lib = _library()
    out = torch.empty(p.nbytes, dtype=torch.uint8, device=device)
    base = out.data_ptr()
    ptr = {name: base + f.offset for name, f in p.layout.items()}
    name = f"sweep_reduce_{_SUFFIX[dtype]}"
    code = getattr(lib, name)(
        cand_cols.data_ptr(), wl_cols.data_ptr(), ptr["n_survivors"],
        ptr["n_feasible"], ptr["ref_energy"], ptr["ref_latency"],
        ptr["surv_idx"], ptr["surv_energy"], ptr["surv_latency"], p.w, p.n,
        p.k, p.clusters, p.lanes, p.threads, p.smem_bytes,
        ctypes.byref(params), device.index, _stream(device))
    LAUNCHES[name] += 1
    _check(lib, code, name)
    return out


def sweep_reduce_packed(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
                        sim: costmodel.SimConfig = costmodel.SimConfig(),
                        max_power_w: Optional[float] = None,
                        max_latency_s: Optional[float] = None,
                        min_hbm_fit: bool = True,
                        max_survivors: int = 2048) -> torch.Tensor:
    """The packed result (``packed_layout``) of one tile, on the inputs'
    device: CUDA tensors launch the fused kernel (a tile that ``plan``
    routes to ``general`` raises), CPU tensors take the plain version."""
    w, n = _validate_tile(cand_cols, wl_cols)
    kw = dict(sim=sim, max_power_w=max_power_w, max_latency_s=max_latency_s,
              min_hbm_fit=min_hbm_fit)
    if cand_cols.device.type == "cpu":
        return sweep_reduce_plain(cand_cols, wl_cols, **kw,
                                  max_survivors=max_survivors)
    p = plan_for(cand_cols, wl_cols, max_survivors)
    if p.variant != FUSED:
        raise ValueError(f"W={w}, N={n} {cand_cols.dtype} is planned "
                         f"{p.variant!r}, not {FUSED!r}")
    return _launch_fused(cand_cols, wl_cols, p,
                         _params(sim, max_power_w, max_latency_s,
                                 bool(min_hbm_fit), cand_cols.dtype))


class ResultBuffer:
    """A pinned host buffer the fused tile's packed result is copied into,
    reused from call to call (grown when a plan needs more).  The
    ``SweepReduced`` of a call holds views into it, valid until the next
    call that uses the same buffer."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf[:nbytes]


def sweep_reduce(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
                 sim: costmodel.SimConfig = costmodel.SimConfig(),
                 max_power_w: Optional[float] = None,
                 max_latency_s: Optional[float] = None,
                 min_hbm_fit: bool = True, max_survivors: int = 2048,
                 host_buffer: Optional[ResultBuffer] = None
                 ) -> costmodel.SweepReduced:
    """One tile, all workload rows, reduced to each row's screen survivors
    and the frontier-accounting aggregates, on the host.

    CUDA tensors: as ``plan`` says.  ``fused``: one launch, one
    ``non_blocking`` copy of the packed result into ``host_buffer`` (a
    fresh pinned buffer if None) and one synchronisation; the full rows
    are not kept, and ``rows`` launches ``dse_sweep`` for them if the
    overflow fallback asks.  ``general``: ``dse_sweep``, ``screen_rows``,
    the compaction as tensor code.  CPU tensors: the plain version, the
    rows again recomputed only if asked."""
    w, n = _validate_tile(cand_cols, wl_cols)
    kw = dict(sim=sim, max_power_w=max_power_w, max_latency_s=max_latency_s,
              min_hbm_fit=min_hbm_fit)
    rows = functools.partial(dse_sweep, cand_cols, wl_cols, **kw)
    p = plan_for(cand_cols, wl_cols, max_survivors)
    device = cand_cols.device
    if device.type == "cpu":
        packed = sweep_reduce_plain(cand_cols, wl_cols, **kw,
                                    max_survivors=max_survivors)
        return unpack(packed.numpy(), p, rows)
    if p.variant == GENERAL:
        e, l, f = dse_sweep(cand_cols, wl_cols, **kw)
        return costmodel.build_sweep_reduced(
            screen_rows(e, l, f) + (e, l, f), p.max_survivors)
    out = _launch_fused(cand_cols, wl_cols, p,
                        _params(sim, max_power_w, max_latency_s,
                                bool(min_hbm_fit), cand_cols.dtype))
    host = (host_buffer or ResultBuffer()).take(p.nbytes)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return unpack(host.numpy(), p, rows)


def max_active_clusters(p: Plan, dtype: torch.dtype,
                        device: torch.device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the fused kernel launched as
    ``p`` on ``device`` (builds and loads the library)."""
    if p.variant != FUSED:
        raise ValueError(f"plan is {p.variant!r}, not {FUSED!r}")
    lib = _library()
    out = ctypes.c_int(0)
    code = lib.sweep_reduce_max_clusters(
        int(dtype == torch.float64), p.w, p.n, p.clusters, p.lanes,
        p.threads, p.smem_bytes, device.index, ctypes.byref(out))
    _check(lib, code, "sweep_reduce_max_clusters")
    return out.value
