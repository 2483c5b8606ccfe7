"""The fused DSE-sweep kernels: wrappers, plain versions, launch counts.

Two hand-written CUDA kernels (``csrc/dse_sweep.cu``) carry the campaign's
per-tile work on the card:

* ``dse_sweep`` — all workloads x one packed candidate tile, elementwise
  (census scaling -> roofline/DVFS simulation -> constraint mask); replaces
  the reference's TPU kernel ``_sweep_kernel``;
* ``screen_rows`` — the per-row conservative dominance screen that reduces
  the ``[W, N]`` rows to survivors; replaces the ``jnp`` screen the reference
  fuses behind its kernel.

Beside each stands its plain PyTorch version (``dse_sweep_plain``,
``screen_rows_plain`` — thin names over the tensor code in
``repro_torch.core.costmodel``).  A wrapper takes the plain version ONLY for
tensors that lie on the CPU; for CUDA tensors it launches its kernel or
raises — there is no fallback.  Each wrapper counts its launches per dtype
in ``LAUNCHES`` (``"dse_sweep_f64"`` ...), incremented exactly where the
kernel is launched.  The CUDA library is built and loaded inside the first
launching call, never at import time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.costmodel import CAND_COLS, WL_COLS

SOURCE = "dse_sweep.cu"
N_PROBES = len(costmodel._PROBE_WEIGHTS)

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

# launches per (kernel, dtype) since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {f"{k}_{s}": 0
                            for k in ("dse_sweep", "screen_rows")
                            for s in _SUFFIX.values()}


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
    if device.type == "cpu":
        return dse_sweep_plain(cand_cols, wl_cols, sim=sim,
                               max_power_w=max_power_w,
                               max_latency_s=max_latency_s,
                               min_hbm_fit=min_hbm_fit)
    if w > 65535:
        raise ValueError(f"W={w} exceeds the kernel's grid limit (65535)")
    lib = _library()
    energy = torch.empty((w, n), dtype=dtype, device=device)
    latency = torch.empty((w, n), dtype=dtype, device=device)
    feasible = torch.empty((w, n), dtype=torch.bool, device=device)
    params = _SweepParams(
        1.0 - sim.overlap, sim.w_mxu, sim.w_hbm, sim.w_ici,
        1.0 - sim.coll_model_frac, sim.coll_model_frac,
        0.0 if max_power_w is None else float(max_power_w),
        0.0 if max_latency_s is None else float(max_latency_s),
        int(max_power_w is not None), int(max_latency_s is not None),
        int(bool(min_hbm_fit)))
    name = f"dse_sweep_{_SUFFIX[dtype]}"
    code = getattr(lib, name)(
        cand_cols.data_ptr(), wl_cols.data_ptr(), energy.data_ptr(),
        latency.data_ptr(), feasible.data_ptr(), w, n, ctypes.byref(params),
        device.index, _stream(device))
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
    # probe weights rounded to the sweep dtype on the host, as the plain
    # version's ``as_tensor(...).to(dtype)`` rounds them
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    wts = costmodel._PROBE_WEIGHTS.astype(np_dt).astype(np.float64)
    params = _ScreenParams((ctypes.c_double * N_PROBES)(*wts.tolist()))
    name = f"screen_rows_{_SUFFIX[dtype]}"
    code = getattr(lib, name)(
        energy.data_ptr(), latency.data_ptr(), feasible.data_ptr(),
        keep.data_ptr(), n_surv.data_ptr(), n_feas.data_ptr(),
        ref_e.data_ptr(), ref_l.data_ptr(), w, n, ctypes.byref(params),
        device.index, _stream(device))
    LAUNCHES[name] += 1
    _check(lib, code, name)
    return keep, n_surv, n_feas, ref_e, ref_l
