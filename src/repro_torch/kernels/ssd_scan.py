"""The SSD chunk-scan kernel (K4): wrapper, plain version, launch count.

One hand-written CUDA source (``csrc/ssd_scan.cu``) computes the Mamba2 SSD
scan of the reference's ``ops.ssd_scan`` for ``ngroups == 1``: ``x`` [b, S,
nh, hp], ``dt`` [b, S, nh] (float32), ``A`` [nh] (float32), ``B``, ``C`` [b,
S, 1, ds] -> ``y`` [b, S, nh, hp] and the final state [b, nh, hp, ds]
(float32); it replaces the reference's TPU kernel ``_ssd_kernel``.  The
sequence is cut into chunks of ``Q = min(chunk, S)`` steps (``S % Q == 0``,
as the reference asserts).  One call runs three ``__global__`` functions --
per-chunk states, the sequential pass over chunks, the outputs per 64-row
tile of a chunk -- and counts as one launch.  ``x``, ``B`` and ``C`` are
float32 or bfloat16 (one type for the three), read in place through their
strides (``B`` and ``C`` may be column slices of one tensor, as in the
model); all arithmetic is float32; ``y`` is written in ``out_dtype``
(default ``x.dtype``, as the reference kernel returns).  Unlike the
reference kernel it also returns the final state, which the model's
prefill keeps for decoding.

Beside it stands ``ssd_scan_plain``: the reference kernel's arithmetic in
float32 tensor code, a loop over chunks vectorised over (b, h).  The
wrapper takes it ONLY for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises -- there is no fallback.  ``LAUNCHES`` counts
launches per input dtype (``"ssd_scan_f32"``, ``"ssd_scan_bf16"``),
incremented exactly where the kernel is launched.  The library is built and
loaded inside the first launching call, never at import time.

Both versions accumulate ``cumsum(dt * A)`` in float64 and round it to
float32 once per element, so that they take the decay exponents from the
same float values (torch's CPU cumsum of float32 already accumulates in
float64; its CUDA cumsum scans in float32 in another order).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

SOURCE = "ssd_scan.cu"

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# launches per input dtype since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {f"ssd_scan_{s}": 0 for s in _SUFFIX.values()}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_bound = None


def _library():
    """The loaded kernel library with ``argtypes`` set (pointers and the
    stream as ``c_void_p``: without them ctypes would pass 32-bit ints and
    cut the pointers)."""
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in LAUNCHES:
            fn = getattr(lib, name)
            fn.argtypes = ([vp] * 9 + [ci] * 6
                           + [ctypes.POINTER(ctypes.c_longlong), ci, ci, vp])
            fn.restype = ci
        lib.ssd_scan_error_string.argtypes = [ci]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_launch_shape.argtypes = [ci] * 6 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_launch_shape.restype = None
        _bound = lib
    return _bound


def launch_shape(b: int, s: int, nh: int, hp: int, ds: int, q: int
                 ) -> Dict[str, object]:
    """The grids and dynamic shared memory of the three launches of one
    call at these sizes, as the kernel library computes them (builds and
    loads it)."""
    out = (ctypes.c_int * 14)()
    _library().ssd_scan_launch_shape(b, s, nh, hp, ds, q, out)
    v = list(out)
    grids = {name: v[3 * i: 3 * i + 3] for i, name in enumerate(
        ("chunk_state", "state_pass", "output"))}
    return {"grids": grids, "smem_chunk_state": v[9], "smem_output": v[10],
            "threads_per_block": v[11], "max_smem": v[12], "tile": v[13]}


def _validate(x, dt, A, B, C, chunk: int
              ) -> Tuple[int, int, int, int, int, int]:
    """Raises on what neither version takes; returns (b, S, nh, hp, ds, Q)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError(f"expected x [b, S, nh, hp], dt [b, S, nh], A [nh], "
                         f"B, C [b, S, ngroups, ds]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, nh, hp = (int(d) for d in x.shape)
    ng, ds = int(B.shape[2]), int(B.shape[3])
    if ng != 1 or int(C.shape[2]) != 1:
        raise ValueError(f"the SSD scan kernel takes ngroups == 1 (B, C "
                         f"shared by all heads); got ngroups {ng}")
    if (tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,)
            or tuple(B.shape[:2]) != (b, s) or tuple(C.shape) != tuple(
                B.shape)):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if min(b, s, nh, hp, ds) < 1 or chunk < 1:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, ds {ds}, chunk "
                         f"{chunk}")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    if x.dtype not in _SUFFIX or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must all be float32 or bfloat16; got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("x, dt, A, B, C must lie on one device")
    return b, s, nh, hp, ds, q


def _out_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]
               ) -> torch.dtype:
    out = x.dtype if out_dtype is None else out_dtype
    if out not in _SUFFIX:
        raise TypeError(f"out_dtype must be float32 or bfloat16; got {out}")
    return out


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the reference kernel's
    arithmetic in float32: for each chunk in order, ``cum = cumsum(dt A)``,
    ``L = exp(cum_i - cum_j)`` below the diagonal (0 above it, where the
    exponent is set to -inf before ``exp``), ``y = (C B^T * L) @ (x dt) +
    (C exp(cum)) @ state^T`` and ``state = state exp(cum[-1]) + ((x dt)
    exp(cum[-1] - cum))^T @ B``; all (b, h) together.  Returns ``(y`` in
    ``out_dtype`` (default ``x.dtype``), the final state [b, nh, hp, ds]
    float32``)``."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    out = _out_dtype(x, out_dtype)
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B[:, :, 0].float(), C[:, :, 0].float()
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, nh, hp, ds), dtype=torch.float32,
                        device=x.device)
    y = torch.empty((b, s, nh, hp), dtype=torch.float32, device=x.device)
    for t0 in range(0, s, q):
        xc = xf[:, t0:t0 + q].transpose(1, 2)           # [b, nh, Q, hp]
        dtc = dtf[:, t0:t0 + q].transpose(1, 2)         # [b, nh, Q]
        Bc, Cc = Bf[:, None, t0:t0 + q], Cf[:, None, t0:t0 + q]  # [b,1,Q,ds]
        cum = torch.cumsum((dtc * A[:, None]).double(), dim=-1).float()
        diff = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(diff.masked_fill(~tril, float("-inf")))
        xdt = xc * dtc[..., None]
        CB = Cc @ Bc.transpose(-1, -2)                  # [b, 1, Q, Q]
        y_diag = (CB * L) @ xdt
        decay_in = torch.exp(cum)
        y_off = (Cc * decay_in[..., None]) @ state.transpose(-1, -2)
        y[:, t0:t0 + q] = (y_diag + y_off).transpose(1, 2)
        decay_end = torch.exp(cum[..., -1:] - cum)
        contrib = (xdt * decay_end[..., None]).transpose(-1, -2) @ Bc
        state = state * torch.exp(cum[..., -1])[..., None, None] + contrib
    return y.to(out), state


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dimension dense, as the kernel reads it; a view
    whose last stride is not 1 is copied.  The model's x and the column
    slices B, C of its conv output are read in place."""
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``x`` [b, S, nh, hp] with ``dt`` [b, S, nh], ``A``
    [nh], ``B``, ``C`` [b, S, 1, ds] in chunks of ``min(chunk, S)``; returns
    ``(y`` [b, S, nh, hp] in ``out_dtype`` (default ``x.dtype``), the final
    state [b, nh, hp, ds] float32``)``.  CUDA tensors launch the hand-written
    kernel; CPU tensors take the plain version."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    out = _out_dtype(x, out_dtype)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk, out_dtype=out)
    nc = s // q
    x, B, C = (_kernel_operand(t) for t in (x, B, C))
    dev = x.device
    y = torch.empty((b, s, nh, hp), dtype=out, device=dev)
    final = torch.empty((b, nh, hp, ds), dtype=torch.float32, device=dev)
    states = torch.empty((b, nh, nc, hp, ds), dtype=torch.float32,
                         device=dev)
    cum = torch.empty((b, nh, nc, q), dtype=torch.float32, device=dev)
    A = A.contiguous()
    strides = (ctypes.c_longlong * 10)(
        *(int(st) for st in (*x.stride()[:3], *dt.stride(), *B.stride()[:2],
                             *C.stride()[:2])))
    lib = _library()
    name = f"ssd_scan_{_SUFFIX[x.dtype]}"
    code = getattr(lib, name)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), final.data_ptr(), states.data_ptr(),
        cum.data_ptr(), b, s, nh, hp, ds, q, strides,
        int(out == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1
    if code != 0:
        msg = lib.ssd_scan_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} "
                           f"(cudaError {code}) at b {b}, S {s}, nh {nh}, "
                           f"hp {hp}, ds {ds}, Q {q}")
    return y, final
