"""The stride-1 convolution kernel (K2): wrapper, plain version, launch count.

One hand-written CUDA kernel (``csrc/conv2d.cu``) computes the stride-1
convolution NHWC x HWIO -> NHWC as an implicit GEMM, reading bf16 or
float32, accumulating in float32 and rounding the output to the input dtype
once; it replaces the reference's TPU kernel ``_conv_kernel``.  Padding is a
bounds check inside the kernel, and any ``H_out`` works: the TPU kernel's
row tile (``tile_h``, which had to divide ``H_out``) is gone.

Beside it stands ``conv2d_plain``: the reference kernel's own arithmetic, a
float32 sum of ``kh*kw`` shifted-window matmuls.  The wrapper takes it ONLY
for tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises -- there is no fallback.  ``LAUNCHES`` counts launches per dtype
(``"conv2d_f32"``, ``"conv2d_bf16"``), incremented exactly where the kernel
is launched.  The library is built and loaded inside the first launching
call, never at import time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

SOURCE = "conv2d.cu"

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
NO_PADDING: Padding = ((0, 0), (0, 0))

# launches per dtype since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {f"conv2d_{s}": 0 for s in _SUFFIX.values()}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_bound = None


def _library():
    """The loaded kernel library with ``argtypes`` set (pointers and the
    stream as ``c_void_p`` -- without them ctypes would pass 32-bit ints and
    cut the pointers)."""
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in LAUNCHES:
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp] + [ci] * 12 + [vp]
            fn.restype = ci
        lib.conv2d_error_string.argtypes = [ci]
        lib.conv2d_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _validate(x: torch.Tensor, w: torch.Tensor, padding: Padding
              ) -> Tuple[int, int]:
    """Raises on what the kernel does not take; returns (H_out, W_out)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin] and w [kh, kw, Cin, "
                         f"Cout]; got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"Cin differs: x has {x.shape[3]}, w has "
                         f"{w.shape[2]}")
    if x.dtype not in _SUFFIX or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if min(p for pair in padding for p in pair) < 0:
        raise ValueError(f"negative padding {padding}")
    (pt, pb), (pl, pr) = padding
    ho = x.shape[1] + pt + pb - w.shape[0] + 1
    wo = x.shape[2] + pl + pr - w.shape[1] + 1
    if ho < 1 or wo < 1 or min(x.shape) < 1 or min(w.shape) < 1:
        raise ValueError(f"empty convolution: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, padding {padding}")
    return ho, wo


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, *,
                 padding: Padding = NO_PADDING) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the reference kernel's
    arithmetic: zero-pad, then add ``kh*kw`` shifted-window float32 matmuls
    ``[B*H_out*W_out, Cin] x [Cin, Cout]`` in tap order, and round the sum to
    ``x.dtype`` once."""
    ho, wo = _validate(x, w, padding)
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    wf = w.float()
    b, cin, cout = x.shape[0], x.shape[3], w.shape[3]
    acc = torch.zeros((b * ho * wo, cout), dtype=torch.float32,
                      device=x.device)
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            win = xp[:, i:i + ho, j:j + wo, :].reshape(b * ho * wo, cin)
            acc = acc + win @ wf[i, j]
    return acc.reshape(b, ho, wo, cout).to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           padding: Padding = NO_PADDING) -> torch.Tensor:
    """Stride-1 VALID convolution of ``x`` [B, H, W, Cin] zero-padded by
    ``padding`` = ((top, bottom), (left, right)) with ``w`` [kh, kw, Cin,
    Cout]; returns [B, H_out, W_out, Cout] in ``x.dtype`` (float32 or
    bfloat16, float32 accumulation).  CUDA tensors launch the hand-written
    kernel; CPU tensors take the plain version."""
    ho, wo = _validate(x, w, padding)
    if x.device.type == "cpu":
        return conv2d_plain(x, w, padding=padding)
    b, h, wd, cin = (int(s) for s in x.shape)
    kh, kw, _, cout = (int(s) for s in w.shape)
    if b * ho * wo >= 2 ** 31:
        raise ValueError(f"B*H_out*W_out = {b * ho * wo} exceeds the "
                         "kernel's int range")
    lib = _library()
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    name = f"conv2d_{_SUFFIX[x.dtype]}"
    code = getattr(lib, name)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin, cout, kh,
        kw, int(padding[0][0]), int(padding[1][0]), ho, wo, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES[name] += 1
    if code != 0:
        msg = lib.conv2d_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} "
                           f"(cudaError {code})")
    return y
