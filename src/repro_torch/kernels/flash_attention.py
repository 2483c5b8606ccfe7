"""The flash-attention kernel (K3): wrapper, plain version, launch count.

One hand-written CUDA kernel (``csrc/flash_attention.cu``) computes causal or
non-causal softmax attention in the BSHD layout of the reference's
``ops.flash_attention``: ``q`` [B, S, H, hd], ``k`` [B, S, KV, hd], ``v``
[B, S, KV, hv] -> [B, S, H, hv] in ``q.dtype``, with the running max, the
running sum and the float32 accumulator kept on chip; it replaces the
reference's TPU kernel ``_flash_kernel``.  GQA / MQA read the kv head
``h // (H // KV)`` in place (no repeated K / V), and any ``S`` works (the
reference kernel needs ``S`` to be a multiple of its block).  bf16 runs on the
tensor cores, float32 on the CUDA cores; the kernel takes ``hd, hv`` in
``HEAD_DIMS``.

Beside it stands ``flash_attention_plain``: the reference kernel's own
arithmetic (float32 throughout, blockwise online softmax over kv blocks of
128, ``NEG_INF = -1e30``, the denominator clamped at ``1e-30``) in tensor
code, for any head size.  The wrapper takes it ONLY for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises -- there is no
fallback.  ``LAUNCHES`` counts launches per dtype (``"flash_attention_f32"``,
``"flash_attention_bf16"``), incremented exactly where the kernel is
launched.  The library is built and loaded inside the first launching call,
never at import time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

SOURCE = "flash_attention.cu"
NEG_INF = -1e30
BLOCK = 128            # the reference kernel's default q / kv block
HEAD_DIMS = (32, 64, 128)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# launches per dtype since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {f"flash_attention_{s}": 0
                            for s in _SUFFIX.values()}


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
            fn.argtypes = ([vp] * 4 + [ci] * 6
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_float, ci, ci, vp])
            fn.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> Tuple[int, int, int, int, int, int]:
    """Raises on what neither version takes; returns (B, S, H, KV, hd, hv)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, dim]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = (int(d) for d in q.shape)
    kv = int(k.shape[2])
    if tuple(k.shape) != (b, s, kv, hd) or tuple(v.shape[:3]) != (b, s, kv):
        raise ValueError(f"k must be [B, S, KV, hd] and v [B, S, KV, hv] "
                         f"beside q {tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"query heads {h} are not a multiple of kv heads "
                         f"{kv}")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if min(b, s, h, hd, int(v.shape[3])) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    return b, s, h, kv, hd, int(v.shape[3])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the reference kernel's
    arithmetic: q, k, v cast to float32; for each kv block of ``BLOCK`` keys
    in order, ``s = q k^T * scale`` (causal: keys past the query row set to
    ``NEG_INF``), ``m' = max(m, rowmax s)``, ``p = exp(s - m')``, ``l = l *
    exp(m - m') + rowsum p``, ``acc = acc * exp(m - m') + p v``; then ``acc /
    max(l, 1e-30)`` rounded to ``q.dtype`` once.  All query rows take each
    kv block together: for a block the reference kernel skips (entirely
    above the diagonal) every ``p`` is exactly 0 and every correction
    exactly 1, so the update changes nothing.  GQA groups query heads over
    their kv head; K and V are never repeated."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    g = h // kv
    if scale is None:
        scale = hd ** -0.5
    qf = q.float().reshape(b, s, kv, g, hd)
    kf, vf = k.float(), v.float()
    m = torch.full((b, kv, g, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, g, s, hv), dtype=torch.float32,
                      device=q.device)
    q_pos = torch.arange(s, device=q.device)
    block = min(BLOCK, s)
    for k0 in range(0, s, block):
        kj, vj = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf, kj) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kj.shape[1], device=q.device)
            sc = torch.where(k_pos[None, :] <= q_pos[:, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        m = m_new
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vj)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hv).to(q.dtype)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: the last dimension dense and every row
    16-byte aligned (it loads 16 bytes at a time).  A view that is not is
    copied to a contiguous tensor; the model's q, k, v already are."""
    per16 = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:3])):
        return t
    return t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``q`` [B, S, H, hd] over ``k`` [B, S, KV, hd],
    ``v`` [B, S, KV, hv] (H a multiple of KV), causal unless ``causal`` is
    False, scores scaled by ``scale`` (default ``hd ** -0.5``); returns [B,
    S, H, hv] in ``q.dtype`` (float32 or bfloat16, float32 statistics and
    accumulation).  CUDA tensors launch the hand-written kernel, which takes
    ``hd, hv`` in ``HEAD_DIMS``; CPU tensors take the plain version."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if hd not in HEAD_DIMS or hv not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}; got hd "
                         f"{hd}, hv {hv}")
    n_q = -(-s // 64)
    if b * h >= 2 ** 31 or n_q > 65535:
        raise ValueError(f"B*H = {b * h} or S = {s} exceeds the kernel's "
                         "grid")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = torch.empty((b, s, h, hv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(int(st) for t in (q, k, v, o) for st in t.stride()[:3]))
    lib = _library()
    name = f"flash_attention_{_SUFFIX[q.dtype]}"
    code = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, kv,
        hd, hv, strides, float(scale), int(bool(causal)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[name] += 1
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} "
                           f"(cudaError {code})")
    return o
