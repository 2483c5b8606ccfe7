"""The flash-attention kernel (K3): launch plan, wrapper, plain version,
launch counts.

Hand-written CUDA kernels (``csrc/flash_attention.cu``) compute causal or
non-causal softmax attention in the BSHD layout of the reference's
``ops.flash_attention``: ``q`` [B, S, H, hd], ``k`` [B, S, KV, hd], ``v``
[B, S, KV, hv] -> [B, S, H, hv] in ``q.dtype``, with the running max, the
running sum and the float32 accumulator kept on chip; they replace the
reference's TPU kernel ``_flash_kernel``.  GQA / MQA read the kv head
``h // (H // KV)`` in place (no repeated K / V), and any ``S`` works (the
reference kernel needs ``S`` to be a multiple of its block).  The kernels
take ``hd, hv`` in ``HEAD_DIMS``.

Three variants, chosen by shape before any launch (``plan``), each counted
under its own key of ``LAUNCHES``:

* ``flash_attention_bf16_tc`` -- bf16 with ``hd == hv`` in ``TC_HEAD_DIMS``
  (every model shape): ``wgmma`` tensor cores fed by TMA, a loader warp and
  two consumer warpgroups over 128-row blocks.
* ``flash_attention_bf16_mma`` -- any other bf16 shape (hd or hv 32,
  ``hv != hd``): ``mma.sync`` tensor cores, 64-row blocks.
* ``flash_attention_f32`` -- float32 on the CUDA cores in IEEE float32.

Beside them stands ``flash_attention_plain``: the reference kernel's own
arithmetic (float32 throughout, blockwise online softmax over kv blocks of
128, ``NEG_INF = -1e30``, the denominator clamped at ``1e-30``) in tensor
code, for any head size.  The wrapper takes it ONLY for tensors that lie on
the CPU; for CUDA tensors it launches a kernel or raises -- there is no
fallback.  The library is built and loaded inside the first launching call,
never at import time.

Training goes through ``flash_attention_trainable``, a
``torch.autograd.Function``.  Its forward is ``flash_attention_fwd``: the
same kernels (``hd == hv`` in ``BWD_HEAD_DIMS``) built with a flag that
also writes the row log-sum-exp of the scaled scores, float32 [B, H, S],
counted under the forward variant's key.  Its backward is
``flash_attention_bwd``: the kernels of ``csrc/flash_attention_bwd.cu``
(``plan_bwd`` picks ``flash_attention_bwd_bf16``, ``wgmma`` tensor cores fed
by TMA in persistent grids that walk the plan's schedule, or
``flash_attention_bwd_f32``, every product as 3xTF32 on ``mma.sync``
tensor cores; one call launches a dQ kernel that
also writes D = rowsum(dO * O) and then a dK / dV kernel, counted once),
with no float atomics, so two runs are bitwise equal.  Beside it
stands ``flash_attention_bwd_plain``, the backward written out step by step
in float32 from the saved log-sum-exp, which CPU tensors take.  The
reference defines no backward for its TPU kernel: it trains through its XLA
attention (``models/layers.py`` ``flash_attention``), which the tests
differentiate with ``jax.vjp``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import Dict, List, Optional, Tuple

import torch

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
NEG_INF = -1e30
BLOCK = 128            # the reference kernel's default q / kv block
HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)
# head dims of the training path on the card (hd == hv), both dtypes
BWD_HEAD_DIMS = TC_HEAD_DIMS
DTYPES = (torch.float32, torch.bfloat16)

TC = "flash_attention_bf16_tc"
MMA = "flash_attention_bf16_mma"
F32 = "flash_attention_f32"
FWD_VARIANTS = (TC, MMA, F32)
BWD_BF16 = "flash_attention_bwd_bf16"
BWD_F32 = "flash_attention_bwd_f32"
BWD_VARIANTS = (BWD_BF16, BWD_F32)

# launches per variant since the last ``reset_launch_counts`` (a forward
# that also writes the log-sum-exp counts under its forward variant)
LAUNCHES: Dict[str, int] = {k: 0 for k in FWD_VARIANTS + BWD_VARIANTS}

# SMs of an H100 SXM: the plan's default card
H100_SMS = 132


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K3 call runs: the variant (its ``LAUNCHES`` key), the query
    rows of a tile ``block_q``, the keys of a kv tile ``block_k``, and the
    launch grid: (``B * H``, q-blocks), one block a tile, or for the
    tensor-core variant (blocks, 1), one persistent block an SM that walks
    the tiles.  Tiles run q-block by q-block over every head, the heaviest
    q-block first under causal."""
    variant: str
    block_q: int
    block_k: int
    grid: Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(b: int, s: int, h: int, kv: int, hd: int, hv: int,
         dtype: torch.dtype, sms: int = H100_SMS) -> Plan:
    """The launch plan of attention over q [b, s, h, hd], k [b, s, kv, hd],
    v [b, s, kv, hv] in ``dtype`` on a card of ``sms`` SMs, for operands
    the kernels read in place (``kernel_ready``; the wrapper copies any
    other first).  A pure function of its arguments.

    bf16 takes the ``wgmma`` variant where ``hd == hv`` in ``TC_HEAD_DIMS``,
    else the ``mma.sync`` variant; float32 takes the CUDA-core variant."""
    if dtype == torch.bfloat16 and hd == hv and hd in TC_HEAD_DIMS:
        variant, bq, bk = TC, 128, 128
    elif dtype == torch.bfloat16:
        variant, bq, bk = MMA, 64, 64
    elif dtype == torch.float32:
        variant, bq, bk = F32, 64, 64
    else:
        raise TypeError(f"no K3 variant for {dtype}")
    grid = (b * h, _cdiv(s, bq))
    if variant == TC:
        grid = (min(grid[0] * grid[1], sms), 1)
    return Plan(variant, bq, bk, grid)


_bound = None
_bwd_bound = None


def _library():
    """The loaded kernel library with ``argtypes`` set (pointers and the
    stream as ``c_void_p`` -- without them ctypes would pass 32-bit ints and
    cut the pointers)."""
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        tail = ([ci] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                            ctypes.c_float, ci] + [ci] * 4 + [ci, vp])
        for name in FWD_VARIANTS:
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 4 + tail
            fn.restype = ci
        for name in (TC, F32):               # the forwards with the LSE
            fn = getattr(lib, name + "_lse")
            fn.argtypes = [vp] * 5 + tail
            fn.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _bwd_library():
    """The loaded backward library with ``argtypes`` set."""
    global _bwd_bound
    if _bwd_bound is None:
        from repro_torch.kernels import build
        lib = build.load(BWD_SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        shape = [ci] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                            ctypes.c_float, ci] + [ci] * 4
        # ..., scratch, [schedule,] dq, dk, dv, shape, strides, scale,
        # causal, the plan (tiles, stages, grids), parts, device, stream
        lib.flash_attention_bwd_bf16.argtypes = \
            [vp] * 11 + shape + [ci] * 4 + [ci, ci, vp]
        lib.flash_attention_bwd_f32.argtypes = \
            [vp] * 10 + shape + [ci] * 4 + [ci, ci, vp]
        for name in BWD_VARIANTS:
            getattr(lib, name).restype = ci
        lib.flash_attention_bwd_error_string.argtypes = [ci]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_bound = lib
    return _bwd_bound


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
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    return _plain_forward(q, k, v, causal, scale)[0]


def _plain_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, scale: Optional[float]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_plain``'s output and the row log-sum-exp of the
    scaled scores, ``m + log(max(l, 1e-30))``, float32 [B, H, S]."""
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
    den = torch.clamp_min(l, 1e-30)
    o = acc / den[..., None]
    lse = (m + torch.log(den)).reshape(b, h, s)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hv).to(q.dtype), lse


def flash_attention_bwd_plain(do: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of the backward kernels, written out step by
    step in float32 from the forward's output ``o`` and log-sum-exp ``lse``
    [B, H, S]: D = rowsum(dO * O); P = exp(scale q k^T - lse) (0 above the
    diagonal when causal); dV = P^T dO; dP = dO V^T; dS = P * (dP - D) *
    scale; dQ = dS K; dK = dS^T Q.  GQA sums dK and dV over each group's
    heads.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    g = h // kv
    if scale is None:
        scale = hd ** -0.5
    qf = q.float().reshape(b, s, kv, g, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, s, kv, g, hv)
    dd = (dof * o.float().reshape(b, s, kv, g, hv)).sum(dim=-1)
    dd = dd.permute(0, 2, 3, 1)                             # [b, kv, g, s]
    sc = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    p = torch.exp(sc - lse.float().reshape(b, kv, g, s)[..., None])
    if causal:
        pos = torch.arange(s, device=q.device)
        p = torch.where(pos[None, :] <= pos[:, None], p, 0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - dd[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, hd)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_ready(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` in place: the last dimension dense,
    the base and every other stride on whole 16 bytes (TMA's and 16-byte
    ``cp.async``'s rule).  The model's q, k, v are."""
    per16 = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:3]))


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: itself where ``kernel_ready``, else a
    copy in fresh contiguous memory (``contiguous()`` would hand back a
    dense view whose base lies off 16 bytes as it is)."""
    return t if kernel_ready(t) else t.clone(
        memory_format=torch.contiguous_format)


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """``plan`` for these tensors, with the SM count of their card
    (``H100_SMS`` off the card)."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    sms = _sm_count(q.device) if q.device.type == "cuda" else H100_SMS
    return plan(b, s, h, kv, hd, hv, q.dtype, sms)


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``q`` [B, S, H, hd] over ``k`` [B, S, KV, hd],
    ``v`` [B, S, KV, hv] (H a multiple of KV), causal unless ``causal`` is
    False, scores scaled by ``scale`` (default ``hd ** -0.5``); returns [B,
    S, H, hv] in ``q.dtype`` (float32 or bfloat16, float32 statistics and
    accumulation).  CUDA tensors launch the variant that ``plan`` picks
    (``hd, hv`` in ``HEAD_DIMS``); CPU tensors take the plain version."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if hd not in HEAD_DIMS or hv not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}; got hd "
                         f"{hd}, hv {hv}")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    p = plan_for(q, k, v)
    gx, gy = p.grid
    if gx >= 2 ** 31 or gy > 65535:
        raise ValueError(f"B*H = {b * h} or S = {s} exceeds the kernel's "
                         "grid")
    o = torch.empty((b, s, h, hv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(int(st) for t in (q, k, v, o) for st in t.stride()[:3]))
    lib = _library()
    code = getattr(lib, p.variant)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, kv,
        hd, hv, strides, float(scale), int(bool(causal)), p.block_q,
        p.block_k, gx, gy, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[p.variant] += 1
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {p.variant} ({p}) failed: {msg} "
                           f"(cudaError {code})")
    return o


def _check_train_shape(hd: int, hv: int) -> None:
    if hd != hv or hd not in BWD_HEAD_DIMS:
        raise ValueError(f"the training kernels take hd == hv in "
                         f"{BWD_HEAD_DIMS}; got hd {hd}, hv {hv}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and the row log-sum-exp of the scaled
    scores, float32 [B, H, S] (what the backward needs).  CUDA tensors
    launch ``plan``'s variant built to write the LSE (``hd == hv`` in
    ``BWD_HEAD_DIMS``; the tensor-core variant in bf16, the CUDA-core one in
    float32); CPU tensors take the plain version."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal, scale)
    _check_train_shape(hd, hv)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    p = plan_for(q, k, v)
    o = torch.empty((b, s, h, hv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(int(st) for t in (q, k, v, o) for st in t.stride()[:3]))
    lib = _library()
    gx, gy = p.grid
    code = getattr(lib, p.variant + "_lse")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, kv, hd, hv, strides, float(scale),
        int(bool(causal)), p.block_q, p.block_k, gx, gy, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[p.variant] += 1
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {p.variant}_lse ({p}) failed: "
                           f"{msg} (cudaError {code})")
    return o, lse


# the bf16 backward's tiles: the dQ kernel's items are BWD_ROWS query rows
# of one (b, head) and walk the keys ``_dq_step(hd)`` at a time; the dK /
# dV kernel's items are BWD_ROWS keys of one (b, kv head) and walk the
# group's query rows BWD_STEP at a time.  The float32 kernels' items are
# F32_BWD_ROWS rows or keys, and each walks ``_f32_step(hd)`` keys or rows
# at a time through a ring of F32_BWD_STAGES slots.
BWD_ROWS, BWD_STEP, F32_BWD_ROWS, F32_BWD_STAGES = 128, 64, 64, 2
# which kernels a backward launch runs (the C entry points' ``parts``)
BWD_DQ, BWD_DKDV, BWD_BOTH = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call runs: the variant (its ``LAUNCHES`` key); the
    dQ kernel owns ``q_rows`` query rows of one (b, head) at a time and
    walks the visible keys ``kv_step`` at a time; the dK / dV kernel owns
    ``kv_rows`` keys of one (b, kv head) and walks the group's heads and
    their visible query rows ``q_step`` at a time.  ``stages``: the ring
    slots of the two kernels' streamed tiles; ``smem``: the dynamic shared
    memory of a block of each.

    bf16: each kernel is persistent, ``grid_*`` = (blocks, 1), and block
    ``c`` works through the items ``schedule_*[c]`` in order -- dQ items
    ``(b * H + h) * nq + q_block``, dK / dV items ``(b * KV + kv_head) * nq
    + key_block`` with ``nq = ceil(S / q_rows)``.  float32: one block an
    item, ``grid_*`` = (items, 1), no schedule: block ``i`` takes q-block
    or key block ``i // (B H)`` (the dQ kernel's reversed under causal, so
    the heaviest items come first) of head ``b H + h = i % (B H)``; with
    GQA the dK / dV items write float32 partials per head, which a last
    kernel sums by group in head order."""
    variant: str
    q_rows: int
    kv_rows: int
    q_step: int
    kv_step: int
    stages: Tuple[int, int]
    grid_dq: Tuple[int, int]
    grid_dkdv: Tuple[int, int]
    smem: Tuple[int, int]
    schedule_dq: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        default=(), repr=False)
    schedule_dkdv: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        default=(), repr=False)


def _bwd_stages(hd: int) -> int:
    """Ring slots of both bf16 kernels (the 227 KB budget decides at 128)."""
    return 4 if hd == 64 else 3


def _dq_step(hd: int) -> int:
    """Keys of the bf16 dQ kernel's kv tile: 128 at hd 64, 64 at hd 128
    (where dQ's accumulator takes 64 registers a thread)."""
    return 128 if hd == 64 else 64


def _bwd_smem(hd: int, stages: int) -> Tuple[int, int]:
    """Dynamic shared memory of a bf16 block, as ``flash_attention_bwd.cu``
    lays it out: 1 KiB to align the base to the swizzle's period; dQ: two
    item slots of Q and dO, ``stages`` slots of K and V tiles, 4 + 4 stages
    mbarriers; dK / dV: two item slots of K and V, ``stages`` slots of Q,
    dO and their 64 lse2 and D floats, 4 + 2 stages mbarriers."""
    boxes = hd // 64                         # 64-column boxes of a row
    big, step = BWD_ROWS * 128, BWD_STEP * 128   # bytes of a box
    dq = 1024 + 4 * boxes * big + stages * 2 * boxes * _dq_step(hd) * 128 \
        + (4 + 4 * stages) * 8
    dkdv = 1024 + 4 * boxes * big \
        + stages * (2 * boxes * step + 2 * BWD_STEP * 4) + (4 + 2 * stages) * 8
    return dq, dkdv


def _f32_step(hd: int) -> int:
    """Keys (dQ) or query rows (dK / dV) of a float32 kernel's streamed
    tile: 32 at hd 64, 16 at hd 128, so that two blocks of each kernel fit
    an SM and ptxas needs no spill."""
    return 32 if hd == 64 else 16


def _f32_bwd_smem(hd: int) -> Tuple[int, int]:
    """Dynamic shared memory of a float32 block, as
    ``flash_attention_bwd.cu`` lays it out in rows of hd + 4 floats: dQ:
    the item's Q and dO, ``F32_BWD_STAGES`` slots of K and V tiles; dK /
    dV: the item's K and V, P^T handed between the warps of a pair
    ([64][step + 8]), ``F32_BWD_STAGES`` slots of Q and dO tiles and their
    lse and D."""
    ld, r, st = hd + 4, F32_BWD_ROWS, _f32_step(hd)
    dq = (2 * r + F32_BWD_STAGES * 2 * st) * ld * 4
    dkdv = (2 * r * ld + r * (st + 8)
            + F32_BWD_STAGES * 2 * st * (ld + 1)) * 4
    return dq, dkdv


def bwd_item_work(b: int, s: int, h: int, kv: int, causal: bool
                  ) -> Tuple[List[int], List[int]]:
    """The work of each bf16 item, in ``BWD_STEP``-wide tiles it walks plus
    one for its set-up (loads, D, the epilogue): dQ item ``(b * H + h) *
    nq + qb`` walks the keys up to its rows' last (all of them when not
    causal), in kv tiles of ``_dq_step`` keys; dK / dV item ``(b * KV +
    kvh) * nq + kb`` walks, for each of the G heads, the q tiles of
    ``BWD_STEP`` rows from the first that sees its keys.  The work does not
    depend on the head size: ``_dq_step(64)`` tiles count as two."""
    nq, nstep = _cdiv(s, BWD_ROWS), _cdiv(s, BWD_STEP)
    per_block = BWD_ROWS // BWD_STEP
    dq = [_cdiv(min((qb + 1) * BWD_ROWS, s) if causal else s, BWD_STEP) + 1
          for qb in range(nq)]
    dkdv = [(h // kv) * (nstep - (kb * per_block if causal else 0)) + 1
            for kb in range(nq)]
    return dq * (b * h), dkdv * (b * kv)


def _lpt(work: List[int], blocks: int) -> Tuple[Tuple[int, ...], ...]:
    """Longest processing time first: the items in order of decreasing work
    (ties by index), each to the block with the least work so far (ties by
    block index).  Every block's list is heaviest first."""
    order = sorted(range(len(work)), key=lambda i: (-work[i], i))
    heap = [(0, c) for c in range(blocks)]
    lists: List[List[int]] = [[] for _ in range(blocks)]
    for i in order:
        load, c = heapq.heappop(heap)
        lists[c].append(i)
        heapq.heappush(heap, (load + work[i], c))
    return tuple(tuple(x) for x in lists)


@functools.lru_cache(maxsize=4096)
def plan_bwd(b: int, s: int, h: int, kv: int, hd: int, dtype: torch.dtype,
             causal: bool = True, sms: int = H100_SMS) -> BwdPlan:
    """The backward's plan for q [b, s, h, hd], k, v [b, s, kv, hd] in
    ``dtype`` on a card of ``sms`` SMs (a pure function of its arguments).
    bf16 on ``wgmma``: items of 128 rows or keys, the dQ kernel stepping
    ``_dq_step`` keys at a time and the dK / dV kernel 64 query rows,
    ``_bwd_stages`` ring slots, each kernel a persistent grid of at most
    one block an SM whose schedule ``_lpt`` makes from ``bwd_item_work``;
    float32 as 3xTF32 on ``mma.sync``: items of 64 rows or keys, one block
    an item, heaviest first, each stepping ``_f32_step`` rows or keys
    through ``F32_BWD_STAGES`` ring slots; with GQA a last kernel sums
    the dK / dV pass's per-head partials."""
    _check_train_shape(hd, hd)
    if dtype == torch.bfloat16:
        work_dq, work_dkdv = bwd_item_work(b, s, h, kv, causal)
        ctas_dq, ctas_dkdv = min(len(work_dq), sms), min(len(work_dkdv), sms)
        st = _bwd_stages(hd)
        return BwdPlan(BWD_BF16, BWD_ROWS, BWD_ROWS, BWD_STEP, _dq_step(hd),
                       (st, st), (ctas_dq, 1), (ctas_dkdv, 1),
                       _bwd_smem(hd, st), _lpt(work_dq, ctas_dq),
                       _lpt(work_dkdv, ctas_dkdv))
    if dtype == torch.float32:
        r, st = F32_BWD_ROWS, _f32_step(hd)
        items = b * h * _cdiv(s, r)
        return BwdPlan(BWD_F32, r, r, st, st,
                       (F32_BWD_STAGES, F32_BWD_STAGES), (items, 1),
                       (items, 1), _f32_bwd_smem(hd))
    raise TypeError(f"no K3 backward variant for {dtype}")


def schedule_words(p: BwdPlan) -> List[int]:
    """The bf16 kernels' schedule as they read it (int32): for the dQ
    kernel, then the dK / dV kernel, ``blocks + 1`` offsets and then the
    items, block ``c`` taking items ``[offsets[c], offsets[c + 1])``."""
    out: List[int] = []
    for sched in (p.schedule_dq, p.schedule_dkdv):
        offsets = [0]
        for items in sched:
            offsets.append(offsets[-1] + len(items))
        out += offsets + [i for items in sched for i in items]
    return out


# each bf16 plan's schedule on each card, made once
_SCHEDULES: Dict[Tuple[int, int], Tuple[BwdPlan, torch.Tensor]] = {}


def _schedule_tensor(p: BwdPlan, device: torch.device) -> torch.Tensor:
    key = (id(p), device.index)
    hit = _SCHEDULES.get(key)
    if hit is None or hit[0] is not p:
        t = torch.tensor(schedule_words(p), dtype=torch.int32).to(device)
        hit = _SCHEDULES[key] = (p, t)
    return hit[1]


def flash_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention's output ``o`` = attention(q, k,
    v) given its gradient ``do`` and the forward's log-sum-exp ``lse``
    [B, H, S].  CUDA tensors launch ``plan_bwd``'s variant (``hd == hv`` in
    ``BWD_HEAD_DIMS``) or raise; CPU tensors take
    ``flash_attention_bwd_plain``."""
    b, s, h, kv, hd, hv = _validate(q, k, v)
    if scale is None:
        scale = hd ** -0.5
    if tuple(o.shape) != (b, s, h, hv) or tuple(do.shape) != (b, s, h, hv) \
            or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must be [B, S, H, hv] in {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, S] = {(b, h, s)}; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal,
                                         scale=scale)
    _check_train_shape(hd, hv)
    return bwd_launch(do, q, k, v, o, lse, causal, scale, BWD_BOTH)[:3]


def bwd_launch(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
               causal: bool, scale: float, parts: int,
               scratch: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """The kernels of ``flash_attention_bwd`` on CUDA tensors it accepts:
    ``parts`` ``BWD_DQ`` (the dQ kernel, which also writes the scratch),
    ``BWD_DKDV`` (the dK / dV kernel, which reads it) or ``BWD_BOTH``;
    returns (dq, dk, dv, scratch), the outputs a part did not launch
    unwritten.  One call counts once.  To time the dK / dV kernel alone,
    pass back the scratch of a ``BWD_BOTH`` call on the same inputs."""
    b, s, h, kv, hd, _ = _validate(q, k, v)
    p = plan_bwd(b, s, h, kv, hd, q.dtype, bool(causal), _sm_count(q.device))
    if max(p.grid_dq[0], p.grid_dkdv[0]) >= 2 ** 31:
        raise ValueError(f"B = {b}, H = {h}, S = {s} exceed the backward "
                         "kernels' grid")
    q, k, v, o, do = (_kernel_operand(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    bf16 = p.variant == BWD_BF16
    if scratch is None:
        # bf16: lse2, D [B H, S padded]; float32: D [B, H, S], after the
        # per-head dK, dV partials [2, B, S, H, hd] with GQA
        shape = (2, b * h, _cdiv(s, BWD_ROWS) * BWD_ROWS) if bf16 \
            else ((h > kv) * 2 * b * s * h * hd + b * h * s,)
        scratch = torch.empty(shape, dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kv, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(int(st) for t in (q, k, v, o, do, dq, dk, dv)
          for st in t.stride()[:3]))
    lib = _bwd_library()
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr()]
    if bf16:
        head.append(_schedule_tensor(p, q.device).data_ptr())
    tail = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, kv, hd,
            strides, float(scale), int(bool(causal)), p.q_rows, p.kv_rows,
            p.q_step, p.kv_step, p.stages[0], p.stages[1], p.grid_dq[0],
            p.grid_dkdv[0]]
    code = getattr(lib, p.variant)(
        *head, *tail, int(parts), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[p.variant] += 1
    if code != 0:
        msg = lib.flash_attention_bwd_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {p.variant} ({p}) failed: {msg} "
                           f"(cudaError {code})")
    return dq, dk, dv, scratch


class FlashAttention(torch.autograd.Function):
    """K3 with its backward: ``flash_attention_fwd`` saves q, k, v, o and
    the log-sum-exp; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(do, q, k, v, o, lse,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` that autograd differentiates (``FlashAttention``)."""
    if scale is None:
        scale = int(q.shape[-1]) ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))
