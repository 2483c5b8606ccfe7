"""The flash-attention kernel (K3): launch plan, wrapper, plain version,
launch counts.

Hand-written CUDA kernels (``csrc/flash_attention.cu``) compute causal or
non-causal softmax attention in the BSHD layout of the reference's
``ops.flash_attention``: ``q`` [B, S, H, hd], ``k`` [B, Sk, KV, hd], ``v``
[B, Sk, KV, hv] -> [B, S, H, hv] in ``q.dtype``, with the running max, the
running sum and the float32 accumulator kept on chip; they replace the
reference's TPU kernel ``_flash_kernel``.  GQA / MQA read the kv head
``h // (H // KV)`` in place (no repeated K / V), and any ``S`` works (the
reference kernel needs ``S`` to be a multiple of its block).  The keys may
be longer or shorter than the queries (``Sk != S``: cross attention, a
decoder's queries over an encoder's frames) when the call is not causal;
causal attention takes ``Sk == S`` (the reference defines no alignment
for it) and raises otherwise.  A causal call may open a bidirectional
prefix (``prefix_len`` P > 0, PaliGemma's image patches, the reference's
``layers._block_mask``): query row ``i`` sees key ``j`` where ``j <= i`` or
``j < P``; ``P >= S`` is full attention.  The kernels take ``hd, hv`` in
``HEAD_DIMS``, 256 only with ``hd == hv``, and the pairs of
``RECT_PAIRS``: (192, 128), deepseek's MLA prefill (q / k of 128 nope and
64 rope columns, v of 128).

Three variants, chosen by shape before any launch (``plan``), each counted
under its own key of ``LAUNCHES``:

* ``flash_attention_bf16_tc`` -- bf16 with ``hd == hv`` in ``TC_HEAD_DIMS``
  or ``(hd, hv)`` in ``RECT_PAIRS`` (every model shape, paligemma's 256 and
  deepseek's (192, 128) included): ``wgmma`` tensor cores fed by TMA, a
  loader warp and two consumer warpgroups over 128-row blocks, kv tiles of
  ``_tc_bn(hd)`` keys.
* ``flash_attention_bf16_mma`` -- any other bf16 shape (hd or hv 32,
  ``hv != hd``): ``mma.sync`` tensor cores, 64-row blocks.
* ``flash_attention_f32`` -- float32: at ``(hd, hv)`` in ``F32_TC_PAIRS``
  (deepseek's (192, 128) and paligemma's hd = hv = 256) every product as
  3xTF32 on ``wgmma`` tensor cores fed by TMA (the C entry point
  ``F32_TC_ENTRY``; a pre-pass splits the operands into TF32 hi and lo in
  a float32 scratch, v transposed), one consumer warpgroup over 64-row
  tiles in a persistent grid; every other shape on the CUDA cores in IEEE
  float32.

Beside them stands ``flash_attention_plain``: the reference kernel's own
arithmetic (float32 throughout, blockwise online softmax over kv blocks of
128, ``NEG_INF = -1e30``, the denominator clamped at ``1e-30``) in tensor
code, for any head size.  The wrapper takes it ONLY for tensors that lie on
the CPU; for CUDA tensors it launches a kernel or raises -- there is no
fallback.  The library is built and loaded inside the first launching call,
never at import time.  Tensors on the meta device (the workload census,
``core.census.analyze_step``) take a shape-only route: the plan's variant,
empty meta outputs, nothing launched or counted in ``LAUNCHES``.  Under an
active census each call books its entry (``fwd_work`` / ``bwd_work``)
through ``census.kernel_call``.

Training goes through ``flash_attention_trainable``, a
``torch.autograd.Function``.  Its forward is ``flash_attention_fwd``: the
``LSE_VARIANTS`` kernels (``hd == hv`` in ``BWD_HEAD_DIMS``, or a pair of
``RECT_PAIRS``) built with a flag that also writes the row log-sum-exp of the scaled scores, float32
[B, H, S], counted under the forward variant's key.  Its backward is
``flash_attention_bwd``: the kernels of ``csrc/flash_attention_bwd.cu``
(``plan_bwd`` picks ``flash_attention_bwd_bf16``, ``wgmma`` tensor cores fed
by TMA in persistent grids that walk the plan's schedule -- at head dim
256 and at (192, 128) the dK / dV kernel splits dK and dV over its two
consumer warpgroups and, with GQA (at 256), writes per-head partials a last
kernel sums --, or ``flash_attention_bwd_f32``, every product as 3xTF32 on
``mma.sync`` tensor cores at head dims 64 and 128 and on ``wgmma`` at
``F32_TC_PAIRS``; one call launches a dQ kernel that
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

from repro_torch.core import census

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
NEG_INF = -1e30
BLOCK = 128            # the reference kernel's default q / kv block
HEAD_DIMS = (32, 64, 128, 256)
# head dims the forward kernels take only with hd == hv
SQUARE_HEAD_DIMS = (256,)
TC_HEAD_DIMS = (64, 128, 256)
# (hd, hv) pairs with hd != hv outside HEAD_DIMS that every kernel takes,
# forward (the wgmma variant in bf16) and backward: deepseek's MLA, H == KV
RECT_PAIRS = ((192, 128),)
# head dims of the training path on the card (hd == hv), both dtypes; and
# RECT_PAIRS
BWD_HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

TC = "flash_attention_bf16_tc"
MMA = "flash_attention_bf16_mma"
F32 = "flash_attention_f32"
FWD_VARIANTS = (TC, MMA, F32)
# the forward variants with an ``_lse`` entry point (the training path's)
LSE_VARIANTS = (TC, F32)
BWD_BF16 = "flash_attention_bwd_bf16"
BWD_F32 = "flash_attention_bwd_f32"
BWD_VARIANTS = (BWD_BF16, BWD_F32)

# launches per variant since the last ``reset_launch_counts`` (a forward
# that also writes the log-sum-exp counts under its forward variant)
LAUNCHES: Dict[str, int] = {k: 0 for k in FWD_VARIANTS + BWD_VARIANTS}
# the (hd, hv) pairs float32 runs as 3xTF32 on wgmma, forward and backward:
# deepseek's MLA (H == KV) and paligemma's head dim 256 (GQA too)
F32_TC_PAIRS = ((192, 128), (256, 256))
# the C entry point (and, with ``_lse``, its LSE twin) of the float32
# variant at ``F32_TC_PAIRS``: 3xTF32 on wgmma, counted under F32
F32_TC_ENTRY = "flash_attention_f32_tc"
# float32 wgmma kernels: query rows of a tile and keys of a kv tile (the
# backward's items and streamed tiles too); their rings' slots of
# F32_TC_SLOT_BYTES (a chunk: 64 rows x 64 columns, or a chunk of V^T, TF32
# hi and lo), ``f32_tc_slots`` of them
F32_TC_ROWS, F32_TC_SLOT_BYTES = 64, 32768
# the backward's C entry point at ``F32_TC_PAIRS`` in float32: 3xTF32 on
# wgmma, counted under BWD_F32
BWD_F32_TC_ENTRY = "flash_attention_bwd_f32_tc"

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
    q-block first under causal.  ``entry``: the C entry point where it is
    not the variant's own (the float32 ``wgmma`` kernel, ``F32_TC_ENTRY``)."""
    variant: str
    block_q: int
    block_k: int
    grid: Tuple[int, int]
    entry: Optional[str] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pairs(s: int, causal: bool, sk: Optional[int] = None,
           prefix: int = 0) -> int:
    """(query, key) pairs attention computes over ``s`` queries and ``sk``
    keys (default ``s``): S(S+1)/2 causal (``sk == s``), plus P(P-1)/2 for
    a bidirectional prefix of P = min(``prefix``, S) keys (the pairs above
    the diagonal that it opens); S Sk not causal."""
    sk = s if sk is None else sk
    _check_lengths(s, sk, causal, prefix)
    if causal:
        p = min(prefix, s)
        return s * (s + 1) // 2 + p * (p - 1) // 2
    return s * sk


def _check_lengths(s: int, sk: int, causal: bool, prefix: int = 0) -> None:
    if causal and sk != s:
        raise ValueError(f"causal attention needs as many keys as queries; "
                         f"got {s} queries, {sk} keys (the reference defines "
                         f"no alignment for a causal mask between lengths)")
    if prefix < 0 or (prefix and not causal):
        raise ValueError(f"a bidirectional prefix (prefix_len {prefix}) "
                         f"opens a causal mask: it needs causal attention "
                         f"and prefix_len >= 0")


def fwd_work(b: int, s: int, h: int, kv: int, hd: int, hv: int,
             causal: bool, dtype: torch.dtype, lse: bool = False,
             sk: Optional[int] = None, prefix: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one forward call over ``s`` queries and ``sk``
    keys (default ``s``) with a bidirectional prefix of ``prefix`` keys, as
    the census books it: the two products, (2 hd + 2 hv) B H pairs
    (``_pairs``), whatever the tiling; q, k, v read and o (and the float32
    log-sum-exp) written once -- never the score blocks."""
    sk = s if sk is None else sk
    el = dtype.itemsize
    nbytes = el * b * (s * (h * hd + h * hv) + sk * (kv * hd + kv * hv))
    if lse:
        nbytes += 4 * b * h * s
    return (2 * hd + 2 * hv) * b * h * _pairs(s, causal, sk, prefix), nbytes


def bwd_work(b: int, s: int, h: int, kv: int, hd: int, hv: int,
             causal: bool, dtype: torch.dtype, sk: Optional[int] = None,
             prefix: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one backward call over ``s`` queries and ``sk``
    keys (default ``s``) with a bidirectional prefix of ``prefix`` keys:
    the recomputed S = Q K^T and the products dP = dO
    V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q, (6 hd + 4 hv) B H pairs;
    q, k, v, o, dO and the LSE read, dq, dk, dv and D = rowsum(dO O)
    written once."""
    sk = s if sk is None else sk
    el = dtype.itemsize
    nbytes = el * b * (s * (2 * h * hd + 2 * h * hv)
                       + sk * 2 * (kv * hd + kv * hv)) + 2 * 4 * b * h * s
    return (6 * hd + 4 * hv) * b * h * _pairs(s, causal, sk, prefix), nbytes


def _tc_bn(hd: int) -> int:
    """Keys of the ``wgmma`` forward's kv tile (``tc_bn``): 128, 64 at head
    dim 256, where S of 128 keys does not fit the registers beside O."""
    return 64 if hd == 256 else 128


@functools.lru_cache(maxsize=4096)
def plan(b: int, s: int, h: int, kv: int, hd: int, hv: int,
         dtype: torch.dtype, sms: int = H100_SMS) -> Plan:
    """The launch plan of attention over q [b, s, h, hd], k [b, sk, kv,
    hd], v [b, sk, kv, hv] in ``dtype`` on a card of ``sms`` SMs, for
    operands the kernels read in place (``kernel_ready``; the wrapper copies
    any other first).  A pure function of its arguments; the tiles walk the
    query rows, so the key length ``sk`` does not change it.

    bf16 takes the ``wgmma`` variant where ``hd == hv`` in ``TC_HEAD_DIMS``
    (head dim 256 among them, kv tiles of 64 keys) or ``(hd, hv)`` is in
    ``RECT_PAIRS`` (kv tiles of 128 keys), else the ``mma.sync`` variant;
    float32 takes its variant: at a pair of ``F32_TC_PAIRS`` the 3xTF32
    ``wgmma`` kernel (``F32_TC_ENTRY``: 64 x 64 tiles, one persistent block
    an SM), else the CUDA cores.  A prefix does not change the plan."""
    if dtype == torch.bfloat16 and ((hd == hv and hd in TC_HEAD_DIMS)
                                    or (hd, hv) in RECT_PAIRS):
        variant, bq, bk = TC, 128, _tc_bn(hd)
    elif dtype == torch.bfloat16:
        variant, bq, bk = MMA, 64, 64
    elif dtype == torch.float32:
        variant, bq, bk = F32, 64, 64
    else:
        raise TypeError(f"no K3 variant for {dtype}")
    grid = (b * h, _cdiv(s, bq))
    if variant == F32 and (hd, hv) in F32_TC_PAIRS:
        return Plan(F32, F32_TC_ROWS, F32_TC_ROWS,
                    (min(grid[0] * grid[1], sms), 1), F32_TC_ENTRY)
    if variant == TC:
        grid = (min(grid[0] * grid[1], sms), 1)
    return Plan(variant, bq, bk, grid)


def f32_tc_slots(hd: int) -> int:
    """Ring slots of the float32 ``wgmma`` kernels, forward and backward
    (``f32_tc_slots``, ``b3_slots``): 4 beside (192, 128)'s resident tile
    of 96 KB, 3 beside hd 256's 128 KB."""
    return 3 if hd == 256 else 4


def f32_tc_smem(hd: int) -> int:
    """Dynamic shared memory of the float32 ``wgmma`` kernel's block, as
    ``flash_attention.cu`` lays it out (``f32_tc_smem_bytes``): 1 KiB to
    align the base to the swizzle's period, Q's TF32 hi and lo (64 rows of
    ``hd`` floats each), the ring of ``f32_tc_slots``, and Q's full / empty
    mbarriers beside a pair a slot."""
    slots = f32_tc_slots(hd)
    return 1024 + 2 * F32_TC_ROWS * hd * 4 + slots * F32_TC_SLOT_BYTES + \
        (2 + 2 * slots) * 8


def f32_tc_scratch_floats(b: int, s: int, sk: int, h: int, kv: int, hd: int,
                          hv: int) -> int:
    """float32 scratch of the 3xTF32 ``wgmma`` forward, as
    ``flash_attention.cu`` lays it out: k split into TF32 hi and lo ([2, B
    KV, Sk, hd]), v transposed and split ([2, B KV, hv, Sk rounded up to
    the 64-key tile]); the kernel splits q itself."""
    skp = _cdiv(sk, F32_TC_ROWS) * F32_TC_ROWS
    return 2 * (b * kv * sk * hd + b * kv * hv * skp)


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
        # B, S, Sk, H, KV, hd, hv, strides, scale, causal, prefix, the
        # plan, ...
        tail = ([ci] * 7 + [ctypes.POINTER(ctypes.c_longlong),
                            ctypes.c_float, ci, ci] + [ci] * 4 + [ci, vp])
        for name in FWD_VARIANTS:
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 4 + tail
            fn.restype = ci
        for name in LSE_VARIANTS:            # the forwards with the LSE
            fn = getattr(lib, name + "_lse")
            fn.argtypes = [vp] * 5 + tail
            fn.restype = ci
        # the float32 wgmma kernel: its scratch after o (and lse)
        lib.flash_attention_f32_tc.argtypes = [vp] * 5 + tail
        lib.flash_attention_f32_tc_lse.argtypes = [vp] * 6 + tail
        lib.flash_attention_f32_tc.restype = ci
        lib.flash_attention_f32_tc_lse.restype = ci
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
        # B, S, Sk, H, KV, hd, hv, strides, scale, causal, prefix
        shape = [ci] * 7 + [ctypes.POINTER(ctypes.c_longlong),
                            ctypes.c_float, ci, ci] + [ci] * 4
        # ..., scratch, [schedule,] dq, dk, dv, shape, strides, scale,
        # causal, prefix, the plan (tiles, stages, grids), parts, device,
        # stream
        lib.flash_attention_bwd_bf16.argtypes = \
            [vp] * 11 + shape + [ci] * 4 + [ci, ci, vp]
        for name in (BWD_F32, BWD_F32_TC_ENTRY):
            getattr(lib, name).argtypes = \
                [vp] * 10 + shape + [ci] * 4 + [ci, ci, vp]
        for name in BWD_VARIANTS + (BWD_F32_TC_ENTRY,):
            getattr(lib, name).restype = ci
        lib.flash_attention_bwd_error_string.argtypes = [ci]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_bound = lib
    return _bwd_bound


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, prefix: int = 0
              ) -> Tuple[int, int, int, int, int, int, int]:
    """Raises on what neither version takes; returns (B, S, Sk, H, KV, hd,
    hv): S query rows, Sk keys (Sk == S when ``causal``; a ``prefix`` only
    when ``causal``)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, dim]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = (int(d) for d in q.shape)
    sk, kv = int(k.shape[1]), int(k.shape[2])
    if tuple(k.shape) != (b, sk, kv, hd) or \
            tuple(v.shape[:3]) != (b, sk, kv):
        raise ValueError(f"k must be [B, Sk, KV, hd] and v [B, Sk, KV, hv] "
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
    if min(b, s, sk, h, hd, int(v.shape[3])) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    _check_lengths(s, sk, causal, prefix)
    return b, s, sk, h, kv, hd, int(v.shape[3])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, prefix_len: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the reference kernel's
    arithmetic: q, k, v cast to float32; for each kv block of ``BLOCK`` keys
    in order, ``s = q k^T * scale`` (causal: keys past the query row and
    not in the first ``prefix_len`` set to ``NEG_INF``), ``m' = max(m,
    rowmax s)``, ``p = exp(s - m')``, ``l = l *
    exp(m - m') + rowsum p``, ``acc = acc * exp(m - m') + p v``; then ``acc /
    max(l, 1e-30)`` rounded to ``q.dtype`` once.  All query rows take each
    kv block together: for a block the reference kernel skips (entirely
    above the diagonal) every ``p`` is exactly 0 and every correction
    exactly 1, so the update changes nothing.  GQA groups query heads over
    their kv head; K and V are never repeated.  Keys may be longer or
    shorter than the queries when not ``causal``."""
    return _plain_forward(q, k, v, causal, scale, prefix_len)[0]


def _visible(q_pos: torch.Tensor, k_pos: torch.Tensor,
             prefix: int) -> torch.Tensor:
    """[queries, keys]: key ``j`` visible to query row ``i`` under the causal
    mask with a bidirectional prefix, ``j <= i or j < prefix`` (the
    reference's ``layers._block_mask``)."""
    return (k_pos[None, :] <= q_pos[:, None]) | (k_pos[None, :] < prefix)


def _plain_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, scale: Optional[float], prefix: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_plain``'s output and the row log-sum-exp of the
    scaled scores, ``m + log(max(l, 1e-30))``, float32 [B, H, S]."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix)
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
    block = min(BLOCK, sk)
    for k0 in range(0, sk, block):
        kj, vj = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf, kj) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kj.shape[1], device=q.device)
            sc = torch.where(_visible(q_pos, k_pos, prefix), sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        m = m_new
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vj)
    den = torch.clamp_min(l, 1e-30)
    o = acc / den[..., None]
    lse = (m + torch.log(den)).reshape(b, h, s)
    # contiguous [B, S, H, hv], as the kernels write it
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hv).to(q.dtype)
    return o.contiguous(), lse


def flash_attention_bwd_plain(do: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, prefix_len: int = 0,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of the backward kernels, written out step by
    step in float32 from the forward's output ``o`` and log-sum-exp ``lse``
    [B, H, S]: D = rowsum(dO * O); P = exp(scale q k^T - lse) (0 above the
    diagonal when causal, outside the first ``prefix_len`` keys); dV = P^T
    dO; dP = dO V^T; dS = P * (dP - D) *
    scale; dQ = dS K; dK = dS^T Q.  GQA sums dK and dV over each group's
    heads; keys may be longer or shorter than the queries when not
    ``causal``.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix_len)
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
        p = torch.where(_visible(pos, pos, prefix_len), p, 0.0)
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
    b, s, _, h, kv, hd, hv = _validate(q, k, v, False)
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


def _check_fwd_shape(hd: int, hv: int) -> None:
    if (hd, hv) in RECT_PAIRS:
        return
    if hd not in HEAD_DIMS or hv not in HEAD_DIMS or (
            hd != hv and (hd in SQUARE_HEAD_DIMS or hv in SQUARE_HEAD_DIMS)):
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} "
                         f"({SQUARE_HEAD_DIMS} only with hd == hv) and the "
                         f"pairs {RECT_PAIRS}; got hd {hd}, hv {hv}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``q`` [B, S, H, hd] over ``k`` [B, Sk, KV, hd],
    ``v`` [B, Sk, KV, hv] (H a multiple of KV), causal unless ``causal`` is
    False (causal needs Sk == S), the first ``prefix_len`` keys seen by
    every query row (causal only), scores scaled by ``scale`` (default ``hd
    ** -0.5``); returns [B, S, H, hv] in ``q.dtype`` (float32 or bfloat16,
    float32 statistics and accumulation).  CUDA tensors launch the variant
    that ``plan`` picks (``hd, hv`` in ``HEAD_DIMS``); CPU tensors take the
    plain version."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix_len)
    if scale is None:
        scale = hd ** -0.5
    with census.kernel_call(lambda: (
            plan_for(q, k, v).variant,
            *fwd_work(b, s, h, kv, hd, hv, causal, q.dtype, sk=sk,
                      prefix=prefix_len))):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         prefix_len=prefix_len, scale=scale)
        _check_fwd_shape(hd, hv)
        p = plan_for(q, k, v)
        gx, gy = p.grid
        if gx >= 2 ** 31 or gy > 65535:
            raise ValueError(f"B*H = {b * h} or S = {s} exceeds the kernel's "
                             "grid")
        o = torch.empty((b, s, h, hv), dtype=q.dtype, device=q.device)
        if q.device.type == "meta":
            return o                  # the census's shape-only route
        _launch_fwd(p, q, k, v, o, None, causal, prefix_len, scale)
        return o


def _launch_fwd(p: Plan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: Optional[torch.Tensor], causal: bool,
                prefix: int, scale: float) -> None:
    """One launch of ``p``'s variant (its ``_lse`` entry point where ``lse``
    is given), counted under the variant's key; raises on a refused
    launch."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *(int(st) for t in (q, k, v, o) for st in t.stride()[:3]))
    lib = _library()
    entry = p.entry or p.variant
    if lse is not None:
        entry += "_lse"
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if lse is not None:
        head.append(lse.data_ptr())
    if p.entry == F32_TC_ENTRY:
        scratch = torch.empty((f32_tc_scratch_floats(b, s, sk, h, kv, hd,
                                                     hv),),
                              dtype=torch.float32, device=q.device)
        head.append(scratch.data_ptr())
    gx, gy = p.grid
    code = getattr(lib, entry)(
        *head, b, s, sk, h, kv, hd, hv, strides, float(scale),
        int(bool(causal)), int(prefix), p.block_q, p.block_k, gx, gy,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[p.variant] += 1
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {entry} ({p}) failed: {msg} "
                           f"(cudaError {code})")


def _check_train_shape(hd: int, hv: int) -> None:
    if (hd, hv) not in RECT_PAIRS and (hd != hv or hd not in BWD_HEAD_DIMS):
        raise ValueError(f"the training kernels take hd == hv in "
                         f"{BWD_HEAD_DIMS} and the pairs {RECT_PAIRS}; got "
                         f"hd {hd}, hv {hv}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, prefix_len: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and the row log-sum-exp of the scaled
    scores, float32 [B, H, S] (what the backward needs).  CUDA tensors
    launch ``plan``'s variant built to write the LSE (``hd == hv`` in
    ``BWD_HEAD_DIMS`` or a pair of ``RECT_PAIRS``: the tensor-core variant
    in bf16; in float32 the 3xTF32 ``wgmma`` kernel at ``F32_TC_PAIRS``, the
    CUDA cores at 64 and 128); CPU tensors take the plain version."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix_len)
    if scale is None:
        scale = hd ** -0.5
    with census.kernel_call(lambda: (
            plan_for(q, k, v).variant,
            *fwd_work(b, s, h, kv, hd, hv, causal, q.dtype, lse=True,
                      sk=sk, prefix=prefix_len))):
        if q.device.type == "cpu":
            return _plain_forward(q, k, v, causal, scale, prefix_len)
        _check_train_shape(hd, hv)
        p = plan_for(q, k, v)
        o = torch.empty((b, s, h, hv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if q.device.type == "meta":
            return o, lse             # the census's shape-only route
        _launch_fwd(p, q, k, v, o, lse, causal, prefix_len, scale)
        return o, lse


# the bf16 backward's tiles: the dQ kernel's items are BWD_ROWS query rows
# of one (b, head) and walk the keys ``_dq_step(hd)`` at a time; the dK /
# dV kernel's items are BWD_ROWS keys of one (b, kv head) and walk the
# group's query rows BWD_STEP at a time -- at head dims 192 and 256 (the
# split kernel, ``_split``) BWD_STEP keys of one (b, head), through
# ``_split_stages(hd)`` ring slots.  The float32 kernels' items are
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
    ``kv_rows`` keys of one (b, kv head) -- of one (b, head) at head dim
    256 -- and walks the visible query rows ``q_step`` at a time.
    ``stages``: the ring slots of the two kernels' streamed tiles;
    ``smem``: the dynamic shared memory of a block of each.

    bf16 on ``wgmma``: each kernel is persistent, ``grid_*`` = (blocks, 1),
    and block ``c`` works through the items ``schedule_*[c]`` in order --
    dQ items ``(b * H + h) * nq + q_block``, dK / dV items ``(b * KV +
    kv_head) * nk + key_block`` (at head dims 192 and 256 ``(b * H + h) *
    nk + key_block``, with GQA writing float32 partials per head that a
    last kernel sums by group in head order) with ``nq = ceil(S / q_rows)``,
    ``nk = ceil(Sk / kv_rows)``.  float32: one block an item, ``grid_*`` =
    (items, 1), no schedule: block ``i`` takes q-block or key block ``i //
    (B H)`` (the dQ kernel's reversed under causal, so the heaviest items
    come first) of head ``b H + h = i % (B H)``; with GQA the dK / dV items
    write float32 partials per head, which a last kernel sums by group in
    head order.  float32 at a pair of ``F32_TC_PAIRS``: the C entry point
    ``entry`` (``BWD_F32_TC_ENTRY``), a pre-pass and three passes of one
    ``wgmma`` kernel (dQ on ``grid_dq``; dK, then dV on ``grid_dkdv``), one
    block an item, head by head (block ``i`` takes query head ``i // n``
    and its item ``i % n``, the dQ pass's reversed under causal); with GQA
    the dK and dV items write per-head partials, summed by a last kernel."""
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
    entry: Optional[str] = None


def _bwd_stages(hd: int) -> int:
    """Ring slots of the bf16 dQ kernel, and of the dK / dV kernel at 64
    and 128 (the 227 KB budget decides at 128, 192 and 256)."""
    return 4 if hd == 64 else 3


def _split(hd: int) -> bool:
    """Whether the bf16 dK / dV pass is the split kernel (items of
    BWD_STEP keys of one head, dK and dV on the two consumer warpgroups):
    at head dim 256 and at deepseek's (192, 128)."""
    return hd >= 192


def _split_stages(hd: int) -> int:
    """Ring slots of the split dK / dV kernel: 2 at hd 256 (64 KB a Q / dO
    pair), 3 at (192, 128) (40 KB)."""
    return 2 if hd == 256 else 3


def _dq_step(hd: int) -> int:
    """Keys of the bf16 dQ kernel's kv tile: 128 at hd 64, 64 at hd 128
    (where dQ's accumulator takes 64 registers a thread) and at (192, 128)
    (96), 32 at hd 256 (128)."""
    return {64: 128, 128: 64, 192: 64}.get(hd, 32)


def _dq_slots(hd: int) -> int:
    """Item slots of Q and dO in the bf16 dQ kernel: two, one at (192,
    128) (80 KB a slot) and at hd 256 (128 KB)."""
    return 1 if hd >= 192 else 2


def _bwd_smem(hd: int, stages: int, kv_stages: Optional[int] = None,
              hv: Optional[int] = None) -> Tuple[int, int]:
    """Dynamic shared memory of a bf16 block at head dims ``hd, hv``
    (``hv`` default ``hd``), as ``flash_attention_bwd.cu`` lays it out:
    1 KiB to align the base to the swizzle's period; dQ: ``_dq_slots`` item
    slots of Q and dO, ``stages`` slots of K and V tiles, 2 slots + 4
    stages mbarriers; dK / dV (``kv_stages``, default ``stages``): two
    item slots of K and V, the ring's Q, dO and their 64 lse2 and D floats,
    4 + 2 stages mbarriers -- at hd 192 and 256 (the split kernel) one
    item's K and V of 64 keys, the ring, two float32 P^T buffers of 128 x
    32 and 2 + 2 stages + 4 mbarriers."""
    kv_stages = stages if kv_stages is None else kv_stages
    hv = hd if hv is None else hv
    boxes = (hd + hv) // 64            # 64-column boxes of a Q and a dO row
    big, step = BWD_ROWS * 128, BWD_STEP * 128   # bytes of a box
    slots = _dq_slots(hd)
    dq = 1024 + slots * boxes * big \
        + stages * boxes * _dq_step(hd) * 128 + (2 * slots + 4 * stages) * 8
    ring = kv_stages * (boxes * step + 2 * BWD_STEP * 4)
    if _split(hd):
        dkdv = 1024 + boxes * step + ring + 2 * 128 * (BWD_STEP // 2) * 4 \
            + (2 + 2 * kv_stages + 4) * 8
    else:
        dkdv = 1024 + 2 * boxes * big + ring + (4 + 2 * kv_stages) * 8
    return dq, dkdv


def _f32_step(hd: int) -> int:
    """Keys (dQ) or query rows (dK / dV) of a TF32 ``mma.sync`` kernel's
    streamed tile: 32 at hd 64, 16 at hd 128, so that two blocks of each
    kernel fit an SM and ptxas needs no spill."""
    return 32 if hd == 64 else 16


def _f32_bwd_smem(hd: int) -> Tuple[int, int]:
    """Dynamic shared memory of a TF32 block (hd == hv), as
    ``flash_attention_bwd.cu`` lays it out in float32 rows of hd elements
    and 16 bytes: dQ: the item's Q and dO, ``F32_BWD_STAGES`` slots of K
    and V tiles; dK / dV: the item's K and V, P^T handed between the warps
    of a pair ([64] [step + 8]), ``F32_BWD_STAGES`` slots of Q and dO tiles
    and their lse and D."""
    pair = 2 * hd * 4 + 32                    # a Q row and a dO row
    r, st = F32_BWD_ROWS, _f32_step(hd)
    dq = (r + F32_BWD_STAGES * st) * pair
    dkdv = r * pair + r * (st + 8) * 4 + F32_BWD_STAGES * (st * pair
                                                           + 2 * st * 4)
    return dq, dkdv


def f32_tc_bwd_stat_bytes(hd: int) -> int:
    """Shared bytes of the float32 ``wgmma`` backward's staged lse2 and D
    (``b3_stat_bytes``): at hd 256 two buffers of 64 of each, float32; none
    at (192, 128)."""
    return 2 * 2 * F32_TC_ROWS * 4 if hd == 256 else 0


def f32_tc_bwd_smem(hd: int, hv: int) -> int:
    """Dynamic shared memory of a block of the float32 ``wgmma`` backward's
    passes (``b3_smem_bytes``): 1 KiB to align the base to the swizzle's
    period, the item's resident tile in TF32 hi and lo (64 rows of ``hd``
    floats: Q or K; the ``hv``-wide operands stream), the ring of
    ``f32_tc_slots``, the staged lse2 and D, the resident's mbarrier and a
    full / empty pair a slot."""
    slots = f32_tc_slots(hd)
    return 1024 + 2 * F32_TC_ROWS * hd * 4 + slots * F32_TC_SLOT_BYTES + \
        f32_tc_bwd_stat_bytes(hd) + (1 + 2 * slots) * 8


def f32_tc_bwd_scratch_floats(b: int, s: int, sk: int, h: int, kv: int,
                              hd: int, hv: int) -> int:
    """float32 scratch of the float32 ``wgmma`` backward, as
    ``flash_attention_bwd.cu`` lays it out (``b3_scratch``): q and do split
    into TF32 hi and lo, as they lie and transposed, over the B H query
    heads; k split as it lies and transposed, v as it lies, over the B KV
    kv heads (S and Sk rounded up to the 64-row tile where transposed); D
    [B H, S], and with GQA (h > kv) the per-head dK and dV partials [2, B,
    Sk, H, hd] from the next multiple of 4 floats."""
    sp, skp = (_cdiv(n, F32_TC_ROWS) * F32_TC_ROWS for n in (s, sk))
    n, nkv = b * h, b * kv
    d = _cdiv(n * s, 4) * 4 + 2 * b * sk * h * hd if h > kv else n * s
    return 2 * (n * (s * (hd + hv) + hd * sp + hv * sp)
                + nkv * (sk * (hd + hv) + hd * skp)) + d


def bwd_item_work(b: int, s: int, h: int, kv: int, causal: bool,
                  sk: Optional[int] = None, prefix: int = 0, hd: int = 64
                  ) -> Tuple[List[int], List[int]]:
    """The work of each bf16 item over ``s`` query rows and ``sk`` keys
    (default ``s``), in the tiles it walks plus one for its set-up (loads,
    D, the epilogue): dQ item ``(b * H + h) * nq + qb`` (``nq = ceil(s /
    BWD_ROWS)``) walks the keys up to its rows' last, or to the prefix's
    last where that lies further (all ``sk`` of them when not causal); dK /
    dV item ``(b * KV + kvh) * nk + kb`` (``nk = ceil(sk / BWD_ROWS)``)
    walks, for each of the G heads, the q tiles of ``BWD_STEP`` rows from
    the first that sees its keys (row 0 where a key of the item lies in the
    prefix).  At head dims 64, 128 and 192 the dQ tiles count ``BWD_STEP``
    keys (``_dq_step(64)`` tiles count as two; 192's are that long).  At
    head dim 256 the dQ item's kv tiles are the kernel's own, of
    ``_dq_step(256)`` keys.  At 192 and 256 (the split kernel) the dK / dV
    item ``(b * H + h) * nk + kb`` (``nk = ceil(sk / BWD_STEP)``) walks its
    one head's q tiles."""
    sk = s if sk is None else sk
    _check_lengths(s, sk, causal, prefix)
    p = min(prefix, s)
    nq = _cdiv(s, BWD_ROWS)
    nstep = _cdiv(s, BWD_STEP)
    dq_tile = _dq_step(hd) if hd == 256 else BWD_STEP
    dq = [_cdiv(max(min((qb + 1) * BWD_ROWS, s), p) if causal else sk,
                dq_tile) + 1 for qb in range(nq)]
    if _split(hd):
        dkdv = [nstep - (kb if causal and kb * BWD_STEP >= p else 0) + 1
                for kb in range(_cdiv(sk, BWD_STEP))]
        return dq * (b * h), dkdv * (b * h)
    per_block = BWD_ROWS // BWD_STEP
    dkdv = [(h // kv) * (nstep - (kb * per_block
                                  if causal and kb * BWD_ROWS >= p else 0))
            + 1 for kb in range(_cdiv(sk, BWD_ROWS))]
    return dq * (b * h), dkdv * (b * kv)


# the operands one round of a persistent grid streams past which its work
# runs head by head: more than the card's 50 MB L2 holds (the forward's
# ``kL2Group`` in ``flash_attention.cu``)
L2_GROUP_BYTES = 64 << 20


def _group_items(per_head: int, heads: int, round_bytes: int) -> int:
    """Items of one schedule group of a kernel whose ``heads`` heads have
    ``per_head`` items each, consecutive: one head's where the operands the
    first round of blocks streams -- the heaviest item of each of as many
    heads, each walking its head's K and V or Q and dO -- pass
    ``L2_GROUP_BYTES`` (``round_bytes``), else every item.  Head by head,
    the blocks stream the operands of a few heads at a time, which the L2
    keeps; over every head at once (deepseek's 128 heads of 2.6 MB at S =
    4096) each item would read its operands from device memory again."""
    return per_head if round_bytes > L2_GROUP_BYTES else per_head * heads


def _lpt(work: List[int], blocks: int,
         group: Optional[int] = None) -> Tuple[Tuple[int, ...], ...]:
    """Longest processing time first: the items group by group (runs of
    ``group`` consecutive items, default all of them), inside a group in
    order of decreasing work (ties by index), each to the block with the
    least work so far (ties by block index).  Every block's list runs group
    by group, heaviest first inside each."""
    group = group or max(len(work), 1)
    order = sorted(range(len(work)), key=lambda i: (i // group, -work[i], i))
    heap = [(0, c) for c in range(blocks)]
    lists: List[List[int]] = [[] for _ in range(blocks)]
    for i in order:
        load, c = heapq.heappop(heap)
        lists[c].append(i)
        heapq.heappush(heap, (load + work[i], c))
    return tuple(tuple(x) for x in lists)


def bwd_variant(dtype: torch.dtype) -> str:
    """The backward's variant (its ``LAUNCHES`` key) for ``dtype``: every
    head dim of a dtype, the pairs of ``RECT_PAIRS`` included, takes the
    same one."""
    if dtype == torch.bfloat16:
        return BWD_BF16
    if dtype == torch.float32:
        return BWD_F32
    raise TypeError(f"no K3 backward variant for {dtype}")


def plan_bwd(b: int, s: int, h: int, kv: int, hd: int, dtype: torch.dtype,
             causal: bool = True, sms: int = H100_SMS,
             sk: Optional[int] = None, prefix: int = 0,
             hv: Optional[int] = None) -> BwdPlan:
    """The backward's plan for q [b, s, h, hd], k [b, sk, kv, hd], v [b,
    sk, kv, hv] (``sk`` default ``s``, ``hv`` default ``hd``) with a
    bidirectional prefix of ``prefix`` keys in ``dtype`` on a card of
    ``sms`` SMs (a pure function of its arguments, made once: the same
    object for the same shape).  A pair of ``RECT_PAIRS`` takes no GQA (h
    == kv).
    bf16 on ``wgmma``: dQ items of 128 rows stepping ``_dq_step`` keys at a
    time, dK / dV items of 128 keys (64 keys of one head at hd 192 and 256,
    the split kernel) stepping 64 query rows, ``_bwd_stages`` ring slots
    (``_split_stages`` in the split kernel), each kernel a persistent grid
    of at most one block an SM whose schedule ``_lpt`` makes from
    ``bwd_item_work``, in head groups (``_group_items``) where the operands
    the items stream pass ``L2_GROUP_BYTES``;
    float32 on ``mma.sync`` (3xTF32) at head dims 64 and 128: items of 64
    rows or keys, one block an item, heaviest first, each stepping
    ``_f32_step`` rows or keys through ``F32_BWD_STAGES`` ring slots; with
    GQA a last kernel sums the dK / dV pass's per-head partials (float32,
    and bf16 at hd 256).  float32 at a pair of ``F32_TC_PAIRS``: 3xTF32 on
    ``wgmma`` (``BWD_F32_TC_ENTRY``), items and tiles of 64, ``f32_tc_slots``
    ring slots, one block an item (with GQA, at hd 256, the dK and dV
    passes' per-head partials summed by the same last kernel)."""
    return _plan_bwd(b, s, s if sk is None else sk, h, kv, hd, dtype,
                     bool(causal), sms, int(prefix), hd if hv is None else hv)


@functools.lru_cache(maxsize=4096)
def _plan_bwd(b: int, s: int, sk: int, h: int, kv: int, hd: int,
              dtype: torch.dtype, causal: bool, sms: int,
              prefix: int, hv: int) -> BwdPlan:
    _check_train_shape(hd, hv)
    _check_lengths(s, sk, causal, prefix)
    if (hd, hv) in RECT_PAIRS and h != kv:
        raise ValueError(f"the training kernels take (hd, hv) = ({hd}, "
                         f"{hv}) without GQA; got {h} query heads over {kv} "
                         f"kv heads")
    variant = bwd_variant(dtype)
    if variant == BWD_BF16:
        work_dq, work_dkdv = bwd_item_work(b, s, h, kv, causal, sk, prefix,
                                           hd)
        ctas_dq, ctas_dkdv = min(len(work_dq), sms), min(len(work_dkdv), sms)
        # the dQ items stream their kv head's K and V, the dK / dV items
        # their head's (or kv head's group's) Q and dO
        g = h // kv
        heads_kv = b * (h if _split(hd) else kv)
        group_dq = _group_items(
            _cdiv(s, BWD_ROWS), b * h,
            _cdiv(min(ctas_dq, b * h), g) * sk * (hd + hv) * 2)
        group_kv = _group_items(
            len(work_dkdv) // heads_kv, heads_kv,
            min(ctas_dkdv, heads_kv) * (b * h // heads_kv) * s * (hd + hv)
            * 2)
        st = _bwd_stages(hd)
        st_kv = _split_stages(hd) if _split(hd) else st
        kv_rows = BWD_STEP if _split(hd) else BWD_ROWS
        return BwdPlan(BWD_BF16, BWD_ROWS, kv_rows, BWD_STEP, _dq_step(hd),
                       (st, st_kv), (ctas_dq, 1), (ctas_dkdv, 1),
                       _bwd_smem(hd, st, st_kv, hv),
                       _lpt(work_dq, ctas_dq, group_dq),
                       _lpt(work_dkdv, ctas_dkdv, group_kv))
    if (hd, hv) in F32_TC_PAIRS:
        r, st = F32_TC_ROWS, f32_tc_slots(hd)
        smem = f32_tc_bwd_smem(hd, hv)
        return BwdPlan(variant, r, r, r, r, (st, st),
                       (b * h * _cdiv(s, r), 1), (b * h * _cdiv(sk, r), 1),
                       (smem, smem), entry=BWD_F32_TC_ENTRY)
    r, st = F32_BWD_ROWS, _f32_step(hd)
    return BwdPlan(variant, r, r, st, st, (F32_BWD_STAGES, F32_BWD_STAGES),
                   (b * h * _cdiv(s, r), 1), (b * h * _cdiv(sk, r), 1),
                   _f32_bwd_smem(hd))


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
                        *, causal: bool = True, prefix_len: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention's output ``o`` = attention(q, k,
    v) given its gradient ``do`` and the forward's log-sum-exp ``lse``
    [B, H, S] (k, dk [B, Sk, KV, hd], v, dv [B, Sk, KV, hv]; the first
    ``prefix_len`` keys seen by every row when causal).  CUDA tensors launch
    ``plan_bwd``'s variant (``hd == hv`` in ``BWD_HEAD_DIMS``, or a pair of
    ``RECT_PAIRS``) or raise; CPU tensors take
    ``flash_attention_bwd_plain``."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix_len)
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
    with census.kernel_call(lambda: (
            bwd_variant(q.dtype),
            *bwd_work(b, s, h, kv, hd, hv, causal, q.dtype, sk=sk,
                      prefix=prefix_len))):
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(do, q, k, v, o, lse,
                                             causal=causal,
                                             prefix_len=prefix_len,
                                             scale=scale)
        _check_train_shape(hd, hv)
        if q.device.type == "meta":       # the census's shape-only route
            return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in (q, k, v))
        return bwd_launch(do, q, k, v, o, lse, causal, scale, BWD_BOTH,
                          prefix=prefix_len)[:3]


def bwd_launch(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
               causal: bool, scale: float, parts: int,
               scratch: Optional[torch.Tensor] = None, prefix: int = 0
               ) -> Tuple[torch.Tensor, ...]:
    """The kernels of ``flash_attention_bwd`` on CUDA tensors it accepts:
    ``parts`` ``BWD_DQ`` (the dQ kernel, which also writes the scratch),
    ``BWD_DKDV`` (the dK / dV kernel, which reads it) or ``BWD_BOTH``;
    returns (dq, dk, dv, scratch), the outputs a part did not launch
    unwritten.  One call counts once.  To time the dK / dV kernel alone,
    pass back the scratch of a ``BWD_BOTH`` call on the same inputs."""
    b, s, sk, h, kv, hd, hv = _validate(q, k, v, causal, prefix)
    p = plan_bwd(b, s, h, kv, hd, q.dtype, bool(causal), _sm_count(q.device),
                 sk, prefix, hv)
    if max(p.grid_dq[0], p.grid_dkdv[0]) >= 2 ** 31:
        raise ValueError(f"B = {b}, H = {h}, S = {s} exceed the backward "
                         "kernels' grid")
    q, k, v, o, do = (_kernel_operand(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    wgmma = p.variant == BWD_BF16
    if scratch is None:
        # wgmma: lse2, D [B H, S padded], at hd 256 with GQA then the
        # per-head dK, dV partials [2, B, Sk, H, hd]; float32: D [B, H, S],
        # after those partials with GQA; float32 at ``F32_TC_PAIRS``: the
        # split and transposed operands, D, the partials with GQA
        partials = (h > kv) * 2 * b * sk * h * hd
        if p.entry == BWD_F32_TC_ENTRY:
            n = f32_tc_bwd_scratch_floats(b, s, sk, h, kv, hd, hv)
        elif wgmma:
            n = 2 * b * h * _cdiv(s, BWD_ROWS) * BWD_ROWS \
                + (hd == 256) * partials
        else:
            n = partials + b * h * s
        scratch = torch.empty((n,), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, kv, hv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(int(st) for t in (q, k, v, o, do, dq, dk, dv)
          for st in t.stride()[:3]))
    lib = _bwd_library()
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr()]
    if wgmma:
        head.append(_schedule_tensor(p, q.device).data_ptr())
    tail = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, sk, h, kv, hd,
            hv, strides, float(scale), int(bool(causal)), int(prefix), p.q_rows,
            p.kv_rows, p.q_step, p.kv_step, p.stages[0], p.stages[1],
            p.grid_dq[0], p.grid_dkdv[0]]
    entry = p.entry or p.variant
    code = getattr(lib, entry)(
        *head, *tail, int(parts), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[p.variant] += 1
    if code != 0:
        msg = lib.flash_attention_bwd_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {entry} ({p}) failed: {msg} "
                           f"(cudaError {code})")
    return dq, dk, dv, scratch


class FlashAttention(torch.autograd.Function):
    """K3 with its backward: ``flash_attention_fwd`` saves q, k, v, o and
    the log-sum-exp; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, prefix: int = 0):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     prefix_len=prefix, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.prefix = causal, scale, prefix
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(do, q, k, v, o, lse,
                                         causal=ctx.causal,
                                         prefix_len=ctx.prefix,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              prefix_len: int = 0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` that autograd differentiates (``FlashAttention``)."""
    if scale is None:
        scale = int(q.shape[-1]) ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                int(prefix_len))
