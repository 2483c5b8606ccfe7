"""The stride-1 convolution kernel (K2) and its gradient: launch plans,
wrappers, plain versions, launch counts.

Hand-written CUDA kernels (``csrc/conv2d.cu``) compute the stride-1
convolution NHWC x HWIO -> NHWC as an implicit GEMM (M = output pixels,
N = Cout, K = kh*kw*Cin), accumulating in float32 and rounding the output to
the input dtype once; they replace the reference's TPU kernel
``_conv_kernel``.  Padding is a bounds check (or TMA's zero fill) inside the
kernel, and any ``H_out`` works.

Three variants, chosen by shape before any launch (``plan``), each counted
under its own key of ``LAUNCHES``:

* ``conv2d_bf16_tc`` -- bf16 with Cin and Cout multiples of 8 and 16-byte
  aligned x and w (every ResNet-50 shape): ``wgmma`` tensor cores fed by TMA
  and ``cp.async`` through a ring of shared-memory stages.
* ``conv2d_bf16_simt`` -- any other bf16 shape: the CUDA-core kernel.
* ``conv2d_f32`` -- float32, any shape, on the CUDA cores in IEEE float32 (as
  the reference convolves float32).

Where the output tiles cannot fill the card, the plan splits the K walk into
slices whose float32 partial sums a second kernel adds in slice order (no
atomics: two runs give the same bits).  One call is one launch in
``LAUNCHES`` whether it runs one kernel or two.

The gradient (``Conv2dK2``, the ``torch.autograd.Function`` that
``conv2d_trainable`` applies; the reference trains through ``jax.vjp`` of
``lax.conv`` and has no backward kernel):

* the data gradient ``conv2d_dgrad`` is K2's forward on dy with the rotated
  weights ``rotate(w)`` and the padding ``dgrad_padding`` -- the same
  kernels and plan, counted under ``conv2d_dgrad_*`` in ``BWD_LAUNCHES`` so
  that ``LAUNCHES`` keeps counting forwards alone;
* the weight gradient ``conv2d_wgrad`` is ``csrc/conv2d_bwd.cu``: one GEMM a
  tap over the pixels (M = Cin, N = Cout, K = B*H_out*W_out), the pixel
  walk split across blocks whose float32 partials a second kernel adds in
  slice order (``plan_wgrad``); variants ``conv2d_wgrad_bf16_tc``
  (``wgmma`` tensor cores fed by TMA, tiles fitted to the channels; bf16
  with Cin, Cout % 8 == 0 and aligned tensors: every ResNet-50 shape),
  ``conv2d_wgrad_bf16_simt`` and ``conv2d_wgrad_f32`` (CUDA cores, IEEE
  float32), each a key of ``BWD_LAUNCHES``.

Beside them stand ``conv2d_plain`` (the reference kernel's own arithmetic, a
float32 sum of ``kh*kw`` shifted-window matmuls), ``conv2d_dgrad_plain``
(``conv2d_plain`` on the rotated weights) and ``conv2d_wgrad_plain`` (the
float32 sum over taps of ``window.T @ dy``).  The wrappers take them ONLY
for tensors that lie on the CPU; for CUDA tensors they launch a kernel or
raise -- there is no fallback.  The libraries are built and loaded inside
the first launching call, never at import time.  Tensors on the meta device
(the workload census, ``core.census.analyze_step``) take a shape-only
route: the plan, an empty meta output, nothing launched or counted.  Under
an active census each call books its entry (``census_work``,
``wgrad_work``) through ``census.kernel_call``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import census

SOURCE = "conv2d.cu"
BWD_SOURCE = "conv2d_bwd.cu"

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
NO_PADDING: Padding = ((0, 0), (0, 0))

TC, SIMT, F32 = "conv2d_bf16_tc", "conv2d_bf16_simt", "conv2d_f32"

# launches per variant since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {TC: 0, SIMT: 0, F32: 0}

# the gradient's variants: the data gradient runs the forward variant's
# kernels, counted under its own key; the weight gradient's keys are the
# entry points of csrc/conv2d_bwd.cu
DGRAD = {TC: "conv2d_dgrad_bf16_tc", SIMT: "conv2d_dgrad_bf16_simt",
         F32: "conv2d_dgrad_f32"}
WG_TC, WG_SIMT, WG_F32 = ("conv2d_wgrad_bf16_tc", "conv2d_wgrad_bf16_simt",
                          "conv2d_wgrad_f32")
BWD_LAUNCHES: Dict[str, int] = {**{k: 0 for k in DGRAD.values()},
                                WG_TC: 0, WG_SIMT: 0, WG_F32: 0}

# SMs of an H100 SXM: the plan's card off the card (CPU, meta)
H100_SMS = 132

# A K slice is at least this many steps: fewer would leave the stage ring
# idle and grow the workspace for little more parallelism.
MIN_SLICE_STEPS = 2
# The tensor-core kernel's ring: up to 5 stages of 32 KB (128 x 128 tile)
# or 4 of 24 KB (128 x 64), never more than the K walk has steps.  A walk
# of at most SHORT_K steps takes the 128 x 64 tile whatever Cout is: with
# 4 stages or fewer and 80 registers a thread, two of its blocks fit on an
# SM, so one block's loads overlap another's products and stores.
MAX_STAGES = {64: 4, 128: 5}
SHORT_K = 2
# blocks of a variant and tile that fit on one SM at once: the tensor-core
# kernel 2 (128 x 64) or 1 (128 x 128, 90 registers x 384 threads); the
# float32 128 x 128 kernel 1 (173 registers x 256 threads), 128 x 64 2
RESIDENT = {(TC, 64): 2, (TC, 128): 1, (F32, 64): 2, (F32, 128): 1}


def reset_launch_counts() -> None:
    """Zeroes the forward's and the gradient's counts."""
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def bwd_launch_counts() -> Dict[str, int]:
    return dict(BWD_LAUNCHES)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K2 call runs: the variant (its ``LAUNCHES`` key), the output
    tile ``bm x bn``, the channels per K step ``bk``, the K steps
    ``kh * kw * ceil(Cin / bk)``, the K slices ``split`` and the grid
    (tiles of M, tiles of N, slices).  ``vec`` is the float32 kernel's copy
    width in floats (4: 16-byte ``cp.async``, 1: 4-byte); ``gather`` says
    that the tensor-core kernel gathers x by ``cp.async`` (any kernel with
    kh*kw > 1 or padding) instead of a TMA tensor map (1x1, no padding);
    ``stages`` is its ring of shared-memory stages."""
    variant: str
    bm: int
    bn: int
    bk: int
    steps: int
    split: int
    grid: Tuple[int, int, int]
    vec: int = 0
    gather: bool = False
    stages: int = 0

    def slice_bounds(self, z: int) -> Tuple[int, int]:
        """Steps ``[begin, end)`` of K slice ``z``: contiguous, in order,
        covering the walk once (the kernels compute the same bounds)."""
        return (z * self.steps // self.split,
                (z + 1) * self.steps // self.split)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(b: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
         padding: Padding, dtype: torch.dtype, sms: int,
         aligned: bool = True) -> Plan:
    """The launch plan of a stride-1 convolution of x [b, h, w, cin] with
    w [kh, kw, cin, cout] on a card of ``sms`` SMs; ``aligned`` says that x
    and w start on 16-byte boundaries.  A pure function of its arguments.

    bf16 takes the tensor-core variant where Cin % 8 == 0, Cout % 8 == 0
    and both are aligned (what TMA and 16-byte copies need), else the SIMT
    variant.  Split-K: where the tiles fill less than one wave of resident
    blocks, the K walk is cut into the fewest slices that fill one, with at
    least ``MIN_SLICE_STEPS`` steps each."""
    (pt, pb), (pl, pr) = padding
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    m = b * ho * wo
    if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and aligned:
        variant, bk = TC, 64
    elif dtype == torch.bfloat16:
        variant, bk = SIMT, 16
    elif dtype == torch.float32:
        variant, bk = F32, 16
    else:
        raise TypeError(f"no K2 variant for {dtype}")
    steps = kh * kw * _cdiv(cin, bk)
    bm, vec, gather, stages = 128, 0, False, 0
    if variant == TC:
        bn = 64 if cout <= 64 or steps <= SHORT_K else 128
        stages = min(MAX_STAGES[bn], steps)
        gather = not (kh == kw == 1 and padding == NO_PADDING)
    elif variant == SIMT:
        bn = 64
    else:
        bn = 128 if cout >= 128 else 64
        vec = 4 if cin % 4 == 0 and cout % 4 == 0 and aligned else 1
    gm, gn = _cdiv(m, bm), _cdiv(cout, bn)
    split = 1
    if variant != SIMT:
        wave = sms * RESIDENT[(variant, bn)]
        if gm * gn < wave:
            split = max(1, min(_cdiv(wave, gm * gn),
                               steps // MIN_SLICE_STEPS))
    return Plan(variant, bm, bn, bk, steps, split, (gm, gn, split), vec,
                gather, stages)


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
        shape = [ci] * 11                      # B .. Wo
        lib.conv2d_bf16_tc.argtypes = [vp] * 4 + shape + [ci] * 6 + [ci, vp]
        lib.conv2d_bf16_simt.argtypes = [vp] * 3 + shape + [ci] * 2 + [ci, vp]
        lib.conv2d_f32.argtypes = [vp] * 4 + shape + [ci] * 5 + [ci, vp]
        for name in LAUNCHES:
            getattr(lib, name).restype = ci
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
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
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


def census_work(x_shape, w_shape, y_shape, dtype: torch.dtype
                ) -> Tuple[int, int]:
    """(flops, bytes) of one call, as the census books it: 2 prod(y) kh kw
    Cin, and x, w read and y written once."""
    kh, kw, cin, _ = w_shape
    ny = 1
    for d in y_shape:
        ny *= int(d)
    nx = 1
    for d in x_shape:
        nx *= int(d)
    return 2 * ny * kh * kw * cin, dtype.itemsize * (
        nx + kh * kw * cin * int(w_shape[3]) + ny)


def plan_for(x: torch.Tensor, w: torch.Tensor,
             padding: Padding = NO_PADDING) -> Plan:
    """``plan`` for these tensors, with the SM count of their card
    (``H100_SMS`` off the card)."""
    _validate(x, w, padding)
    return _plan_of(x, w, padding)


def _plan_of(x: torch.Tensor, w: torch.Tensor, padding: Padding) -> Plan:
    (pt, pb), (pl, pr) = padding
    return plan(*(int(s) for s in x.shape), int(w.shape[3]),
                int(w.shape[0]), int(w.shape[1]),
                ((int(pt), int(pb)), (int(pl), int(pr))), x.dtype,
                _sm_count(x.device) if x.device.type == "cuda" else H100_SMS,
                aligned(x, w))


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n


def aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether x and w start on 16-byte boundaries (TMA's and 16-byte
    ``cp.async``'s rule); a view at an element offset may not."""
    return x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           padding: Padding = NO_PADDING) -> torch.Tensor:
    """Stride-1 VALID convolution of ``x`` [B, H, W, Cin] zero-padded by
    ``padding`` = ((top, bottom), (left, right)) with ``w`` [kh, kw, Cin,
    Cout]; returns [B, H_out, W_out, Cout] in ``x.dtype`` (float32 or
    bfloat16, float32 accumulation).  CUDA tensors launch the variant that
    ``plan`` picks; CPU tensors take the plain version."""
    return _conv(x, w, padding, None)


def _conv(x: torch.Tensor, w: torch.Tensor, padding: Padding,
          names: Optional[Dict[str, str]]) -> torch.Tensor:
    """``conv2d``, each launch counted (and booked by the census) under
    ``names[variant]`` in ``BWD_LAUNCHES`` where ``names`` is given (the
    data gradient), else under the variant in ``LAUNCHES``."""
    ho, wo = _validate(x, w, padding)
    b, h, wd, cin = (int(s) for s in x.shape)
    kh, kw, _, cout = (int(s) for s in w.shape)

    def key(variant: str) -> str:
        return variant if names is None else names[variant]

    with census.kernel_call(lambda: (
            key(_plan_of(x, w, padding).variant),
            *census_work(x.shape, w.shape, (b, ho, wo, cout), x.dtype))):
        if x.device.type == "cpu":
            return conv2d_plain(x, w, padding=padding)
        if b * ho * wo >= 2 ** 31:
            raise ValueError(f"B*H_out*W_out = {b * ho * wo} exceeds the "
                             "kernel's int range")
        p = _plan_of(x, w, padding)
        y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
        if x.device.type == "meta":
            return y                  # the census's shape-only route
        lib = _library()
        ws: Optional[torch.Tensor] = None
        if p.split > 1:
            ws = torch.empty((p.split, b * ho * wo, cout),
                             dtype=torch.float32, device=x.device)
        shape = (b, h, wd, cin, cout, kh, kw, int(padding[0][0]),
                 int(padding[1][0]), ho, wo)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        gx, gy, _ = p.grid
        ws_ptr = 0 if ws is None else ws.data_ptr()
        if p.variant == SIMT:
            code = lib.conv2d_bf16_simt(x.data_ptr(), w.data_ptr(),
                                        y.data_ptr(), *shape, gx, gy,
                                        x.device.index, stream)
        elif p.variant == TC:
            code = lib.conv2d_bf16_tc(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), ws_ptr, *shape,
                p.bn, int(p.gather), p.stages, p.split, gx, gy,
                x.device.index, stream)
        else:
            code = lib.conv2d_f32(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), ws_ptr, *shape,
                p.bn, p.vec, p.split, gx, gy, x.device.index, stream)
        if names is None:
            LAUNCHES[p.variant] += 1
        else:
            BWD_LAUNCHES[names[p.variant]] += 1
        if code != 0:
            msg = lib.conv2d_error_string(code).decode()
            raise RuntimeError(f"CUDA launch of {key(p.variant)} ({p}) "
                               f"failed: {msg} (cudaError {code})")
        return y


# --- the gradient ----------------------------------------------------------------

def rotate(w: torch.Tensor) -> torch.Tensor:
    """The data gradient's weights: ``w_rot[i, j, co, ci] = w[kh-1-i,
    kw-1-j, ci, co]``, contiguous."""
    return w.flip((0, 1)).transpose(2, 3).contiguous()


def dgrad_padding(kh: int, kw: int, padding: Padding) -> Padding:
    """The padding of the data gradient's convolution of dy with
    ``rotate(w)``: ``((kh-1-pt, kh-1-pb), (kw-1-pl, kw-1-pr))``; raises for a
    forward padding of the kernel's size or more (no ResNet convolution has
    one)."""
    (pt, pb), (pl, pr) = padding
    out = ((kh - 1 - pt, kh - 1 - pb), (kw - 1 - pl, kw - 1 - pr))
    if min(p for pair in out for p in pair) < 0:
        raise ValueError(f"padding {padding} reaches past the {kh}x{kw} "
                         "kernel: the data gradient is not implemented for "
                         "it")
    return out


def conv2d_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, *,
                       padding: Padding = NO_PADDING) -> torch.Tensor:
    """Plain version of the data gradient: ``conv2d_plain`` of dy with the
    rotated weights."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    return conv2d_plain(dy, rotate(w), padding=dgrad_padding(kh, kw,
                                                             padding))


def conv2d_dgrad(dy: torch.Tensor, w: torch.Tensor, *,
                 padding: Padding = NO_PADDING) -> torch.Tensor:
    """dx [B, H, W, Cin] of the forward ``conv2d(x, w, padding=padding)``
    given dy [B, H_out, W_out, Cout] (``dy.dtype``): K2's forward kernels on
    dy and ``rotate(w)``, counted under ``DGRAD[variant]``; CPU tensors take
    the plain version."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    return _conv(dy, rotate(w), dgrad_padding(kh, kw, padding), DGRAD)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """How one weight-gradient call runs: the variant (its ``BWD_LAUNCHES``
    key and its C entry point), the tile ``bm x bn`` over (Cin, Cout), the
    pixels per step ``bk``, the steps of one tap's pixel walk, the pixel
    slices ``split`` of each tap and the grid (tiles of Cin, tiles of Cout,
    tap groups * split).  The tensor-core variant also has ``taps`` (taps a
    block: a group of consecutive taps shares each dy box), the TMA box of a
    step ``box`` = (bw, bh, bb) over the logical [images, H, W] of dy, the
    boxes along each of those ``boxes`` = (nw, nh, nb), ``flat`` (a 1x1
    kernel with no padding: x and dy walked as [1, 1, B*H*W]) and the ring's
    ``stages``."""
    variant: str
    bm: int
    bn: int
    bk: int
    steps: int
    split: int
    grid: Tuple[int, int, int]
    taps: int = 1
    box: Tuple[int, int, int] = (0, 0, 0)
    boxes: Tuple[int, int, int] = (0, 0, 0)
    flat: bool = False
    stages: int = 0

    def slice_bounds(self, z: int) -> Tuple[int, int]:
        """Steps ``[begin, end)`` of pixel slice ``z`` (the kernels compute
        the same bounds)."""
        return (z * self.steps // self.split,
                (z + 1) * self.steps // self.split)

    def box_origin(self, s: int) -> Tuple[int, int, int]:
        """(w0, h0, b0): where step ``s``'s box starts in the logical
        [images, H, W] of dy, boxes along W first (the tensor-core kernel's
        producer computes the same); tap (i, j) reads x's box at (w0 + j -
        pad_l, h0 + i - pad_t, b0)."""
        nw, nh, _ = self.boxes
        t = s // nw
        return ((s - t * nw) * self.box[0], (t % nh) * self.box[1],
                (t // nh) * self.box[2])


# blocks of a weight-gradient variant that fit on one SM at once (the
# tensor-core kernel: 384 threads and up to 227 KB of shared memory; the
# CUDA-core kernel: 256 threads, 16 KB)
WGRAD_RESIDENT = {WG_TC: 1, WG_SIMT: 2, WG_F32: 2}
# a pixel slice is at least this many pixels: fewer would spend more on the
# workspace and the tile's epilogue than on the products
MIN_WGRAD_SLICE_PIXELS = 256
# the tensor-core kernel's instances (bm, bn, taps), each the rule's choice
# at some ResNet-50 shape (64 x 256 and 128 x 256 were measured too and
# never won), its largest box (rows = pixels a step, a multiple of 16:
# wgmma's depth), its deepest ring and the shared memory a block may take
# (the ring, 16 bytes of barriers a stage, 1 KiB to align it)
WGRAD_TILES = ((64, 64, 1), (64, 128, 1), (128, 64, 1), (128, 128, 1),
               (64, 64, 3))
WGRAD_MAX_ROWS = 128
WGRAD_MAX_STAGES = 8
WGRAD_MIN_STAGES = 4
WGRAD_SMEM_BYTES = 232448


def wgrad_max_rows(bm: int, bn: int, taps: int) -> int:
    """The most pixels a step of tile (bm, bn, taps) takes: at most
    ``WGRAD_MAX_ROWS``, and few enough that ``WGRAD_MIN_STAGES`` stages fit
    (with 64-row tiles each consumer warpgroup holds a stage while it waits
    for its next, so the ring needs three at least)."""
    boxes = taps * bm // 64 + bn // 64
    fit = (WGRAD_SMEM_BYTES - 1024 - 16 * WGRAD_MAX_STAGES) // (
        WGRAD_MIN_STAGES * boxes * 128)
    return min(WGRAD_MAX_ROWS, fit // 16 * 16)


@functools.lru_cache(maxsize=4096)
def wgrad_box(w: int, h: int, n: int, max_rows: int = WGRAD_MAX_ROWS
              ) -> Tuple[int, int, int]:
    """The TMA box (bw, bh, bb) of one step over a logical [n, h, w] pixel
    grid: bw*bh*bb pixels, a multiple of 16 and at most ``max_rows``; the
    fewest pixels loaded over the whole walk (a box past the grid's edge is
    zero-filled), then the widest rows, then the most pixels a step, then
    the most image rows.  At 112 rows or more every ResNet-50 grid is tiled
    exactly: 56x56 by (56, 2, 1), 28x28 by (28, 4, 1), 14x14 by (14, 2, 4),
    7x7 by (7, 1, 16), B*H*W pixels by up to 128 (112 at 7x7, B=32)."""
    best = None
    for bw in range(1, min(max_rows, _cdiv(w, 16) * 16) + 1):
        for bh in range(1, min(h, max_rows // bw) + 1):
            for bb in range(1, min(n, max_rows // (bw * bh)) + 1):
                rows = bw * bh * bb
                if rows % 16:
                    continue
                loaded = _cdiv(w, bw) * _cdiv(h, bh) * _cdiv(n, bb) * rows
                key = (loaded, -bw, -rows, -bh)
                if best is None or key < best[0]:
                    best = (key, (bw, bh, bb))
    return best[1]


# a tap's pixel walk of at least this many pixels is long (ResNet-50 at
# 56x56, B=32), of fewer than WGRAD_SHORT_WALK short (7x7)
WGRAD_LONG_WALK = 65536
WGRAD_SHORT_WALK = 4096


def wgrad_tile(cin: int, cout: int, kh: int, kw: int, pixels: int
               ) -> Tuple[int, int, int]:
    """The tensor-core kernel's (bm, bn, taps) for these channels and a
    walk of ``pixels`` = B*H_out*W_out, the rule measured at ResNet-50's 16
    shapes (``tools/conv2d_bwd_ms.py --tiles``):

    * a long walk is byte-bound and its slices fill the card: 64 x 64, the
      smallest tile, keeps the workspace of partial tiles small;
    * a 1x1 kernel over a middling walk: 128 (64 where Cin <= 64) x 64;
    * a 1x1 kernel over a short walk: 64 x 128 (64 where Cout <= 64), whose
      tiles fill the card with no split;
    * a larger kernel (operation-bound): 128 x 128, 64 where Cin or Cout
      <= 64.

    A 3x3 kernel at 64 x 64 holds a row of three taps in a block, so that
    each dy box serves three taps.  No tile runs a product on a zero-filled
    channel where Cin and Cout are multiples of 64."""
    if pixels >= WGRAD_LONG_WALK:
        bm, bn = 64, 64
    elif kh * kw == 1 and pixels >= WGRAD_SHORT_WALK:
        bm, bn = (64 if cin <= 64 else 128), 64
    elif kh * kw == 1:
        bm, bn = 64, (64 if cout <= 64 else 128)
    else:
        bm, bn = (64 if cin <= 64 else 128), (64 if cout <= 64 else 128)
    taps = 3 if (bm, bn) == (64, 64) and kw == 3 and kh * kw % 3 == 0 else 1
    return bm, bn, taps


def wgrad_stages(bm: int, bn: int, taps: int, rows: int) -> int:
    """The deepest ring of the tensor-core kernel's stages (each a dy box a
    64 output channels and, a tap, an x box a 64 input channels) that fits
    ``WGRAD_SMEM_BYTES``."""
    stage = (taps * bm // 64 + bn // 64) * rows * 128
    return max(1, min(WGRAD_MAX_STAGES, (WGRAD_SMEM_BYTES - 1024
                                         - 16 * WGRAD_MAX_STAGES) // stage))


@functools.lru_cache(maxsize=4096)
def plan_wgrad(b: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
               padding: Padding, dtype: torch.dtype, sms: int,
               aligned: bool = True,
               tile: Optional[Tuple[int, int, int]] = None) -> WgradPlan:
    """The launch plan of the weight gradient of a stride-1 convolution of
    x [b, h, w, cin] with a [kh, kw, cin, cout] kernel on a card of ``sms``
    SMs; ``aligned`` says that x, dy and dw start on 16-byte boundaries;
    ``tile`` = (bm, bn, taps), one of ``WGRAD_TILES``, overrides
    ``wgrad_tile`` (for measuring one against another).  A pure function of
    its arguments.

    bf16 takes the tensor-core variant where Cin % 8 == 0, Cout % 8 == 0 and
    x, dy and dw are aligned: TMA's 16-byte strides and base, so every such
    shape has tensor maps.  Any other bf16 shape takes the CUDA-core one.
    Where the tiles of all tap groups fill less than one wave of resident
    blocks, each tap's pixel walk is cut into the most slices that still fit
    one wave, of at least ``MIN_WGRAD_SLICE_PIXELS`` pixels (and two steps)
    each."""
    (pt, pb), (pl, pr) = padding
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    pixels = b * ho * wo
    if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and aligned:
        bm, bn, taps = tile or wgrad_tile(cin, cout, kh, kw, pixels)
        if (bm, bn, taps) not in WGRAD_TILES or kh * kw % taps:
            raise ValueError(f"no tensor-core weight-gradient tile "
                             f"{(bm, bn, taps)} for a {kh}x{kw} kernel")
        flat = kh == kw == 1 and padding == NO_PADDING
        grid_whn = (pixels, 1, 1) if flat else (wo, ho, b)
        box = wgrad_box(*grid_whn, wgrad_max_rows(bm, bn, taps))
        boxes = tuple(_cdiv(g, e) for g, e in zip(grid_whn, box))
        rows = box[0] * box[1] * box[2]
        steps = boxes[0] * boxes[1] * boxes[2]
        groups = kh * kw // taps
        tiles = _cdiv(cin, bm) * _cdiv(cout, bn) * groups
        wave = sms * WGRAD_RESIDENT[WG_TC]
        split = 1
        if tiles < wave:
            min_steps = max(2, _cdiv(MIN_WGRAD_SLICE_PIXELS, rows))
            split = max(1, min(wave // tiles, steps // min_steps))
        return WgradPlan(WG_TC, bm, bn, rows, steps, split,
                         (_cdiv(cin, bm), _cdiv(cout, bn), groups * split),
                         taps, box, boxes, flat,
                         wgrad_stages(bm, bn, taps, rows))
    if dtype == torch.bfloat16:
        variant, bk = WG_SIMT, 8
    elif dtype == torch.float32:
        variant, bk = WG_F32, 8
    else:
        raise TypeError(f"no K2 weight-gradient variant for {dtype}")
    bm = bn = 128
    steps = _cdiv(pixels, bk)
    tiles = _cdiv(cin, bm) * _cdiv(cout, bn) * kh * kw
    wave = sms * WGRAD_RESIDENT[variant]
    split = 1
    if tiles < wave:
        split = max(1, min(_cdiv(wave, tiles),
                           steps // _cdiv(MIN_WGRAD_SLICE_PIXELS, bk)))
    return WgradPlan(variant, bm, bn, bk, steps, split,
                     (_cdiv(cin, bm), _cdiv(cout, bn), kh * kw * split))


_bwd_bound = None


def _bwd_library():
    """The loaded weight-gradient library with ``argtypes`` set."""
    global _bwd_bound
    if _bwd_bound is None:
        from repro_torch.kernels import build
        lib = build.load(BWD_SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # pointers, the shape (B .. Wo), the plan, the device and stream
        lib.conv2d_wgrad_bf16_tc.argtypes = [vp] * 4 + [ci] * 11 + [ci] * 11 \
            + [ci, vp]
        for name in (WG_SIMT, WG_F32):
            getattr(lib, name).argtypes = [vp] * 4 + [ci] * 11 + [ci] * 3 \
                + [ci, vp]
        for name in (WG_TC, WG_SIMT, WG_F32):
            getattr(lib, name).restype = ci
        lib.conv2d_wgrad_error_string.argtypes = [ci]
        lib.conv2d_wgrad_error_string.restype = ctypes.c_char_p
        _bwd_bound = lib
    return _bwd_bound


def _validate_wgrad(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
                    padding: Padding) -> None:
    """Raises unless dy is the output gradient of a [kh, kw, Cin, Cout]
    convolution of x with ``padding``."""
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin] and dy [B, H_out, W_out, "
                         f"Cout]; got {tuple(x.shape)} and {tuple(dy.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must both be float32 or bfloat16; got "
                        f"{x.dtype} and {dy.dtype}")
    if dy.device != x.device:
        raise ValueError(f"x is on {x.device}, dy on {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    if min(p for pair in padding for p in pair) < 0:
        raise ValueError(f"negative padding {padding}")
    (pt, pb), (pl, pr) = padding
    ho = x.shape[1] + pt + pb - kh + 1
    wo = x.shape[2] + pl + pr - kw + 1
    if ho < 1 or wo < 1 or min(x.shape) < 1 or min(dy.shape) < 1 or \
            min(kh, kw) < 1:
        raise ValueError(f"empty convolution: x {tuple(x.shape)}, a {kh}x{kw}"
                         f" kernel, padding {padding}")
    if (dy.shape[0], dy.shape[1], dy.shape[2]) != (x.shape[0], ho, wo):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} under a {kh}x{kw} kernel with "
                         f"padding {padding}")


def wgrad_work(x_shape, dy_shape, kh: int, kw: int, dtype: torch.dtype
               ) -> Tuple[int, int]:
    """(flops, bytes) of one weight-gradient call, as the census books it:
    2 P kh kw Cin Cout, and x, dy read and dw written once."""
    b, h, w, cin = (int(s) for s in x_shape)
    _, ho, wo, cout = (int(s) for s in dy_shape)
    pixels = b * ho * wo
    return 2 * pixels * kh * kw * cin * cout, dtype.itemsize * (
        b * h * w * cin + pixels * cout + kh * kw * cin * cout)


def conv2d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
                       *, padding: Padding = NO_PADDING) -> torch.Tensor:
    """Plain version of the weight gradient, with the reference's
    arithmetic: zero-pad, then for each tap the float32 product
    ``window.T @ dy`` ([Cin, P] x [P, Cout]), rounded to ``x.dtype`` once."""
    _validate_wgrad(x, dy, kh, kw, padding)
    (pt, pb), (pl, pr) = padding
    b, _, _, cin = (int(s) for s in x.shape)
    _, ho, wo, cout = (int(s) for s in dy.shape)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    dyf = dy.float().reshape(b * ho * wo, cout)
    dw = torch.empty((kh, kw, cin, cout), dtype=torch.float32,
                     device=x.device)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + ho, j:j + wo, :].reshape(b * ho * wo, cin)
            dw[i, j] = win.T @ dyf
    return dw.to(x.dtype)


def wgrad_plan_for(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
                   padding: Padding = NO_PADDING) -> WgradPlan:
    """``plan_wgrad`` for these tensors, with the SM count of their card
    (``H100_SMS`` off the card)."""
    (pt, pb), (pl, pr) = padding
    return plan_wgrad(*(int(s) for s in x.shape), int(dy.shape[3]), kh, kw,
                      ((int(pt), int(pb)), (int(pl), int(pr))), x.dtype,
                      _sm_count(x.device) if x.device.type == "cuda"
                      else H100_SMS,
                      x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)


def conv2d_wgrad(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int, *,
                 padding: Padding = NO_PADDING) -> torch.Tensor:
    """dw [kh, kw, Cin, Cout] in ``x.dtype`` of the forward
    ``conv2d(x, w, padding=padding)`` given dy [B, H_out, W_out, Cout]:
    CUDA tensors launch the variant that ``plan_wgrad`` picks; CPU tensors
    take the plain version."""
    _validate_wgrad(x, dy, kh, kw, padding)
    cin, cout = int(x.shape[3]), int(dy.shape[3])
    with census.kernel_call(lambda: (
            wgrad_plan_for(x, dy, kh, kw, padding).variant,
            *wgrad_work(x.shape, dy.shape, kh, kw, x.dtype))):
        if x.device.type == "cpu":
            return conv2d_wgrad_plain(x, dy, kh, kw, padding=padding)
        b, ho, wo = int(x.shape[0]), int(dy.shape[1]), int(dy.shape[2])
        if b * ho * wo >= 2 ** 31:
            raise ValueError(f"B*H_out*W_out = {b * ho * wo} exceeds the "
                             "kernel's int range")
        p = wgrad_plan_for(x, dy, kh, kw, padding)
        if x.device.type == "meta":       # the census's shape-only route
            return torch.empty((kh, kw, cin, cout), dtype=x.dtype,
                               device=x.device)
        return wgrad_launch(x, dy, kh, kw, padding, p)


def wgrad_launch(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
                 padding: Padding, p: WgradPlan) -> torch.Tensor:
    """Launches plan ``p`` of the weight gradient on CUDA tensors that
    ``conv2d_wgrad`` has checked (or on a plan of another tile, to measure
    one against another); counts the launch under ``p.variant``."""
    b, h, wd, cin = (int(s) for s in x.shape)
    ho, wo, cout = int(dy.shape[1]), int(dy.shape[2]), int(dy.shape[3])
    dw = torch.empty((kh, kw, cin, cout), dtype=x.dtype, device=x.device)
    if p.variant == WG_TC and dw.data_ptr() % 16:
        raise ValueError("the weight gradient's output is not 16-byte "
                         "aligned")
    lib = _bwd_library()
    ws = (torch.empty((p.split, kh * kw * cin * cout), dtype=torch.float32,
                      device=x.device)
          if p.split > 1 else None)
    shape = (b, h, wd, cin, cout, kh, kw, int(padding[0][0]),
             int(padding[1][0]), ho, wo)
    ptrs = (x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            0 if ws is None else ws.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.variant == WG_TC:
        code = lib.conv2d_wgrad_bf16_tc(
            *ptrs, *shape, p.bm, p.bn, p.taps, *p.box, int(p.flat),
            p.stages, p.split, p.grid[0], p.grid[1], x.device.index, stream)
    else:
        code = getattr(lib, p.variant)(*ptrs, *shape, p.split, p.grid[0],
                                       p.grid[1], x.device.index, stream)
    BWD_LAUNCHES[p.variant] += 1
    if code != 0:
        msg = lib.conv2d_wgrad_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {p.variant} ({p}) failed: "
                           f"{msg} (cudaError {code})")
    return dw


class Conv2dK2(torch.autograd.Function):
    """K2 with its gradient: the forward ``conv2d`` saves x and w; the
    backward takes dy contiguous and computes dx (``conv2d_dgrad``) and dw
    (``conv2d_wgrad``) where ``needs_input_grad`` asks for them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, padding: Padding):
        ctx.padding = padding
        ctx.save_for_backward(x, w)
        return conv2d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dgrad(dy, w, padding=ctx.padding)
        if ctx.needs_input_grad[1]:
            dw = conv2d_wgrad(x, dy, int(w.shape[0]), int(w.shape[1]),
                              padding=ctx.padding)
        return dx, dw, None


def conv2d_trainable(x: torch.Tensor, w: torch.Tensor, *,
                     padding: Padding = NO_PADDING) -> torch.Tensor:
    """``conv2d`` under autograd: ``Conv2dK2``."""
    return Conv2dK2.apply(x, w, padding)
