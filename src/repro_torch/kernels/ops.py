"""Public entry points of the port's kernels (the reference's
``kernels/ops.py``).

``dse_sweep`` is what ``TileEvaluator.sweep_reduced`` calls per tile: on a
card, one launch of the fused sweep-screen-compaction kernel, one copy of
its packed result to the host and one synchronisation (tiles past the fused
kernel's shared memory take the sweep kernel, the screen kernel and the
compaction in turn), returning the host-side ``SweepReduced``.
``conv2d`` is what the models call for a convolution: stride 1 goes to the
hand-written kernel K2 with the reference's SAME padding, differentiable
(K2's hand-written data- and weight-gradient kernels) where autograd
records, any other stride to the library convolution with JAX's SAME
padding written out.  ``flash_attention`` is what the transformer calls for
prefill attention: the hand-written kernel K3, in the reference's BSHD
layout, GQA without repeating K / V, differentiable (K3's backward
kernels) where autograd records.  ``ssd_scan`` is what the Mamba2
block calls for its chunked scan: the hand-written kernel K4, returning
the output and the final state, differentiable (K4's backward kernels)
where autograd records.  With CUDA tensors the hand-written
kernels run (or the call raises); with CPU tensors their plain versions do
— the device of the inputs alone decides, there is no switch and no
fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import costmodel
from repro_torch.kernels import conv2d as _k2
from repro_torch.kernels import dse_sweep as _k
from repro_torch.kernels import flash_attention as _k3
from repro_torch.kernels import ssd_scan as _k4
from repro_torch.kernels.dse_sweep import (CAND_COLS, launch_counts,
                                           reset_launch_counts)

__all__ = ["CAND_COLS", "conv2d", "dse_sweep", "flash_attention",
           "launch_counts", "reset_launch_counts", "same_pads", "ssd_scan"]


def dse_sweep(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
              sim: costmodel.SimConfig = costmodel.SimConfig(),
              constraint=None, max_survivors: int = 2048,
              host_buffer: Optional[_k.ResultBuffer] = None
              ) -> costmodel.SweepReduced:
    """Fused on-device campaign evaluator.

    Evaluates all workload rows of ``wl_cols`` against the packed candidate
    tile ``cand_cols`` (padding lanes carry ``valid = 0``) and reduces each
    row to its screen survivors + frontier-accounting aggregates.
    ``constraint`` duck-types ``dse.Constraint`` (``max_power_w`` /
    ``max_latency_s`` / ``min_hbm_fit``).  The tensors' dtype is the
    precision tier: float64 frontiers hold the exact tier's candidate set,
    float32 is the fast tier.  ``host_buffer``, a ``ResultBuffer`` the
    caller reuses, takes the packed result on the host (the returned arrays
    are views into it, valid until its next use).
    """
    kw = dict(max_power_w=None, max_latency_s=None, min_hbm_fit=True)
    if constraint is not None:
        kw = dict(max_power_w=constraint.max_power_w,
                  max_latency_s=constraint.max_latency_s,
                  min_hbm_fit=constraint.min_hbm_fit)
    return _k.sweep_reduce(cand_cols, wl_cols, sim=sim, **kw,
                           max_survivors=int(max_survivors),
                           host_buffer=host_buffer)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial axis under JAX's ``"SAME"``:
    output ``ceil(size / stride)``, the total split with the odd element
    AFTER.  For stride 2 that is asymmetric (224, k=7 -> (2, 3); 56, k=3 ->
    (0, 1)), which a symmetric ``padding=`` argument of PyTorch cannot say."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC x HWIO -> NHWC convolution, ``padding`` ``"SAME"`` or
    ``"VALID"``.  Stride 1 runs on the hand-written kernel K2 (its plain
    version for CPU tensors), SAME padded ``(kh//2, (kh-1)//2)`` as the
    reference's ``ops.conv2d`` pads.  Any other stride -- ResNet's 7x7 stem
    and its stride-2 3x3 and 1x1 convolutions -- goes to the library
    convolution, as in the reference, with JAX's SAME padding applied by
    ``F.pad`` first.  A float32 library convolution runs in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is off, as a float32 ``ResNet``
    sets it.  Where autograd records (gradients on and an input that
    requires them) a stride-1 call goes through ``conv2d.Conv2dK2``, K2
    with its hand-written backward; the library convolution keeps its own
    autograd."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin] and w [kh, kw, Cin, "
                         f"Cout]; got {tuple(x.shape)} and {tuple(w.shape)}")
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if stride == 1:
        pads = _k2.NO_PADDING
        if padding == "SAME":
            pads = ((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2))
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _k2.conv2d_trainable(x, w, padding=pads)
        return _k2.conv2d(x, w, padding=pads)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if padding == "SAME":
        (pt, pb) = same_pads(int(x.shape[1]), kh, stride)
        (pl, pr) = same_pads(int(x.shape[2]), kw, stride)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, Sk, KV, hd | hv] -> [B, S, H, hv] in
    ``q.dtype``, on the hand-written kernel K3 (its plain version for CPU
    tensors).  Unlike the reference's ``ops.flash_attention`` nothing is
    transposed to [B*H, S, hd] and K / V are not repeated for GQA: the
    kernel reads the kv head ``h // (H // KV)`` in place.  ``scale``
    defaults to ``hd ** -0.5``; any ``S`` works, and the key length ``Sk``
    may differ from ``S`` when not ``causal``.  ``prefix_len`` P opens a
    bidirectional prefix in the causal mask (key ``j`` visible to row ``i``
    where ``j <= i`` or ``j < P``: the reference's ``layers._block_mask``,
    PaliGemma's image patches); it needs ``causal`` and ``Sk == S``.  Where
    autograd records (gradients on and an input that requires them) the
    call goes through ``FlashAttention``, K3 with its hand-written backward
    (``hd == hv`` in 64, 128, 256, or (192, 128), on the card); otherwise
    -- prefill, decode -- straight to K3."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _k3.flash_attention_trainable(q, k, v, causal=causal,
                                             prefix_len=prefix_len,
                                             scale=scale)
    return _k3.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len,
                               scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan, ``ngroups == 1``: x [b, S, nh, hp], dt [b, S, nh]
    and A [nh] float32, B / C [b, S, 1, ds] -> ``(y`` [b, S, nh, hp] in
    ``out_dtype`` (default ``x.dtype``), the final state [b, nh, hp, ds]
    float32``)``, on the hand-written kernel K4 (its plain version for CPU
    tensors).  Unlike the reference's ``ops.ssd_scan`` it also returns the
    final state, and nothing is transposed: K4 reads x and B / C (column
    slices of one tensor included) in place, the model's always (a view
    whose base or strides lie off 16 bytes is copied first at the model's
    shapes).  Where autograd records (gradients on and an input that
    requires them) the call goes through ``SSDScan``, K4 with its
    hand-written backward; otherwise -- prefill -- straight to K4."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        return _k4.SSDScan.apply(x, dt, A, B, C, int(chunk), out_dtype)
    return _k4.ssd_scan(x, dt, A, B, C, chunk=chunk, out_dtype=out_dtype)
