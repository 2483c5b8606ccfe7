"""Gradient compression: int8 blockwise + error feedback (the reference's
``optim/compression.py``).

``compress_decompress`` is the quantize round trip a compressed all-reduce
would carry; ``compressed_grads_with_feedback`` sends Q(g + e) and carries
the residual e' = (g + e) - Q(g + e) to the next step.  Both work over a
flat list of tensors.  The reference's ``crosspod_compressed_psum`` (a
``shard_map`` over a pod mesh axis) needs more than one card and is not
ported (ROADMAP.md, with ``models/dist.py`` / ``sharding.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

BLOCK = 256


def _blockwise_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True),
                            1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _blockwise_dequant(q: torch.Tensor, scale: torch.Tensor,
                       shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Quantize round trip (what the wire would carry), in float32."""
    q, s = _blockwise_quant(x.float())
    return _blockwise_dequant(q, s, tuple(x.shape))


def init_residual(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in grads]


def compressed_grads_with_feedback(grads: Sequence[torch.Tensor],
                                   residual: Sequence[torch.Tensor]
                                   ) -> Tuple[list, list]:
    """Error-feedback compression: send Q(g + e) in g's dtype; carry
    e' = (g + e) - Q(g + e) in float32."""
    sent, new_e = [], []
    for g, e in zip(grads, residual):
        target = g.float() + e
        out = compress_decompress(target)
        sent.append(out.to(g.dtype))
        new_e.append(target - out)
    return sent, new_e
