"""Adafactor with momentum (the reference's ``optim/adafactor.py``).

The second moment of a tensor of two or more dimensions whose two trailing
dimensions are both at least ``min_dim_factor`` is FACTORED into row and
column statistics (``FactoredV``: r, the mean over the last dimension; c,
the mean over the second-to-last), which drop the reduced dimension as in
the reference.  Like ``adamw``, it works over a flat list of tensors,
updates parameters and moments in place and keeps one state leaf a group
(``adamw.Group``).  The update clip (RMS(u) <= 1) is taken over each leaf,
as the reference's: a stacked group's is the RMS over all its layers, the
reference's [L, ...] leaf.  The reference's
``state_specs`` / ``factored_spec`` are JAX partition specs and have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.optim.adamw import (Group, check_groups, clip_factor,
                                     global_norm, leaf_of, leaf_shapes, lr_at,
                                     per_tensor, sqrt, warmup_cosine,
                                     write_back)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: Union[Callable, float] = 3e-4
    b1: float = 0.9                  # momentum (bf16)
    decay: float = 0.99              # running second-moment decay
    eps: float = 1e-30
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    min_dim_factor: int = 128
    moment_dtype: str = "bfloat16"


class FactoredV(NamedTuple):
    r: torch.Tensor   # [..., d_in]  (mean over the last dim)
    c: torch.Tensor   # [..., d_out] (mean over the second-to-last dim)


class AdafactorState(NamedTuple):
    step: int
    m: list
    v: list           # per leaf: FactoredV or a full float32 tensor
    groups: Tuple[Group, ...]    # the leaves over the parameters


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def factorable(shape, cfg: AdafactorConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_factor
            and shape[-2] >= cfg.min_dim_factor)


def init_state(params: Sequence[torch.Tensor], cfg: AdafactorConfig,
               groups: Optional[Sequence[Group]] = None) -> AdafactorState:
    """Zero moments, one leaf a group (default: a tensor); the state keeps
    the groups."""
    def mk_v(shape, dev):
        if factorable(shape, cfg):
            return FactoredV(
                r=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                c=torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                              device=dev))
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    groups = tuple(per_tensor(len(params)) if groups is None else groups)
    shapes = leaf_shapes(params, groups)
    m = [torch.zeros(s, dtype=_MOMENT_DTYPES[cfg.moment_dtype], device=d)
         for s, d in shapes]
    return AdafactorState(step=0, m=m, v=[mk_v(s, d) for s, d in shapes],
                          groups=groups)


@torch.no_grad()
def apply_adafactor(params: List[torch.Tensor],
                    grads: Sequence[torch.Tensor], state: AdafactorState,
                    cfg: AdafactorConfig):
    """One Adafactor step over ``params`` (updated in place, as are the
    moments), one leaf a group of the state's ``groups``; returns (params,
    new state, metrics)."""
    check_groups(state.groups, len(state.m), params, grads)
    gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_at(cfg.lr, step)
    d = cfg.decay
    new_v = []
    # each float32 temporary is dropped as soon as it is used, and the
    # parameter's update runs in place: a stacked leaf of deepseek's
    # experts is 1.26 G elements, 5 GB a float32 copy; the arithmetic is
    # the same operations in the same order
    for grp, m, v in zip(state.groups, state.m, state.v):
        p, g = leaf_of(params, grp), leaf_of(grads, grp)
        g = g.float() * clip_factor(gnorm, cfg.grad_clip).to(p.device)
        g2 = g * g + cfg.eps
        if isinstance(v, FactoredV):
            r = d * v.r + (1 - d) * torch.mean(g2, dim=-1)
            c = d * v.c + (1 - d) * torch.mean(g2, dim=-2)
            del g2
            # rank-1 reconstruction: v_ij ~ r_i * c_j / mean(r)
            denom = torch.clamp_min(torch.mean(r, dim=-1, keepdim=True),
                                    cfg.eps)
            vhat = (r[..., :, None] * c[..., None, :]) / denom[..., None]
            v.r.copy_(r)
            v.c.copy_(c)
        else:
            vhat = d * v + (1 - d) * g2
            del g2
            v.copy_(vhat)
        new_v.append(v)
        u = g / sqrt(vhat + cfg.eps)
        del g, vhat
        # Adafactor update clipping (RMS(u) <= 1)
        rms_u = sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        m_f = cfg.b1 * m.float() + (1 - cfg.b1) * u
        del u
        pf = p.float()
        step_ = m_f + cfg.weight_decay * pf
        p.copy_(pf.sub_(step_.mul_(lr.to(p.device))))
        del pf, step_
        write_back(params, grp, p)
        m.copy_(m_f)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdafactorState(step, state.m, new_v, state.groups), metrics


def make_adafactor(lr: float = 3e-4,
                   total_steps: int = 10000) -> AdafactorConfig:
    return AdafactorConfig(lr=warmup_cosine(lr, min(500, total_steps // 10 + 1),
                                            total_steps))
