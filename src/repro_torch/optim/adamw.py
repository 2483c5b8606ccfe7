"""AdamW with optional int8 block-quantized moments, schedules, clipping
(the reference's ``optim/adamw.py``).

The optimiser works over a flat list of tensors -- a module's parameters in
the order ``named_parameters()`` gives -- and updates parameters and moments
IN PLACE under ``torch.no_grad()`` (the reference returns new pytrees).  The
arithmetic is the reference's, operation for operation, in float32: the
gradient clipped by the global norm, the moments updated, bias-corrected,
weight decay added, the parameter cast back to its own dtype.

``adamw8bit`` stores both moments as int8 with one float32 scale a block of
256 (``quantize_i8``), v in the square-root domain; each moment leaf is the
reference's dict ``{"q", "scale", "shape", "n"}``.

State leaves follow ``groups`` (``Group``): one leaf a group of tensors.  A
stacked group holds the layers of one reference leaf -- the port keeps a
[L, ...] stack as L per-layer tensors, ``layers.<i>.<rest>`` -- and its
moments are one [L, ...] leaf, as the reference's are: the int8 blocks run
across layer boundaries exactly where the reference's do, and a group's
update is the reference's update of the stacked leaf.  Without ``groups``
every tensor is a group of its own (``per_tensor``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch

BLOCK = 256


# --- groups: the reference's leaves over the port's tensors ----------------------

@dataclasses.dataclass(frozen=True)
class Group:
    """One optimiser leaf: the indices of its tensors in the flat parameter
    list and whether they are the layers of one stacked [L, ...] leaf (in
    layer order, one shape and dtype) or a single tensor of its own.  A
    layout, not state: no walk over a state's tuples (``state_bytes``)
    counts it."""
    members: Tuple[int, ...]
    stacked: bool


def per_tensor(n: int) -> List[Group]:
    """The default: every one of ``n`` tensors a leaf of its own."""
    return [Group((i,), False) for i in range(n)]


def leaf_of(tensors: Sequence[torch.Tensor], g: Group) -> torch.Tensor:
    """The group's leaf: its tensor, or its members stacked [L, ...] (a
    copy)."""
    if g.stacked:
        return torch.stack([tensors[i] for i in g.members])
    return tensors[g.members[0]]


def write_back(params: Sequence[torch.Tensor], g: Group,
               leaf: torch.Tensor) -> None:
    """Copies a stacked leaf updated in place back into its members (a
    single tensor's leaf is the tensor itself)."""
    if g.stacked:
        for k, i in enumerate(g.members):
            params[i].copy_(leaf[k])


def leaf_shapes(params: Sequence[torch.Tensor], groups: Sequence[Group]
                ) -> List[Tuple[Tuple[int, ...], torch.device]]:
    """(shape, device) of each group's leaf; raises on a stacked group whose
    members differ in shape, dtype or device."""
    out = []
    for g in groups:
        first = params[g.members[0]]
        if g.stacked:
            for i in g.members[1:]:
                p = params[i]
                if (p.shape, p.dtype, p.device) != (first.shape, first.dtype,
                                                    first.device):
                    raise ValueError(f"group {g.members}: tensors of "
                                     f"{tuple(first.shape)} {first.dtype} "
                                     f"and {tuple(p.shape)} {p.dtype}")
            out.append(((len(g.members),) + tuple(first.shape),
                        first.device))
        else:
            out.append((tuple(first.shape), first.device))
    return out


# --- int8 block quantization -------------------------------------------------------

def quantize_i8(x: torch.Tensor) -> dict:
    """``x`` in float32, flattened and zero-padded to whole blocks of
    ``BLOCK``; each block scaled by max |x| / 127 (at least 1e-12) and
    rounded half to even (``jnp.round``'s rule, ``torch.round``'s too) into
    [-127, 127]."""
    flat = x.detach().float().reshape(-1)
    n = flat.numel()
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale, "shape": tuple(x.shape), "n": n}


def dequantize_i8(qs: dict) -> torch.Tensor:
    flat = (qs["q"].float() * qs["scale"]).reshape(-1)
    return flat[: qs["n"]].reshape(qs["shape"])


def is_moment_leaf(x) -> bool:
    """Whether ``x`` is an int8 moment (``quantize_i8``'s dict)."""
    return isinstance(x, dict) and set(x) == {"q", "scale", "shape", "n"}


# --- schedules -----------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable[[int], torch.Tensor]:
    """The reference's schedule in float32: linear warm-up to ``base_lr``
    over ``warmup`` steps, then cosine down to ``min_frac * base_lr`` at
    ``total``.  Returns a 0-d float32 tensor on the CPU."""
    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return sched


# --- AdamW -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable, float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False      # int8 block-quantized
    moment_dtype: str = "float32"       # "bfloat16" halves optimizer state


def check_groups(groups: Sequence[Group], n_leaves: int,
                 params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor]) -> None:
    """Raises unless the state's ``groups`` have ``n_leaves`` moment leaves
    and their members are the indices of ``params`` and ``grads``."""
    members = sorted(i for g in groups for i in g.members)
    if len(groups) != n_leaves or members != list(range(len(params))) \
            or len(grads) != len(params):
        raise ValueError(f"optimiser state of {n_leaves} leaves over "
                         f"{len(groups)} groups of {len(members)} tensors; "
                         f"given {len(params)} parameters, {len(grads)} "
                         "gradients")


class OptState(NamedTuple):
    step: int            # updates taken (the reference's int32 scalar)
    m: list              # one moment a leaf, in the groups' order
    v: list
    groups: Tuple[Group, ...]    # the leaves over the parameters


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _zeros_moment(shape, device, cfg: AdamWConfig):
    z = torch.zeros(shape, dtype=_MOMENT_DTYPES[cfg.moment_dtype],
                    device=device)
    return quantize_i8(z) if cfg.quantize_moments else z


def init_opt_state(params: Sequence[torch.Tensor], cfg: AdamWConfig,
                   groups: Optional[Sequence[Group]] = None) -> OptState:
    """Zero moments, one leaf a group (default: a tensor); the state keeps
    the groups."""
    groups = tuple(per_tensor(len(params)) if groups is None else groups)
    shapes = leaf_shapes(params, groups)
    return OptState(step=0,
                    m=[_zeros_moment(s, d, cfg) for s, d in shapes],
                    v=[_zeros_moment(s, d, cfg) for s, d in shapes],
                    groups=groups)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's, and CUDA's
    ``torch.sqrt``): PyTorch's vectorized CPU ``torch.sqrt`` is one ulp off
    on about 0.7 % of float32 inputs, so on the CPU the root is taken in
    float64 and rounded once, which is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors (in order) of each one's sum of squares
    in float32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tensors)
    return sqrt(sq)


def clip_factor(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    return torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)


def lr_at(cfg_lr, step: int) -> torch.Tensor:
    """The learning rate of update ``step`` (1-based) as a 0-d float32
    tensor on the CPU."""
    lr = cfg_lr(step) if callable(cfg_lr) else cfg_lr
    return torch.as_tensor(lr, dtype=torch.float32)


@torch.no_grad()
def apply_adamw(params: List[torch.Tensor], grads: Sequence[torch.Tensor],
                state: OptState, cfg: AdamWConfig):
    """One AdamW step over ``params`` (updated in place, as are the
    moments), one leaf a group of the state's ``groups``; returns (params,
    new state, metrics)."""
    check_groups(state.groups, len(state.m), params, grads)
    gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_at(cfg.lr, step)
    step_f = torch.tensor(step, dtype=torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), step_f)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), step_f)
    on = {}                       # the scalars on each parameter's device

    def scalars(dev):
        if dev not in on:
            on[dev] = (clip_factor(gnorm, cfg.grad_clip).to(dev), lr.to(dev),
                       b1c.to(dev), b2c.to(dev))
        return on[dev]

    def update(p, g, m_f, v_f):
        """p updated in place from float32 moments; returns the new ones."""
        clip, lr_d, b1c_d, b2c_d = scalars(p.device)
        g = g.float() * clip
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        upd = (m_f / b1c_d) / (sqrt(v_f / b2c_d) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr_d * (upd + cfg.weight_decay * pf))
        return m_f, v_f

    new_m, new_v = [], []
    for grp, m, v in zip(state.groups, state.m, state.v):
        if cfg.quantize_moments:
            # the int8 blocks run over the whole leaf: update it stacked
            p = leaf_of(params, grp)
            m_f, v_f = update(p, leaf_of(grads, grp), dequantize_i8(m),
                              torch.square(dequantize_i8(v)))  # v: sqrt
            write_back(params, grp, p)
            new_m.append(quantize_i8(m_f))
            new_v.append(quantize_i8(sqrt(v_f)))
            continue
        # float moments: each tensor against its slice of the leaf (the
        # same element operations, and no stacked copies)
        for k, i in enumerate(grp.members):
            mk, vk = (m[k], v[k]) if grp.stacked else (m, v)
            m_f, v_f = update(params[i], grads[i], mk.float(), vk.float())
            mk.copy_(m_f)
            vk.copy_(v_f)
        new_m.append(m)
        new_v.append(v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, new_m, new_v, state.groups), metrics


def make_optimizer(name: str, lr: float = 3e-4,
                   total_steps: int = 10000) -> AdamWConfig:
    sched = warmup_cosine(lr, warmup=min(500, total_steps // 10 + 1),
                          total=total_steps)
    if name == "adamw8bit":
        return AdamWConfig(lr=sched, quantize_moments=True)
    if name in ("adamw_bf16", "adamw_lowmem"):
        return AdamWConfig(lr=sched, moment_dtype="bfloat16")
    return AdamWConfig(lr=sched)
