"""Optimizers with one interface (the reference's ``optim/__init__.py``).

``make_optimizer(name, lr, total_steps)`` returns an ``Optimizer``:
``init(params, groups=None)`` makes the state and ``apply(params, grads,
state)`` returns ``(params, state, metrics)``; ``params`` and ``grads`` are
flat lists of tensors in the order ``named_parameters()`` gives, and
parameters and moments are updated in place.  ``groups`` (a list of
``Group``) maps the tensors onto the reference's leaves -- one state leaf a
group, a stacked group's the [L, ...] leaf of its layers
(``models.api.leaf_groups`` makes them from parameter names); without it
every tensor is a leaf of its own.  The state keeps its groups, and
``apply`` raises if the tensors it is given do not fit them.  The reference's ``specs`` member (a JAX
sharding tree) is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.optim import adafactor as _af
from repro_torch.optim import adamw as _aw
from repro_torch.optim.adafactor import (AdafactorConfig,  # noqa: F401
                                         AdafactorState, FactoredV)
from repro_torch.optim.adamw import (AdamWConfig, Group,  # noqa: F401
                                     OptState, dequantize_i8, global_norm,
                                     per_tensor, quantize_i8, warmup_cosine)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    config: object
    init: Callable          # (params, groups=None) -> state
    apply: Callable         # (params, grads, state) -> (params, state,
    #                         metrics)


def make_optimizer(name: str, lr: float = 3e-4,
                   total_steps: int = 10000) -> Optimizer:
    if name == "adafactor":
        cfg = _af.make_adafactor(lr, total_steps)
        return Optimizer(
            name, cfg, lambda p, groups=None: _af.init_state(p, cfg, groups),
            lambda p, g, s: _af.apply_adafactor(p, g, s, cfg))
    cfg = _aw.make_optimizer(name, lr, total_steps)
    return Optimizer(
        name, cfg, lambda p, groups=None: _aw.init_opt_state(p, cfg, groups),
        lambda p, g, s: _aw.apply_adamw(p, g, s, cfg))
