"""Optimizers with one interface (the reference's ``optim/__init__.py``).

``make_optimizer(name, lr, total_steps)`` returns an ``Optimizer``:
``init(params)`` makes the state and ``apply(params, grads, state)``
returns ``(params, state, metrics)``; ``params`` and ``grads`` are flat
lists of tensors in the order ``named_parameters()`` gives, and parameters
and moments are updated in place.  The reference's ``specs`` member (a JAX
sharding tree) is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.optim import adafactor as _af
from repro_torch.optim import adamw as _aw
from repro_torch.optim.adafactor import (AdafactorConfig,  # noqa: F401
                                         AdafactorState, FactoredV)
from repro_torch.optim.adamw import (AdamWConfig, OptState,  # noqa: F401
                                     dequantize_i8, global_norm, quantize_i8,
                                     warmup_cosine)

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    config: object
    init: Callable          # params -> state
    apply: Callable         # (params, grads, state) -> (params, state, metrics)


def make_optimizer(name: str, lr: float = 3e-4,
                   total_steps: int = 10000) -> Optimizer:
    if name == "adafactor":
        cfg = _af.make_adafactor(lr, total_steps)
        return Optimizer(name, cfg, lambda p: _af.init_state(p, cfg),
                         lambda p, g, s: _af.apply_adafactor(p, g, s, cfg))
    cfg = _aw.make_optimizer(name, lr, total_steps)
    return Optimizer(name, cfg, lambda p: _aw.init_opt_state(p, cfg),
                     lambda p, g, s: _aw.apply_adamw(p, g, s, cfg))
