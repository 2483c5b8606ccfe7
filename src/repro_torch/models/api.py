"""Per-family model API (the reference's ``models/api.py``).

``build_model(cfg)`` returns a ``Model`` whose ``init`` builds the network
as a ``torch.nn.Module`` on the requested device.  So far only the CNN
family (ResNet-50 inference) is ported; the other families raise
``NotImplementedError`` naming the roadmap item that brings them.  Training
(``loss``) is not ported either: the convolution kernel has no backward yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import resnet


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., torch.nn.Module]   # (generator=None, device="cuda")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "cnn":
        def init(generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda") -> resnet.ResNet:
            return resnet.ResNet(cfg, generator=generator, device=device)

        return Model(cfg, init)
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        "ROADMAP.md Queue 1 (dense transformer prefill with K3, mamba2 "
        "prefill with K4, then the rest of the workload side)")
