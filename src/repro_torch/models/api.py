"""Per-family model API (the reference's ``models/api.py``).

``build_model(cfg)`` returns a ``Model`` whose ``init`` builds the network
as a ``torch.nn.Module`` on the requested device.  Ported so far: the CNN
family (ResNet-50 inference), the dense transformer family (prefill, KV
cache, decode) and the SSM family (Mamba2: chunked prefill, recurrent
decode).  ``prefill(module, batch)``, ``decode(module, batch,
cache)`` and ``init_cache(batch, max_len, device=...)`` mirror the
reference's serving entries (``None`` for the CNN, as there); the other
families raise ``NotImplementedError`` naming the roadmap item that brings
them.  Training (``loss``) is not ported: the kernels have no backward yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import mamba, resnet, transformer

# the serving families: (config check, module class, init_cache)
_SERVING = {"dense": (transformer.check_dense, transformer.Transformer,
                      transformer.init_cache),
            "ssm": (mamba.check_ssm, mamba.Mamba, mamba.init_cache)}

# the roadmap item that ports each family not ported yet
_NOT_PORTED = {"moe": "Queue 1 item 12e (MoE, MLA)",
               "vlm": "Queue 1 item 12e (the VLM prefix)",
               "hybrid": "Queue 1 item 12e (zamba)",
               "audio": "Queue 1 item 12e (whisper)"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., torch.nn.Module]   # (generator=None, device="cuda")
    prefill: Optional[Callable] = None     # (module, batch) -> (logits, cache)
    decode: Optional[Callable] = None      # (module, batch, cache) -> same
    init_cache: Optional[Callable] = None  # (batch, max_len, device) -> cache


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "cnn":
        def init(generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda") -> resnet.ResNet:
            return resnet.ResNet(cfg, generator=generator, device=device)

        return Model(cfg, init)
    if cfg.family in _SERVING:
        check, module, make_cache = _SERVING[cfg.family]
        check(cfg)

        def init(generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda") -> torch.nn.Module:
            return module(cfg, generator=generator, device=device)

        def init_cache(batch: int, max_len: int,
                       device: DeviceLike = "cuda"):
            return make_cache(cfg, batch, max_len, device)

        return Model(cfg, init,
                     prefill=lambda m, batch: m.prefill(batch["tokens"]),
                     decode=lambda m, batch, cache: m.decode_step(
                         batch["tokens"], cache),
                     init_cache=init_cache)
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        f"ROADMAP.md {_NOT_PORTED.get(cfg.family, 'Queue 1')}")
