"""Helpers the models share (counterparts of the reference's
``models/layers.py`` functions of the same names)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    """The ``torch.dtype`` named by ``cfg.dtype`` (``"bfloat16"`` ...)."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported model dtype {cfg.dtype!r}; expected "
                         f"one of {sorted(_DTYPES)}") from None


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               dtype: torch.dtype, scale: float = 0.02) -> torch.Tensor:
    """Normal(0, ``scale``) drawn in float32 on the generator's device, then
    cast to ``dtype`` (the reference's association)."""
    dev = generator.device if generator is not None else None
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=dev)
    return (w * scale).to(dtype)
