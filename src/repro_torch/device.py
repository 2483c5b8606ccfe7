"""Device / dtype resolution, done once per entry point.

``resolve_device("cuda")`` raises when there is no CUDA device: the port's
entry points default to the card and never degrade to the CPU on their own.
The CPU is used only when the caller names it (``device="cpu"``), which is
what the parity tests do; kernels' plain PyTorch versions run there.  The
meta device (shapes and dtypes, no storage) is accepted only where the
caller asks for it (``allow_meta=True``): the models' constructors and
caches, so that the workload census (``launch.lowering.lower_cell``) traces a
step without a card and without memory.  Campaign, serving and training
entry points resolve with the default and refuse it.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

DeviceLike = Union[str, torch.device]
DtypeLike = Union[str, torch.dtype]

DEFAULT_DEVICE = "cuda"

# the two precision tiers of the cost model
_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def resolve_device(device: DeviceLike = DEFAULT_DEVICE, *,
                   allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.  ``"meta"``
    is refused unless ``allow_meta``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is false; pass device='cpu' "
                "explicitly to run the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(device)!r} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
    elif dev.type == "meta" and not allow_meta:
        raise ValueError(f"device {str(device)!r}: the meta device is taken "
                         "only by the workload census (models built for "
                         "launch.lowering.lower_cell); expected 'cuda' or "
                         "'cpu'")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device type {dev.type!r}; "
                         "expected 'cuda' or 'cpu'")
    return dev


def resolve_dtype(dtype: DtypeLike = torch.float64) -> torch.dtype:
    """``dtype`` as one of the two supported tiers (float64 / float32)."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                             f"{sorted(_DTYPES)}")
        return _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"unsupported dtype {dtype}; expected "
                         "torch.float64 or torch.float32")
    return dtype


def dtype_name(dtype: DtypeLike) -> str:
    """``"float64"`` / ``"float32"`` — the JSON form of a tier's dtype."""
    dt = resolve_dtype(dtype)
    return next(k for k, v in _DTYPES.items() if v is dt)


def resolve(device: DeviceLike = DEFAULT_DEVICE,
            dtype: DtypeLike = torch.float64
            ) -> Tuple[torch.device, torch.dtype]:
    """``(device, dtype)`` resolved together (one call per entry point)."""
    return resolve_device(device), resolve_dtype(dtype)
