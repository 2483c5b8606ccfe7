"""PyTorch / CUDA port of the design-space-exploration stack.

The package mirrors ``repro`` module for module (same sub-package and
function names, so a reader finds the counterpart), written against
``torch`` tensors instead of ``jax`` arrays, with the fused campaign sweep
and ResNet-50's stride-1 convolutions carried by hand-written CUDA kernels
(``repro_torch.kernels``).  It imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro``; the two packages meet in the parity tests
alone.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
``dtype``; there is no environment override and no silent landing on the
CPU: asking for the card without one raises (``repro_torch.device``).
"""

from repro_torch.device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
