"""ResNet-50 inference -- the paper's own CNN domain.

The counterpart of the reference's ``models/resnet.py`` ``forward(params,
cfg, images, train=False)``: an NHWC bottleneck ResNet whose batch norm uses
the stored running statistics.  Activations stay NHWC and weights HWIO, as
in the reference, so no layout changes are needed between the two packages
or inside the network.  Every stride-1 convolution (each bottleneck's 1x1
``conv1`` / ``conv3``, the stride-1 3x3 ``conv2`` and the first projection:
46 of ResNet-50's 53) runs on the hand-written kernel K2 through
``kernels.ops.conv2d``; the stem and the stride-2 convolutions go to the
library convolution there.  Inference only: K2 has no backward kernel yet,
so the parameters do not require gradients and ``forward`` runs under
``torch.no_grad``.

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots (``stage0_block0.conv1.conv``, ``bn_stem.mean``, ``fc.fc``), so
``params_from_reference`` carries a reference ``init_params`` pytree over
one leaf at a time.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L

BN_EPS = 1e-5

def _conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
               cout: int, dtype: torch.dtype) -> torch.Tensor:
    """He-normal HWIO weight, drawn in float32 and cast (the reference's
    association)."""
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Conv(nn.Module):
    """One convolution: HWIO weight ``conv``, SAME padding."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, stride: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.stride = stride
        self.conv = _frozen(_conv_init(generator, kh, kw, cin, cout,
                                       dtype).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv2d(x, self.conv, stride=self.stride, padding="SAME")


class BatchNorm(nn.Module):
    """Inference batch norm over the channel axis with the reference's
    association, ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32,
    cast back to the input dtype (``nn.BatchNorm2d`` places eps and updates
    its statistics differently)."""

    def __init__(self, c: int, device: torch.device):
        super().__init__()
        self.scale = _frozen(torch.ones(c, device=device))
        self.bias = _frozen(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = ((x.float() - self.mean) * torch.rsqrt(self.var + BN_EPS)
               * self.scale + self.bias)
        return out.to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (carries the stride) -> 1x1 x4, with a projection
    shortcut where the stride or the width changes."""

    def __init__(self, cin: int, cmid: int, stride: int, dtype: torch.dtype,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        cout = cmid * 4
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.conv1 = Conv(1, 1, cin, cmid, 1, **kw)
        self.bn1 = BatchNorm(cmid, device)
        self.conv2 = Conv(3, 3, cmid, cmid, stride, **kw)
        self.bn2 = BatchNorm(cmid, device)
        self.conv3 = Conv(1, 1, cmid, cout, 1, **kw)
        self.bn3 = BatchNorm(cout, device)
        self.proj: Optional[Conv] = None
        self.bn_proj: Optional[BatchNorm] = None
        if stride != 1 or cin != cout:
            self.proj = Conv(1, 1, cin, cout, stride, **kw)
            self.bn_proj = BatchNorm(cout, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.proj is not None:
            x = self.bn_proj(self.proj(x))
        return F.relu(x + h)


class Dense(nn.Module):
    """The classifier matrix ``fc`` [features, classes]."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        self.fc = _frozen(L.dense_init(generator, (cin, cout),
                                       dtype).to(device))


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``reduce_window(max, SAME)`` of the reference on NHWC: JAX's SAME
    padding with ``-inf`` (asymmetric at stride 2: 112 -> (0, 1)), then an
    unpadded max pool."""
    pt, pb = ops.same_pads(int(x.shape[1]), window, stride)
    pl, pr = ops.same_pads(int(x.shape[2]), window, stride)
    x = F.pad(x, (0, 0, pl, pr, pt, pb), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).contiguous()


class ResNet(nn.Module):
    """Bottleneck ResNet of ``cfg`` (``cnn_stages``, ``cnn_width``,
    ``vocab_size`` classes, ``cfg.dtype`` weights and activations).

    Weights are He-normal (the classifier normal(0, 0.02)) from
    ``generator`` -- a seeded ``torch.Generator``, drawn on its own device
    and moved to ``device`` -- and batch norm starts at the identity, as the
    reference's ``init_params`` does; the numbers differ from the
    reference's, which come from ``jax.random``.  ``device`` defaults to the
    card and raises without one.  Building a float32 ResNet turns off
    ``torch.backends.cudnn.allow_tf32`` for the whole process."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.family != "cnn":
            raise ValueError(f"{cfg.name} is not a CNN (family "
                             f"{cfg.family!r})")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = L.dtype_of(cfg)
        if self.dtype == torch.float32:
            # the reference convolves float32 in IEEE float32; PyTorch lets
            # cuDNN use TF32 for it unless this process-wide flag is off
            torch.backends.cudnn.allow_tf32 = False
        kw = dict(dtype=self.dtype, generator=generator, device=dev)
        w = cfg.cnn_width
        self.stem = Conv(7, 7, 3, w, 2, **kw)
        self.bn_stem = BatchNorm(w, dev)
        self.block_names: List[str] = []
        cin = w
        for s, n_blocks in enumerate(cfg.cnn_stages):
            cmid = w * (2 ** s)
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                name = f"stage{s}_block{b}"
                self.add_module(name, Bottleneck(cin, cmid, stride, **kw))
                self.block_names.append(name)
                cin = cmid * 4
        self.fc = Dense(cin, cfg.vocab_size, **kw)

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> float32 logits [B, classes]."""
        x = images.to(self.dtype)
        x = F.relu(self.bn_stem(self.stem(x)))
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.float().mean(dim=(1, 2))
        # the classifier product stays in cfg.dtype, as the reference's einsum
        return (x.to(self.dtype) @ self.fc.fc).float()


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> ResNet:
    """A ``ResNet`` holding the reference's ``init_params`` pytree
    ``params`` (nested dicts of arrays; any float dtype that numpy can cast
    to float32, bf16 included).  Every leaf must match one parameter or
    batch-norm buffer by path and shape; each is cast to that tensor's
    dtype."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, path)
            else:
                flat[path] = np.array(v, dtype=np.float32)

    walk(params, "")
    model = ResNet(cfg, device=device)
    state = model.state_dict()
    if set(flat) != set(state):
        raise ValueError(f"reference params do not match the module: only "
                         f"reference {sorted(set(flat) - set(state))[:4]}, "
                         f"only module {sorted(set(state) - set(flat))[:4]}")
    for key, target in state.items():
        if tuple(flat[key].shape) != tuple(target.shape):
            raise ValueError(f"{key}: reference shape {flat[key].shape}, "
                             f"module shape {tuple(target.shape)}")
        target.copy_(torch.from_numpy(flat[key]).to(target.dtype))
    return model

