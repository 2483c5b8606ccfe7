"""ResNet-50 -- the paper's own CNN domain: inference and training.

The counterpart of the reference's ``models/resnet.py`` ``forward(params,
cfg, images, train=False)`` and ``loss_fn``: an NHWC bottleneck ResNet.
Activations stay NHWC and weights HWIO, as in the reference, so no layout
changes are needed between the two packages or inside the network.  Every
stride-1 convolution (each bottleneck's 1x1 ``conv1`` / ``conv3``, the
stride-1 3x3 ``conv2`` and the first projection: 46 of ResNet-50's 53) runs
on the hand-written kernel K2 through ``kernels.ops.conv2d`` -- in training
with K2's hand-written data- and weight-gradient kernels --; the stem and
the stride-2 convolutions go to the library convolution there.

Inference (``forward(images)``, under ``torch.no_grad``) normalises with
the stored ``mean`` / ``var``; training (``forward(images, train=True)``,
``loss_fn``) with the batch's mean and population variance, in float32, as
the reference's ``batchnorm(train=True)``.  As in the reference, ``mean``
and ``var`` are parameters (optimiser leaves whose gradient is zero in
training, so AdamW's weight decay shrinks ``var``) and no step updates them
from the batch statistics: the reference's train step has no running
update, whatever its module docstring says.

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots (``stage0_block0.conv1.conv``, ``bn_stem.mean``, ``fc.fc``), and its
parameters are registered in the order of the reference's leaves (sorted
keys at every level, ``jax.tree_util``'s order), so that the optimiser's
leaves and its global norm's sum run in the reference's order;
``params_from_reference`` carries a reference ``init_params`` pytree over
one leaf at a time.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

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
    """Batch norm over the channel axis with the reference's association,
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32, cast back to
    the input dtype (``nn.BatchNorm2d`` places eps and updates its
    statistics differently).  Inference takes the stored ``mean`` / ``var``;
    ``train=True`` the batch's mean and population variance over (B, H, W),
    in float32 (``jnp.mean`` / ``jnp.var``), and leaves the stored ones
    alone.  ``bias``, ``mean``, ``scale``, ``var``: the reference's leaf
    order."""

    def __init__(self, c: int, device: torch.device):
        super().__init__()
        self.bias = _frozen(torch.zeros(c, device=device))
        self.mean = _frozen(torch.zeros(c, device=device))
        self.scale = _frozen(torch.ones(c, device=device))
        self.var = _frozen(torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.square(xf - mean).mean(dim=(0, 1, 2))
        else:
            mean, var = self.mean, self.var
        out = (xf - mean) * torch.rsqrt(var + BN_EPS) * self.scale + self.bias
        return out.to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (carries the stride) -> 1x1 x4, with a projection
    shortcut where the stride or the width changes."""

    def __init__(self, cin: int, cmid: int, stride: int, dtype: torch.dtype,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        cout = cmid * 4
        kw = dict(dtype=dtype, generator=generator, device=device)
        # drawn in the reference's order, registered in its leaf order
        parts = {"conv1": Conv(1, 1, cin, cmid, 1, **kw),
                 "conv2": Conv(3, 3, cmid, cmid, stride, **kw),
                 "conv3": Conv(1, 1, cmid, cout, 1, **kw)}
        norms = {"bn1": cmid, "bn2": cmid, "bn3": cout}
        if stride != 1 or cin != cout:
            parts["proj"] = Conv(1, 1, cin, cout, stride, **kw)
            norms["bn_proj"] = cout
        parts.update({n: BatchNorm(c, device) for n, c in norms.items()})
        for name in sorted(parts):
            self.add_module(name, parts[name])
        if "proj" not in parts:
            self.proj: Optional[Conv] = None
            self.bn_proj: Optional[BatchNorm] = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.relu(self.bn2(self.conv2(h), train))
        h = self.bn3(self.conv3(h), train)
        if self.proj is not None:
            x = self.bn_proj(self.proj(x), train)
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
        # drawn in the reference's order, registered in its leaf order
        parts = {"stem": Conv(7, 7, 3, w, 2, **kw),
                 "bn_stem": BatchNorm(w, dev)}
        self.block_names: List[str] = []
        cin = w
        for s, n_blocks in enumerate(cfg.cnn_stages):
            cmid = w * (2 ** s)
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                name = f"stage{s}_block{b}"
                parts[name] = Bottleneck(cin, cmid, stride, **kw)
                self.block_names.append(name)
                cin = cmid * 4
        parts["fc"] = Dense(cin, cfg.vocab_size, **kw)
        for name in sorted(parts):
            self.add_module(name, parts[name])
        self.device = dev

    def forward(self, images, train: bool = False) -> torch.Tensor:
        """images [B, H, W, 3] (a tensor or an array, any float dtype) ->
        float32 logits [B, classes].  Inference (the default) runs under
        ``torch.no_grad`` with the stored batch-norm statistics; ``train``
        is differentiable and normalises with the batch's.  Training turns
        on ``torch.backends.cudnn.deterministic`` for the whole process:
        cuDNN's backward of the stride-2 convolutions is otherwise not
        repeatable, and a resumed run must equal a fresh one bit for
        bit."""
        if train:
            torch.backends.cudnn.deterministic = True
            return self._run(images, True)
        with torch.no_grad():
            return self._run(images, False)

    def _run(self, images, train: bool) -> torch.Tensor:
        x = torch.as_tensor(images, device=self.device).to(self.dtype)
        x = F.relu(self.bn_stem(self.stem(x), train))
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(1, 2))
        # the classifier product stays in cfg.dtype, as the reference's einsum
        return (x.to(self.dtype) @ self.fc.fc).float()


def loss_fn(model: ResNet, images, labels
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn``: the train-mode logits' mean NLL against
    ``labels`` [B] (``L.cross_entropy`` over one position a row), and the
    metrics ``{"nll"}``."""
    logits = model(images, train=True)
    labels = torch.as_tensor(labels, device=logits.device)
    loss = L.cross_entropy(logits[:, None, :], labels[:, None])
    return loss, {"nll": loss.detach()}


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> ResNet:
    """A ``ResNet`` holding the reference's ``init_params`` pytree
    ``params`` (nested dicts of arrays; any float dtype that numpy can cast
    to float32, bf16 included).  Every leaf must match one parameter by
    path and shape; each is cast to that parameter's dtype."""
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

