"""Per-family model API (the reference's ``models/api.py``).

``build_model(cfg)`` returns a ``Model`` whose ``init`` builds the network
as a ``torch.nn.Module`` on the requested device.  Ported so far: the CNN
family (ResNet-50 inference), the dense transformer family (prefill, KV
cache, decode, and training) and the SSM family (Mamba2: chunked prefill,
recurrent decode).  ``prefill(module, batch)``, ``decode(module, batch,
cache)`` and ``init_cache(batch, max_len, device=...)`` mirror the
reference's serving entries (``None`` for the CNN, as there); the other
families raise ``NotImplementedError`` naming the roadmap item that brings
them.  ``loss(module, batch)`` and ``make_train_step`` train the dense
family; the SSM and CNN families raise, naming the roadmap item that
brings their backward kernels.

A ``TrainState`` is the module and its optimiser state; ``state_tree`` /
``load_state_tree`` turn it into the flat tree ``checkpoint.store`` writes
and back, and ``restore_train_state`` also reads a checkpoint of the
reference's ``TrainState``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import mamba, resnet, transformer
from repro_torch.optim.adafactor import FactoredV
from repro_torch.optim.adamw import is_moment_leaf

# the serving families: (config check, module class, init_cache)
_SERVING = {"dense": (transformer.check_dense, transformer.Transformer,
                      transformer.init_cache),
            "ssm": (mamba.check_ssm, mamba.Mamba, mamba.init_cache)}

# the roadmap item that ports each family not ported yet
_NOT_PORTED = {"moe": "Queue 1 item 12e (MoE, MLA)",
               "vlm": "Queue 1 item 12e (the VLM prefix)",
               "hybrid": "Queue 1 item 12e (zamba)",
               "audio": "Queue 1 item 12e (whisper)"}

# the roadmap item that brings training to each ported family that lacks it
_NO_TRAINING = {"ssm": "Queue 1 item 13b (Mamba2 training: a K4 backward)",
                "cnn": "Queue 1 item 12d (ResNet training: a K2 backward "
                       "and train-mode batch norm)"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., torch.nn.Module]   # (generator=None, device="cuda")
    prefill: Optional[Callable] = None     # (module, batch) -> (logits, cache)
    decode: Optional[Callable] = None      # (module, batch, cache) -> same
    init_cache: Optional[Callable] = None  # (batch, max_len, device) -> cache
    loss: Optional[Callable] = None        # (module, batch) -> (loss, metrics)


def check_trainable(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family!r} family ({cfg.name}) is not ported "
            f"yet: see ROADMAP.md "
            f"{_NO_TRAINING.get(cfg.family, 'Queue 1 item 12e')}")


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

        def loss(module: torch.nn.Module, batch):
            check_trainable(cfg)
            return transformer.loss_fn(module, batch["tokens"],
                                       batch["labels"])

        return Model(cfg, init,
                     prefill=lambda m, batch: m.prefill(batch["tokens"]),
                     decode=lambda m, batch, cache: m.decode_step(
                         batch["tokens"], cache),
                     init_cache=init_cache, loss=loss)
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        f"ROADMAP.md {_NOT_PORTED.get(cfg.family, 'Queue 1')}")


# --- training --------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module       # the model, parameters updated in place
    opt: Any                      # the optimiser's state


def init_train_state(module: torch.nn.Module, optimizer) -> TrainState:
    """Gradients on for ``module``'s parameters and a fresh optimiser
    state over them (in ``named_parameters()`` order)."""
    module.requires_grad_(True)
    return TrainState(module, optimizer.init(list(module.parameters())))


def make_train_step(model: Model, optimizer,
                    grad_transform: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and every
    parameter's gradient, the optional ``grad_transform`` (grads -> grads,
    e.g. int8 compression), then ``optimizer.apply``, which writes the new
    parameters and moments in place.  A failure in the forward or the
    backward leaves the state as it was.  Metrics: ``nll``, ``moe_aux``,
    ``grad_norm``, ``lr``, ``loss`` (tensors)."""
    check_trainable(model.cfg)

    def train_step(state: TrainState, batch):
        module = state.params
        params = list(module.parameters())
        loss, metrics = model.loss(module, batch)
        grads = list(torch.autograd.grad(loss, params))
        if grad_transform is not None:
            grads = list(grad_transform(grads))
        _, opt, opt_metrics = optimizer.apply(params, grads, state.opt)
        return (TrainState(module, opt),
                {**metrics, **opt_metrics, "loss": loss.detach()})

    return train_step


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The flat tree ``checkpoint.store.save`` writes: ``params/<name>``,
    ``opt/step``, ``opt/m/<name>`` and ``opt/v/<name>`` (an int8 moment as
    ``.../q`` and ``.../scale``, a factored one as ``.../r`` and
    ``.../c``), ``<name>`` a ``named_parameters()`` name."""
    named = list(state.params.named_parameters())
    tree: Dict[str, Any] = {f"params/{n}": p.detach() for n, p in named}
    tree["opt/step"] = torch.tensor(state.opt.step, dtype=torch.int32)
    for field in ("m", "v"):
        for (n, _), leaf in zip(named, getattr(state.opt, field)):
            pre = f"opt/{field}/{n}"
            if is_moment_leaf(leaf):
                tree[f"{pre}/q"], tree[f"{pre}/scale"] = leaf["q"], \
                    leaf["scale"]
            elif isinstance(leaf, FactoredV):
                tree[f"{pre}/r"], tree[f"{pre}/c"] = leaf.r, leaf.c
            else:
                tree[pre] = leaf
    return tree


@torch.no_grad()
def load_state_tree(state: TrainState, tree: Dict) -> TrainState:
    """``state`` with the values of a restored ``state_tree`` (the nested
    dict ``checkpoint.store.restore`` returns) copied in."""
    named = list(state.params.named_parameters())
    for n, p in named:
        p.copy_(tree["params"][n])
    moments = {}
    for field in ("m", "v"):
        saved, out = tree["opt"][field], []
        for (n, p), leaf in zip(named, getattr(state.opt, field)):
            if is_moment_leaf(leaf):
                leaf = {"q": saved[n]["q"].to(p.device),
                        "scale": saved[n]["scale"].to(p.device),
                        "shape": tuple(p.shape), "n": p.numel()}
            elif isinstance(leaf, FactoredV):
                leaf.r.copy_(saved[n]["r"])
                leaf.c.copy_(saved[n]["c"])
            else:
                leaf.copy_(saved[n])
            out.append(leaf)
        moments[field] = out
    return TrainState(state.params, state.opt._replace(
        step=int(tree["opt"]["step"]), **moments))


def restore_train_state(ckpt_dir: str, state: TrainState, model: Model,
                        optimizer, step: Optional[int] = None
                        ) -> Tuple[int, TrainState, Dict]:
    """(step, state, data state) from checkpoint ``step`` (default: the
    latest) of ``ckpt_dir``, written by the port or by the reference (its
    ``TrainState`` carried by ``transformer.train_state_from_reference``
    onto ``state``'s device)."""
    if store.is_reference_checkpoint(ckpt_dir, step):
        check_trainable(model.cfg)
        paths = transformer.reference_state_paths(state.params,
                                                  optimizer.name)
        step, tree, extra = store.restore(ckpt_dir, step,
                                          reference_paths=paths)
        return step, transformer.train_state_from_reference(
            tree, model.cfg, optimizer, device=state.params.device), extra
    step, tree, extra = store.restore(ckpt_dir, step)
    return step, load_state_tree(state, tree), extra
