"""Per-family model API (the reference's ``models/api.py``).

``build_model(cfg)`` returns a ``Model`` whose ``init`` builds the network
as a ``torch.nn.Module`` on the requested device.  Ported so far: the CNN
family (ResNet-50 inference and training), the dense transformer family (prefill, KV
cache, decode, and training), the SSM family (Mamba2: chunked prefill,
recurrent decode, and training), the hybrid family (Zamba2: the Mamba2
backbone with one shared attention block; prefill, decode and training),
the audio family (whisper: an encoder over precomputed frames and a
decoder with cross attention; prefill, decode and training), the VLM
family (paligemma: a bidirectional prefix of precomputed patch embeddings
over the dense decoder; prefill, decode and training) and the MoE family
(deepseek v2 / v3: multi-head latent attention, routed and shared
experts, v3's multi-token prediction; prefill, compressed-cache decode and
training, on one device).
``prefill(module, batch)``, ``decode(module, batch, cache)`` and
``init_cache(batch, max_len, device=...)`` mirror the reference's serving
entries (``None`` for the CNN, as there; the audio family's prefill and loss
also read ``batch["frames"]``, the VLM family's ``batch["prefix_embeds"]``
where the batch has them); the other families raise
``NotImplementedError`` naming the roadmap item that brings them.
``init(generator=None, device="cuda", max_seq=4096)`` builds the module;
``max_seq`` sizes whisper's decoder positions, as the reference's
``init(key, max_seq)``, and the other families ignore it.
``loss(module, batch)`` and ``make_train_step`` train every family: the
CNN's loss reads ``batch["images"]`` and ``batch["labels"]``, the others'
``batch["tokens"]`` and ``batch["labels"]``.

A ``TrainState`` is the module and its optimiser state, one optimiser leaf
for each of the reference's parameter leaves (``leaf_groups``: a [L, ...]
stack of layers -- ``layers``, zamba's ``mamba_layers``, whisper's
``enc_layers`` and ``dec_layers``, deepseek's ``dense_layers`` and
``moe_layers`` -- is one leaf; ResNet's batch-norm ``mean`` and ``var``
are leaves, as in the reference);
``state_tree`` / ``load_state_tree`` turn it into the flat tree
``checkpoint.store`` writes and back, and ``restore_train_state`` also reads a checkpoint of the
reference's ``TrainState`` (``train_state_from_reference``, any trainable
family).
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import layers as L
from repro_torch.models import mamba, resnet, transformer, whisper, zamba
from repro_torch.optim.adafactor import AdafactorConfig, FactoredV, factorable
from repro_torch.optim.adamw import Group, is_moment_leaf

# the serving families: (config check, module class, init_cache)
_SERVING = {"dense": (transformer.check_dense, transformer.Transformer,
                      transformer.init_cache),
            "ssm": (mamba.check_ssm, mamba.Mamba, mamba.init_cache),
            "hybrid": (zamba.check_hybrid, zamba.Zamba, zamba.init_cache),
            "audio": (whisper.check_audio, whisper.Whisper,
                      whisper.init_cache),
            "vlm": (transformer.check_dense, transformer.Transformer,
                    transformer.init_cache),
            "moe": (transformer.check_dense, transformer.Transformer,
                    transformer.init_cache)}

# the trainable families: (loss_fn, params_from_reference)
_TRAINING = {"cnn": (resnet.loss_fn, resnet.params_from_reference),
             "dense": (transformer.loss_fn, transformer.params_from_reference),
             "ssm": (mamba.loss_fn, mamba.params_from_reference),
             "hybrid": (zamba.loss_fn, zamba.params_from_reference),
             "audio": (whisper.loss_fn, whisper.params_from_reference),
             "vlm": (transformer.loss_fn, transformer.params_from_reference),
             "moe": (transformer.loss_fn, transformer.params_from_reference)}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    # (generator=None, device="cuda", max_seq=4096)
    init: Callable[..., torch.nn.Module]
    prefill: Optional[Callable] = None     # (module, batch) -> (logits, cache)
    decode: Optional[Callable] = None      # (module, batch, cache) -> same
    init_cache: Optional[Callable] = None  # (batch, max_len, device) -> cache
    loss: Optional[Callable] = None        # (module, batch) -> (loss, metrics)


def check_trainable(cfg: ArchConfig) -> None:
    if cfg.family not in _TRAINING:
        raise NotImplementedError(
            f"training the {cfg.family!r} family ({cfg.name}) is not ported "
            f"yet: see ROADMAP.md Queue 1 item 12e")


def _inputs(cfg: ArchConfig, batch) -> tuple:
    """The batch's inputs beside the tokens (and labels) that the family's
    entries take: the audio family's ``frames``, the VLM family's
    ``prefix_embeds`` (None where the batch has none: text alone, as the
    reference's ``batch.get``)."""
    if cfg.family == "audio":
        return (batch["frames"],)
    if cfg.family == "vlm":
        return (batch.get("prefix_embeds"),)
    return ()


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "cnn":
        def init(generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda",
                 max_seq: int = 4096) -> resnet.ResNet:
            return resnet.ResNet(cfg, generator=generator, device=device)

        def cnn_loss(module: resnet.ResNet, batch):
            return resnet.loss_fn(module, batch["images"], batch["labels"])

        return Model(cfg, init, loss=cnn_loss)
    if cfg.family in _SERVING:
        check, module, make_cache = _SERVING[cfg.family]
        check(cfg)

        def init(generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda",
                 max_seq: int = 4096) -> torch.nn.Module:
            kw = {"max_seq": max_seq} if cfg.family == "audio" else {}
            return module(cfg, generator=generator, device=device, **kw)

        def init_cache(batch: int, max_len: int,
                       device: DeviceLike = "cuda"):
            return make_cache(cfg, batch, max_len, device)

        def loss(module: torch.nn.Module, batch):
            check_trainable(cfg)
            return _TRAINING[cfg.family][0](module, batch["tokens"],
                                            batch["labels"],
                                            *_inputs(cfg, batch))

        return Model(cfg, init,
                     prefill=lambda m, batch: m.prefill(
                         batch["tokens"], *_inputs(cfg, batch)),
                     decode=lambda m, batch, cache: m.decode_step(
                         batch["tokens"], cache),
                     init_cache=init_cache, loss=loss)
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        f"ROADMAP.md Queue 1")


# --- training --------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module       # the model, parameters updated in place
    opt: Any                      # the optimiser's state, a leaf a group


def leaf_groups(names: Sequence[str]) -> List[Tuple[str, Group]]:
    """The reference's parameter leaves over the port's parameters named
    ``names`` (in ``named_parameters()`` order): ``(leaf name, Group)`` in
    order of first appearance, the leaf name the reference's path joined by
    dots.  ``<root>.<i>.<rest>`` for i = 0 .. L-1, ``<root>`` a stacked
    root (``layers.STACKED_ROOTS``: ``layers``, zamba's ``mamba_layers``,
    whisper's ``enc_layers`` and ``dec_layers``, deepseek's
    ``dense_layers`` and ``moe_layers``), is one stacked group,
    ``<root>.<rest>``; every other parameter (zamba's ``shared_attn.*``,
    deepseek's ``mtp.*`` included) a group of its own."""
    order: List[str] = []
    members: Dict[str, List[Tuple[int, int]]] = {}
    for i, name in enumerate(names):
        path, layer = L.reference_key(name)
        leaf = path.replace("/", ".")
        if leaf not in members:
            order.append(leaf)
            members[leaf] = []
        members[leaf].append((-1 if layer is None else layer, i))
    out = []
    for leaf in order:
        got = sorted(members[leaf])
        stacked = got[0][0] >= 0
        if stacked and [lay for lay, _ in got] != list(range(len(got))):
            raise ValueError(f"{leaf}: layers {[lay for lay, _ in got]} "
                             "are not 0 .. L-1")
        out.append((leaf, Group(tuple(i for _, i in got), stacked)))
    return out


def param_groups(module: torch.nn.Module) -> List[Tuple[str, Group]]:
    """``leaf_groups`` of ``module``'s ``named_parameters()``."""
    return leaf_groups([n for n, _ in module.named_parameters()])


def init_train_state(module: torch.nn.Module, optimizer) -> TrainState:
    """Gradients on for ``module``'s parameters and a fresh optimiser
    state over them, one leaf a ``param_groups`` group."""
    module.requires_grad_(True)
    return TrainState(module, optimizer.init(
        list(module.parameters()), [g for _, g in param_groups(module)]))


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """d loss / d p for every parameter, zeros for one the loss does not
    reach (deepseek v3's ``router_bias`` biases the routing's selection
    only; ``jax.grad`` gives such a leaf zeros too)."""
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def make_train_step(model: Model, optimizer,
                    grad_transform: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and every
    parameter's gradient, the optional ``grad_transform`` (grads -> grads,
    e.g. int8 compression), then ``optimizer.apply`` over the groups the
    state was made with, which writes the new parameters and moments in
    place.  A failure in the forward or the backward leaves the state as it
    was.  Metrics: ``nll``, ``moe_aux`` (and ``mtp_nll`` with an MTP head),
    ``grad_norm``, ``lr``, ``loss`` (tensors)."""
    check_trainable(model.cfg)

    def train_step(state: TrainState, batch):
        module = state.params
        params = list(module.parameters())
        loss, metrics = model.loss(module, batch)
        grads = grads_of(loss, params)
        if grad_transform is not None:
            grads = list(grad_transform(grads))
        _, opt, opt_metrics = optimizer.apply(params, grads, state.opt)
        return (TrainState(module, opt),
                {**metrics, **opt_metrics, "loss": loss.detach()})

    return train_step


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The flat tree ``checkpoint.store.save`` writes: ``params/<name>``
    (``<name>`` a ``named_parameters()`` name), ``opt/step``,
    ``opt/m/<leaf>`` and ``opt/v/<leaf>`` (``<leaf>`` a ``param_groups``
    leaf name: a stacked group's ``<root>.<rest>``; an int8 moment as
    ``.../q`` and ``.../scale``, a factored one as ``.../r`` and
    ``.../c``)."""
    tree: Dict[str, Any] = {f"params/{n}": p.detach()
                            for n, p in state.params.named_parameters()}
    tree["opt/step"] = torch.tensor(state.opt.step, dtype=torch.int32)
    for field in ("m", "v"):
        for (leaf_name, _), leaf in zip(param_groups(state.params),
                                        getattr(state.opt, field)):
            pre = f"opt/{field}/{leaf_name}"
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
    for n, p in state.params.named_parameters():
        p.copy_(tree["params"][n])
    moments = {}
    for field in ("m", "v"):
        saved, out = tree["opt"][field], []
        for (leaf_name, _), leaf in zip(param_groups(state.params),
                                        getattr(state.opt, field)):
            got = saved[leaf_name]
            if is_moment_leaf(leaf):
                dev = leaf["q"].device
                leaf = {"q": got["q"].to(dev), "scale": got["scale"].to(dev),
                        "shape": leaf["shape"], "n": leaf["n"]}
            elif isinstance(leaf, FactoredV):
                leaf.r.copy_(got["r"])
                leaf.c.copy_(got["c"])
            else:
                leaf.copy_(got)
            out.append(leaf)
        moments[field] = out
    return TrainState(state.params, state.opt._replace(
        step=int(tree["opt"]["step"]), **moments))


def restore_train_state(ckpt_dir: str, state: TrainState, model: Model,
                        optimizer, step: Optional[int] = None
                        ) -> Tuple[int, TrainState, Dict]:
    """(step, state, data state) from checkpoint ``step`` (default: the
    latest) of ``ckpt_dir``, written by the port or by the reference (its
    ``TrainState`` carried by ``train_state_from_reference`` onto
    ``state``'s device)."""
    if store.is_reference_checkpoint(ckpt_dir, step):
        check_trainable(model.cfg)
        paths = reference_state_paths(state.params, optimizer.name)
        step, tree, extra = store.restore(ckpt_dir, step,
                                          reference_paths=paths)
        return step, train_state_from_reference(
            tree, model.cfg, optimizer, device=state.params.device), extra
    step, tree, extra = store.restore(ckpt_dir, step)
    return step, load_state_tree(state, tree), extra


# --- the reference's training state carried across --------------------------------

def reference_param_leaves(module: torch.nn.Module
                           ) -> List[Tuple[str, tuple]]:
    """(path, shape) of each leaf of the reference's ``init_params`` tree
    for ``module``'s config, layer leaves stacked [L, ...], in
    ``jax.tree_util``'s order (dict keys sorted at every level)."""
    shapes = {}
    for name, p in module.named_parameters():
        path, layer = L.reference_key(name)
        stack = ((L.stack_depth(module.cfg, path.split("/")[0]),)
                 if layer is not None else ())
        shapes[path] = stack + tuple(p.shape)
    return sorted(shapes.items(), key=lambda kv: kv[0].split("/"))


def reference_state_paths(module: torch.nn.Module, optimizer_name: str
                          ) -> List[str]:
    """The leaf paths of the reference's ``TrainState(params, OptState(step,
    m, v))`` for ``module`` and the optimiser named ``optimizer_name``, in
    the order the reference's checkpoint stores them: the params, the step,
    then m and v leaf by leaf -- an int8 moment as its dict (``n``, ``q``,
    ``scale``, ``shape``'s ints), an Adafactor factored v as (``r``,
    ``c``)."""
    leaves = reference_param_leaves(module)
    paths = [f"params/{p}" for p, _ in leaves] + ["opt/step"]
    af = AdafactorConfig()
    for field in ("m", "v"):
        for p, shape in leaves:
            pre = f"opt/{field}/{p}"
            if optimizer_name == "adamw8bit":
                paths += [f"{pre}/n", f"{pre}/q", f"{pre}/scale"] + [
                    f"{pre}/shape/{i}" for i in range(len(shape))]
            elif (optimizer_name == "adafactor" and field == "v"
                  and factorable(shape, af)):
                paths += [f"{pre}/r", f"{pre}/c"]
            else:
                paths.append(pre)
    return paths


def _as_tensor(x) -> torch.Tensor:
    """A reference leaf (numpy, bf16 as ml_dtypes, or a tensor) as a CPU
    tensor of its own dtype."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _float_tree(tree):
    """A reference params tree with tensor leaves as float32 numpy (what
    ``layers.copy_reference_params`` reads)."""
    if isinstance(tree, Mapping):
        return {k: _float_tree(v) for k, v in tree.items()}
    return _as_tensor(tree).float().numpy()


def _field(leaf, key: str):
    return leaf[key] if isinstance(leaf, Mapping) else getattr(leaf, key)


def _copy_exact(dst: torch.Tensor, src) -> None:
    t = _as_tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"reference leaf {tuple(t.shape)}, port leaf "
                         f"{tuple(dst.shape)}")
    dst.copy_(t)


def _carry_leaf(ref, mine):
    """The port's optimiser leaf ``mine`` holding the reference's leaf
    ``ref`` of the same shape: float moments and factored statistics
    copied, an int8 moment block for block."""
    if is_moment_leaf(mine):
        q, scale = _as_tensor(ref["q"]), _as_tensor(ref["scale"]).float()
        if tuple(q.shape) != tuple(mine["q"].shape) or \
                tuple(scale.shape) != tuple(mine["scale"].shape):
            raise ValueError(f"reference int8 blocks {tuple(q.shape)}, port "
                             f"{tuple(mine['q'].shape)}")
        dev = mine["q"].device
        return {"q": q.to(dev), "scale": scale.to(dev),
                "shape": mine["shape"], "n": mine["n"]}
    if isinstance(mine, FactoredV):
        _copy_exact(mine.r, _field(ref, "r"))
        _copy_exact(mine.c, _field(ref, "c"))
        return mine
    _copy_exact(mine, ref)
    return mine


def train_state_from_reference(state, cfg: ArchConfig, optimizer,
                               device: DeviceLike = "cuda") -> TrainState:
    """A ``TrainState`` holding the reference's ``TrainState(params,
    OptState(step, m, v))`` ``state`` (the object with numpy or tensor
    leaves, or the nested dict ``checkpoint.store.restore`` returns) of a
    trainable family, for ``optimizer`` (a ``repro_torch.optim.Optimizer``
    of the same name).  Parameters are split one layer at a time (the
    family's ``params_from_reference``); each optimiser leaf is the
    reference's, copied exactly -- a stacked leaf whole, int8 moments
    block for block."""
    check_trainable(cfg)
    if isinstance(state, Mapping):
        params, opt = state["params"], state["opt"]
    else:
        params, opt = state.params, state.opt
    step, ref_m, ref_v = (_field(opt, k) for k in ("step", "m", "v"))
    module = _TRAINING[cfg.family][1](_float_tree(params), cfg, device)
    ts = init_train_state(module, optimizer)
    for ref, mine in ((ref_m, ts.opt.m), (ref_v, ts.opt.v)):
        for k, (leaf_name, _) in enumerate(param_groups(module)):
            leaf = ref
            for key in leaf_name.split("."):
                leaf = leaf[key]
            mine[k] = _carry_leaf(leaf, mine[k])
    return TrainState(module, ts.opt._replace(
        step=int(_as_tensor(step).item())))
