"""Decoder-only transformer LM, the dense path (counterpart of the
reference's ``models/transformer.py``).

Dense GQA / MQA models -- stablelm, qwen2 (``qkv_bias``), qwen3
(``qk_norm``), granite (one kv head).  Inference: ``prefill`` (every
layer's attention on the hand-written kernel K3), a KV cache and greedy
``decode_step``, under ``torch.no_grad`` on frozen parameters.  Training:
``forward`` / ``loss_fn`` over all positions, differentiable (K3 with its
hand-written backward), with the reference's ``cfg.remat`` per layer.  The
reference scans one stacked layer body with ``lax.scan``; here
``Transformer.layers`` is an ``nn.ModuleList`` walked by a Python loop.
MoE, MLA, multi-token prediction and the VLM embedding scale raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 12e).

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots, with the stacked leading L axis of ``params["layers"]`` spread over
``layers.<i>`` (``layers.3.attn.wq``, ``embed.embed_w``,
``final_norm.scale``), so ``params_from_reference`` carries a reference
``init_params`` pytree over one leaf and one layer at a time, and
``train_state_from_reference`` a reference ``TrainState`` with its
optimiser state.

The cache is the reference's dict ``{"len", "layers": {"k", "v"}}`` with
``len`` a Python int.  ``decode_step`` writes into it in place and RAISES
when ``len`` has reached ``max_len``; the reference's
``dynamic_update_slice`` clamps that index and silently overwrites the last
position -- which is what decoding straight after the reference's
``prefill`` (a cache exactly as long as the prompt) does.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.optim import adamw as _aw
from repro_torch.optim.adafactor import AdafactorConfig, FactoredV, factorable

Cache = Dict[str, object]


def check_dense(cfg) -> None:
    """Raises for what the dense path does not compute."""
    missing = []
    if cfg.num_experts:
        missing.append("mixture of experts")
    if cfg.attn_type == "mla":
        missing.append("multi-head latent attention")
    elif cfg.attn_type != "gqa":
        missing.append(f"attn_type {cfg.attn_type!r}")
    if cfg.mtp_depth:
        missing.append("multi-token prediction")
    if cfg.family == "vlm":
        missing.append("the VLM embedding scale and patch prefix")
    if cfg.family not in ("dense", "moe", "vlm"):
        missing.append(f"family {cfg.family!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet: see ROADMAP.md "
            "Queue 1 item 12e")


# --- init ------------------------------------------------------------------------

def init_layer(generator, cfg, device=None) -> Dict:
    return {"ln1": L.init_rmsnorm(cfg.d_model, device),
            "ln2": L.init_rmsnorm(cfg.d_model, device),
            "attn": L.init_attention(generator, cfg, device),
            "ffn": L.init_ffn(generator, cfg, device=device)}


def init_params(generator, cfg, device=None) -> Dict:
    """The dense parameter tree with ``layers`` as a list of per-layer
    trees; weights from ``generator`` with ``dense_init``'s scales (``wo`` /
    ``w_out`` scaled by ``1/sqrt(L)``), norms at one, biases at zero."""
    p = {"embed": L.init_embed(generator, cfg, device),
         "final_norm": L.init_rmsnorm(cfg.d_model, device),
         "layers": [init_layer(generator, cfg, device)
                    for _ in range(cfg.num_layers)]}
    if not cfg.tie_embeddings:
        p["head"] = {"head_w": L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), L.dtype_of(cfg)
        ).to(device)}
    return p


def init_cache(cfg, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """An empty cache with room for ``max_len`` positions."""
    return {"len": 0, "layers": L.init_kv_cache(
        cfg, batch, max_len, cfg.num_layers,
        resolve_device(device, allow_meta=True))}


# --- forward ---------------------------------------------------------------------

def _layer_fwd(lp, cfg, x: torch.Tensor, positions: torch.Tensor):
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    a, kv = L.attention_prefill(lp["attn"], cfg, h, positions)
    x = x + a
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], cfg, h), kv


def _layer_train(lp, x: torch.Tensor, positions: torch.Tensor,
                 cfg) -> torch.Tensor:
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(lp["attn"], cfg, h, positions)
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], cfg, h)


# what the reference's "dots" policy (dots_with_no_batch_dims_saveable)
# keeps: the products without batch dimensions -- here every projection,
# each one aten.mm once matmul has folded [B, S, d] into rows
_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg):
    """The per-layer training body under ``cfg.remat``, as the reference's
    ``_remat``: ``"none"`` keeps every activation; ``"full"`` keeps only
    the layer's input and recomputes the layer in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` keeps the
    outputs of the projections too (a selective-checkpoint policy)."""
    body = functools.partial(_layer_train, cfg=cfg)
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        return lambda lp, x, positions: _ckpt.checkpoint(
            body, lp, x, positions, use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda lp, x, positions: _ckpt.checkpoint(
            body, lp, x, positions, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {cfg.remat!r}; expected "
                     "'none', 'dots' or 'full'")


def _layer_decode(lp, cfg, x: torch.Tensor, cache_l: Mapping,
                  cache_len: int) -> torch.Tensor:
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    a, _ = L.attention_decode(lp["attn"], cfg, h, cache_l, cache_len)
    x = x + a
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], cfg, h)


class Transformer(nn.Module):
    """The dense decoder of ``cfg`` in ``cfg.dtype`` (norms in float32).

    Weights come from ``generator`` (``init_params``), drawn on the
    generator's own device -- a CUDA generator draws on the card -- and
    moved to ``device``; the numbers differ from the reference's, which come
    from ``jax.random``.  ``device`` defaults to the card and raises without
    one; ``device="meta"`` builds the module with shapes only (nothing drawn,
    nothing allocated) for the workload census."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        check_dense(cfg)
        dev = resolve_device(device, allow_meta=True)
        generator, ctx = L.init_generator(generator, dev)
        with ctx:
            params = init_params(generator, cfg, dev)
        self.cfg = cfg
        self.device = dev
        self.embed = L.ParamTree(params["embed"])
        self.final_norm = L.ParamTree(params["final_norm"])
        self.layers = nn.ModuleList(L.ParamTree(lp)
                                    for lp in params["layers"])
        self.head = (L.ParamTree(params["head"]) if "head" in params
                     else None)

    def _run(self, tokens: torch.Tensor, kv_out: Optional[Dict]
             ) -> torch.Tensor:
        """The full-sequence forward; each layer's (k, v) is written into
        ``kv_out`` (a cache's ``"layers"``) when one is given."""
        x = L.embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        head_major = self.cfg.cache_layout == "head_major"
        for i, lp in enumerate(self.layers):
            x, (k, v) = _layer_fwd(lp, self.cfg, x, positions)
            if kv_out is not None:
                if head_major:
                    k, v = k.transpose(1, 2), v.transpose(1, 2)
                kv_out["k"][i] = k
                kv_out["v"][i] = v
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, vocab]."""
        return self._run(torch.as_tensor(tokens, device=self.device), None)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """Logits and a populated cache whose ``max_len`` is the prompt
        length (as the reference's); copy it into a larger ``init_cache``
        to decode after it."""
        tokens = torch.as_tensor(tokens, device=self.device)
        cache = self.init_cache(*tokens.shape)
        logits = self._run(tokens, cache["layers"])
        cache["len"] = int(tokens.shape[1])
        return logits, cache

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: tokens [B, 1] -> (logits [B, 1, vocab],
        the cache with ``len`` + 1).  The cache is updated in place; a full
        one raises (``layers.attention_decode``) before anything is
        written."""
        cache_len = int(cache["len"])
        tokens = torch.as_tensor(tokens, device=self.device)
        x = L.embed(self.embed, tokens)
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]
        for i, lp in enumerate(self.layers):
            x = _layer_decode(lp, self.cfg, x, {"k": kc[i], "v": vc[i]},
                              cache_len)
        cache["len"] = cache_len + 1
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h), cache


def forward(model: Transformer, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over all positions: tokens [B, S] -> (final
    hidden [B, S, D], float32 logits [B, S, vocab]), differentiable, each
    layer under ``cfg.remat``."""
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.device)
    x = L.embed(model.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=model.device)[None]
    layer = _remat(cfg)
    for lp in model.layers:
        x = layer(lp, x, positions)
    h = L.norm(model.final_norm, x, cfg.norm_eps)
    return h, L.unembed(model.head, model.embed, h)


def loss_fn(model: Transformer, tokens, labels
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of ``logits[:, :-1]`` against ``labels[:, 1:]`` (the
    reference's pairing) and the metrics ``{"nll", "moe_aux"}`` (0 for the
    dense family)."""
    _, logits = forward(model, tokens)
    labels = torch.as_tensor(labels, device=model.device)
    loss = L.cross_entropy(logits[:, :-1], labels[:, 1:])
    return loss, {"nll": loss.detach(),
                  "moe_aux": torch.zeros((), dtype=torch.float32,
                                         device=model.device)}


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> Transformer:
    """A ``Transformer`` holding the reference's ``init_params`` pytree
    ``params`` (nested dicts of arrays; any float dtype that numpy can cast
    to float32, bf16 included).  The leading L axis of ``params["layers"]``
    is split one layer at a time; every leaf must match one parameter of the
    module by path and shape, and is cast to that parameter's dtype."""
    check_dense(cfg)
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    L.copy_reference_params(model, params, cfg.num_layers)
    return model


# --- training state carried across --------------------------------------------

def _reference_key(name: str) -> Tuple[str, Optional[int]]:
    """The reference's path of the port's parameter ``name`` and its layer
    (``layers.3.attn.wq`` -> ``("layers/attn/wq", 3)``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def reference_param_leaves(model: Transformer) -> List[Tuple[str, tuple]]:
    """(path, shape) of each leaf of the reference's ``init_params`` tree
    for ``model``'s config, layer leaves stacked [L, ...], in
    ``jax.tree_util``'s order (dict keys sorted at every level)."""
    shapes = {}
    for name, p in model.named_parameters():
        path, layer = _reference_key(name)
        stack = (model.cfg.num_layers,) if layer is not None else ()
        shapes[path] = stack + tuple(p.shape)
    return sorted(shapes.items(), key=lambda kv: kv[0].split("/"))


def reference_state_paths(model: Transformer, optimizer_name: str
                          ) -> List[str]:
    """The leaf paths of the reference's ``TrainState(params, OptState(step,
    m, v))`` for ``model`` and the optimiser named ``optimizer_name``, in
    the order the reference's checkpoint stores them: the params, the step,
    then m and v leaf by leaf -- an int8 moment as its dict (``n``, ``q``,
    ``scale``, ``shape``'s ints), an Adafactor factored v as (``r``,
    ``c``)."""
    leaves = reference_param_leaves(model)
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
    ``copy_reference_params`` reads)."""
    if isinstance(tree, Mapping):
        return {k: _float_tree(v) for k, v in tree.items()}
    return _as_tensor(tree).float().numpy()


def _field(leaf, key: str):
    return leaf[key] if isinstance(leaf, Mapping) else getattr(leaf, key)


def _carry_leaf(ref, mine, layer: Optional[int], p: torch.Tensor,
                num_layers: int):
    """The port's optimiser leaf ``mine`` (of parameter ``p``) from the
    reference's leaf ``ref`` (stacked [L, ...] when ``layer`` is not
    None)."""
    def sliced(x):
        t = _as_tensor(x)
        return t if layer is None else t[layer]

    if _aw.is_moment_leaf(mine):
        q, scale = _as_tensor(ref["q"]), _as_tensor(ref["scale"]).float()
        per = p.numel()
        if layer is None or per % _aw.BLOCK == 0:
            nb = -(-per // _aw.BLOCK)
            lo = 0 if layer is None else layer * nb
            return {"q": q[lo:lo + nb].to(p.device),
                    "scale": scale[lo:lo + nb].to(p.device),
                    "shape": tuple(p.shape), "n": per}
        # the reference's blocks cross layer boundaries: carry the values
        # and quantize this layer's tensor on its own
        full = (q.float() * scale).reshape(-1)[:num_layers * per]
        return _aw.quantize_i8(
            full.reshape((num_layers,) + tuple(p.shape))[layer].to(p.device))
    if isinstance(mine, FactoredV):
        mine.r.copy_(sliced(_field(ref, "r")))
        mine.c.copy_(sliced(_field(ref, "c")))
        return mine
    mine.copy_(sliced(ref))
    return mine


def train_state_from_reference(state, cfg, optimizer,
                               device: DeviceLike = "cuda"):
    """A ``models.api.TrainState`` holding the reference's ``TrainState(params,
    OptState(step, m, v))`` ``state`` (the object with numpy or tensor
    leaves, or the nested dict ``checkpoint.store.restore`` returns) for
    ``optimizer`` (a ``repro_torch.optim.Optimizer`` of the same name).
    Stacked layer leaves are split one layer at a time; float moments and
    Adafactor's factored ``(r, c)`` are copied exactly; an int8 moment keeps
    its blocks where a layer's size is a whole number of blocks, else its
    values are re-quantized a layer at a time (``optim.adamw``)."""
    from repro_torch.models.api import TrainState, init_train_state
    if isinstance(state, Mapping):
        params, opt = state["params"], state["opt"]
    else:
        params, opt = state.params, state.opt
    step, ref_m, ref_v = (_field(opt, k) for k in ("step", "m", "v"))
    module = params_from_reference(_float_tree(params), cfg, device)
    ts = init_train_state(module, optimizer)
    for ref, mine in ((ref_m, ts.opt.m), (ref_v, ts.opt.v)):
        for i, (name, p) in enumerate(module.named_parameters()):
            path, layer = _reference_key(name)
            leaf = ref
            for key in path.split("/"):
                leaf = leaf[key]
            mine[i] = _carry_leaf(leaf, mine[i], layer, p, cfg.num_layers)
    return TrainState(module, ts.opt._replace(
        step=int(_as_tensor(step).item())))
