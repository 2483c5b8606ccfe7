"""Decoder-only transformer LM (counterpart of the reference's
``models/transformer.py``): the dense, MoE and VLM families.

Dense GQA / MQA models -- stablelm, qwen2 (``qkv_bias``), qwen3
(``qk_norm``), granite (one kv head) -- and the VLM family (paligemma:
gemma's embedding scale, sqrt(d) rounded to the model dtype, on the token
embeddings, after which ``prefix_embeds`` -- the SigLIP tower's patch
embeddings, a stub input -- are put in front of the text; every layer's
attention sees the patches bidirectionally, the text causally; positions
run over the whole sequence, patches included).  Inference: ``prefill``
(every layer's attention on the hand-written kernel K3), a KV cache and
greedy ``decode_step``, under ``torch.no_grad`` on frozen parameters.
Training: ``forward`` / ``loss_fn`` over all positions (the patches'
logits dropped before the loss), differentiable (K3 with its hand-written
backward), with the reference's ``cfg.remat`` per layer.  The reference
scans one stacked layer body with ``lax.scan``; here ``Transformer.layers``
is an ``nn.ModuleList`` walked by a Python loop.

The MoE family (deepseek v2 / v3): multi-head latent attention
(``models/mla.py``: prefill on K3 at head dims (192, 128), absorbed decode
over a compressed cache), the experts of ``models/moe.py`` (softmax or
sigmoid + bias routing, routed and shared experts), and two stacks of
layers as the reference's: ``dense_layers`` (the first ``first_k_dense``,
dense FFN) and ``moe_layers``; v3's multi-token-prediction head ``mtp``
(``proj``, one dense ``layer``, ``norm``) adds ``0.3 * mtp_nll`` to the
loss, and softmax routing ``0.001 * aux``.  The cache is ``{"len",
"dense", "moe"}`` with MLA's ``{"c_kv", "k_rope"}`` entries.

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots, with the stacked leading L axis of ``params["layers"]`` (and of
``dense_layers`` / ``moe_layers``) spread over ``layers.<i>``
(``layers.3.attn.wq``, ``moe_layers.0.moe.w_in``, ``embed.embed_w``,
``final_norm.scale``), so ``params_from_reference`` carries a reference
``init_params`` pytree over one leaf and one layer at a time (and
``models.api.train_state_from_reference`` a reference ``TrainState`` with
its optimiser state).

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

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE

Cache = Dict[str, object]


def check_dense(cfg) -> None:
    """Raises for what the decoder does not compute."""
    missing = []
    if cfg.attn_type not in ("gqa", "mla"):
        missing.append(f"attn_type {cfg.attn_type!r}")
    if cfg.family not in ("dense", "moe", "vlm"):
        missing.append(f"family {cfg.family!r}")
    if cfg.num_experts and cfg.family != "moe":
        missing.append(f"experts in the {cfg.family!r} family")
    if cfg.attn_type == "mla" and cfg.family != "moe":
        missing.append("multi-head latent attention outside the MoE family")
    if cfg.mtp_depth and cfg.family != "moe":
        missing.append("multi-token prediction outside the MoE family")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet: see ROADMAP.md "
            "Queue 1 item 12e")


def stack_depths(cfg) -> Dict[str, int]:
    """The layers of each stacked root of ``cfg``'s tree, in order:
    ``layers``; with experts ``dense_layers`` (the first
    ``first_k_dense``, where there are any) and ``moe_layers``."""
    if not cfg.num_experts:
        return {"layers": cfg.num_layers}
    n_dense = cfg.first_k_dense
    out = {"dense_layers": n_dense} if n_dense else {}
    out["moe_layers"] = cfg.num_layers - n_dense
    return out


# the cache key of each stacked root
CACHE_KEYS = {"layers": "layers", "dense_layers": "dense",
              "moe_layers": "moe"}


# --- init ------------------------------------------------------------------------

def init_layer(generator, cfg, device=None, moe: bool = False) -> Dict:
    attn = (MLA.init_mla(generator, cfg, device) if cfg.attn_type == "mla"
            else L.init_attention(generator, cfg, device))
    p = {"ln1": L.init_rmsnorm(cfg.d_model, device),
         "ln2": L.init_rmsnorm(cfg.d_model, device), "attn": attn}
    if moe:
        p["moe"] = MOE.init_moe(generator, cfg, device)
    else:
        p["ffn"] = L.init_ffn(generator, cfg, device=device)
    return p


def init_params(generator, cfg, device=None) -> Dict:
    """The parameter tree with each stacked root (``stack_depths``) as a
    list of per-layer trees; weights from ``generator`` with
    ``dense_init``'s scales (``wo`` / ``w_out`` scaled by ``1/sqrt(L)``),
    norms at one, biases at zero; v3's ``mtp`` head where
    ``cfg.mtp_depth``."""
    p = {"embed": L.init_embed(generator, cfg, device),
         "final_norm": L.init_rmsnorm(cfg.d_model, device)}
    for root, n in stack_depths(cfg).items():
        p[root] = [init_layer(generator, cfg, device,
                              moe=root == "moe_layers") for _ in range(n)]
    if not cfg.tie_embeddings:
        p["head"] = {"head_w": L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), L.dtype_of(cfg)
        ).to(device)}
    if cfg.mtp_depth:
        p["mtp"] = {"proj": L.dense_init(
            generator, (2 * cfg.d_model, cfg.d_model), L.dtype_of(cfg)
        ).to(device),
            "layer": init_layer(generator, cfg, device),
            "norm": L.init_rmsnorm(cfg.d_model, device)}
    return p


def init_cache(cfg, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """An empty cache with room for ``max_len`` positions: ``{"len",
    "layers"}``, or with experts ``{"len", "dense", "moe"}``; each stack's
    entries MLA's compressed ``{"c_kv", "k_rope"}`` or ``{"k", "v"}``."""
    dev = resolve_device(device, allow_meta=True)
    cache: Cache = {"len": 0}
    for root, n in stack_depths(cfg).items():
        cache[CACHE_KEYS[root]] = (
            MLA.init_mla_cache(cfg, batch, max_len, n, dev)
            if cfg.attn_type == "mla"
            else L.init_kv_cache(cfg, batch, max_len, n, dev))
    return cache


# --- forward ---------------------------------------------------------------------

def embed_scale(cfg, dtype: torch.dtype) -> float:
    """gemma's embedding scale, which the VLM family puts on its token
    embeddings: sqrt(d_model) rounded to ``dtype`` first as the reference's
    ``jnp.asarray(d ** 0.5, x.dtype)`` (45.25 in bf16 at d 2048), so that
    ``x * scale`` is the reference's product in that dtype."""
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=dtype))


def embed_inputs(model: "Transformer", tokens, prefix_embeds=None
                 ) -> Tuple[torch.Tensor, int]:
    """The decoder's input sequence and its prefix length: the tokens'
    embeddings (the VLM family's scaled by ``embed_scale``), after
    ``prefix_embeds`` [B, P,
    d] (numpy or a tensor, any float dtype, cast to the model's) where
    given (P = 0 without)."""
    cfg = model.cfg
    x = L.embed(model.embed, torch.as_tensor(tokens, device=model.device))
    if cfg.family == "vlm":
        x = x * embed_scale(cfg, x.dtype)
    if prefix_embeds is None:
        return x, 0
    prefix = torch.as_tensor(prefix_embeds, device=model.device)
    if prefix.dim() != 3 or prefix.shape[0] != x.shape[0] or \
            prefix.shape[2] != cfg.d_model:
        raise ValueError(f"prefix_embeds must be [B, P, {cfg.d_model}] "
                         f"beside tokens {tuple(x.shape[:2])}; got "
                         f"{tuple(prefix.shape)}")
    return torch.cat([prefix.to(x.dtype), x], dim=1), int(prefix.shape[1])


def _ffn(lp, cfg, h: torch.Tensor):
    """(the layer's FFN output, the MoE block's aux, None for a dense
    FFN)."""
    if "moe" in lp:
        return MOE.moe_block(lp["moe"], cfg, h)
    return L.ffn_block(lp["ffn"], cfg, h), None


def _layer_fwd(lp, cfg, x: torch.Tensor, positions: torch.Tensor,
               prefix_len: int = 0):
    """Prefill: (x, the layer's cache entries: MLA's (c_kv, k_rope), else
    (k, v))."""
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, kv = MLA.mla_prefill(lp["attn"], cfg, h, positions, prefix_len)
    else:
        a, kv = L.attention_prefill(lp["attn"], cfg, h, positions,
                                    prefix_len)
    x = x + a
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn(lp, cfg, h)[0], kv


def _layer_train(lp, x: torch.Tensor, positions: torch.Tensor,
                 cfg, prefix_len: int = 0):
    """Training: the layer's output; a MoE layer's (output, aux)."""
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        x = x + MLA.mla_block(lp["attn"], cfg, h, positions, prefix_len)
    else:
        x = x + L.attention_block(lp["attn"], cfg, h, positions, prefix_len)
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    f, aux = _ffn(lp, cfg, h)
    return x + f if aux is None else (x + f, aux)


def _layer_decode(lp, cfg, x: torch.Tensor, cache_l: Mapping,
                  cache_len: int) -> torch.Tensor:
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = MLA.mla_decode(lp["attn"], cfg, h, cache_l, cache_len)
    else:
        a, _ = L.attention_decode(lp["attn"], cfg, h, cache_l, cache_len)
    x = x + a
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn(lp, cfg, h)[0]


class Transformer(nn.Module):
    """The decoder of ``cfg`` in ``cfg.dtype`` (norms and the router in
    float32): ``layers``, or with experts ``dense_layers`` and
    ``moe_layers`` (``nn.ModuleList``s, ``stack_depths``), and v3's
    ``mtp`` head.

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
        for root in stack_depths(cfg):
            setattr(self, root, nn.ModuleList(L.ParamTree(lp)
                                              for lp in params[root]))
        self.head = (L.ParamTree(params["head"]) if "head" in params
                     else None)
        self.mtp = L.ParamTree(params["mtp"]) if "mtp" in params else None

    def stacks(self) -> List[Tuple[str, nn.ModuleList]]:
        """(cache key, layers) of each stack, in order."""
        return [(CACHE_KEYS[root], getattr(self, root))
                for root in stack_depths(self.cfg)]

    def _run(self, x: torch.Tensor, prefix_len: int, cache: Optional[Cache]
             ) -> torch.Tensor:
        """The full-sequence forward of the embedded sequence ``x``
        (``embed_inputs``) whose first ``prefix_len`` positions every
        position sees; each layer's cache entries are written into
        ``cache`` (its stacks' tensors) when one is given."""
        positions = torch.arange(x.shape[1], device=self.device)[None]
        head_major = self.cfg.cache_layout == "head_major"
        mla = self.cfg.attn_type == "mla"
        for key, stack in self.stacks():
            for i, lp in enumerate(stack):
                x, (a, b) = _layer_fwd(lp, self.cfg, x, positions,
                                       prefix_len)
                if cache is None:
                    continue
                out = cache[key]
                if mla:
                    out["c_kv"][i] = a
                    out["k_rope"][i] = b
                    continue
                if head_major:
                    a, b = a.transpose(1, 2), b.transpose(1, 2)
                out["k"][i] = a
                out["v"][i] = b
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                prefix_embeds=None) -> torch.Tensor:
        """tokens [B, S] (after ``prefix_embeds`` [B, P, d] where given) ->
        float32 logits [B, P + S, vocab]."""
        return self._run(*embed_inputs(self, tokens, prefix_embeds), None)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, prefix_embeds=None
                ) -> Tuple[torch.Tensor, Cache]:
        """Logits [B, P + S, vocab] and a populated cache of ``len`` P + S,
        the prefix's positions and the prompt's, whose ``max_len`` is that
        length (as the reference's); copy it into a larger ``init_cache``
        to decode after it."""
        x, prefix_len = embed_inputs(self, tokens, prefix_embeds)
        cache = self.init_cache(*x.shape[:2])
        logits = self._run(x, prefix_len, cache)
        cache["len"] = int(x.shape[1])
        return logits, cache

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: tokens [B, 1] -> (logits [B, 1, vocab],
        the cache with ``len`` + 1).  The cache is updated in place; a full
        one raises (``layers.attention_decode``, ``mla.mla_decode``) before
        anything is written."""
        cache_len = int(cache["len"])
        x, _ = embed_inputs(self, tokens)
        for key, stack in self.stacks():
            entries = cache[key]
            for i, lp in enumerate(stack):
                x = _layer_decode(lp, self.cfg, x,
                                  {n: t[i] for n, t in entries.items()},
                                  cache_len)
        cache["len"] = cache_len + 1
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h), cache


def _forward(model: Transformer, tokens, prefix_embeds=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``forward`` and the sum of the MoE layers' aux (float32, 0 without
    experts), in layer order as the reference's scans add it."""
    cfg = model.cfg
    x, prefix_len = embed_inputs(model, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=model.device)[None]
    layer = L.remat(functools.partial(_layer_train, cfg=cfg,
                                      prefix_len=prefix_len), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=model.device)
    for key, stack in model.stacks():
        for lp in stack:
            if key == "moe":
                x, a = layer(lp, x, positions)
                aux = aux + a
            else:
                x = layer(lp, x, positions)
    h = L.norm(model.final_norm, x, cfg.norm_eps)
    return h, L.unembed(model.head, model.embed, h), aux


def forward(model: Transformer, tokens, prefix_embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over all positions: tokens [B, S] (after
    ``prefix_embeds`` [B, P, d] where given) -> (final hidden [B, P + S,
    D], float32 logits [B, P + S, vocab]), differentiable, each layer under
    ``cfg.remat``."""
    return _forward(model, tokens, prefix_embeds)[:2]


def mtp_loss(model: Transformer, h: torch.Tensor, tokens, labels
             ) -> torch.Tensor:
    """v3's multi-token prediction: token t + 2 from (h_t, embed(t + 1)),
    ``mtp.proj`` over their concatenation, one dense layer (not under
    remat, as the reference's), ``mtp.norm``, the shared head; the mean
    NLL of its ``[:, :-1]`` against ``labels[:, 2:]``."""
    cfg, p = model.cfg, model.mtp
    tokens = torch.as_tensor(tokens, device=model.device)
    labels = torch.as_tensor(labels, device=model.device)
    emb_next = L.embed(model.embed, tokens[:, 1:])
    h_mtp = torch.cat([h[:, :-1], emb_next], dim=-1) @ p["proj"]
    pos = torch.arange(h_mtp.shape[1], device=model.device)[None]
    h_mtp = _layer_train(p["layer"], h_mtp, pos, cfg)
    h_mtp = L.norm(p["norm"], h_mtp, cfg.norm_eps)
    logits = L.unembed(model.head, model.embed, h_mtp)
    return L.cross_entropy(logits[:, :-1], labels[:, 2:])


def loss_fn(model: Transformer, tokens, labels, prefix_embeds=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of the text's ``logits[:, :-1]`` (the prefix's positions
    dropped) against ``labels[:, 1:]`` (the reference's pairing), plus ``0.3
    * mtp_nll`` where the model has the MTP head and ``0.001 * aux`` for
    softmax routing; metrics ``{"nll", "moe_aux"}`` (aux 0 for the dense
    family) and ``"mtp_nll"`` with the MTP head."""
    cfg = model.cfg
    h, logits, aux = _forward(model, tokens, prefix_embeds)
    if prefix_embeds is not None:
        logits = logits[:, int(prefix_embeds.shape[1]):]
    loss, metrics = L.next_token_loss(logits, labels)
    metrics["moe_aux"] = aux.detach()
    if cfg.mtp_depth and model.mtp is not None:
        mtp = mtp_loss(model, h, tokens, labels)
        loss = loss + 0.3 * mtp
        metrics["mtp_nll"] = mtp.detach()
    if cfg.num_experts and cfg.router_fn == "softmax":
        loss = loss + 0.001 * aux
    return loss, metrics


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> Transformer:
    """A ``Transformer`` holding the reference's ``init_params`` pytree
    ``params`` (nested dicts of arrays; any float dtype that numpy can cast
    to float32, bf16 included).  The leading L axis of each stacked root
    (``layers``, or ``dense_layers`` and ``moe_layers``) is split one layer
    at a time; every leaf must match one parameter of the module by path
    and shape, and is cast to that parameter's dtype (the router and its
    bias stay float32)."""
    check_dense(cfg)
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    L.copy_reference_params(model, params, stack_depths(cfg))
    return model
