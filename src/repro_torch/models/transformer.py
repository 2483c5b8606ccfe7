"""Decoder-only transformer LM, the dense path (counterpart of the
reference's ``models/transformer.py``).

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
is an ``nn.ModuleList`` walked by a Python loop.  MoE, MLA and multi-token
prediction raise ``NotImplementedError`` (ROADMAP.md Queue 1 item 12e).

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots, with the stacked leading L axis of ``params["layers"]`` spread over
``layers.<i>`` (``layers.3.attn.wq``, ``embed.embed_w``,
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
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

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


def _layer_fwd(lp, cfg, x: torch.Tensor, positions: torch.Tensor,
               prefix_len: int = 0):
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    a, kv = L.attention_prefill(lp["attn"], cfg, h, positions, prefix_len)
    x = x + a
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], cfg, h), kv


def _layer_train(lp, x: torch.Tensor, positions: torch.Tensor,
                 cfg, prefix_len: int = 0) -> torch.Tensor:
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(lp["attn"], cfg, h, positions, prefix_len)
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], cfg, h)


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

    def _run(self, x: torch.Tensor, prefix_len: int, kv_out: Optional[Dict]
             ) -> torch.Tensor:
        """The full-sequence forward of the embedded sequence ``x``
        (``embed_inputs``) whose first ``prefix_len`` positions every
        position sees; each layer's (k, v) is written into ``kv_out`` (a
        cache's ``"layers"``) when one is given."""
        positions = torch.arange(x.shape[1], device=self.device)[None]
        head_major = self.cfg.cache_layout == "head_major"
        for i, lp in enumerate(self.layers):
            x, (k, v) = _layer_fwd(lp, self.cfg, x, positions, prefix_len)
            if kv_out is not None:
                if head_major:
                    k, v = k.transpose(1, 2), v.transpose(1, 2)
                kv_out["k"][i] = k
                kv_out["v"][i] = v
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
        logits = self._run(x, prefix_len, cache["layers"])
        cache["len"] = int(x.shape[1])
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
        x, _ = embed_inputs(self, tokens)
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]
        for i, lp in enumerate(self.layers):
            x = _layer_decode(lp, self.cfg, x, {"k": kc[i], "v": vc[i]},
                              cache_len)
        cache["len"] = cache_len + 1
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h), cache


def forward(model: Transformer, tokens, prefix_embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over all positions: tokens [B, S] (after
    ``prefix_embeds`` [B, P, d] where given) -> (final hidden [B, P + S,
    D], float32 logits [B, P + S, vocab]), differentiable, each layer under
    ``cfg.remat``."""
    cfg = model.cfg
    x, prefix_len = embed_inputs(model, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=model.device)[None]
    layer = L.remat(functools.partial(_layer_train, cfg=cfg,
                                      prefix_len=prefix_len), cfg)
    for lp in model.layers:
        x = layer(lp, x, positions)
    h = L.norm(model.final_norm, x, cfg.norm_eps)
    return h, L.unembed(model.head, model.embed, h)


def loss_fn(model: Transformer, tokens, labels, prefix_embeds=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of the text's ``logits[:, :-1]`` (the prefix's positions
    dropped) against ``labels[:, 1:]`` (the reference's pairing) and the
    metrics ``{"nll", "moe_aux"}`` (0 for the dense family)."""
    logits = forward(model, tokens, prefix_embeds)[1]
    if prefix_embeds is not None:
        logits = logits[:, int(prefix_embeds.shape[1]):]
    return L.next_token_loss(logits, labels)


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
