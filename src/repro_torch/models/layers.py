"""Layers the models share (counterparts of the reference's
``models/layers.py`` functions of the same names).

Conventions, as in the reference: parameters are nested string-keyed
mappings of tensors (a ``ParamTree`` module, or a plain dict); activations
are [B, S, ...] and attention uses the BSHD layout; products run in the
config dtype, softmax and norm statistics in float32, cast back once.
Prefill attention -- causal, an encoder's bidirectional attention and a
decoder's cross attention over an encoder's output alike -- goes through
``kernels.ops.flash_attention`` (the hand-written kernel K3); single-token
decode attention is plain tensor code, as the reference computes it outside
any Pallas kernel.  Large products are
``torch.matmul`` / ``einsum``, as the reference leaves them to XLA.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels import ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

NEG_INF = -1e30


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


def init_generator(generator: Optional[torch.Generator],
                   device: torch.device):
    """``(generator, context)`` for drawing a model's weights on ``device``:
    ``generator`` (seed 0 on ``device`` when None) under no context; on the
    meta device no generator -- nothing is drawn -- and the context makes
    ``dense_init`` create its tensors there (shapes and dtypes only)."""
    if device.type == "meta":
        return None, torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator, contextlib.nullcontext()


class ParamTree(nn.Module):
    """A nested mapping of parameters as a module: ``tree["wq"]`` and
    ``"bias" in tree`` read like the reference's parameter dicts, and the
    ``state_dict`` keys are the reference's paths joined by dots.  The
    parameters are made frozen, for the inference entries; a training entry
    turns gradients on (``models.api.init_train_state``)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# the reference's parameter roots that stack one leaf a layer along a leading
# [L, ...] axis: the dense and SSM models' ``layers``, zamba's
# ``mamba_layers``, whisper's ``enc_layers`` and ``dec_layers``, the MoE
# family's ``dense_layers`` and ``moe_layers``; the port spreads each over
# ``<root>.<i>``
STACKED_ROOTS = ("layers", "mamba_layers", "enc_layers", "dec_layers",
                 "dense_layers", "moe_layers")


def stack_depth(cfg, root: str) -> int:
    """The layers of the stacked root ``root``: ``cfg.encoder_layers`` for
    whisper's ``enc_layers``, ``cfg.first_k_dense`` for the MoE family's
    ``dense_layers`` and the rest of ``cfg.num_layers`` for its
    ``moe_layers``, ``cfg.num_layers`` for every other root."""
    if root == "enc_layers":
        return cfg.encoder_layers
    if root == "dense_layers":
        return cfg.first_k_dense
    if root == "moe_layers":
        return cfg.num_layers - cfg.first_k_dense
    return cfg.num_layers


def copy_reference_params(module: nn.Module, params: Mapping,
                          num_layers: Union[int, Mapping[str, int]]) -> None:
    """Copies the reference's ``init_params`` pytree ``params`` (nested
    dicts of arrays; any float dtype that numpy can cast to float32, bf16
    included) into ``module``, whose ``state_dict`` keys are the
    reference's paths joined by dots.  The leading L axis of each stacked
    root (``STACKED_ROOTS``: ``params["layers"]``,
    ``params["mamba_layers"]``, ...) is split one layer at a time over
    ``<root>.<i>``, L being ``num_layers`` (or ``num_layers[root]``, a
    mapping for models whose stacks differ in depth); every leaf must match
    one parameter by path and shape, and is cast to that parameter's
    dtype."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            root, _, rest = path.partition(".")
            if isinstance(v, Mapping):
                walk(v, path)
            elif root in STACKED_ROOTS and rest:
                arr = np.asarray(v)
                n = (num_layers[root] if isinstance(num_layers, Mapping)
                     else num_layers)
                if arr.shape[:1] != (n,):
                    raise ValueError(f"{path}: leading axis {arr.shape[:1]}, "
                                     f"expected ({n},) layers")
                for i in range(n):
                    flat[f"{root}.{i}.{rest}"] = np.array(arr[i],
                                                          dtype=np.float32)
            else:
                flat[path] = np.array(v, dtype=np.float32)

    walk(params, "")
    state = module.state_dict()
    if set(flat) != set(state):
        raise ValueError(f"reference params do not match the module: only "
                         f"reference {sorted(set(flat) - set(state))[:4]}, "
                         f"only module {sorted(set(state) - set(flat))[:4]}")
    for key, target in state.items():
        if tuple(flat[key].shape) != tuple(target.shape):
            raise ValueError(f"{key}: reference shape {flat[key].shape}, "
                             f"module shape {tuple(target.shape)}")
        target.copy_(torch.from_numpy(flat[key]).to(target.dtype))


def reference_key(name: str) -> Tuple[str, Optional[int]]:
    """The reference's path of the port's parameter ``name`` and its layer
    (``layers.3.attn.wq`` -> ``("layers/attn/wq", 3)``,
    ``mamba_layers.5.mix.D`` -> ``("mamba_layers/mix/D", 5)``; an unstacked
    parameter's layer is None)."""
    parts = name.split(".")
    if parts[0] in STACKED_ROOTS:
        return "/".join(parts[:1] + parts[2:]), int(parts[1])
    return "/".join(parts), None


# --- rematerialisation -----------------------------------------------------------

# what the reference's "dots" policy (dots_with_no_batch_dims_saveable)
# keeps: the products without batch dimensions -- here every projection,
# each one aten.mm once matmul has folded [B, S, d] into rows
_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(body: Callable, cfg) -> Callable:
    """``body`` (one layer of a training forward) under ``cfg.remat``, as
    the reference's ``_remat``: ``"none"`` keeps every activation;
    ``"full"`` keeps only the layer's inputs and recomputes the layer in
    the backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"``
    keeps the outputs of the projections too (a selective-checkpoint
    policy)."""
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        return lambda *args: _ckpt.checkpoint(body, *args,
                                              use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *args: _ckpt.checkpoint(body, *args,
                                              use_reentrant=False,
                                              context_fn=ctx)
    raise ValueError(f"unknown remat policy {cfg.remat!r}; expected "
                     "'none', 'dots' or 'full'")


# --- normalization -------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def init_layernorm(d: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# --- rotary embeddings -----------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] or [S]."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs             # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- attention -----------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): x [B, S, d] by w [d, heads, k]."""
    d, heads, k = w.shape
    return (x @ w.reshape(d, heads * k)).reshape(*x.shape[:-1], heads, k)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): o [B, S, heads, k] by w [heads, k, d]."""
    heads, k, d = w.shape
    return o.reshape(*o.shape[:-2], heads * k) @ w.reshape(heads * k, d)


def _qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                    prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill) through K3, with
    K3's backward where autograd records (``ops.flash_attention``); the
    first ``prefix_len`` positions (PaliGemma's image patches) seen by every
    row."""
    return attention_prefill(p, cfg, x, positions, prefix_len)[0]


def attention_prefill(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                      prefix_len: int = 0):
    """Prefill: causal attention through K3, with a bidirectional prefix of
    ``prefix_len`` positions, that also returns (k, v) for the cache."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = ops.flash_attention(q, k, v, causal=True, prefix_len=prefix_len,
                            scale=cfg.head_dim ** -0.5)
    return _out(o, p["wo"]), (k, v)


def attention_encode(p, cfg, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional (encoder) self attention through K3 (``causal=False``;
    the reference's is a materialised float32 softmax)."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = ops.flash_attention(q, k, v, causal=False,
                            scale=cfg.head_dim ** -0.5)
    return _out(o, p["wo"])


def cross_kv(p, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys and values of cross attention: ``enc_out`` [B, F, d] by
    ``wk`` and ``wv`` (no bias, as the reference's), [B, F, KV, hd]."""
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


def attention_cross(p, cfg, x: torch.Tensor,
                    kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Cross attention of the queries ``x`` [B, S, d] by ``wq`` over the
    given keys and values ``kv`` ([B, F, KV, hd], from ``cross_kv``), not
    causal, through K3 with its key length apart from the query length.
    The reference's ``attention_block(..., kv_override=...)`` also projects
    k and v from ``x`` and drops them; the port projects only q."""
    k, v = kv
    o = ops.flash_attention(_proj(x, p["wq"]), k, v, causal=False,
                            scale=cfg.head_dim ** -0.5)
    return _out(o, p["wo"])


def _decode_softmax_av(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cache_len: int, scale: float, s_eq: str,
                       o_eq: str, seq_axis: int) -> torch.Tensor:
    """Scores in float32 (bf16 products are exact in float32: the
    reference's ``preferred_element_type=float32``), positions at or past
    ``cache_len`` set to ``NEG_INF``, softmax in float32, ``p`` cast to the
    cache dtype and the product accumulated in float32."""
    s = torch.einsum(s_eq, qg.float(), k.float()) * scale
    valid = torch.arange(k.shape[seq_axis], device=k.device) < cache_len
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    return torch.einsum(o_eq, pr.to(v.dtype).float(), v.float())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: float) -> torch.Tensor:
    """Single-step decode: q [B, 1, H, hd]; caches [B, Smax, KV, hd]."""
    b, _, h, hd = q.shape
    kv, hv = k_cache.shape[2], v_cache.shape[-1]
    qg = q.reshape(b, kv, h // kv, hd)
    o = _decode_softmax_av(qg, k_cache, v_cache, cache_len, scale,
                           "bkgd,bskd->bkgs", "bkgs,bskd->bkgd", 1)
    return o.reshape(b, 1, h, hv).to(q.dtype)


def decode_attention_hm(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_len: int, *,
                        scale: float) -> torch.Tensor:
    """Head-major decode: caches [B, KV, Smax, hd]."""
    b, _, h, hd = q.shape
    kv, hv = k_cache.shape[1], v_cache.shape[-1]
    qg = q.reshape(b, kv, h // kv, hd)
    o = _decode_softmax_av(qg, k_cache, v_cache, cache_len, scale,
                           "bkgd,bksd->bkgs", "bkgs,bksd->bkgd", 2)
    return o.reshape(b, 1, h, hv).to(q.dtype)


def attention_decode(p, cfg, x: torch.Tensor, cache: Mapping,
                     cache_len: int):
    """Single-token decode against one layer's cache ``{"k", "v"}``
    (seq_major [B, Smax, KV, hd] | head_major [B, KV, Smax, hd]).  The new
    k, v are written at ``cache_len`` IN PLACE (the reference returns
    updated copies; writing in place saves a copy of the whole cache per
    layer and step), and the call raises when ``cache_len`` is past the
    cache, where the reference's ``dynamic_update_slice`` would clamp the
    index and overwrite the last position."""
    max_len = cache["k"].shape[2 if cfg.cache_layout == "head_major" else 1]
    if cache_len >= max_len:
        raise ValueError(
            f"cache is full (len {cache_len} == max_len {max_len}); the "
            "reference would clamp the write index and overwrite the last "
            "position -- allocate a larger cache (init_cache) and copy the "
            "prefill cache into it")
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    scale = cfg.head_dim ** -0.5
    if cfg.cache_layout == "head_major":
        cache["k"][:, :, cache_len] = k[:, 0]
        cache["v"][:, :, cache_len] = v[:, 0]
        o = decode_attention_hm(q, cache["k"], cache["v"], cache_len + 1,
                                scale=scale)
    else:
        cache["k"][:, cache_len] = k[:, 0]
        cache["v"][:, cache_len] = v[:, 0]
        o = decode_attention(q, cache["k"], cache["v"], cache_len + 1,
                             scale=scale)
    return _out(o, p["wo"]), cache


def attention_cross_decode(p, cfg, x: torch.Tensor,
                           kv: Tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
    """Single-token cross attention of ``x`` [B, 1, d] (``wq`` only) over a
    layer's whole cross cache ``kv`` ([B, F, KV, hd] each), as tensor code:
    the reference's ``decode_attention`` over all F keys."""
    k, v = kv
    o = decode_attention(_proj(x, p["wq"]), k, v, k.shape[1],
                         scale=cfg.head_dim ** -0.5)
    return _out(o, p["wo"])


def init_kv_cache(cfg, batch: int, max_len: int, layers: int,
                  device=None) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.cache_layout == "head_major":
        shape = (layers, batch, kv, max_len, hd)
    else:
        shape = (layers, batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_attention(generator, cfg, device=None) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    wo_scale = 0.02 / max(cfg.num_layers, 1) ** 0.5
    p = {"wq": dense_init(generator, (d, h, hd), dt),
         "wk": dense_init(generator, (d, kv, hd), dt),
         "wv": dense_init(generator, (d, kv, hd), dt),
         "wo": dense_init(generator, (h, hd, d), dt, scale=wo_scale)}
    p = {key: t.to(device) for key, t in p.items()}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device)
        p["k_norm"] = init_rmsnorm(hd, device)
    return p


# --- feed-forward ------------------------------------------------------------------

def init_ffn(generator, cfg, d_ff: Optional[int] = None,
             device=None) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {"w_in": dense_init(generator, (d, f), dt),
         "w_out": dense_init(generator, (f, d), dt,
                             scale=0.02 / max(cfg.num_layers, 1) ** 0.5)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, (d, f), dt)
    return {key: t.to(device) for key, t in p.items()}


def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act_fn == "silu" else F.gelu(x, approximate="tanh")


def ffn_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = _act(cfg, x @ p["w_gate"]) * h
    else:
        h = _act(cfg, h)
    return h @ p["w_out"]


# --- embeddings / head ----------------------------------------------------------------

def init_embed(generator, cfg, device=None) -> Dict[str, torch.Tensor]:
    w = dense_init(generator, (cfg.vocab_size, cfg.d_model), dtype_of(cfg),
                   scale=1.0 / cfg.d_model ** 0.5)
    return {"embed_w": w.to(device)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["embed_w"])


def unembed(p_head, p_embed, x: torch.Tensor) -> torch.Tensor:
    w = p_embed["embed_w"].T if p_head is None else p_head["head_w"]
    return (x @ w).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in float32; logits [B, S, V], labels [B, S] (negative
    = pad / ignore)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(labels, 0)[..., None].long())[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def next_token_loss(logits: torch.Tensor, labels
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The LM loss of the reference's ``loss_fn``: mean NLL of
    ``logits[:, :-1]`` against ``labels[:, 1:]``, and the metrics ``{"nll",
    "moe_aux"}`` (0 without experts)."""
    labels = torch.as_tensor(labels, device=logits.device)
    loss = cross_entropy(logits[:, :-1], labels[:, 1:])
    return loss, {"nll": loss.detach(),
                  "moe_aux": torch.zeros((), dtype=torch.float32,
                                         device=logits.device)}
