"""Whisper-small encoder-decoder backbone (counterpart of the reference's
``models/whisper.py``).

The conv / log-mel frontend is a stub, as the reference's: the inputs are
precomputed frame embeddings ``frames`` [B, num_frames, d_model].  The
encoder is ``cfg.encoder_layers`` pre-LN blocks (layer norm with a bias,
bidirectional attention, a GELU MLP) over the frames plus learned
``enc_pos``; the decoder is ``cfg.num_layers`` blocks of causal self
attention, cross attention over the encoder's output and a GELU MLP over
the tokens' embeddings plus learned ``dec_pos`` (``max_seq`` rows); the
token embedding is tied to the unembedding.

Inference: ``prefill`` runs the encoder's attention (not causal, S = the
frames), the decoder's self attention (causal) and its cross attention
(queries of the prompt's length over the frames' keys) on the hand-written
kernel K3, and keeps each decoder layer's self (k, v) and cross (k, v);
``decode_step`` is single-token attention against both caches, as tensor
code; both run under ``torch.no_grad`` on frozen parameters.  Training:
``forward`` / ``loss_fn`` over all positions, differentiable -- every
attention on K3 with its hand-written backward
(``kernels.flash_attention.FlashAttention``) -- each encoder and decoder
layer under the reference's ``cfg.remat``.

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots, with the stacked leading L axes of ``params["enc_layers"]`` and
``params["dec_layers"]`` spread over ``enc_layers.<i>`` and
``dec_layers.<i>`` (``enc_layers.3.attn.wq``,
``dec_layers.0.cross_attn.wk``, ``dec_pos.pos_w``), so
``params_from_reference`` carries a reference ``init_params`` pytree over.

The cache is the reference's ``{"len", "self": {"k", "v"}, "cross": {"k",
"v"}}`` with ``len`` a Python int, ``self`` [L, B, max_len, KV, hd] and
``cross`` [L, B, num_frames, KV, hd] in the model dtype.  The prefill
cache's self part is exactly as long as the prompt; copy it into a larger
``init_cache`` to decode after it.  ``decode_step`` writes into the cache in
place and RAISES, before writing anything, where the reference clamps: a
full self cache (its ``dynamic_update_slice`` would overwrite the last
position) or ``len`` at or past ``dec_pos``'s rows (its
``dynamic_slice_in_dim`` would reuse the last row).
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import layers as L

Cache = Dict[str, object]


def check_audio(cfg, device: Optional[torch.device] = None) -> None:
    """Raises for what the audio path does not compute: a config without an
    encoder, rope (whisper's positions are learned), attention other than
    GQA, q / k norms or qkv biases (the reference's decode computes the
    cross query without them), a head-major cache (the reference's whisper
    cache is seq-major); and, for a ``device`` other than the CPU, a head
    dim K3's training kernels do not take (``flash_attention.BWD_HEAD_DIMS``;
    the CPU's plain versions take any)."""
    if cfg.family != "audio":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not the audio path")
    if not (cfg.is_encoder_decoder and cfg.encoder_layers > 0
            and cfg.num_frames > 0):
        raise ValueError(f"{cfg.name}: the audio model needs an encoder "
                         f"(is_encoder_decoder, encoder_layers "
                         f"{cfg.encoder_layers}, num_frames {cfg.num_frames})")
    missing = []
    if cfg.use_rope:
        missing.append("use_rope")
    if cfg.attn_type != "gqa":
        missing.append(f"attn_type {cfg.attn_type!r}")
    if cfg.qk_norm or cfg.qkv_bias:
        missing.append("qk_norm / qkv_bias")
    if cfg.cache_layout != "seq_major":
        missing.append(f"cache_layout {cfg.cache_layout!r}")
    if (device is not None and device.type != "cpu"
            and cfg.head_dim not in k3.BWD_HEAD_DIMS):
        missing.append(f"head_dim {cfg.head_dim} on {device.type} (K3 takes "
                       f"{k3.BWD_HEAD_DIMS})")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  "ported")


def init_params(generator, cfg, max_seq: int = 4096, device=None) -> Dict:
    """The whisper parameter tree with ``enc_layers`` and ``dec_layers`` as
    lists of per-layer trees."""
    dt = L.dtype_of(cfg)
    d = cfg.d_model

    def pos(rows):
        return {"pos_w": L.dense_init(generator, (rows, d), dt).to(device)}

    def enc_layer():
        return {"ln1": L.init_layernorm(d, device),
                "attn": L.init_attention(generator, cfg, device),
                "ln2": L.init_layernorm(d, device),
                "ffn": L.init_ffn(generator, cfg, device=device)}

    def dec_layer():
        return {"ln1": L.init_layernorm(d, device),
                "self_attn": L.init_attention(generator, cfg, device),
                "ln2": L.init_layernorm(d, device),
                "cross_attn": L.init_attention(generator, cfg, device),
                "ln3": L.init_layernorm(d, device),
                "ffn": L.init_ffn(generator, cfg, device=device)}

    return {"embed": L.init_embed(generator, cfg, device),
            "enc_pos": pos(cfg.num_frames),
            "dec_pos": pos(max_seq),
            "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
            "dec_layers": [dec_layer() for _ in range(cfg.num_layers)],
            "enc_norm": L.init_layernorm(d, device),
            "dec_norm": L.init_layernorm(d, device)}


def init_cache(cfg, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """An empty cache: room for ``max_len`` positions of self attention and
    the frames' cross (k, v), each decoder layer."""
    dev = resolve_device(device, allow_meta=True)
    return {"len": 0,
            "self": L.init_kv_cache(cfg, batch, max_len, cfg.num_layers, dev),
            "cross": L.init_kv_cache(cfg, batch, cfg.num_frames,
                                     cfg.num_layers, dev)}


def _enc_layer(lp, x: torch.Tensor, positions: torch.Tensor,
               cfg) -> torch.Tensor:
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.attention_encode(lp["attn"], cfg, h, positions)
    return x + L.ffn_block(lp["ffn"], cfg, L.norm(lp["ln2"], x, cfg.norm_eps))


def _dec_tail(lp, cfg, x: torch.Tensor,
              kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Cross attention over ``kv`` and the MLP, after the self attention."""
    h = L.norm(lp["ln2"], x, cfg.norm_eps)
    x = x + L.attention_cross(lp["cross_attn"], cfg, h, kv)
    return x + L.ffn_block(lp["ffn"], cfg, L.norm(lp["ln3"], x, cfg.norm_eps))


def _dec_layer(lp, x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor, cfg) -> torch.Tensor:
    h = L.norm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(lp["self_attn"], cfg, h, positions)
    return _dec_tail(lp, cfg, x, L.cross_kv(lp["cross_attn"], enc_out))


class Whisper(nn.Module):
    """The whisper backbone of ``cfg`` in ``cfg.dtype`` (norms and softmax
    statistics in float32), with ``max_seq`` rows of decoder positions.

    Weights come from ``generator`` (``init_params``), drawn on the
    generator's own device -- a CUDA generator draws on the card -- and
    moved to ``device``; the numbers differ from the reference's, which come
    from ``jax.random``.  ``device`` defaults to the card and raises without
    one; ``device="meta"`` builds the module with shapes only (nothing drawn,
    nothing allocated) for the workload census."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda", max_seq: int = 4096):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        check_audio(cfg, dev)
        generator, ctx = L.init_generator(generator, dev)
        with ctx:
            params = init_params(generator, cfg, max_seq, dev)
        self.cfg = cfg
        self.device = dev
        self.max_seq = max_seq
        self.embed = L.ParamTree(params["embed"])
        self.enc_pos = L.ParamTree(params["enc_pos"])
        self.dec_pos = L.ParamTree(params["dec_pos"])
        self.enc_layers = nn.ModuleList(L.ParamTree(lp)
                                        for lp in params["enc_layers"])
        self.dec_layers = nn.ModuleList(L.ParamTree(lp)
                                        for lp in params["dec_layers"])
        self.enc_norm = L.ParamTree(params["enc_norm"])
        self.dec_norm = L.ParamTree(params["dec_norm"])

    def frames_in(self, frames) -> torch.Tensor:
        """``frames`` (numpy or a tensor, any float dtype) [B, num_frames,
        d] on the module's device in the model dtype (the reference's
        ``frames.astype``)."""
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=self.device).to(
            L.dtype_of(cfg))
        if frames.dim() != 3 or tuple(frames.shape[1:]) != (cfg.num_frames,
                                                            cfg.d_model):
            raise ValueError(f"frames must be [B, {cfg.num_frames}, "
                             f"{cfg.d_model}]; got {tuple(frames.shape)}")
        return frames

    def _positions(self, s: int) -> torch.Tensor:
        if s > self.max_seq:
            raise ValueError(f"{s} tokens past the decoder's {self.max_seq} "
                             "positions (max_seq)")
        return torch.arange(s, device=self.device)[None]

    def encode(self, frames) -> torch.Tensor:
        """The encoder's output [B, num_frames, d] (after ``enc_norm``);
        every layer's attention on K3, not causal."""
        cfg = self.cfg
        x = self.frames_in(frames) + self.enc_pos["pos_w"][None]
        positions = torch.arange(x.shape[1], device=self.device)[None]
        layer = L.remat(functools.partial(_enc_layer, cfg=cfg), cfg)
        for lp in self.enc_layers:
            x = layer(lp, x, positions)
        return L.norm(self.enc_norm, x, cfg.norm_eps)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return (L.embed(self.embed, tokens)
                + self.dec_pos["pos_w"][None, :tokens.shape[1]])

    @torch.no_grad()
    def prefill(self, tokens, frames) -> Tuple[torch.Tensor, Cache]:
        """Float32 logits [B, S, vocab] and the cache after the prompt, from
        the same pass: each decoder layer's self (k, v), exactly
        prompt-long (as the reference's), and its cross (k, v) over the
        frames."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        positions = self._positions(s)
        enc_out = self.encode(frames)
        cache = self.init_cache(b, s)
        x = self._embed(tokens)
        for i, lp in enumerate(self.dec_layers):
            h = L.norm(lp["ln1"], x, cfg.norm_eps)
            a, (k, v) = L.attention_prefill(lp["self_attn"], cfg, h,
                                            positions)
            ck, cv = L.cross_kv(lp["cross_attn"], enc_out)
            x = _dec_tail(lp, cfg, x + a, (ck, cv))
            cache["self"]["k"][i] = k
            cache["self"]["v"][i] = v
            cache["cross"]["k"][i] = ck
            cache["cross"]["v"][i] = cv
        cache["len"] = int(s)
        h = L.norm(self.dec_norm, x, cfg.norm_eps)
        return L.unembed(None, self.embed, h), cache

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, tokens, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: tokens [B, 1] -> (logits [B, 1, vocab],
        the cache with ``len`` + 1, updated in place).  A full self cache,
        or ``len`` at or past ``dec_pos``'s rows, raises before anything is
        written."""
        cfg = self.cfg
        cache_len = int(cache["len"])
        sk, sv = cache["self"]["k"], cache["self"]["v"]
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        if cache_len >= sk.shape[2]:
            raise ValueError(
                f"cache is full (len {cache_len} == max_len {sk.shape[2]}); "
                "the reference would clamp the write index and overwrite the "
                "last position -- allocate a larger cache (init_cache) and "
                "copy the prefill cache into it")
        if cache_len >= self.max_seq:
            raise ValueError(
                f"position {cache_len} is past the decoder's {self.max_seq} "
                "positions (max_seq); the reference would clamp it and reuse "
                "the last position's embedding")
        tokens = torch.as_tensor(tokens, device=self.device)
        x = L.embed(self.embed, tokens) + \
            self.dec_pos["pos_w"][cache_len][None, None]
        for i, lp in enumerate(self.dec_layers):
            h = L.norm(lp["ln1"], x, cfg.norm_eps)
            a, _ = L.attention_decode(lp["self_attn"], cfg, h,
                                      {"k": sk[i], "v": sv[i]}, cache_len)
            x = x + a
            h = L.norm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.attention_cross_decode(lp["cross_attn"], cfg, h,
                                             (ck[i], cv[i]))
            x = x + L.ffn_block(lp["ffn"], cfg,
                                L.norm(lp["ln3"], x, cfg.norm_eps))
        cache["len"] = cache_len + 1
        h = L.norm(self.dec_norm, x, cfg.norm_eps)
        return L.unembed(None, self.embed, h), cache


def forward(model: Whisper, tokens, frames
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over all positions: tokens [B, S] and frames
    [B, num_frames, d] -> (final hidden [B, S, d], float32 logits [B, S,
    vocab]), differentiable, each encoder and decoder layer under
    ``cfg.remat`` (the reference's ``whisper.forward``)."""
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.device)
    positions = model._positions(tokens.shape[1])
    enc_out = model.encode(frames)
    x = model._embed(tokens)
    layer = L.remat(functools.partial(_dec_layer, cfg=cfg), cfg)
    for lp in model.dec_layers:
        x = layer(lp, x, positions, enc_out)
    h = L.norm(model.dec_norm, x, cfg.norm_eps)
    return h, L.unembed(None, model.embed, h)


def loss_fn(model: Whisper, tokens, labels, frames
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of ``logits[:, :-1]`` against ``labels[:, 1:]`` (the
    reference's pairing) and the metrics ``{"nll", "moe_aux"}`` (0: no
    experts)."""
    return L.next_token_loss(forward(model, tokens, frames)[1], labels)


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> Whisper:
    """A ``Whisper`` holding the reference's ``init_params`` pytree
    ``params`` (numpy arrays, bf16 included), with as many decoder
    positions as its ``dec_pos``, the leading L axes of
    ``params["enc_layers"]`` and ``params["dec_layers"]`` split per layer
    (``layers.copy_reference_params``)."""
    dev = resolve_device(device)
    check_audio(cfg, dev)
    max_seq = int(params["dec_pos"]["pos_w"].shape[0])
    model = Whisper(cfg, device=dev, max_seq=max_seq,
                    generator=torch.Generator(device=dev).manual_seed(0))
    L.copy_reference_params(model, params, {
        root: L.stack_depth(cfg, root) for root in ("enc_layers",
                                                    "dec_layers")})
    return model
