"""Zamba2 hybrid LM: a Mamba2 backbone and ONE shared attention block
(counterpart of the reference's ``models/zamba.py``).

``cfg.num_layers`` SSM layers; after every full segment of
``cfg.attn_every`` of them the single shared attention + MLP block runs
(the same parameters at every call site, a KV cache for each site), and
not after a shorter tail.  Inference: ``prefill`` runs every layer's scan
on the hand-written kernel K4 and every site's causal attention on K3, and
keeps each layer's conv tail and K4 final state and each site's (k, v);
``decode_step`` is the O(1) recurrent SSM update and single-token attention
against each site's cache, both as tensor code; both run under
``torch.no_grad`` on frozen parameters.  Training: ``forward`` /
``loss_fn`` over all positions, differentiable -- K4 with its hand-written
backward (``kernels.ssd_scan.SSDScan``), K3 with its hand-written backward
(``kernels.flash_attention.FlashAttention``) -- each SSM layer under the
reference's ``cfg.remat`` and the shared block outside it, as the
reference's.  The shared block's gradient is the sum over its sites, by
autograd.

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots, with the stacked leading L axis of ``params["mamba_layers"]``
spread over ``mamba_layers.<i>`` (``mamba_layers.3.mix.in_x``,
``shared_attn.attn.wq``, ``embed.embed_w``), so ``params_from_reference``
carries a reference ``init_params`` pytree over.

The cache is the reference's ``{"len", "ssm": {"conv", "state"}, "attn":
{"k", "v"}}`` with ``len`` a Python int, ``conv`` [L, B, cw - 1, d_inner +
2 ds] in the model dtype, ``state`` [L, B, nh, hp, ds] float32 and ``k`` /
``v`` [sites, B, max_len, KV, hd] (seq-major, as the reference's).  The
prefill cache's attention part is exactly as long as the prompt; copy it
into a larger ``init_cache`` to decode after it.  ``decode_step`` writes
into the cache in place and RAISES, before writing anything, when ``len``
has reached ``max_len``, where the reference's ``dynamic_update_slice``
clamps the index and silently overwrites the last position.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import layers as L
from repro_torch.models import ssd

Cache = Dict[str, object]


def check_hybrid(cfg, device: Optional[torch.device] = None) -> None:
    """Raises for what the hybrid path does not compute: ``ngroups != 1``
    (K4), attention other than GQA or a head-major cache (the reference's
    zamba cache is seq-major), no shared block (``attn_every == 0``); and,
    for a ``device`` other than the CPU, a head dim K3's training kernels
    do not take (``flash_attention.BWD_HEAD_DIMS``; the CPU's plain
    versions take any)."""
    if cfg.family != "hybrid":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not the hybrid path")
    if cfg.attn_every <= 0:
        raise ValueError(f"{cfg.name}: attn_every {cfg.attn_every}; the "
                         "hybrid model runs its shared block after every "
                         "attn_every > 0 SSM layers")
    missing = []
    if cfg.ssm_ngroups != 1:
        missing.append(f"ssm_ngroups {cfg.ssm_ngroups} (the SSD scan kernel "
                       "K4 takes ngroups == 1)")
    if cfg.attn_type != "gqa":
        missing.append(f"attn_type {cfg.attn_type!r}")
    if cfg.cache_layout != "seq_major":
        missing.append(f"cache_layout {cfg.cache_layout!r}")
    if (device is not None and device.type != "cpu"
            and cfg.head_dim not in k3.BWD_HEAD_DIMS):
        missing.append(f"head_dim {cfg.head_dim} on {device.type} (K3 takes "
                       f"{k3.BWD_HEAD_DIMS})")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  "ported")


def n_sites(cfg) -> int:
    """The shared block's call sites: one per full segment."""
    return cfg.num_layers // cfg.attn_every


def _segments(cfg) -> List[Tuple[int, int]]:
    """(start, stop) layer ranges; the shared block runs after each full
    one."""
    e = cfg.attn_every
    return [(i * e, min((i + 1) * e, cfg.num_layers))
            for i in range(-(-cfg.num_layers // e))]


def init_params(generator, cfg, device=None) -> Dict:
    """The hybrid parameter tree with ``mamba_layers`` as a list of
    per-layer trees ``{"ln", "mix"}`` and one ``shared_attn`` tree."""
    p = {"embed": L.init_embed(generator, cfg, device),
         "mamba_layers": [{"ln": L.init_rmsnorm(cfg.d_model, device),
                           "mix": ssd.init_mamba_block(generator, cfg,
                                                       device)}
                          for _ in range(cfg.num_layers)],
         "shared_attn": {"ln1": L.init_rmsnorm(cfg.d_model, device),
                         "attn": L.init_attention(generator, cfg, device),
                         "ln2": L.init_rmsnorm(cfg.d_model, device),
                         "ffn": L.init_ffn(generator, cfg, device=device)},
         "final_norm": L.init_rmsnorm(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["head"] = {"head_w": L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), L.dtype_of(cfg)
        ).to(device)}
    return p


def init_cache(cfg, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """An empty cache with room for ``max_len`` positions at each site."""
    dev = resolve_device(device, allow_meta=True)
    return {"len": 0,
            "ssm": ssd.init_ssm_cache(cfg, batch, cfg.num_layers, dev),
            "attn": L.init_kv_cache(cfg, batch, max_len, n_sites(cfg), dev)}


def _shared_mlp(sp, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + L.ffn_block(sp["ffn"], cfg, L.norm(sp["ln2"], x, cfg.norm_eps))


class Zamba(nn.Module):
    """The Zamba2 LM of ``cfg`` in ``cfg.dtype`` (norms, dt, the scan and
    the state in float32).

    Weights come from ``generator`` (``init_params``), drawn on the
    generator's own device -- a CUDA generator draws on the card -- and
    moved to ``device``; the numbers differ from the reference's, which come
    from ``jax.random``.  ``device`` defaults to the card and raises without
    one; ``device="meta"`` builds the module with shapes only (nothing drawn,
    nothing allocated) for the workload census."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        check_hybrid(cfg, dev)
        generator, ctx = L.init_generator(generator, dev)
        with ctx:
            params = init_params(generator, cfg, dev)
        self.cfg = cfg
        self.device = dev
        self.embed = L.ParamTree(params["embed"])
        self.mamba_layers = nn.ModuleList(L.ParamTree(lp)
                                          for lp in params["mamba_layers"])
        self.shared_attn = L.ParamTree(params["shared_attn"])
        self.final_norm = L.ParamTree(params["final_norm"])
        self.head = (L.ParamTree(params["head"]) if "head" in params
                     else None)
        self._decode_conv = ssd.DecodeConvJoins(cfg.num_layers)

    def decode_conv(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s decode conv weight and bias over the joined
        channels, kept up to date with the parameters
        (``ssd.DecodeConvJoins``)."""
        return self._decode_conv.get(i, self.mamba_layers[i]["mix"])

    def _run(self, tokens: torch.Tensor, cache: Optional[Cache]
             ) -> torch.Tensor:
        """The full-sequence forward; each layer's conv tail and final
        state, and each site's (k, v), are written into ``cache`` when one
        is given."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        site = 0
        for lo, hi in _segments(cfg):
            for i in range(lo, hi):
                lp = self.mamba_layers[i]
                h = L.norm(lp["ln"], x, cfg.norm_eps)
                if cache is None:
                    dx = ssd.mamba_block(lp["mix"], cfg, h)
                else:
                    dx, (conv_tail, state) = ssd.mamba_block(
                        lp["mix"], cfg, h, return_cache=True)
                    cache["ssm"]["conv"][i] = conv_tail
                    cache["ssm"]["state"][i] = state
                x = x + dx
            if hi - lo == cfg.attn_every:
                sp = self.shared_attn
                a, (k, v) = L.attention_prefill(
                    sp["attn"], cfg, L.norm(sp["ln1"], x, cfg.norm_eps),
                    positions)
                x = _shared_mlp(sp, cfg, x + a)
                if cache is not None:
                    cache["attn"]["k"][site] = k
                    cache["attn"]["v"][site] = v
                site += 1
        h = L.norm(self.final_norm, x, cfg.norm_eps)
        return L.unembed(self.head, self.embed, h)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, vocab]."""
        return self._run(torch.as_tensor(tokens, device=self.device), None)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """Logits and the cache after the prompt, from the same pass: per
        layer the conv tail and the scan's final state, per site (k, v) in
        a cache whose ``max_len`` is the prompt length (as the
        reference's)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        cache = self.init_cache(*tokens.shape)
        logits = self._run(tokens, cache)
        cache["len"] = int(tokens.shape[1])
        return logits, cache

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: tokens [B, 1] -> (logits [B, 1, vocab],
        the cache with ``len`` + 1, updated in place).  A full cache raises
        before anything is written."""
        cfg = self.cfg
        cache_len = int(cache["len"])
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        if n_sites(cfg) and cache_len >= kc.shape[2]:
            raise ValueError(
                f"cache is full (len {cache_len} == max_len {kc.shape[2]}); "
                "the reference would clamp the write index and overwrite the "
                "last position -- allocate a larger cache (init_cache) and "
                "copy the prefill cache into it")
        tokens = torch.as_tensor(tokens, device=self.device)
        x = L.embed(self.embed, tokens)
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        site = 0
        for lo, hi in _segments(cfg):
            for i in range(lo, hi):
                lp = self.mamba_layers[i]
                h = L.norm(lp["ln"], x, cfg.norm_eps)
                dx, new = ssd.mamba_decode(lp["mix"], cfg, h,
                                           {"conv": conv[i],
                                            "state": state[i]},
                                           self.decode_conv(i))
                conv[i] = new["conv"]
                state[i] = new["state"]
                x = x + dx
            if hi - lo == cfg.attn_every:
                sp = self.shared_attn
                a, _ = L.attention_decode(
                    sp["attn"], cfg, L.norm(sp["ln1"], x, cfg.norm_eps),
                    {"k": kc[site], "v": vc[site]}, cache_len)
                x = _shared_mlp(sp, cfg, x + a)
                site += 1
        cache["len"] = cache_len + 1
        h = L.norm(self.final_norm, x, cfg.norm_eps)
        return L.unembed(self.head, self.embed, h), cache


def _layer_train(lp, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + ssd.mamba_block(lp["mix"], cfg,
                               L.norm(lp["ln"], x, cfg.norm_eps))


def _shared_train(sp, cfg, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention_block(sp["attn"], cfg,
                              L.norm(sp["ln1"], x, cfg.norm_eps), positions)
    return _shared_mlp(sp, cfg, x)


def forward(model: Zamba, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over all positions: tokens [B, S] -> (final
    hidden [B, S, D], float32 logits [B, S, vocab]), differentiable, each
    SSM layer under ``cfg.remat`` and the shared block outside it (the
    reference's ``zamba.forward``)."""
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.device)
    x = L.embed(model.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=model.device)[None]
    layer = L.remat(functools.partial(_layer_train, cfg=cfg), cfg)
    for lo, hi in _segments(cfg):
        for i in range(lo, hi):
            x = layer(model.mamba_layers[i], x)
        if hi - lo == cfg.attn_every:
            x = _shared_train(model.shared_attn, cfg, x, positions)
    h = L.norm(model.final_norm, x, cfg.norm_eps)
    return h, L.unembed(model.head, model.embed, h)


def loss_fn(model: Zamba, tokens, labels
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of ``logits[:, :-1]`` against ``labels[:, 1:]`` (the
    reference's pairing) and the metrics ``{"nll", "moe_aux"}`` (0: no
    experts)."""
    return L.next_token_loss(forward(model, tokens)[1], labels)


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> Zamba:
    """A ``Zamba`` holding the reference's ``init_params`` pytree ``params``
    (numpy arrays, bf16 included), the leading L axis of
    ``params["mamba_layers"]`` split per layer and ``shared_attn`` copied
    once (``layers.copy_reference_params``)."""
    dev = resolve_device(device)
    check_hybrid(cfg, dev)
    model = Zamba(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    L.copy_reference_params(model, params, cfg.num_layers)
    return model
