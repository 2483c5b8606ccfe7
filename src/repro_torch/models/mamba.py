"""Mamba2 LM, pure SSM and attention-free (counterpart of the reference's
``models/mamba.py``).

Inference: ``prefill`` runs every layer's chunked SSD scan on the
hand-written kernel K4 and keeps, per layer, the conv tail and K4's final
state as the cache; ``decode_step`` is the reference's O(1) recurrent update
as tensor code; both run under ``torch.no_grad`` on frozen parameters.
Training: ``forward`` / ``loss_fn`` over all positions, differentiable --
the scan through ``kernels.ssd_scan.SSDScan``, K4 with its hand-written
backward -- with each layer under the reference's ``cfg.remat``
(``layers.remat``).  The reference scans one stacked layer body with
``lax.scan``; here ``Mamba.layers`` is an ``nn.ModuleList`` walked by a
Python loop.

The module's ``state_dict`` keys are the reference's parameter paths joined
by dots, with the stacked leading L axis of ``params["layers"]`` spread over
``layers.<i>`` (``layers.3.mix.in_x``, ``embed.embed_w``,
``final_norm.scale``), so ``params_from_reference`` carries a reference
``init_params`` pytree over.

The cache is the reference's ``{"len", "ssm": {"conv", "state"}}`` with
``len`` a Python int, ``conv`` [L, B, cw - 1, d_inner + 2 ds] in the model
dtype and ``state`` [L, B, nh, hp, ds] float32.  It does not grow with the
sequence, so decoding straight after ``prefill`` is right (unlike the
transformer's full prefill cache); ``init_cache`` ignores ``max_len`` as
the reference's does.  ``decode_step`` writes the new conv tail and state
into the cache in place.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssd

Cache = Dict[str, object]


def check_ssm(cfg) -> None:
    """Raises for what the SSM path does not compute."""
    if cfg.family != "ssm":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not the pure-SSM path")
    if cfg.ssm_ngroups != 1:
        raise NotImplementedError(
            f"{cfg.name}: ssm_ngroups {cfg.ssm_ngroups}; the SSD scan kernel "
            "K4 takes ngroups == 1")


def init_params(generator, cfg, device=None) -> Dict:
    """The SSM parameter tree with ``layers`` as a list of per-layer trees
    ``{"ln", "mix"}``."""
    p = {"embed": L.init_embed(generator, cfg, device),
         "final_norm": L.init_rmsnorm(cfg.d_model, device),
         "layers": [{"ln": L.init_rmsnorm(cfg.d_model, device),
                     "mix": ssd.init_mamba_block(generator, cfg, device)}
                    for _ in range(cfg.num_layers)]}
    if not cfg.tie_embeddings:
        p["head"] = {"head_w": L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), L.dtype_of(cfg)
        ).to(device)}
    return p


def init_cache(cfg, batch: int, max_len: int = 0,
               device: DeviceLike = "cuda") -> Cache:
    """An empty cache; ``max_len`` is ignored (constant-size state)."""
    del max_len
    return {"len": 0, "ssm": ssd.init_ssm_cache(
        cfg, batch, cfg.num_layers, resolve_device(device, allow_meta=True))}


class Mamba(nn.Module):
    """The Mamba2 LM of ``cfg`` in ``cfg.dtype`` (norms, dt, the scan and
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
        check_ssm(cfg)
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
        self._decode_conv = ssd.DecodeConvJoins(len(self.layers))

    def decode_conv(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s decode conv weight and bias over the joined
        channels, kept up to date with the parameters
        (``ssd.DecodeConvJoins``)."""
        return self._decode_conv.get(i, self.layers[i]["mix"])

    def _run(self, tokens: torch.Tensor, ssm_out: Optional[Dict]
             ) -> torch.Tensor:
        """The full-sequence forward; each layer's conv tail and final
        state are written into ``ssm_out`` (a cache's ``"ssm"``) when one
        is given."""
        x = L.embed(self.embed, tokens)
        for i, lp in enumerate(self.layers):
            h = L.norm(lp["ln"], x, self.cfg.norm_eps)
            if ssm_out is None:
                dx = ssd.mamba_block(lp["mix"], self.cfg, h)
            else:
                dx, (conv_tail, state) = ssd.mamba_block(
                    lp["mix"], self.cfg, h, return_cache=True)
                ssm_out["conv"][i] = conv_tail
                ssm_out["state"][i] = state
            x = x + dx
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, vocab]."""
        return self._run(torch.as_tensor(tokens, device=self.device), None)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """Logits and the cache after the prompt: per layer the conv tail
        and the scan's final state, from the same pass (no replay)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        cache = self.init_cache(int(tokens.shape[0]))
        logits = self._run(tokens, cache["ssm"])
        cache["len"] = int(tokens.shape[1])
        return logits, cache

    def init_cache(self, batch: int, max_len: int = 0) -> Cache:
        return init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: tokens [B, 1] -> (logits [B, 1, vocab],
        the cache with ``len`` + 1, updated in place)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = L.embed(self.embed, tokens)
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        for i, lp in enumerate(self.layers):
            h = L.norm(lp["ln"], x, self.cfg.norm_eps)
            dx, new = ssd.mamba_decode(lp["mix"], self.cfg, h,
                                       {"conv": conv[i], "state": state[i]},
                                       self.decode_conv(i))
            conv[i] = new["conv"]
            state[i] = new["state"]
            x = x + dx
        cache["len"] = int(cache["len"]) + 1
        h = L.norm(self.final_norm, x, self.cfg.norm_eps)
        return L.unembed(self.head, self.embed, h), cache


def _layer_train(lp, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + ssd.mamba_block(lp["mix"], cfg,
                               L.norm(lp["ln"], x, cfg.norm_eps))


def forward(model: Mamba, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over all positions: tokens [B, S] -> (final
    hidden [B, S, D], float32 logits [B, S, vocab]), differentiable, each
    layer under ``cfg.remat``."""
    cfg = model.cfg
    x = L.embed(model.embed, torch.as_tensor(tokens, device=model.device))
    layer = L.remat(functools.partial(_layer_train, cfg=cfg), cfg)
    for lp in model.layers:
        x = layer(lp, x)
    h = L.norm(model.final_norm, x, cfg.norm_eps)
    return h, L.unembed(model.head, model.embed, h)


def loss_fn(model: Mamba, tokens, labels
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of ``logits[:, :-1]`` against ``labels[:, 1:]`` (the
    reference's pairing) and the metrics ``{"nll", "moe_aux"}`` (0: no
    experts)."""
    return L.next_token_loss(forward(model, tokens)[1], labels)


def params_from_reference(params: Mapping, cfg,
                          device: DeviceLike = "cuda") -> Mamba:
    """A ``Mamba`` holding the reference's ``init_params`` pytree
    ``params`` (numpy arrays, bf16 included), the leading L axis of
    ``params["layers"]`` split per layer (``layers.copy_reference_params``)."""
    check_ssm(cfg)
    dev = resolve_device(device)
    model = Mamba(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    L.copy_reference_params(model, params, cfg.num_layers)
    return model
