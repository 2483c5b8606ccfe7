"""Multi-head latent attention (deepseek v2 / v3; the counterpart of the
reference's ``models/mla.py``).

Two modes, as the reference's:

* train / prefill: the KV latent is decompressed to per-head keys and
  values, ``k_rope`` (one rotary key a position) is broadcast to every
  head, and attention runs on the hand-written kernel K3 at head dims
  (192, 128): q / k of ``qk_nope_head_dim`` + ``qk_rope_head_dim``
  columns, v of ``v_head_dim``, H == KV (``ops.flash_attention``, with
  K3's backward where autograd records).
* decode (absorbed): ``W_UK`` folds into the query and ``W_UV`` into the
  output, so the cache holds only the compressed latent ``c_kv``
  [kv_lora_rank] and ``k_rope`` [qk_rope_head_dim] a position.  Float32
  tensor code, operation for operation the reference's (which runs no
  kernel there either).

The cache of a layer is ``{"c_kv": [B, Smax, kvr], "k_rope": [B, Smax,
rope]}``; ``mla_decode`` writes the new position IN PLACE and raises when
the cache is full, where the reference's ``dynamic_update_slice`` clamps
the index and overwrites the last position.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_mla(generator, cfg, device=None) -> Dict:
    """The reference's ``init_mla`` tree: ``wq_a`` [d, q_lora],
    ``q_a_norm``, ``wq_b`` [q_lora, H, nope + rope] (``wq`` [d, H, nope +
    rope] without a q LoRA), ``wkv_a`` [d, kv_lora + rope], ``kv_a_norm``,
    ``wkv_b`` [kv_lora, H, nope + v], ``wo`` [H, v, d] (scaled by
    1/sqrt(L))."""
    d, h = cfg.d_model, cfg.num_heads
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    kvr, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dt = L.dtype_of(cfg)
    p = {}
    if qr:
        p["wq_a"] = L.dense_init(generator, (d, qr), dt).to(device)
        p["q_a_norm"] = L.init_rmsnorm(qr, device)
        p["wq_b"] = L.dense_init(generator, (qr, h, nope + rope_d),
                                 dt).to(device)
    else:
        p["wq"] = L.dense_init(generator, (d, h, nope + rope_d),
                               dt).to(device)
    p["wkv_a"] = L.dense_init(generator, (d, kvr + rope_d), dt).to(device)
    p["kv_a_norm"] = L.init_rmsnorm(kvr, device)
    p["wkv_b"] = L.dense_init(generator, (kvr, h, nope + vd), dt).to(device)
    p["wo"] = L.dense_init(generator, (h, vd, d), dt,
                           scale=0.02 / max(cfg.num_layers, 1) ** 0.5
                           ).to(device)
    return p


def _project_q(p, cfg, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] rotated)."""
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        qa = L.rmsnorm(p["q_a_norm"], x @ p["wq_a"], cfg.norm_eps)
        q = L._proj(qa, p["wq_b"])
    else:
        q = L._proj(x, p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(p, cfg, x: torch.Tensor, positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv [B, S, kvr] normed, k_rope [B, S, 1, rope] rotated)."""
    kvr = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    c_kv = L.rmsnorm(p["kv_a_norm"], kv[..., :kvr], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., kvr:][:, :, None, :], positions,
                          cfg.rope_theta)
    return c_kv, k_rope


def _attend(p, cfg, x: torch.Tensor, positions: torch.Tensor,
            prefix_len: int):
    """The decompressed attention of ``mla_block`` / ``mla_prefill``: (its
    output [B, S, d], the cache entries (c_kv [B, S, kvr], k_rope [B, S,
    rope]))."""
    nope = cfg.qk_nope_head_dim
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c_kv, k_rope = _project_kv_latent(p, cfg, x, positions)
    kv_up = L._proj(c_kv, p["wkv_b"])
    k_nope, v = kv_up[..., :nope], kv_up[..., nope:]
    k_rope_b = k_rope.expand(*k_rope.shape[:2], cfg.num_heads,
                             k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    scale = (nope + cfg.qk_rope_head_dim) ** -0.5
    o = ops.flash_attention(q, k, v, causal=True, prefix_len=prefix_len,
                            scale=scale)
    return L._out(o, p["wo"]), (c_kv, k_rope[:, :, 0])


def mla_block(p, cfg, x: torch.Tensor, positions: torch.Tensor,
              prefix_len: int = 0) -> torch.Tensor:
    """Train / prefill: the latent decompressed, attention on K3."""
    return _attend(p, cfg, x, positions, prefix_len)[0]


def mla_prefill(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                prefix_len: int = 0):
    """Prefill: the output and the COMPRESSED cache entries (c_kv [B, S,
    kvr], k_rope [B, S, rope])."""
    return _attend(p, cfg, x, positions, prefix_len)


def init_mla_cache(cfg, batch: int, max_len: int, num_layers: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """The compressed cache of ``num_layers`` layers: ``c_kv`` [L, B,
    max_len, kvr], ``k_rope`` [L, B, max_len, rope] in the model dtype."""
    dt = L.dtype_of(cfg)
    return {"c_kv": torch.zeros((num_layers, batch, max_len,
                                 cfg.kv_lora_rank), dtype=dt, device=device),
            "k_rope": torch.zeros((num_layers, batch, max_len,
                                   cfg.qk_rope_head_dim), dtype=dt,
                                  device=device)}


def mla_decode(p, cfg, x: torch.Tensor, cache: Mapping, cache_len: int):
    """Absorbed single-token decode against one layer's compressed cache
    ``{"c_kv": [B, Smax, kvr], "k_rope": [B, Smax, rope]}``: the new
    entries written at ``cache_len`` in place (raises, before any write,
    when the cache is full), then the reference's float32 einsums over
    positions ``<= cache_len``.  Returns (output [B, 1, d], the cache)."""
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    max_len = c_cache.shape[1]
    if cache_len >= max_len:
        raise ValueError(
            f"cache is full (len {cache_len} == max_len {max_len}); the "
            "reference would clamp the write index and overwrite the last "
            "position -- allocate a larger cache (init_cache) and copy the "
            "prefill cache into it")
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, positions)        # [B, 1, H, *]
    c_new, k_rope_new = _project_kv_latent(p, cfg, x, positions)
    c_cache[:, cache_len] = c_new[:, 0].to(c_cache.dtype)
    r_cache[:, cache_len] = k_rope_new[:, 0, 0].to(r_cache.dtype)
    w_uk = p["wkv_b"][..., :nope].float()                    # [kvr, H, nope]
    w_uv = p["wkv_b"][..., nope:].float()                    # [kvr, H, vd]
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
    c32, r32 = c_cache.float(), r_cache.float()
    s = torch.einsum("bshr,btr->bhst", q_lat, c32)
    s = s + torch.einsum("bshr,btr->bhst", q_rope.float(), r32)
    s = s * (nope + rope_d) ** -0.5
    pos = torch.arange(max_len, device=x.device)
    s = torch.where(pos <= cache_len, s, L.NEG_INF)
    attn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", attn, c32)         # [B, 1, H, kvr]
    o = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).to(x.dtype)
    return L._out(o, p["wo"]), cache
