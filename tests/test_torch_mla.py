"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the reference's ``models/mla.py`` on the CPU.

One layer at deepseek's real attention head dims (q / k of 128 nope + 64
rope columns, v of 128, so K3's plain version runs at the pair (192, 128)
that the kernel takes on the card) and narrow everything else: d_model 64,
2 heads, q_lora / kv_lora 32 (and a case without a q LoRA).  The weights
are the reference's ``init_mla`` (norm scales redrawn in [0.5, 1.5]),
inputs numpy draws.  Tolerances, relative to the scale (max |reference|):
float32 1e-5 (measured ~3e-7), bf16 5e-2 for outputs and 2e-2 for cache
entries (those of ``tests/test_torch_transformer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as rmla
from repro_torch.models import mla

from _deepseek_cases import configs, numpy_tree, randomize, rel

OUT_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 12


def _case(dtype, q_lora=32, seed=0):
    rcfg, cfg = configs("deepseek_v2_236b", dtype, q_lora_rank=q_lora)
    rp = randomize(rmla.init_mla(jax.random.PRNGKey(seed), rcfg),
                   np.random.default_rng(seed + 1))
    p = {k: (torch.from_numpy(v).to(TORCH[dtype]) if not isinstance(v, dict)
             else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in numpy_tree(rp).items()}
    x = np.random.default_rng(seed + 2).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, rcfg.dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TORCH[dtype])
    return rcfg, cfg, rp, p, xj, xt


def test_init_mla_has_the_reference_tree():
    rcfg, cfg, rp, _, _, _ = _case("float32")
    got = mla.init_mla(torch.Generator().manual_seed(0), cfg)
    want = numpy_tree(rp)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert {kk: tuple(t.shape) for kk, t in got[k].items()} == \
                {kk: vv.shape for kk, vv in v.items()}
        else:
            assert tuple(got[k].shape) == v.shape, k
            assert got[k].dtype == torch.float32


@pytest.mark.parametrize("q_lora", [32, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_output_and_compressed_cache_match(dtype, q_lora):
    rcfg, cfg, rp, p, xj, xt = _case(dtype, q_lora)
    pos = jnp.arange(S)[None, :]
    r_out, (r_c, r_r) = rmla.mla_prefill(rp, rcfg, xj, pos)
    out, (c, r) = mla.mla_prefill(p, cfg, xt, torch.arange(S)[None, :])
    assert tuple(out.shape) == (B, S, cfg.d_model) and out.dtype == TORCH[dtype]
    assert tuple(c.shape) == (B, S, 32) and tuple(r.shape) == (B, S, 64)
    assert rel(out, r_out) <= OUT_TOL[dtype]
    assert rel(c, r_c) <= CACHE_TOL[dtype]
    assert rel(r, r_r) <= CACHE_TOL[dtype]


def test_block_is_the_prefill_output():
    _, cfg, _, p, _, xt = _case("float32")
    pos = torch.arange(S)[None, :]
    assert torch.equal(mla.mla_block(p, cfg, xt, pos),
                       mla.mla_prefill(p, cfg, xt, pos)[0])


def _reference_decode(rp, rcfg, xj, steps):
    """The reference's prefill of the first S - steps positions into a
    cache of S, then ``mla_decode`` of the rest one at a time."""
    n = S - steps
    _, (c, r) = rmla.mla_prefill(rp, rcfg, xj[:, :n], jnp.arange(n)[None])
    cache = rmla.init_mla_cache(rcfg, B, S, 1)
    cache = {"c_kv": cache["c_kv"][0].at[:, :n].set(c),
             "k_rope": cache["k_rope"][0].at[:, :n].set(r)}
    outs = []
    for i in range(steps):
        o, cache = rmla.mla_decode(rp, rcfg, xj[:, n + i:n + i + 1], cache,
                                   n + i)
        outs.append(o)
    return outs, cache


def _port_decode(p, cfg, xt, steps):
    n = S - steps
    _, (c, r) = mla.mla_prefill(p, cfg, xt[:, :n], torch.arange(n)[None])
    cache = {k: v[0] for k, v in mla.init_mla_cache(cfg, B, S, 1).items()}
    cache["c_kv"][:, :n] = c
    cache["k_rope"][:, :n] = r
    outs = []
    for i in range(steps):
        o, cache = mla.mla_decode(p, cfg, xt[:, n + i:n + i + 1], cache,
                                  n + i)
        outs.append(o)
    return outs, cache


@pytest.mark.parametrize("q_lora", [32, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches(dtype, q_lora):
    rcfg, cfg, rp, p, xj, xt = _case(dtype, q_lora)
    r_outs, r_cache = _reference_decode(rp, rcfg, xj, 3)
    outs, cache = _port_decode(p, cfg, xt, 3)
    for o, ro in zip(outs, r_outs):
        assert tuple(o.shape) == (B, 1, cfg.d_model)
        assert rel(o, ro) <= OUT_TOL[dtype]
    for k in ("c_kv", "k_rope"):
        assert rel(cache[k], r_cache[k]) <= CACHE_TOL[dtype]


def test_absorbed_decode_equals_the_decompressed_attention():
    """Folding W_UK into the query and W_UV into the output changes only
    the order of the sums: each decode step's output is the prefill's
    output at that position (float32, 1e-5 of scale)."""
    _, cfg, _, p, _, xt = _case("float32")
    outs, _ = _port_decode(p, cfg, xt, 4)
    full = mla.mla_prefill(p, cfg, xt, torch.arange(S)[None, :])[0]
    for i, o in enumerate(outs):
        want = full[:, S - 4 + i:S - 3 + i]
        assert float((o - want).abs().max() / want.abs().max()) <= 1e-5


def test_decode_raises_on_a_full_cache_before_writing():
    _, cfg, _, p, _, xt = _case("float32")
    cache = {k: v[0] for k, v in mla.init_mla_cache(cfg, B, 4, 1).items()}
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(ValueError, match="cache is full"):
        mla.mla_decode(p, cfg, xt[:, :1], cache, 4)
    assert all(torch.equal(cache[k], before[k]) for k in cache)


def test_prefill_attention_runs_at_the_kernels_head_dims(monkeypatch):
    """The attention call of the prefill: q / k of 192 columns, v of 128,
    H == KV, scale 192 ** -0.5, causal -- the pair K3 takes on the card."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    _, cfg, _, p, _, xt = _case("float32")
    mla.mla_prefill(p, cfg, xt, torch.arange(S)[None, :])
    assert seen == [((B, S, 2, 192), (B, S, 2, 192), (B, S, 2, 128),
                     {"causal": True, "prefix_len": 0,
                      "scale": 192 ** -0.5})]
