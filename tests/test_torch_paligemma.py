"""The port's paligemma serving path (the VLM family) against the
reference.

``paligemma_3b.reduced()``: 2 layers, d_model 64, 4 heads of 16, one kv
head (MQA), d_ff 128, a gated tanh-GELU MLP, vocab 256, tied embeddings, 8
patches, in float32 and bf16, with the reference's ``init_params`` weights
carried over by ``params_from_reference`` (norm scales redrawn at random so
that they matter).  Tokens and the patch embeddings (the SigLIP tower is a
stub: ``prefix_embeds`` [B, 8, 64]) are drawn with numpy and go through
both packages on the CPU, where attention takes K3's plain version with
the bidirectional prefix.  The reference's XLA attention scans, for query
chunk ``i``, only the key chunks ``0..i`` (chunks of min(1024, S)), so it is
the exact prefix mask only while the prefix fits its first chunk: the 8
patches here (and paligemma's 256) always do.  Tolerances, relative to the
scale (max |reference|), those of ``tests/test_torch_transformer.py``:
float32 1e-5, bf16 5e-2 for logits and 2e-2 for cache entries; the
embedded sequence (gemma's sqrt(d) scale rounded to the model dtype, then
the patches in front) bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import layers as rL
from repro.models import transformer as rt
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import layers as L
from repro_torch.models import transformer as tt
from repro_torch.models.api import build_model

DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 16        # text tokens; 8 patches go in front


def _configs(dtype, **kw):
    return (dataclasses.replace(rbase.get_config("paligemma_3b").reduced(),
                                dtype=dtype, **kw),
            dataclasses.replace(base.get_config("paligemma_3b").reduced(),
                                dtype=dtype, **kw))


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "scale":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32), v.dtype)
        else:
            out[k] = v
    return out


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _inputs(cfg, seed=2, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    patches = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)) \
        .astype(np.float32)
    return toks, patches


_CASES = {}


def _case(dtype):
    """(reference cfg, port cfg, reference params, port model, tokens,
    patches, reference prefill (logits, cache)), built once per dtype."""
    if dtype not in _CASES:
        rcfg, cfg = _configs(dtype)
        params = _randomize(rt.init_params(jax.random.PRNGKey(0), rcfg),
                            np.random.default_rng(1))
        model = tt.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
        toks, patches = _inputs(cfg)
        _CASES[dtype] = (rcfg, cfg, params, model, toks, patches,
                         rt.prefill(params, rcfg, jnp.asarray(toks),
                                    prefix_embeds=jnp.asarray(patches)))
    return _CASES[dtype]


def test_reduced_config_is_the_vlm_shape():
    _, cfg = _configs("bfloat16")
    assert (cfg.family, cfg.num_kv_heads, cfg.num_patches, cfg.act_fn,
            cfg.tie_embeddings, cfg.gated_mlp) == ("vlm", 1, 8, "gelu", True,
                                                   True)
    full = base.get_config("paligemma_3b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.num_patches) == \
        (18, 2048, 8, 1, 256, 16384, 257216, 256)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedded_sequence_is_bitwise_the_reference(dtype):
    """gemma's embedding scale rounded to the model dtype first (45.25 in
    bf16 at d 2048, the reference's ``jnp.asarray(d ** 0.5, x.dtype)``),
    the token embeddings multiplied by it, the patches cast to the model
    dtype in front: bitwise the reference's sequence."""
    _, cfg, params, model, toks, patches, _ = _case(dtype)
    x = rL.embed(params["embed"], jnp.asarray(toks))
    x = x * jnp.asarray(cfg.d_model ** 0.5, x.dtype)
    want = jnp.concatenate([jnp.asarray(patches).astype(x.dtype), x], axis=1)
    got, prefix = tt.embed_inputs(model, torch.from_numpy(toks), patches)
    assert prefix == cfg.num_patches and got.dtype == L.dtype_of(cfg)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    assert tt.embed_scale(cfg, torch.bfloat16) == 8.0   # sqrt(64)
    full = base.get_config("paligemma_3b")
    assert tt.embed_scale(full, torch.bfloat16) == 45.25
    assert tt.embed_scale(full, torch.float32) == float(np.float32(2048 ** .5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    """Logits over the patches and the text, the k / v cache of every
    position and ``len`` = patches + text, against ``transformer.prefill``
    with ``prefix_embeds``."""
    _, cfg, _, model, toks, patches, (want, want_cache) = _case(dtype)
    n = cfg.num_patches + S
    logits, cache = model.prefill(torch.from_numpy(toks), patches)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, n, cfg.vocab_size)
    assert np.isfinite(logits.numpy()).all()
    assert _rel(logits, want) < LOGIT_TOL[dtype]
    assert cache["len"] == n == int(want_cache["len"])
    for kv in ("k", "v"):
        got = cache["layers"][kv]
        assert tuple(got.shape) == want_cache["layers"][kv].shape
        assert _rel(got, want_cache["layers"][kv]) < CACHE_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_three_decode_steps_after_prefill_match_reference(dtype):
    """The reference's prefill cache at positions [0, 24) of a 32-long
    cache in both packages, then three greedy steps of
    ``transformer.decode_step`` (the embedding scale applied to each token)
    on the same tokens: logits, every written position, ``len``."""
    rcfg, cfg, params, model, _, _, (logits, pre) = _case(dtype)
    n = cfg.num_patches + S
    rcache = rt.init_cache(rcfg, B, 32)
    rcache = {"len": pre["len"], "layers": {
        kv: rcache["layers"][kv].at[:, :, :n].set(pre["layers"][kv])
        for kv in ("k", "v")}}
    cache = model.init_cache(B, 32)
    for kv in ("k", "v"):
        cache["layers"][kv].copy_(torch.from_numpy(
            np.array(rcache["layers"][kv].astype(jnp.float32))))
    cache["len"] = n
    tok = np.asarray(jnp.argmax(logits[:, -1:], -1)).astype(np.int32)
    for step in range(3):
        want, rcache = rt.decode_step(params, rcfg, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(torch.from_numpy(tok), cache)
        assert tuple(got.shape) == (B, 1, cfg.vocab_size)
        assert _rel(got, want) < LOGIT_TOL[dtype], step
        assert cache["len"] == n + step + 1 == int(rcache["len"])
        for kv in ("k", "v"):
            assert _rel(cache["layers"][kv][:, :, n + step],
                        rcache["layers"][kv][:, :, n + step]) \
                < CACHE_TOL[dtype]
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_text_alone_matches_reference(dtype):
    """Without ``prefix_embeds`` (the reference's ``batch.get``): the
    scaled token embeddings alone, plain causal attention."""
    rcfg, cfg, params, model, toks, _, _ = _case(dtype)
    want, _ = rt.prefill(params, rcfg, jnp.asarray(toks))
    logits, cache = model.prefill(torch.from_numpy(toks))
    assert cache["len"] == S and tuple(logits.shape) == (B, S,
                                                         cfg.vocab_size)
    assert _rel(logits, want) < LOGIT_TOL[dtype]


def test_patches_see_each_other_and_the_text_sees_them():
    """The prefix is bidirectional: changing the last patch changes every
    patch's logits (a causal mask would leave the first seven alone) and
    every text position's."""
    _, cfg, _, model, toks, patches, _ = _case("float32")
    base_logits, _ = model.prefill(torch.from_numpy(toks), patches)
    other = patches.copy()
    other[:, -1] += 1.0
    moved, _ = model.prefill(torch.from_numpy(toks), other)
    diff = (moved - base_logits).abs().amax(dim=-1)        # [B, P + S]
    assert bool((diff > 1e-6).all())


def test_one_kernel_call_per_layer_with_the_prefix(monkeypatch):
    """Each prefill calls K3 once a layer over the whole sequence with
    ``prefix_len`` = the patches and one kv head; decode calls it never."""
    _, cfg, _, model, toks, patches, _ = _case("bfloat16")
    seen = []
    real = k3.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], q.shape[2], k.shape[2], kw["causal"],
                     kw["prefix_len"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(k3, "flash_attention", spy)
    n = cfg.num_patches + S
    _, cache = model.prefill(torch.from_numpy(toks), patches)
    assert seen == [(n, cfg.num_heads, 1, True, cfg.num_patches)] \
        * cfg.num_layers
    big = model.init_cache(B, n + 1)
    big["layers"]["k"][:, :, :n] = cache["layers"]["k"]
    big["layers"]["v"][:, :, :n] = cache["layers"]["v"]
    big["len"] = n
    model.decode_step(torch.zeros((B, 1), dtype=torch.int32), big)
    assert len(seen) == cfg.num_layers


def test_model_api_serves_the_vlm_family():
    """``build_model(paligemma).prefill`` reads ``batch["prefix_embeds"]``;
    ``decode`` takes one token and no prefix; ``init`` builds a
    ``Transformer`` on the requested device."""
    _, cfg, _, model, toks, patches, _ = _case("bfloat16")
    m = build_model(cfg)
    logits, cache = m.prefill(model, {"tokens": toks,
                                      "prefix_embeds": patches})
    want, _ = model.prefill(torch.from_numpy(toks), patches)
    assert torch.equal(logits, want)
    n = cfg.num_patches + S
    full = m.init_cache(B, n + 1, device="cpu")
    full["layers"]["k"][:, :, :n] = cache["layers"]["k"]
    full["layers"]["v"][:, :, :n] = cache["layers"]["v"]
    full["len"] = n
    step, full = m.decode(model, {"tokens": logits[:, -1:].argmax(-1)}, full)
    assert tuple(step.shape) == (B, 1, cfg.vocab_size) and full["len"] == n + 1
    fresh = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(fresh, tt.Transformer) and fresh.head is None
    with pytest.raises(RuntimeError, match="cuda"):
        m.init()                     # the card by default; none here


def test_prefix_embeds_of_the_wrong_shape_raise():
    _, cfg, _, model, toks, patches, _ = _case("float32")
    with pytest.raises(ValueError, match="prefix_embeds"):
        model.prefill(torch.from_numpy(toks), patches[:1])
    with pytest.raises(ValueError, match="prefix_embeds"):
        model.prefill(torch.from_numpy(toks), patches[..., :32])
