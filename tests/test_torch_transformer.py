"""The port's dense transformer serving path against the reference.

Reduced configs (``cfg.reduced()``: 2 layers, d_model 64, 4 heads of 16,
vocab 256) of stablelm, qwen3 (``qk_norm``), qwen2 (``qkv_bias``) and granite
(one kv head), in float32 and bf16, with the reference's ``init_params``
weights carried over by ``params_from_reference`` (biases and norm scales
redrawn at random so that they matter).  Prompts are drawn with numpy and go
through both packages on the CPU, where attention takes K3's plain version.
Tolerances, relative to the scale (max |reference|): float32 1e-5 (prefill
measured below 4e-7), bf16 5e-2 for logits and 2e-2 for cache entries
(prefill measured 5.6e-3 and 6.4e-3: a bf16 ulp where a value rounds the
other way, carried into the later layers).
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

DENSE = ["stablelm_1_6b", "qwen3_14b", "qwen2_72b", "granite_20b"]
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 24


def _configs(name, dtype):
    return (dataclasses.replace(rbase.get_config(name).reduced(), dtype=dtype),
            dataclasses.replace(base.get_config(name).reduced(), dtype=dtype))


def _randomize(tree, rng):
    """Norm scales and qkv biases drawn at random (the reference initialises
    them to one and zero, which would hide a misplaced one)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "scale" or k in ("bq", "bk", "bv"):
            draw = rng.uniform(0.5, 1.5, v.shape) if k == "scale" \
                else rng.normal(0, 0.5, v.shape)
            out[k] = jnp.asarray(draw.astype(np.float32), v.dtype)
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


_CASES = {}


def _case(name, dtype):
    """(reference cfg, port cfg, reference params, port model, tokens,
    reference prefill (logits, cache)), built once per (name, dtype)."""
    key = (name, dtype)
    if key not in _CASES:
        rcfg, cfg = _configs(name, dtype)
        params = _randomize(rt.init_params(jax.random.PRNGKey(0), rcfg),
                            np.random.default_rng(1))
        model = tt.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        _CASES[key] = (rcfg, cfg, params, model, toks,
                       rt.prefill(params, rcfg, jnp.asarray(toks)))
    return _CASES[key]


# --- prefill and decode against the reference -------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_reference(name, dtype):
    """Logits and the k / v cache of ``Transformer.prefill`` vs
    ``transformer.prefill``."""
    _, cfg, _, model, toks, (want_logits, want_cache) = _case(name, dtype)
    logits, cache = model.prefill(torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert np.isfinite(logits.numpy()).all()
    assert _rel(logits, want_logits) < LOGIT_TOL[dtype]
    assert cache["len"] == S == int(want_cache["len"])
    for kv in ("k", "v"):
        got = cache["layers"][kv]
        assert tuple(got.shape) == want_cache["layers"][kv].shape
        assert got.dtype == L.dtype_of(cfg)
        assert _rel(got, want_cache["layers"][kv]) < CACHE_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_decode_step_matches_reference(name, dtype):
    """One step into a cache with room (the reference's prefill cache at
    positions [0, S) of a 32-long cache, in both packages) vs
    ``transformer.decode_step``: logits, the written position, ``len``."""
    rcfg, cfg, params, model, _, (_, pre) = _case(name, dtype)
    rcache = rt.init_cache(rcfg, B, 32)
    rcache = {"len": pre["len"], "layers": {
        kv: rcache["layers"][kv].at[:, :, :S].set(pre["layers"][kv])
        for kv in ("k", "v")}}
    cache = model.init_cache(B, 32)
    for kv in ("k", "v"):
        cache["layers"][kv].copy_(torch.from_numpy(
            np.array(rcache["layers"][kv].astype(jnp.float32))))
    cache["len"] = S
    tok = np.array([[5], [77]], np.int32)
    want, wcache = rt.decode_step(params, rcfg, jnp.asarray(tok), rcache)
    got, cache = model.decode_step(torch.from_numpy(tok), cache)
    assert tuple(got.shape) == (B, 1, cfg.vocab_size)
    assert _rel(got, want) < LOGIT_TOL[dtype]
    assert cache["len"] == S + 1 == int(wcache["len"])
    for kv in ("k", "v"):
        assert _rel(cache["layers"][kv][:, :, S],
                    wcache["layers"][kv][:, :, S]) < CACHE_TOL[dtype]
        assert _rel(cache["layers"][kv], wcache["layers"][kv]) \
            < CACHE_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_prefill_equals_stepwise_decode(name, dtype):
    """The last position's logits of a prefill equal decoding the prompt
    one token at a time from an empty cache (``tests/test_archs.py``'s
    check, here within the tolerances above instead of atol 0.1)."""
    _, cfg, _, model, toks, _ = _case(name, dtype)
    pre, _ = model.prefill(torch.from_numpy(toks[:, :8]))
    cache = model.init_cache(B, 16)
    for i in range(8):
        step, cache = model.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                        cache)
    assert cache["len"] == 8
    want = pre[:, -1].numpy()
    assert (float(np.abs(step[:, -1].numpy() - want).max())
            / float(np.abs(want).max())) < LOGIT_TOL[dtype]


@pytest.mark.parametrize("name", DENSE)
def test_one_kernel_call_per_layer_per_prefill(name, monkeypatch):
    """Each prefill calls the K3 wrapper once per layer with the config's
    kv heads (never repeated for GQA); decode calls it never."""
    _, cfg, _, model, toks, _ = _case(name, "bfloat16")
    seen = []
    real = k3.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(k3, "flash_attention", spy)
    _, cache = model.prefill(torch.from_numpy(toks))
    assert seen == [(cfg.num_heads, cfg.num_kv_heads, True)] * cfg.num_layers
    big = model.init_cache(B, S + 1)
    big["layers"]["k"][:, :, :S] = cache["layers"]["k"]
    big["layers"]["v"][:, :, :S] = cache["layers"]["v"]
    big["len"] = S
    model.decode_step(torch.zeros((B, 1), dtype=torch.int32), big)
    assert len(seen) == cfg.num_layers


@pytest.mark.parametrize("name", DENSE)
def test_decode_raises_when_the_cache_is_full(name):
    """The reference clamps the write index of a full cache and overwrites
    its last position; the port raises, and leaves the cache as it was."""
    _, _, _, model, toks, _ = _case(name, "float32")
    _, cache = model.prefill(torch.from_numpy(toks))
    before = cache["layers"]["k"].clone()
    with pytest.raises(ValueError, match="cache is full"):
        model.decode_step(torch.zeros((B, 1), dtype=torch.int32), cache)
    assert cache["len"] == S and torch.equal(cache["layers"]["k"], before)


def test_head_major_cache_decodes_like_the_reference():
    """``cache_layout="head_major"``: prefill writes [L, B, KV, S, hd] and a
    decode step after it matches the reference's head-major decode."""
    rcfg, cfg = _configs("qwen3_14b", "float32")
    rcfg = dataclasses.replace(rcfg, cache_layout="head_major")
    cfg = dataclasses.replace(cfg, cache_layout="head_major")
    params = _randomize(rt.init_params(jax.random.PRNGKey(3), rcfg),
                        np.random.default_rng(4))
    model = tt.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, (B, 12)).astype(np.int32)
    _, pre = model.prefill(torch.from_numpy(toks))
    assert tuple(pre["layers"]["k"].shape) == (2, B, 4, 12, 16)
    _, rpre = rt.prefill(params, rcfg, jnp.asarray(toks))
    np.testing.assert_allclose(
        pre["layers"]["k"].numpy(),
        np.asarray(rpre["layers"]["k"]).transpose(0, 1, 3, 2, 4),
        rtol=1e-5, atol=1e-5)
    rcache = rt.init_cache(rcfg, B, 16)
    rcache = {"len": jnp.asarray(12, jnp.int32), "layers": {
        kv: rcache["layers"][kv].at[:, :, :, :12].set(
            jnp.swapaxes(rpre["layers"][kv], 2, 3)) for kv in ("k", "v")}}
    cache = model.init_cache(B, 16)
    for kv in ("k", "v"):
        cache["layers"][kv][:, :, :, :12] = pre["layers"][kv]
    cache["len"] = 12
    tok = np.array([[9], [10]], np.int32)
    want, _ = rt.decode_step(params, rcfg, jnp.asarray(tok), rcache)
    got, _ = model.decode_step(torch.from_numpy(tok), cache)
    assert _rel(got, want) < 1e-5


# --- the layers against the reference's -------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_rope_and_ffn_match_reference(dtype):
    rng = np.random.default_rng(6)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(2, 5, 4, 16)).astype(np.float32), jdt)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    p = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32),
         "bias": jnp.asarray(rng.normal(size=16), jnp.float32)}
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    pos = np.arange(5)[None].repeat(2, 0) + 3
    cases = [
        (rL.norm({"scale": p["scale"]}, x), L.norm({"scale": pt["scale"]}, xt)),
        (rL.norm(p, x), L.norm(pt, xt)),
        (rL.apply_rope(x, jnp.asarray(pos), 1e4),
         L.apply_rope(xt, torch.from_numpy(pos), 1e4)),
    ]
    _, cfg = _configs("stablelm_1_6b", dtype)
    fp = {k: jnp.asarray(rng.normal(0, 0.1, s).astype(np.float32), jdt)
          for k, s in (("w_in", (16, 8)), ("w_gate", (16, 8)),
                       ("w_out", (8, 16)))}
    fpt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(xt.dtype)
           for k, v in fp.items()}
    cases.append((rL.ffn_block(fp, cfg, x[:, :, 0]),
                  L.ffn_block(fpt, cfg, xt[:, :, 0])))
    for want, got in cases:
        assert got.dtype == xt.dtype
        assert _rel(got, want) < (1e-6 if dtype == "float32" else 1e-2)


# --- build, init, the API -----------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_parameter_shapes_match_reference(name):
    """Every parameter of the port's reduced model has the path, shape and
    dtype of the reference's ``init_params`` leaf, one layer at a time
    (``jax.eval_shape``: nothing is drawn on the reference side)."""
    rcfg, cfg = _configs(name, "bfloat16")
    want = {}
    tree = jax.eval_shape(lambda k: rt.init_params(k, rcfg),
                          jax.random.PRNGKey(0))

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            elif path.startswith("layers."):
                for i in range(cfg.num_layers):
                    want[f"layers.{i}.{path[7:]}"] = (v.shape[1:], v.dtype)
            else:
                want[path] = (v.shape, v.dtype)

    walk(tree, "")
    got = build_model(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu").state_dict()
    assert sorted(got) == sorted(want)
    for key, (shape, dt) in want.items():
        assert tuple(got[key].shape) == tuple(shape), key
        assert str(got[key].dtype).split(".")[-1] == str(dt), key


def test_init_is_seeded_with_the_reference_scales():
    cfg = dataclasses.replace(base.get_config("qwen2_72b").reduced(),
                              d_model=256, d_ff=512)
    a = build_model(cfg).init(torch.Generator().manual_seed(9), device="cpu")
    b = build_model(cfg).init(torch.Generator().manual_seed(9), device="cpu")
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    lp = a.layers[0]
    for w, want in ((lp.attn.wq, 0.02), (lp.ffn.w_in, 0.02),
                    (lp.attn.wo, 0.02 / 2 ** 0.5),
                    (lp.ffn.w_out, 0.02 / 2 ** 0.5),
                    (a.embed.embed_w, 256 ** -0.5)):
        assert abs(float(w.float().std()) / want - 1) < 0.1
    assert torch.equal(lp.attn.bq, torch.zeros_like(lp.attn.bq))
    assert torch.equal(lp.ln1.scale, torch.ones(256))
    assert lp.ln1.scale.dtype == torch.float32
    assert all(not p.requires_grad for p in a.parameters())


def test_tied_embeddings_have_no_head():
    cfg = dataclasses.replace(base.get_config("stablelm_1_6b").reduced(),
                              tie_embeddings=True, dtype="float32")
    model = build_model(cfg).init(device="cpu")
    assert model.head is None and not any(
        k.startswith("head") for k in model.state_dict())
    h = torch.randn(1, 3, cfg.d_model)
    torch.testing.assert_close(L.unembed(None, model.embed, h),
                               h @ model.embed.embed_w.T)


def test_build_model_dense_api():
    """``Model.prefill`` / ``decode`` / ``init_cache`` of the dense family
    on the CPU; ``init`` asks for the card by default and raises without
    one; the CNN has no serving entries."""
    cfg = dataclasses.replace(base.get_config("granite_20b").reduced(),
                              dtype="float32")
    m = build_model(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            m.init()
        with pytest.raises(RuntimeError, match="cuda"):
            m.init_cache(1, 8)
    model = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    logits, cache = m.prefill(model, {"tokens": toks})
    full = m.init_cache(1, 8, device="cpu")
    full["layers"]["k"][:, :, :3] = cache["layers"]["k"]
    full["layers"]["v"][:, :, :3] = cache["layers"]["v"]
    full["len"] = 3
    step, full = m.decode(model, {"tokens": logits[:, -1:].argmax(-1)}, full)
    assert tuple(step.shape) == (1, 1, cfg.vocab_size) and full["len"] == 4
    torch.testing.assert_close(model(toks), logits)
    cnn = build_model(base.get_config("resnet50"))
    assert cnn.prefill is None and cnn.decode is None and cnn.init_cache is None


@pytest.mark.parametrize("name,replace", [
    ("deepseek_v3_671b", {}), ("deepseek_v2_236b", {}),
    ("paligemma_3b", {"num_experts": 8}),
    ("stablelm_1_6b", {"num_experts": 8}),
    ("stablelm_1_6b", {"attn_type": "mla"}),
    ("stablelm_1_6b", {"mtp_depth": 1}),
])
def test_moe_mla_and_vlm_raise(name, replace):
    """Experts, MLA and MTP outside the MoE family still raise; the MoE
    family itself (deepseek v2 / v3, MLA and MTP included) builds and runs
    a prefill on the CPU since ROADMAP.md Queue 1 item 12e step 4 (its
    reduced config's head dims, which only the plain version takes)."""
    cfg = dataclasses.replace(base.get_config(name).reduced(), **replace)
    if name.startswith("deepseek"):
        model = build_model(cfg).init(device="cpu")
        logits, cache = model.prefill(torch.tensor([[1, 2, 3]]))
        assert tuple(logits.shape) == (1, 3, cfg.vocab_size)
        assert set(cache) == {"len", "dense", "moe"} and cache["len"] == 3
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg).init(device="cpu")


def test_bidirectional_prefix_raises():
    """A bidirectional prefix opens the causal mask: ``attention_prefill``
    takes it (the reference's ``attention_prefill(..., prefix_len)``), and
    K3 refuses it on a call that is not causal or whose keys are not the
    queries' own."""
    rcfg, cfg, params, model, _, _ = _case("stablelm_1_6b", "float32")
    x = np.random.default_rng(3).normal(size=(1, 6, cfg.d_model)).astype(
        np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    want, (wk, _) = rL.attention_prefill(lp["attn"], rcfg, jnp.asarray(x),
                                        jnp.arange(6)[None], prefix_len=4)
    got, (k, _) = L.attention_prefill(model.layers[0].attn, cfg,
                                      torch.from_numpy(x),
                                      torch.arange(6)[None], prefix_len=4)
    assert _rel(got, want) < LOGIT_TOL["float32"]
    assert _rel(k, wk) < CACHE_TOL["float32"]
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="prefix"):
        k3.flash_attention(q, q, q, causal=False, prefix_len=2)
    with pytest.raises(ValueError, match="causal"):
        k3.flash_attention(q, q[:, :3], q[:, :3], prefix_len=2)
