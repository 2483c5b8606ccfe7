"""The port's whisper serving path (``repro_torch.models.whisper``) against
the reference's ``repro.models.whisper``.

``whisper_small.reduced()``: d_model 64, 4 heads of 16, d_ff 128, 2 encoder
and 2 decoder layers, 8 frames, vocab 256, 64 decoder positions; float32
and bf16, with the reference's ``init_params`` weights carried over by
``params_from_reference`` -- every layer norm's scale and bias redrawn at
random so that they matter.  Prompts of 24 tokens (longer than the 8
frames, so cross attention has more queries than keys) and frames drawn
with numpy go through both packages on the CPU, where every attention
takes K3's plain version.  Tolerances, relative to the scale (max
|reference|): float32 1e-5, bf16 3e-2, as ``tests/test_torch_zamba.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import api as rapi
from repro.models import layers as rl
from repro.models import whisper as rw
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import layers as L
from repro_torch.models import whisper as tw
from repro_torch.models.api import build_model

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S, STEPS, MAX_SEQ = 2, 24, 4, 64


def _configs(dtype, **kw):
    kw = dict(dtype=dtype, **kw)
    return (dataclasses.replace(rbase.get_config("whisper_small").reduced(),
                                **kw),
            dataclasses.replace(base.get_config("whisper_small").reduced(),
                                **kw))


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "scale":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32), v.dtype)
        elif k == "bias":
            out[k] = jnp.asarray(rng.normal(0, 0.1, v.shape)
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


def _inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.normal(0, 1, (B, cfg.num_frames, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


_CASES = {}


def _case(dtype):
    """(reference cfg, port cfg, reference params, port model, tokens,
    frames, reference prefill (logits, cache)), built once per dtype."""
    if dtype not in _CASES:
        rcfg, cfg = _configs(dtype)
        params = _randomize(rw.init_params(jax.random.PRNGKey(0), rcfg,
                                           max_seq=MAX_SEQ),
                            np.random.default_rng(1))
        model = tw.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
        toks, frames = _inputs(cfg)
        want = rapi.build_model(rcfg).prefill(
            params, {"tokens": jnp.asarray(toks),
                     "frames": jnp.asarray(frames)})
        _CASES[dtype] = (rcfg, cfg, params, model, toks, frames, want)
    return _CASES[dtype]


def _prefill(model, toks, frames):
    return model.prefill(torch.from_numpy(toks), torch.from_numpy(frames))


def _ref_decode(rcfg):
    return jax.jit(lambda p, t, c: rw.decode_step(p, rcfg, t, c))


def _cache_leaves(cache):
    return {f"{part}/{key}": cache[part][key]
            for part in ("self", "cross") for key in ("k", "v")}


def _grown(model, cache, extra):
    """The port's prefill cache copied into an ``init_cache`` with room for
    ``extra`` more positions."""
    b, s = cache["self"]["k"].shape[1:3]
    big = model.init_cache(b, s + extra)
    big["len"] = cache["len"]
    for key in ("k", "v"):
        big["self"][key][:, :, :s] = cache["self"][key]
        big["cross"][key].copy_(cache["cross"][key])
    return big


def _ref_grown(rcache, extra):
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {"len": rcache["len"], "cross": rcache["cross"],
            "self": {k: jnp.pad(v, pad) for k, v in rcache["self"].items()}}


# --- the layers the path adds ----------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_and_gelu_match_reference(dtype):
    """``layers.norm`` with a bias (layer norm) at whisper's norm_eps 1e-6
    and the tanh GELU of ``ffn_block`` against the reference's."""
    rcfg, cfg, params, model, _, _, _ = _case(dtype)
    assert cfg.norm_eps == rcfg.norm_eps == 1e-6
    x = np.random.default_rng(3).normal(0, 2, (B, 5, cfg.d_model)) \
        .astype(np.float32)
    xr = jnp.asarray(x).astype(rl.dtype_of(rcfg))
    xt = torch.from_numpy(x).to(TORCH[dtype])
    lp = params["dec_layers"]
    ln = {k: v[0] for k, v in lp["ln1"].items()}
    want = rl.norm(ln, xr, rcfg.norm_eps)
    got = L.norm(model.dec_layers[0]["ln1"], xt, cfg.norm_eps)
    assert got.dtype == TORCH[dtype]
    assert _rel(got, want) <= TOL[dtype]
    ffn = {k: v[0] for k, v in lp["ffn"].items()}
    want = rl.ffn_block(ffn, rcfg, xr)
    got = L.ffn_block(model.dec_layers[0]["ffn"], cfg, xt)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    rcfg, _, params, model, _, frames, _ = _case(dtype)
    want = rw.encode(params, rcfg, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == want.shape
    assert _rel(got, want) < TOL[dtype]


# --- prefill and decode against the reference -------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    """Logits and both caches of ``Whisper.prefill`` against the
    reference's ``forward(..., collect_kv=True)`` (through its model
    API's prefill): the self part exactly prompt-long, the cross part all
    frames."""
    _, cfg, _, model, toks, frames, (want_logits, want_cache) = _case(dtype)
    logits, cache = _prefill(model, toks, frames)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert np.isfinite(logits.numpy()).all()
    assert _rel(logits, want_logits) < TOL[dtype]
    assert cache["len"] == S == int(want_cache["len"])
    for key, got in _cache_leaves(cache).items():
        want = _cache_leaves(want_cache)[key]
        assert tuple(got.shape) == want.shape, key
        assert got.dtype == TORCH[str(want.dtype)], key
        assert _rel(got, want) < TOL[dtype], key
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    assert tuple(cache["self"]["k"].shape) == (cfg.num_layers, B, S, kv, hd)
    assert tuple(cache["cross"]["k"].shape) == (cfg.num_layers, B,
                                                cfg.num_frames, kv, hd)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_after_prefill_matches_reference(dtype):
    """Greedy ``decode_step``s from each package's prefill cache grown by
    ``STEPS`` positions: logits and every cache leaf after every step, on
    the reference's tokens."""
    rcfg, cfg, params, model, toks, frames, (want_logits, rcache) = \
        _case(dtype)
    _, cache = _prefill(model, toks, frames)
    cache = _grown(model, cache, STEPS)
    rcache = _ref_grown(rcache, STEPS)
    step_fn = _ref_decode(rcfg)
    tok = np.asarray(want_logits[:, -1:].argmax(-1)).astype(np.int32)
    for step in range(STEPS):
        want, rcache = step_fn(params, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(torch.from_numpy(tok), cache)
        assert tuple(got.shape) == (B, 1, cfg.vocab_size)
        assert _rel(got, want) < TOL[dtype], step
        for key, leaf in _cache_leaves(cache).items():
            assert _rel(leaf, _cache_leaves(rcache)[key]) < TOL[dtype], key
        assert cache["len"] == S + step + 1 == int(rcache["len"])
        tok = np.asarray(want[:, -1:].argmax(-1)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_from_a_fresh_cache_matches_reference(dtype):
    """Eight steps from each package's own empty ``init_cache(B, 8)`` (a
    cross part of zeros, as the reference's)."""
    rcfg, cfg, params, model, toks, _, _ = _case(dtype)
    rcache = rw.init_cache(rcfg, B, 8)
    cache = model.init_cache(B, 8)
    assert cache["len"] == 0
    for key, leaf in _cache_leaves(cache).items():
        assert tuple(leaf.shape) == _cache_leaves(rcache)[key].shape, key
    step_fn = _ref_decode(rcfg)
    for i in range(8):
        tok = toks[:, i:i + 1]
        want, rcache = step_fn(params, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(torch.from_numpy(tok), cache)
        assert _rel(got, want) < TOL[dtype], i
        for key, leaf in _cache_leaves(cache).items():
            if key.startswith("self"):
                assert _rel(leaf, _cache_leaves(rcache)[key]) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_equals_prefill_logits(dtype):
    _, _, _, model, toks, frames, _ = _case(dtype)
    logits, _ = _prefill(model, toks, frames)
    _, got = tw.forward(model, torch.from_numpy(toks),
                        torch.from_numpy(frames))
    assert torch.equal(got, logits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_equals_stepwise_decode(dtype):
    """Decoding the prompt one token at a time, from a cache whose cross
    part is the prefill's, gives the prefill's self cache and last-position
    logits (K3's plain versions against single-token attention)."""
    _, _, _, model, toks, frames, _ = _case(dtype)
    logits, cache = _prefill(model, toks, frames)
    step_cache = model.init_cache(B, S)
    for key in ("k", "v"):
        step_cache["cross"][key].copy_(cache["cross"][key])
    t = torch.from_numpy(toks)
    for i in range(S):
        step, step_cache = model.decode_step(t[:, i:i + 1], step_cache)
    tol = TOL[dtype]
    assert _rel(step[:, 0], logits[:, -1].numpy()) < tol
    for key, leaf in _cache_leaves(step_cache).items():
        assert _rel(leaf, _cache_leaves(cache)[key].float().numpy()) < tol, \
            key


def test_decode_past_a_full_cache_raises_where_the_reference_clamps():
    """Decoding straight from the prefill cache (exactly prompt-long): the
    reference clamps the write index and overwrites the last position; the
    port raises before it writes anything."""
    rcfg, _, params, model, toks, frames, (want_logits, rcache) = \
        _case("float32")
    tok = np.asarray(want_logits[:, -1:].argmax(-1)).astype(np.int32)
    out, clamped = rw.decode_step(params, rcfg, jnp.asarray(tok), rcache)
    assert np.isfinite(np.asarray(out)).all()
    assert clamped["self"]["k"].shape[2] == S
    _, cache = _prefill(model, toks, frames)
    kept = {k: v.clone() for k, v in _cache_leaves(cache).items()}
    with pytest.raises(ValueError, match="cache is full"):
        model.decode_step(torch.from_numpy(tok), cache)
    assert cache["len"] == S
    for key, leaf in _cache_leaves(cache).items():
        assert torch.equal(leaf, kept[key]), key


def test_decode_past_the_decoder_positions_raises_where_the_reference_clamps():
    """At ``len`` == ``max_seq`` the reference's ``dynamic_slice_in_dim``
    clamps to the last row of ``dec_pos`` and decodes on; the port raises
    before it writes anything, even with room in the cache."""
    rcfg, cfg, params, model, toks, _, _ = _case("float32")
    rcache = rw.init_cache(rcfg, B, MAX_SEQ + 1)
    rcache["len"] = jnp.asarray(MAX_SEQ, jnp.int32)
    out, _ = rw.decode_step(params, rcfg, jnp.asarray(toks[:, :1]), rcache)
    assert np.isfinite(np.asarray(out)).all()
    cache = model.init_cache(B, MAX_SEQ + 1)
    cache["len"] = MAX_SEQ
    kept = {k: v.clone() for k, v in _cache_leaves(cache).items()}
    with pytest.raises(ValueError, match="max_seq"):
        model.decode_step(torch.from_numpy(toks[:, :1]), cache)
    assert cache["len"] == MAX_SEQ
    for key, leaf in _cache_leaves(cache).items():
        assert torch.equal(leaf, kept[key]), key
    with pytest.raises(ValueError, match="max_seq"):
        model.prefill(torch.zeros((1, MAX_SEQ + 1), dtype=torch.int32),
                      torch.zeros((1, cfg.num_frames, cfg.d_model)))


def test_frames_of_another_shape_raise():
    _, cfg, _, model, toks, frames, _ = _case("float32")
    with pytest.raises(ValueError, match="frames"):
        _prefill(model, toks, frames[:, :-1])


# --- the kernels the path goes through ---------------------------------------------


def test_prefill_and_decode_go_through_the_kernel_entries(monkeypatch):
    """A prefill calls K3's wrapper once an encoder layer (S = the frames,
    not causal) and twice a decoder layer -- self attention (causal) and
    cross attention (the prompt's queries over the frames' keys, not
    causal); a decode step calls it never."""
    _, cfg, _, model, toks, frames, _ = _case("bfloat16")
    calls = []
    attn = k3.flash_attention

    def spy_attn(q, k, v, *, causal, scale, **kw):
        calls.append((q.shape[1], k.shape[1], causal))
        return attn(q, k, v, causal=causal, scale=scale, **kw)

    monkeypatch.setattr(k3, "flash_attention", spy_attn)
    _, cache = _prefill(model, toks, frames)
    f = cfg.num_frames
    assert calls == ([(f, f, False)] * cfg.encoder_layers
                     + [(S, S, True), (S, f, False)] * cfg.num_layers)
    model.decode_step(torch.from_numpy(toks[:, :1]), _grown(model, cache, 1))
    assert len(calls) == cfg.encoder_layers + 2 * cfg.num_layers


# --- entry points ------------------------------------------------------------------


def test_build_model_audio_serves_like_the_module():
    _, cfg, _, model, toks, frames, _ = _case("float32")
    m = build_model(cfg)
    assert None not in (m.prefill, m.decode, m.init_cache, m.loss)
    logits, cache = m.prefill(model, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)})
    want, _ = _prefill(model, toks, frames)
    assert torch.equal(logits, want)
    cache = _grown(model, cache, 1)
    step, cache = m.decode(model, {"tokens": torch.from_numpy(toks[:, :1])},
                           cache)
    assert tuple(step.shape) == (B, 1, cfg.vocab_size)
    empty = m.init_cache(B, 100, device="cpu")
    assert empty["len"] == 0
    assert tuple(empty["self"]["k"].shape) == (
        cfg.num_layers, B, 100, cfg.num_kv_heads, cfg.head_dim)
    assert tuple(empty["cross"]["v"].shape) == (
        cfg.num_layers, B, cfg.num_frames, cfg.num_kv_heads, cfg.head_dim)
    small = m.init(device="cpu", max_seq=32)
    assert isinstance(small, tw.Whisper) and small.max_seq == 32
    assert tuple(small.dec_pos["pos_w"].shape) == (32, cfg.d_model)


def test_build_model_whisper_needs_a_card_unless_told_cpu():
    """The full config has the reference's parameter count at the same
    ``max_seq`` (built on the meta device: shapes only); a model builds on
    the CPU when asked, and the default and ``"cuda"`` raise without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = build_model(base.get_config("whisper_small"))
    meta = m.init(device="meta", max_seq=448)
    assert len(meta.enc_layers) == len(meta.dec_layers) == 12
    shapes = jax.eval_shape(
        lambda k: rw.init_params(k, rbase.get_config("whisper_small"),
                                 max_seq=448), jax.random.PRNGKey(0))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in meta.parameters()) == want
    with pytest.raises(RuntimeError, match="cuda"):
        m.init()
    with pytest.raises(RuntimeError, match="cuda"):
        m.init(device="cuda")
    small = build_model(_configs("float32")[1])
    assert isinstance(small.init(device="cpu"), tw.Whisper)


@pytest.mark.parametrize("change,err,match", [
    (dict(use_rope=True), NotImplementedError, "use_rope"),
    (dict(attn_type="mla"), NotImplementedError, "attn_type"),
    (dict(qkv_bias=True), NotImplementedError, "qkv_bias"),
    (dict(cache_layout="head_major"), NotImplementedError, "cache_layout"),
    (dict(encoder_layers=0), ValueError, "encoder"),
])
def test_check_audio_refuses_what_the_path_does_not_compute(change, err,
                                                            match):
    cfg = dataclasses.replace(base.get_config("whisper_small"), **change)
    with pytest.raises(err, match=match):
        tw.check_audio(cfg)
    with pytest.raises(err, match=match):
        build_model(cfg)


def test_check_audio_head_dims_by_device():
    """K3's training kernels (card, and the census's meta route) take head
    dims 64 and 128; the CPU's plain versions any."""
    cfg = base.get_config("whisper_small").reduced()
    assert cfg.head_dim == 16
    tw.check_audio(cfg, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        tw.check_audio(cfg, torch.device("meta"))
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        tw.Whisper(cfg, device="meta")
    tw.check_audio(base.get_config("whisper_small"), torch.device("meta"))


def test_params_from_reference_refuses_a_mismatch():
    _, cfg, params, _, _, _, _ = _case("float32")
    tree = _numpy_tree(params)
    tree["enc_layers"]["ln1"]["scale"] = np.ones((3, cfg.d_model),
                                                 np.float32)
    with pytest.raises(ValueError, match="leading axis"):
        tw.params_from_reference(tree, cfg, device="cpu")
    tree = _numpy_tree(params)
    tree["enc_pos"]["pos_w"] = tree["enc_pos"]["pos_w"][:1]
    with pytest.raises(ValueError, match="shape"):
        tw.params_from_reference(tree, cfg, device="cpu")


def test_params_from_reference_splits_stacks_of_different_depths():
    """3 encoder layers beside 2 decoder layers: each stack split over its
    own depth, every parameter the reference's slice exactly."""
    rcfg, cfg = _configs("float32", encoder_layers=3)
    params = rw.init_params(jax.random.PRNGKey(4), rcfg, max_seq=16)
    model = tw.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    assert len(model.enc_layers) == 3 and len(model.dec_layers) == 2
    for name, p in model.named_parameters():
        path, layer = L.reference_key(name)
        leaf = params
        for key in path.split("/"):
            leaf = leaf[key]
        want = np.asarray(leaf)
        if layer is not None:
            want = want[layer]
        assert np.array_equal(p.detach().numpy(), want), name
