"""The port's Zamba2 serving path (``repro_torch.models.zamba``) against the
reference's ``repro.models.zamba``.

The reduced ``zamba2_1_2b`` cut to 5 layers (``cfg.reduced()`` gives 2
layers with ``attn_every`` 2, one site and no tail, which would hide a
site-indexing or tail fault): d_model 64, d_inner 128, 8 SSM heads of 16,
ds 16, chunk 16, 4 attention heads of 16, vocab 256; two sites (after
layers 2 and 4) and a 1-layer tail.  Float32 and bf16, with the reference's
``init_params`` weights carried over by ``params_from_reference`` --
``dt_bias``, ``A_log``, ``D``, the conv biases and every norm scale (the
shared block's included) redrawn at random so that they matter.  Prompts
are drawn with numpy and go through both packages on the CPU, where the
scan takes K4's plain version and the attention K3's.  Tolerances,
relative to the scale (max |reference|): float32 1e-5, bf16 3e-2, as
``tests/test_torch_mamba.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import zamba as rz
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ssd_scan as k4
from repro_torch.models import zamba as tz
from repro_torch.models.api import build_model

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S, STEPS, LAYERS = 2, 48, 4, 5

_DRAWS = {"scale": (0.5, 1.5), "dt_bias": (-4.0, -1.0), "A_log": (-1.0, 1.0),
          "D": (0.5, 1.5)}


def _configs(dtype, **kw):
    kw = dict(num_layers=LAYERS, dtype=dtype, **kw)
    return (dataclasses.replace(rbase.get_config("zamba2_1_2b").reduced(),
                                **kw),
            dataclasses.replace(base.get_config("zamba2_1_2b").reduced(),
                                **kw))


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in _DRAWS:
            out[k] = jnp.asarray(rng.uniform(*_DRAWS[k], v.shape)
                                 .astype(np.float32), v.dtype)
        elif k in ("conv_b", "conv_bc_b"):
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


_CASES = {}


def _case(dtype):
    """(reference cfg, port cfg, reference params, port model, tokens,
    reference prefill (logits, cache)), built once per dtype."""
    if dtype not in _CASES:
        rcfg, cfg = _configs(dtype)
        params = _randomize(rz.init_params(jax.random.PRNGKey(0), rcfg),
                            np.random.default_rng(1))
        model = tz.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        _CASES[dtype] = (rcfg, cfg, params, model, toks,
                         rz.prefill(params, rcfg, jnp.asarray(toks)))
    return _CASES[dtype]


def _ref_decode(rcfg):
    return jax.jit(lambda p, t, c: rz.decode_step(p, rcfg, t, c))


def _cache_leaves(cache):
    return {"ssm/conv": cache["ssm"]["conv"],
            "ssm/state": cache["ssm"]["state"],
            "attn/k": cache["attn"]["k"], "attn/v": cache["attn"]["v"]}


def _grown(model, cache, extra):
    """The port's prefill cache copied into an ``init_cache`` with room for
    ``extra`` more positions."""
    b, s = cache["attn"]["k"].shape[1:3]
    big = model.init_cache(b, s + extra)
    big["len"] = cache["len"]
    big["ssm"]["conv"].copy_(cache["ssm"]["conv"])
    big["ssm"]["state"].copy_(cache["ssm"]["state"])
    big["attn"]["k"][:, :, :s] = cache["attn"]["k"]
    big["attn"]["v"][:, :, :s] = cache["attn"]["v"]
    return big


def _ref_grown(rcache, extra):
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {"len": rcache["len"], "ssm": rcache["ssm"],
            "attn": {k: jnp.pad(v, pad) for k, v in rcache["attn"].items()}}


# --- the structure -----------------------------------------------------------------


@pytest.mark.parametrize("layers,every", [(38, 6), (5, 2), (4, 2), (6, 6),
                                          (1, 2), (7, 6)])
def test_segments_and_sites_match_reference(layers, every):
    """The shared block runs after each full segment of ``attn_every``
    layers and not after a short tail, as the reference's ``_segments``."""
    cfg = dataclasses.replace(base.get_config("zamba2_1_2b"),
                              num_layers=layers, attn_every=every)
    rcfg = dataclasses.replace(rbase.get_config("zamba2_1_2b"),
                               num_layers=layers, attn_every=every)
    assert tz._segments(cfg) == rz._segments(rcfg)
    assert tz.n_sites(cfg) == rz._n_sites(rcfg)


def test_shared_block_is_one_set_of_parameters():
    """One ``shared_attn`` tree, the reference's leaf for leaf; a write to
    it changes what every site computes: each site's k cache after a
    prefill."""
    rcfg, cfg, params, model, toks, _ = _case("float32")
    names = [n for n, _ in model.named_parameters()
             if n.startswith("shared_attn.")]
    want = {"shared_attn." + ".".join(str(getattr(k, "key", k))
                                      for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                params["shared_attn"])[0]}
    assert set(names) == want and len(names) == len(want)
    _, before = model.prefill(torch.from_numpy(toks))
    other = tz.Zamba(cfg, generator=torch.Generator().manual_seed(5),
                     device="cpu")
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        other.shared_attn["attn"]["wk"].mul_(1.5)
    _, after = other.prefill(torch.from_numpy(toks))
    assert tz.n_sites(cfg) == 2
    for site in range(tz.n_sites(cfg)):
        assert not torch.allclose(after["attn"]["k"][site],
                                  before["attn"]["k"][site])
    # the SSM layers before the first site are untouched by the write
    assert torch.equal(after["ssm"]["state"][:cfg.attn_every],
                       before["ssm"]["state"][:cfg.attn_every])


@pytest.mark.parametrize("change,err,match", [
    (dict(ssm_ngroups=2), NotImplementedError, "ngroups"),
    (dict(attn_every=0), ValueError, "attn_every"),
    (dict(attn_type="mla"), NotImplementedError, "attn_type"),
    (dict(cache_layout="head_major"), NotImplementedError, "cache_layout"),
])
def test_check_hybrid_refuses_what_the_path_does_not_compute(change, err,
                                                             match):
    cfg = dataclasses.replace(base.get_config("zamba2_1_2b"), **change)
    with pytest.raises(err, match=match):
        tz.check_hybrid(cfg)
    with pytest.raises(err, match=match):
        build_model(cfg)


def test_check_hybrid_head_dims_by_device():
    """K3's kernels (card, and the census's meta route) take head dims 64
    and 128; the CPU's plain versions any."""
    cfg = dataclasses.replace(base.get_config("zamba2_1_2b").reduced(),
                              num_layers=LAYERS)
    assert cfg.head_dim == 16
    tz.check_hybrid(cfg, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        tz.check_hybrid(cfg, torch.device("meta"))
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        tz.Zamba(cfg, device="meta")
    tz.check_hybrid(base.get_config("zamba2_1_2b"), torch.device("meta"))


# --- prefill and decode against the reference -------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    """Logits and every cache leaf of ``Zamba.prefill`` vs
    ``zamba.prefill``."""
    _, cfg, _, model, toks, (want_logits, want_cache) = _case(dtype)
    logits, cache = model.prefill(torch.from_numpy(toks))
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
    assert tuple(cache["attn"]["k"].shape) == (
        2, B, S, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_after_prefill_matches_reference(dtype):
    """Greedy ``decode_step``s from each package's prefill cache grown by
    ``STEPS`` positions: logits and every cache leaf after every step, on
    the reference's tokens."""
    rcfg, cfg, params, model, toks, (want_logits, rcache) = _case(dtype)
    _, cache = model.prefill(torch.from_numpy(toks))
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
    """Eight steps from each package's own empty ``init_cache(B, 8)``."""
    rcfg, cfg, params, model, toks, _ = _case(dtype)
    rcache = rz.init_cache(rcfg, B, 8)
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
            assert _rel(leaf, _cache_leaves(rcache)[key]) < TOL[dtype], key


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_equals_prefill_logits(dtype):
    _, _, _, model, toks, _ = _case(dtype)
    logits, _ = model.prefill(torch.from_numpy(toks))
    assert torch.equal(model(torch.from_numpy(toks)), logits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_equals_stepwise_decode(dtype):
    """Decoding the prompt one token at a time from an empty cache gives the
    prefill's cache and last-position logits (K4's and K3's plain versions
    against the recurrence and the single-token attention)."""
    _, cfg, _, model, toks, _ = _case(dtype)
    t = torch.from_numpy(toks[:, :32])
    logits, cache = model.prefill(t)
    step_cache = model.init_cache(B, 32)
    for i in range(32):
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
    rcfg, cfg, params, model, toks, (want_logits, rcache) = _case("float32")
    tok = np.asarray(want_logits[:, -1:].argmax(-1)).astype(np.int32)
    out, clamped = rz.decode_step(params, rcfg, jnp.asarray(tok), rcache)
    assert np.isfinite(np.asarray(out)).all()
    assert clamped["attn"]["k"].shape[2] == S
    _, cache = model.prefill(torch.from_numpy(toks))
    kept = {k: v.clone() for k, v in _cache_leaves(cache).items()}
    with pytest.raises(ValueError, match="cache is full"):
        model.decode_step(torch.from_numpy(tok), cache)
    assert cache["len"] == S
    for key, leaf in _cache_leaves(cache).items():
        assert torch.equal(leaf, kept[key]), key


# --- the kernels the path goes through ---------------------------------------------


def test_prefill_and_decode_go_through_the_kernel_entries(monkeypatch):
    """A prefill calls K4's wrapper once a layer and K3's once a site, with
    the model's chunk and float32 scan output; a decode step calls
    neither."""
    _, cfg, _, model, toks, _ = _case("bfloat16")
    calls = {"k3": 0, "k4": []}
    scan, attn = k4.ssd_scan, k3.flash_attention

    def spy_scan(x, dt, A, Bm, Cm, *, chunk, out_dtype):
        calls["k4"].append((tuple(x.shape), chunk, out_dtype))
        return scan(x, dt, A, Bm, Cm, chunk=chunk, out_dtype=out_dtype)

    def spy_attn(*a, **kw):
        calls["k3"] += 1
        return attn(*a, **kw)

    monkeypatch.setattr(k4, "ssd_scan", spy_scan)
    monkeypatch.setattr(k3, "flash_attention", spy_attn)
    _, cache = model.prefill(torch.from_numpy(toks))
    shape = (B, S, cfg.ssm_nheads, cfg.ssm_headdim)
    assert calls["k4"] == [(shape, cfg.ssm_chunk, torch.float32)] * LAYERS
    assert calls["k3"] == tz.n_sites(cfg) == 2
    model.decode_step(torch.from_numpy(toks[:, :1]),
                      _grown(model, cache, 1))
    assert len(calls["k4"]) == LAYERS and calls["k3"] == 2


# --- entry points ------------------------------------------------------------------


def test_build_model_hybrid_serves_like_the_module():
    _, cfg, _, model, toks, _ = _case("float32")
    m = build_model(cfg)
    assert None not in (m.prefill, m.decode, m.init_cache, m.loss)
    logits, cache = m.prefill(model, {"tokens": torch.from_numpy(toks)})
    want, _ = model.prefill(torch.from_numpy(toks))
    assert torch.equal(logits, want)
    cache = _grown(model, cache, 1)
    step, cache = m.decode(model, {"tokens": torch.from_numpy(toks[:, :1])},
                           cache)
    assert tuple(step.shape) == (B, 1, cfg.vocab_size)
    empty = m.init_cache(B, 100, device="cpu")
    assert empty["len"] == 0
    assert tuple(empty["attn"]["k"].shape) == (2, B, 100, cfg.num_kv_heads,
                                               cfg.head_dim)
    assert tuple(empty["ssm"]["state"].shape) == (
        LAYERS, B, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)


def test_build_model_zamba2_needs_a_card_unless_told_cpu():
    """The full config has the reference's parameter count (built on the
    meta device: shapes only); a model builds on the CPU when asked, and
    the default and ``"cuda"`` raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = build_model(base.get_config("zamba2_1_2b"))
    meta = m.init(device="meta")
    assert len(meta.mamba_layers) == 38 and tz.n_sites(meta.cfg) == 6
    shapes = jax.eval_shape(
        lambda k: rz.init_params(k, rbase.get_config("zamba2_1_2b")),
        jax.random.PRNGKey(0))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in meta.parameters()) == want
    with pytest.raises(RuntimeError, match="cuda"):
        m.init()
    with pytest.raises(RuntimeError, match="cuda"):
        m.init(device="cuda")
    small = build_model(_configs("float32")[1])
    assert isinstance(small.init(device="cpu"), tz.Zamba)


def test_decode_conv_joins_follow_the_parameters():
    """The decode conv's joined weights (``ssd.DecodeConvJoins``, shared
    with mamba2) are joined once per layer and joined again after
    ``load_state_dict`` replaced the parameters."""
    _, cfg, _, ref_model, _, _ = _case("float32")
    model = tz.Zamba(cfg, generator=torch.Generator().manual_seed(7),
                     device="cpu")
    stale = [model.decode_conv(i) for i in range(cfg.num_layers)]
    assert model.decode_conv(0)[0] is stale[0][0]
    model.load_state_dict(ref_model.state_dict())
    for i, lp in enumerate(ref_model.mamba_layers):
        mix = lp["mix"]
        got = model.decode_conv(i)
        assert torch.equal(got[0], torch.cat(
            [mix["conv_w"], mix["conv_bc_w"]], dim=1).float())
        assert torch.equal(got[1], torch.cat(
            [mix["conv_b"], mix["conv_bc_b"]]))
        assert not torch.equal(got[0], stale[i][0])


def test_params_from_reference_refuses_a_mismatch():
    _, cfg, params, _, _, _ = _case("float32")
    tree = _numpy_tree(params)
    tree["mamba_layers"]["mix"]["D"] = np.zeros((3, cfg.ssm_nheads),
                                                np.float32)
    with pytest.raises(ValueError, match="leading axis"):
        tz.params_from_reference(tree, cfg, device="cpu")
    tree = _numpy_tree(params)
    tree["shared_attn"]["attn"]["wq"] = tree["shared_attn"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="shape"):
        tz.params_from_reference(tree, cfg, device="cpu")
