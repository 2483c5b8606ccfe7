"""The port's Mamba2 serving path against the reference.

The reduced ``mamba2_130m`` (``cfg.reduced()``: 2 layers, d_model 64,
d_inner 128, 8 heads of 16, ds 16, chunk 16, vocab 256), in float32 and bf16,
with the reference's ``init_params`` weights carried over by
``params_from_reference`` -- ``dt_bias``, ``A_log``, ``D``, the conv biases
and the norm scales redrawn at random so that they matter (with ``dt_bias``
in U(-4, -1) the state decays slowly enough to carry across the 3 chunks of
a 48-token prompt).  Prompts are drawn with numpy and go through both
packages on the CPU, where the scan takes K4's plain version.  Tolerances,
relative to the scale (max |reference|): float32 1e-5 (measured below
5e-7), bf16 3e-2 for logits, conv cache and state (measured below 1e-2: a
bf16 ulp where a value rounds the other way, carried into later layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as rbase
from repro.models import mamba as rm
from repro.models import ssd as rssd
from repro_torch.configs import base
from repro_torch.kernels import ssd_scan as k4
from repro_torch.models import mamba as tm
from repro_torch.models import ssd as tssd
from repro_torch.models.api import build_model

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S, STEPS = 2, 48, 4

_DRAWS = {"scale": (0.5, 1.5), "dt_bias": (-4.0, -1.0), "A_log": (-1.0, 1.0),
          "D": (0.5, 1.5)}


def _configs(dtype):
    return (dataclasses.replace(rbase.get_config("mamba2_130m").reduced(),
                                dtype=dtype),
            dataclasses.replace(base.get_config("mamba2_130m").reduced(),
                                dtype=dtype))


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


def _torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(TORCH[dtype])


_CASES = {}


def _case(dtype):
    """(reference cfg, port cfg, reference params, port model, tokens,
    reference prefill (logits, cache)), built once per dtype."""
    if dtype not in _CASES:
        rcfg, cfg = _configs(dtype)
        params = _randomize(rm.init_params(jax.random.PRNGKey(0), rcfg),
                            np.random.default_rng(1))
        model = tm.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        _CASES[dtype] = (rcfg, cfg, params, model, toks,
                         rm.prefill(params, rcfg, jnp.asarray(toks)))
    return _CASES[dtype]


# --- prefill and decode against the reference -------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    """Logits and both cache tensors of ``Mamba.prefill`` vs
    ``mamba.prefill``."""
    _, cfg, _, model, toks, (want_logits, want_cache) = _case(dtype)
    logits, cache = model.prefill(torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert np.isfinite(logits.numpy()).all()
    assert _rel(logits, want_logits) < TOL[dtype]
    assert cache["len"] == S == int(want_cache["len"])
    for key in ("conv", "state"):
        got, want = cache["ssm"][key], want_cache["ssm"][key]
        assert tuple(got.shape) == want.shape
        assert got.dtype == TORCH[str(want.dtype)]
        assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_from_the_prefill_cache_match_reference(dtype):
    """Greedy ``decode_step``s straight from each package's own prefill
    cache (the SSM cache does not grow): logits, conv tail and state after
    every step, on the reference's tokens."""
    rcfg, cfg, params, model, toks, (want_logits, rcache) = _case(dtype)
    _, cache = model.prefill(torch.from_numpy(toks))
    tok = np.asarray(want_logits[:, -1:].argmax(-1)).astype(np.int32)
    for step in range(STEPS):
        want, rcache = rm.decode_step(params, rcfg, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(torch.from_numpy(tok), cache)
        assert tuple(got.shape) == (B, 1, cfg.vocab_size)
        assert _rel(got, want) < TOL[dtype], step
        for key in ("conv", "state"):
            assert _rel(cache["ssm"][key], rcache["ssm"][key]) < TOL[dtype]
        assert cache["len"] == S + step + 1 == int(rcache["len"])
        tok = np.asarray(want[:, -1:].argmax(-1)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_equals_prefill_logits(dtype):
    _, _, _, model, toks, _ = _case(dtype)
    logits, _ = model.prefill(torch.from_numpy(toks))
    assert torch.equal(model(torch.from_numpy(toks)), logits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_state_equals_stepwise_decode(dtype):
    """The port's own discipline of ``tests/test_layers.py``'s
    ``test_mamba_prefill_state_matches_decode_replay``: decoding the prompt
    one token at a time from an empty cache gives the prefill's cache and
    last-position logits (K4's plain version against the recurrence)."""
    _, cfg, _, model, toks, _ = _case(dtype)
    t = torch.from_numpy(toks[:, :32])
    logits, cache = model.prefill(t)
    step_cache = model.init_cache(B)
    for i in range(32):
        step, step_cache = model.decode_step(t[:, i:i + 1], step_cache)
    tol = TOL[dtype]
    assert _rel(step[:, 0], logits[:, -1].numpy()) < tol
    assert _rel(step_cache["ssm"]["state"], cache["ssm"]["state"].numpy()) \
        < tol
    assert _rel(step_cache["ssm"]["conv"], cache["ssm"]["conv"].float()
                .numpy()) < tol


# --- block-level numerics ----------------------------------------------------


def _ulps(got: torch.Tensor, want: np.ndarray) -> int:
    """Largest distance in units in the last place (same-sign values)."""
    if got.dtype == torch.bfloat16:
        g, w = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        g, w = got.numpy().view(np.int32), want.view(np.int32)
    return int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference_bitwise(dtype, monkeypatch):
    """The prefill conv: four shifted products and their partial sums in
    the activation dtype, in order, then ``+ b``: bit for bit the
    reference's in both dtypes (``F.conv1d`` would not be; read with the
    silu taken out of both).  The silu rounds once (``F.silu``, one op per
    conv); the reference's ``jax.nn.silu`` lowers on XLA's CPU to four
    steps, each rounded to bf16, so the outputs may differ by two bf16
    ulps (measured: 2) and two float32 ulps (XLA's and torch's ``exp``)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 40, 24)).astype(np.float32),
                    jnp.dtype(dtype))
    w = jnp.asarray(rng.normal(0, 0.2, (4, 24)).astype(np.float32),
                    jnp.dtype(dtype))
    b = jnp.asarray(rng.normal(0, 0.1, (24,)).astype(np.float32),
                    jnp.dtype(dtype))
    tx, tw, tb = (_torch(a, dtype) for a in (x, w, b))
    want = np.asarray(rssd._causal_conv(x, w, b))
    got = tssd._causal_conv(tx, tw, tb)
    assert got.dtype == TORCH[dtype]
    assert _ulps(got, want) <= 2
    with monkeypatch.context() as m:
        m.setattr(jax.nn, "silu", lambda v: v)
        want_pre = np.asarray(rssd._causal_conv(x, w, b))
    with monkeypatch.context() as m:
        m.setattr(F, "silu", lambda v: v)
        got_pre = tssd._causal_conv(tx, tw, tb)
    assert _ulps(got_pre, want_pre) == 0
    assert torch.equal(got, F.silu(got_pre))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_and_cache_match_reference(dtype):
    """One block with ``return_cache``: output, the pre-conv tail and the
    final state vs ``ssd.mamba_block``."""
    rcfg, cfg, params, model, _, _ = _case(dtype)
    rp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["mix"])
    x = jnp.asarray(np.random.default_rng(4).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32), jnp.dtype(dtype))
    want, (want_tail, want_state) = rssd.mamba_block(rp, rcfg, x,
                                                     return_cache=True)
    got, (tail, state) = tssd.mamba_block(model.layers[0]["mix"], cfg,
                                          _torch(x, dtype),
                                          return_cache=True)
    assert _rel(got, want) < TOL[dtype]
    assert tuple(tail.shape) == (B, cfg.ssm_conv_width - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)
    assert _rel(tail, want_tail) < TOL[dtype]
    assert _rel(state, want_state) < TOL[dtype]


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 25.0, 60.0])
    np.testing.assert_allclose(
        tssd._softplus(x).numpy(),
        np.array(jax.nn.softplus(jnp.asarray(x.numpy()))), rtol=1e-7)


def test_prefill_goes_through_the_scan_entry_once_per_layer(monkeypatch):
    """Every layer's scan goes through ``ops.ssd_scan`` (K4's wrapper) with
    the model's chunk, float32 output and B / C as strided views."""
    _, cfg, _, model, toks, _ = _case("bfloat16")
    calls = []
    plain = k4.ssd_scan

    def spy(x, dt, A, Bm, Cm, *, chunk, out_dtype):
        calls.append((tuple(x.shape), chunk, out_dtype, Bm.is_contiguous()))
        return plain(x, dt, A, Bm, Cm, chunk=chunk, out_dtype=out_dtype)

    monkeypatch.setattr(k4, "ssd_scan", spy)
    model.prefill(torch.from_numpy(toks))
    want = (B, S, cfg.ssm_nheads, cfg.ssm_headdim)
    assert calls == [(want, cfg.ssm_chunk, torch.float32, False)] * \
        cfg.num_layers
    calls.clear()
    _, cache = model.prefill(torch.from_numpy(toks))
    model.decode_step(torch.from_numpy(toks[:, :1]), cache)
    assert len(calls) == cfg.num_layers      # none from the decode step


# --- entry points --------------------------------------------------------------


def test_build_model_ssm_serves_like_the_module():
    _, cfg, _, model, toks, _ = _case("float32")
    m = build_model(cfg)
    assert m.prefill is not None and m.decode is not None
    logits, cache = m.prefill(model, {"tokens": torch.from_numpy(toks)})
    want, _ = model.prefill(torch.from_numpy(toks))
    assert torch.equal(logits, want)
    step, cache = m.decode(model, {"tokens": torch.from_numpy(toks[:, :1])},
                           cache)
    assert tuple(step.shape) == (B, 1, cfg.vocab_size)
    empty = m.init_cache(B, 10_000, device="cpu")
    assert empty["len"] == 0
    assert tuple(empty["ssm"]["state"].shape) == (
        cfg.num_layers, B, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)


def test_build_model_mamba2_130m_needs_a_card_unless_told_cpu():
    """The full config builds a ``Mamba`` on the CPU when asked, and raises
    without a card for the default and for ``"cuda"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = build_model(base.get_config("mamba2_130m"))
    model = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(model, tm.Mamba)
    assert len(model.layers) == 24
    shapes = jax.eval_shape(
        lambda k: rm.init_params(k, rbase.get_config("mamba2_130m")),
        jax.random.PRNGKey(0))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want
    with pytest.raises(RuntimeError, match="cuda"):
        m.init()
    with pytest.raises(RuntimeError, match="cuda"):
        m.init(device="cuda")


def test_decode_conv_weights_follow_the_parameters():
    """The decode conv's joined weights, joined once per layer, are joined
    again when the parameters are replaced: by ``load_state_dict`` and by
    ``params_from_reference``."""
    _, cfg, params, ref_model, _, _ = _case("float32")
    model = tm.Mamba(cfg, generator=torch.Generator().manual_seed(7),
                     device="cpu")
    stale = [model.decode_conv(i) for i in range(cfg.num_layers)]
    model.load_state_dict(ref_model.state_dict())
    for i, lp in enumerate(ref_model.layers):
        mix = lp["mix"]
        got = model.decode_conv(i)
        assert torch.equal(got[0], torch.cat(
            [mix["conv_w"], mix["conv_bc_w"]], dim=1).float())
        assert torch.equal(got[1], torch.cat(
            [mix["conv_b"], mix["conv_bc_b"]]))
        assert not torch.equal(got[0], stale[i][0])
        want = ref_model.decode_conv(i)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # joined once: a second read without a change returns the same tensors
    assert model.decode_conv(0)[0] is model.decode_conv(0)[0]


def test_decode_after_an_in_place_weight_write_matches_a_fresh_model():
    """A decode step after ``conv_w.mul_(2)`` on layer 0 (an in-place write,
    as an optimizer's) gives the logits of a model freshly built from the
    same parameters, not those of the stale join (0.17 apart)."""
    _, cfg, _, ref_model, toks, _ = _case("float32")
    model = tm.Mamba(cfg, generator=torch.Generator().manual_seed(7),
                     device="cpu")
    model.load_state_dict(ref_model.state_dict())
    logits, cache = model.prefill(torch.from_numpy(toks))
    tok = logits[:, -1:].argmax(-1)

    def fork(c):
        return {"len": c["len"], "ssm": {k: [t.clone() for t in v]
                                         for k, v in c["ssm"].items()}}

    before, _ = model.decode_step(tok, fork(cache))    # joins every layer
    with torch.no_grad():
        model.layers[0]["mix"]["conv_w"].mul_(2)
    got, _ = model.decode_step(tok, fork(cache))
    fresh = tm.Mamba(cfg, generator=torch.Generator().manual_seed(8),
                     device="cpu")
    fresh.load_state_dict(model.state_dict())
    want, _ = fresh.decode_step(tok, fork(cache))
    assert torch.equal(got, want)
    assert not torch.equal(got, before)


def test_ngroups_other_than_one_is_refused():
    cfg = dataclasses.replace(base.get_config("mamba2_130m").reduced(),
                              ssm_ngroups=2)
    with pytest.raises(NotImplementedError, match="ngroups"):
        build_model(cfg)


def test_params_from_reference_refuses_a_mismatch():
    _, cfg, params, _, _, _ = _case("float32")
    tree = _numpy_tree(params)
    tree["layers"]["mix"]["D"] = np.zeros((3, cfg.ssm_nheads), np.float32)
    with pytest.raises(ValueError, match="leading axis"):
        tm.params_from_reference(tree, cfg, device="cpu")
