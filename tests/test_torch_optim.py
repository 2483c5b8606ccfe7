"""The port's optimisers (``repro_torch.optim``) against the reference's.

The same numpy parameters and gradients (drawn from a seed) go through the
reference's ``apply_adamw`` / ``apply_adafactor`` (eager JAX on the CPU)
and the port's (PyTorch on the CPU) for five steps.  Tolerances:

* int8 quantization, the schedule, compression: bitwise -- one IEEE
  operation after another in both packages (``jnp.round`` and
  ``torch.round`` both round half to even).
* AdamW with gradients under the clip norm (no clipping): parameters and
  moments bitwise -- every element operation is the same IEEE float32
  operation in the same order, and the scalars (learning rate, bias
  corrections) agree bit for bit.
* AdamW with clipping active, and Adafactor with float32 momentum: within
  4 float32 ulps of the parameter scale over five steps.  The global norm
  is a sum of squares that XLA and PyTorch reduce in different orders, so
  the clip factor may differ in its last bit; Adafactor also takes row /
  column means and the RMS of the update, reductions in different orders.
  Adafactor's default bf16 momentum turns such an ulp into a bf16 rounding
  flip now and then: its bound is in the test.
* int8 moments with clipping: q within one step of 127 and scales within
  4 ulps (a value on a rounding boundary may round the other way).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as raf
from repro.optim import adamw as raw
from repro.optim import compression as rcomp
from repro_torch import optim
from repro_torch.optim import adafactor as af
from repro_torch.optim import adamw as aw
from repro_torch.optim import compression as comp

SHAPES = {"a": (300,), "b": (17, 40), "c": (64, 256), "d": (3, 5, 7)}
AF_SHAPES = {"a": (300,), "b": (128, 160), "c": (2, 130, 128),
             "d": (140, 64)}
STEPS = 5
F32_ULP = float(np.finfo(np.float32).eps)


def _draw(shapes, rng, scale):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _max_rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _run_adamw(name, grad_scale, pdtype=np.float32):
    rng = np.random.default_rng(0)
    params0 = _draw(SHAPES, rng, 1.0)
    grads = [_draw(SHAPES, rng, grad_scale) for _ in range(STEPS)]
    rcfg = raw.make_optimizer(name, lr=3e-2, total_steps=10)
    jdt = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
    rparams = {k: jnp.asarray(v).astype(jdt) for k, v in params0.items()}
    rstate = raw.init_opt_state(rparams, rcfg)
    opt = optim.make_optimizer(name, lr=3e-2, total_steps=10)
    tparams = [_t(params0[k]).to(tdt) for k in sorted(SHAPES)]
    tstate = opt.init(tparams)
    for g in grads:
        rparams, rstate, rmet = raw.apply_adamw(
            rparams, {k: jnp.asarray(v).astype(jdt) for k, v in g.items()},
            rstate, rcfg)
        tparams, tstate, tmet = opt.apply(
            tparams, [_t(g[k]).to(tdt) for k in sorted(SHAPES)], tstate)
    return rparams, rstate, rmet, tparams, tstate, tmet


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adamw_bf16"])
def test_adamw_bitwise_without_clipping(name):
    """Gradients of norm < 1: the clip factor is exactly 1 in both."""
    rp, rs, rmet, tp, ts, tmet = _run_adamw(name, 0.005)
    assert float(rmet["grad_norm"]) < 1.0
    assert ts.step == int(rs.step) == STEPS
    assert _np(tmet["lr"]) == _np(rmet["lr"])
    for i, k in enumerate(sorted(SHAPES)):
        np.testing.assert_array_equal(_np(tp[i]), _np(rp[k]))
        if name == "adamw8bit":
            for field in ("m", "v"):
                mine, ref = getattr(ts, field)[i], getattr(rs, field)[k]
                np.testing.assert_array_equal(mine["q"].numpy(),
                                              np.asarray(ref["q"]))
                np.testing.assert_array_equal(mine["scale"].numpy(),
                                              np.asarray(ref["scale"]))
                assert mine["shape"] == tuple(ref["shape"])
                assert mine["n"] == int(ref["n"])
        else:
            np.testing.assert_array_equal(_np(ts.m[i]), _np(rs.m[k]))
            np.testing.assert_array_equal(_np(ts.v[i]), _np(rs.v[k]))


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adamw_bf16"])
def test_adamw_with_clipping_within_ulps(name):
    rp, rs, rmet, tp, ts, tmet = _run_adamw(name, 1.0)
    assert float(rmet["grad_norm"]) > 1.0
    assert abs(float(tmet["grad_norm"]) / float(rmet["grad_norm"]) - 1) \
        <= 4 * F32_ULP
    for i, k in enumerate(sorted(SHAPES)):
        assert _max_rel(tp[i], rp[k]) <= 4 * F32_ULP, k
        if name == "adamw8bit":
            for field in ("m", "v"):
                mine, ref = getattr(ts, field)[i], getattr(rs, field)[k]
                dq = np.abs(mine["q"].numpy().astype(np.int32)
                            - np.asarray(ref["q"]).astype(np.int32))
                assert dq.max() <= 1
                assert _max_rel(mine["scale"], ref["scale"]) <= 4 * F32_ULP
        else:
            # bf16 moments: a value on a rounding boundary may take the
            # neighbouring bf16 (2^-8 relative)
            tol = 2.0 ** -7 if name == "adamw_bf16" else 4 * F32_ULP
            assert _max_rel(ts.m[i], rs.m[k]) <= tol
            assert _max_rel(ts.v[i], rs.v[k]) <= tol


def test_adamw_bf16_parameters_bitwise_without_clipping():
    """bf16 parameters: cast back to bf16 after the float32 update."""
    rp, rs, _, tp, ts, _ = _run_adamw("adamw_bf16", 0.005, "bfloat16")
    for i, k in enumerate(sorted(SHAPES)):
        assert tp[i].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(tp[i]), _np(rp[k]))
        np.testing.assert_array_equal(_np(ts.m[i]), _np(rs.m[k]))


@pytest.mark.parametrize("grad_scale", [0.01, 1.0])
@pytest.mark.parametrize("momentum", ["float32", "bfloat16"])
def test_adafactor_against_reference(grad_scale, momentum):
    """Factored (2-D and 3-D, both trailing dims >= 128) and full second
    moments.  With float32 momentum the parameters and statistics agree
    within 4 ulps of the scale (row / column means and the update's RMS
    reduce in different orders).  With the default bf16 momentum a
    momentum element that lands on a rounding boundary takes the
    neighbouring bf16 (2^-7 relative at most), which moves its parameter by
    up to lr * 2^-7 * |m| a step: parameters within STEPS * lr * 2^-7 *
    max |m| of the reference."""
    rng = np.random.default_rng(1)
    params0 = _draw(AF_SHAPES, rng, 1.0)
    grads = [_draw(AF_SHAPES, rng, grad_scale) for _ in range(STEPS)]
    rcfg = dataclasses.replace(raf.make_adafactor(lr=3e-2, total_steps=10),
                               moment_dtype=momentum)
    cfg = dataclasses.replace(af.make_adafactor(lr=3e-2, total_steps=10),
                              moment_dtype=momentum)
    rparams = {k: jnp.asarray(v) for k, v in params0.items()}
    rstate = raf.init_state(rparams, rcfg)
    keys = sorted(AF_SHAPES)
    tparams = [_t(params0[k]) for k in keys]
    tstate = af.init_state(tparams, cfg)
    for i, k in enumerate(keys):
        assert isinstance(tstate.v[i], af.FactoredV) == \
            isinstance(rstate.v[k], raf.FactoredV)
    for g in grads:
        rparams, rstate, _ = raf.apply_adafactor(
            rparams, {k: jnp.asarray(v) for k, v in g.items()}, rstate, rcfg)
        tparams, tstate, _ = af.apply_adafactor(
            tparams, [_t(g[k]) for k in keys], tstate, cfg)
    for i, k in enumerate(keys):
        m_ref = _np(rstate.m[k])
        if momentum == "float32":
            assert _max_rel(tparams[i], rparams[k]) <= 4 * F32_ULP, k
            assert _max_rel(tstate.m[i], m_ref) <= 4 * F32_ULP, k
        else:
            assert tstate.m[i].dtype == torch.bfloat16
            diff = np.abs(_np(tparams[i]) - _np(rparams[k])).max()
            assert diff <= STEPS * 3e-2 * 2.0 ** -7 * np.abs(m_ref).max(), k
            assert _max_rel(tstate.m[i], m_ref) <= 2.0 ** -7, k
        mine, ref = tstate.v[i], rstate.v[k]
        vtol = 4 * F32_ULP if momentum == "float32" else 2.0 ** -7
        if isinstance(ref, raf.FactoredV):
            assert tuple(mine.r.shape) == ref.r.shape
            assert tuple(mine.c.shape) == ref.c.shape
            assert _max_rel(mine.r, ref.r) <= vtol
            assert _max_rel(mine.c, ref.c) <= vtol
        else:
            assert _max_rel(mine, ref) <= vtol


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (3, 300), (0, 5)])
def test_quantize_roundtrip_bitwise(shape):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    if x.size > 300:
        x.reshape(-1)[256:512] = 0.0          # an all-zero block
    mine, ref = aw.quantize_i8(_t(x)), raw.quantize_i8(jnp.asarray(x))
    np.testing.assert_array_equal(mine["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(mine["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    assert mine["shape"] == tuple(ref["shape"]) and mine["n"] == ref["n"]
    np.testing.assert_array_equal(aw.dequantize_i8(mine).numpy(),
                                  np.asarray(raw.dequantize_i8(ref)))


def test_quantize_rounds_half_to_even():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    mine, ref = aw.quantize_i8(_t(x)), raw.quantize_i8(jnp.asarray(x))
    np.testing.assert_array_equal(mine["q"].numpy(), np.asarray(ref["q"]))
    assert mine["q"].reshape(-1)[:6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 2, 10),
                                                  (1e-3, 500, 2000),
                                                  (5e-2, 1, 1)])
def test_warmup_cosine_bitwise(base_lr, warmup, total):
    mine = aw.warmup_cosine(base_lr, warmup, total)
    ref = raw.warmup_cosine(base_lr, warmup, total)
    steps = sorted(set(range(0, 12)) | {warmup, total, total + 5,
                                        (warmup + total) // 2})
    got = np.array([float(mine(s)) for s in steps], np.float32)
    want = np.array([float(ref(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)


def test_global_norm_matches():
    rng = np.random.default_rng(3)
    g = _draw(SHAPES, rng, 1.0)
    mine = float(aw.global_norm([_t(g[k]) for k in sorted(g)]))
    ref = float(raw.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    assert abs(mine / ref - 1) <= 4 * F32_ULP


def test_compress_decompress_bitwise():
    rng = np.random.default_rng(4)
    for shape in [(7,), (300,), (4, 256), (3, 5, 40)]:
        x = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(
            comp.compress_decompress(_t(x)).numpy(),
            np.asarray(rcomp.compress_decompress(jnp.asarray(x))))


def test_compression_error_feedback_bitwise_over_steps():
    rng = np.random.default_rng(5)
    keys = sorted(SHAPES)
    rres = rcomp.init_residual({k: jnp.zeros(SHAPES[k]) for k in keys})
    tres = comp.init_residual([torch.zeros(SHAPES[k]) for k in keys])
    for _ in range(3):
        g = _draw(SHAPES, rng, 0.1)
        rsent, rres = rcomp.compressed_grads_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, rres)
        tsent, tres = comp.compressed_grads_with_feedback(
            [_t(g[k]) for k in keys], tres)
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(tsent[i].numpy(),
                                          np.asarray(rsent[k]))
            np.testing.assert_array_equal(tres[i].numpy(),
                                          np.asarray(rres[k]))


def test_make_optimizer_names_and_state_kinds():
    p = [torch.zeros(300), torch.zeros(128, 256)]
    assert all(isinstance(m, torch.Tensor) and m.dtype == torch.float32
               for m in optim.make_optimizer("adamw").init(p).m)
    assert all(aw.is_moment_leaf(m)
               for m in optim.make_optimizer("adamw8bit").init(p).v)
    for name in ("adamw_bf16", "adamw_lowmem"):
        assert all(m.dtype == torch.bfloat16
                   for m in optim.make_optimizer(name).init(p).m)
    s = optim.make_optimizer("adafactor").init(p)
    assert not isinstance(s.v[0], af.FactoredV)
    assert isinstance(s.v[1], af.FactoredV)
    assert tuple(s.v[1].r.shape) == (128,) and tuple(s.v[1].c.shape) == (256,)
