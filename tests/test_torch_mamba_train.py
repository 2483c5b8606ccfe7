"""The port's Mamba2 training path (loss, gradients, train step,
``train()``) against the reference's, on the CPU.

A reduced ``mamba2_130m``: 2 layers, d_model 128 (d_inner 256: 4 heads of
64), state 16, chunk 16, vocab 256, with the reference's ``init_params``
weights carried across by ``params_from_reference`` -- ``dt_bias``,
``A_log``, ``D``, the conv biases and the norm scales redrawn at random so
that their gradients matter -- and tokens drawn with numpy; 48 positions,
3 chunks.  The scan takes K4's plain forward and plain backward (the CPU
path).  Tolerances, each stated where it is used:

* loss: 1e-5 relative; every parameter gradient: 1e-4 of its reference's
  scale (max |reference|) -- sums in other orders through two layers, the
  scan's VJP and a 256-way head (measured: loss ~1e-7, gradients below
  2e-6 of scale);
* remat "none", "full" and "dots" in the port: bitwise (recomputation runs
  the same code on the same inputs);
* 12 train steps against the reference's jitted ``make_train_step`` +
  ``apply_adamw``: float32 losses within 1e-5 relative and parameters
  within 0.05 learning rates absolute (measured 0.011, from step 1 on: a
  first Adam update, g / (|g| + 1e-8), turns the float noise of a gradient
  element near 1e-8 into a share of a learning rate -- 1.3e-4 of in_z's
  scale);
* ``train()`` resumed from a checkpoint: bitwise the uninterrupted run.
"""

import dataclasses
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.configs import base as rbase
from repro.models import api as rapi
from repro.models import mamba as rm
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import ssd_scan as k4
from repro_torch.launch.train import train
from repro_torch.models import api, layers
from repro_torch.models import mamba as tm

B, S = 2, 48
LR = 1e-3
_DRAWS = {"scale": (0.5, 1.5), "dt_bias": (-4.0, -1.0), "A_log": (-1.0, 1.0),
          "D": (0.5, 1.5)}


def _configs(dtype="float32", **kw):
    kw = dict(d_model=128, ssm_headdim=64, dtype=dtype, **kw)
    return (dataclasses.replace(rbase.get_config("mamba2_130m").reduced(),
                                **kw),
            dataclasses.replace(base.get_config("mamba2_130m").reduced(),
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


def _case(dtype="float32", **kw):
    rcfg, cfg = _configs(dtype, **kw)
    params = _randomize(rm.init_params(jax.random.PRNGKey(0), rcfg),
                        np.random.default_rng(1))
    model = tm.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    return rcfg, cfg, params, model


def _tokens(seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1                     # pads are ignored
    return toks[:, :-1], labels


def _ref_leaf(tree, name):
    path, layer = layers.reference_key(name)
    leaf = tree
    for key in path.split("/"):
        leaf = leaf[key]
    leaf = np.array(jnp.asarray(leaf).astype(jnp.float32))
    return leaf if layer is None else leaf[layer]


def _rel(got, want):
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _port_grads(model, toks, labels):
    model.requires_grad_(True)
    loss, metrics = tm.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels))
    return loss, metrics, torch.autograd.grad(loss,
                                              list(model.parameters()))


def test_loss_and_every_gradient_match_jax_value_and_grad():
    rcfg, cfg, params, model = _case()
    toks, labels = _tokens()
    (want_loss, want_met), want_g = jax.value_and_grad(
        lambda p: rm.loss_fn(p, rcfg, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True)(params)
    loss, metrics, grads = _port_grads(model, toks, labels)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-5
    assert float(metrics["nll"]) == float(loss.detach())
    assert float(metrics["moe_aux"]) == 0.0
    assert float(want_met["nll"]) == float(want_loss)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(grads) == 2 * 15 + 2
    for name, g in zip(names, grads):
        assert _rel(g, _ref_leaf(want_g, name)) <= 1e-4, name


def test_model_api_trains_the_ssm_family():
    """``Model.loss`` is ``mamba.loss_fn``; ``check_trainable`` passes."""
    _, cfg, _, model = _case()
    toks, labels = _tokens()
    api.check_trainable(cfg)
    model.requires_grad_(True)
    got, _ = api.build_model(cfg).loss(model, {"tokens": toks,
                                               "labels": labels})
    want, _ = tm.loss_fn(model, torch.from_numpy(toks),
                         torch.from_numpy(labels))
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bitwise_no_remat(remat):
    toks, labels = _tokens()
    _, _, _, plain = _case(remat="none")
    _, _, _, other = _case(remat=remat)
    loss0, _, g0 = _port_grads(plain, toks, labels)
    loss1, _, g1 = _port_grads(other, toks, labels)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat,scans", [("none", 1), ("dots", 2),
                                         ("full", 2)])
def test_scans_a_step_runs(monkeypatch, remat, scans):
    """K4's forward runs once a layer without remat and twice under "dots"
    and "full": the reference's dots policy keeps only products without
    batch dimensions, and the scan's are batched, so the backward
    recomputes it; K4's backward runs once a layer."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = k4._scan, k4.ssd_scan_bwd

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(k4, "_scan", spy_fwd)
    monkeypatch.setattr(k4, "ssd_scan_bwd", spy_bwd)
    _, cfg, _, model = _case(remat=remat)
    _port_grads(model, *_tokens())
    assert calls == {"fwd": scans * cfg.num_layers, "bwd": cfg.num_layers}


def _batches(cfg, n):
    shape = base.ShapeConfig("train_cli", S, B, "train")
    return [synth_batch(cfg, shape, DataConfig(seed=7), s) for s in range(n)]


def test_twelve_train_steps_match_the_reference():
    """12 steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` + ``apply_adamw``, from the same weights on the
    same batches, float32: losses within 1e-5 relative, parameters within
    0.05 learning rates (the module docstring)."""
    rcfg, cfg, params, model = _case()
    batches = _batches(cfg, 12)
    ropt = roptim.make_optimizer("adamw", lr=LR, total_steps=12)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = jax.jit(rapi.make_train_step(rapi.build_model(rcfg), ropt))
    opt = optim.make_optimizer("adamw", lr=LR, total_steps=12)
    state = api.init_train_state(model, opt)
    step = api.make_train_step(api.build_model(cfg), opt)
    rlosses, losses = [], []
    for batch in batches:
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, batch)
        rlosses.append(float(rmet["loss"]))
        losses.append(float(met["loss"]))
        assert set(met) == {"nll", "moe_aux", "grad_norm", "lr", "loss"}
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    assert state.opt.step == int(rstate.opt.step) == 12
    for name, p in state.params.named_parameters():
        diff = np.abs(p.detach().numpy() - _ref_leaf(rstate.params, name))
        assert diff.max() <= 0.05 * LR, name


def test_train_restarts_bitwise():
    """``train("mamba2_130m", device="cpu")`` (the reduced config): 8 steps
    with a checkpoint every 4; resuming at 4 gives the uninterrupted run's
    last 4 losses and final parameters and moments bitwise."""
    kw = dict(steps=8, reduced=True, seq_len=32, batch=2,
              install_signals=False, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("mamba2_130m", ckpt_dir=d, ckpt_every=4, **kw)
        assert np.all(np.isfinite(full))
        shutil.rmtree(os.path.join(d, "step_8"))
        resumed, s_res = train("mamba2_130m", ckpt_dir=d, restore=True,
                               ckpt_every=100, **kw)
    assert resumed == full[4:]
    for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s_full.opt.m + s_full.opt.v, s_res.opt.m + s_res.opt.v):
        assert torch.equal(a, b)
    assert s_res.opt.step == s_full.opt.step == 8
