"""The port's deepseek v2 / v3 training path (``transformer.loss_fn`` with
MLA, the experts and v3's MTP head; Adafactor; ``train()``) against the
reference's, on the CPU.

Configs and weights: ``tests/_deepseek_cases.py`` (3 layers -- 1 dense + 2
MoE -- at MLA's real head dims, d_model 64, 8 experts top-2, one shared,
MTP depth 1 for v3), float32, remat "full" (the configs'); tokens and
labels numpy draws.  Attention takes K3's plain forward and backward, the
routed experts ``moe.RoutedExperts`` and its backward.  Tolerances:

* ``nll``, ``moe_aux``, ``mtp_nll`` and the loss: 1e-5 relative (measured
  ~3e-7);
* every parameter gradient against ``jax.grad`` of the reference's loss:
  1e-5 of its reference's scale (max |reference|; measured below 1e-6);
  v3's ``router_bias`` (a stop-gradient in the reference) gets zeros;
* Adafactor steps against the reference's jitted ``make_train_step``:
  losses within 1e-5 relative and parameters within 0.05 learning rates
  (those of ``tests/test_torch_paligemma_train.py``);
* ``train()`` resumed from a checkpoint: bitwise the uninterrupted run.
"""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.models import api as rapi
from repro.models import transformer as rt
from repro_torch import optim
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch.train import train
from repro_torch.models import api
from repro_torch.models import transformer as tt

from _deepseek_cases import (ARCHS, configs, flat_reference, port_model,
                             reference_leaf, reference_params, tokens)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-5
LR = 1e-3

_CASES = {}


def _case(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CASES:
        rcfg, cfg = configs(arch, **kw)
        params = reference_params(rcfg)
        _CASES[key] = (rcfg, cfg, params, port_model(params, cfg))
    return _CASES[key]


def _batch(cfg, seed=3):
    return tokens(cfg, seed), tokens(cfg, seed + 1)


def _port_grads(model, toks, labels):
    model.requires_grad_(True)
    loss, metrics = tt.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels))
    return loss, metrics, api.grads_of(loss, list(model.parameters()))


_REF = {}


def _reference(arch):
    """The reference's (loss, metrics) and gradients, once per arch."""
    if arch not in _REF:
        rcfg, cfg, params, _ = _case(arch)
        toks, labels = _batch(cfg)
        (loss, met), grads = jax.value_and_grad(
            lambda p: rt.loss_fn(p, rcfg, jnp.asarray(toks),
                                 jnp.asarray(labels)), has_aux=True)(params)
        _REF[arch] = (float(loss), {k: float(v) for k, v in met.items()},
                      flat_reference(grads))
    return _REF[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match(arch):
    """``nll``, ``moe_aux`` (the MoE layers' sum), ``mtp_nll`` (v3) and the
    loss (+ 0.3 mtp_nll for v3, + 0.001 aux for v2's softmax routing)."""
    _, cfg, _, model = _case(arch)
    loss, met, _ = _port_grads(model, *_batch(cfg))
    want_loss, want_met, _ = _reference(arch)
    assert set(met) == set(want_met) == (
        {"nll", "moe_aux", "mtp_nll"} if cfg.mtp_depth else
        {"nll", "moe_aux"})
    assert abs(float(loss.detach()) / want_loss - 1) <= LOSS_TOL
    for k, v in want_met.items():
        assert abs(float(met[k]) / v - 1) <= LOSS_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_matches_jax_grad(arch):
    _, cfg, _, model = _case(arch)
    _, _, grads = _port_grads(model, *_batch(cfg))
    flat = _reference(arch)[2]
    for (name, p), g in zip(model.named_parameters(), grads):
        want = reference_leaf(flat, name)
        assert tuple(g.shape) == want.shape, name
        scale = float(np.abs(want).max())
        if scale == 0.0:
            assert not g.any(), name
            continue
        assert float((g - torch.from_numpy(np.array(want))).abs().max()) <= \
            GRAD_TOL * scale, name


@pytest.mark.parametrize("arch", ARCHS)
def test_optimiser_leaves_are_the_reference_leaves(arch):
    """One optimiser leaf a reference leaf: ``dense_layers.*`` and
    ``moe_layers.*`` are [L, ...] stacks (``moe_layers.moe.w_in`` [L, E, D,
    F], which Adafactor factors over its last two dims), ``mtp.*`` leaves
    of their own; ``reference_param_leaves`` gives the reference tree's
    paths and shapes in its order."""
    rcfg, cfg, params, model = _case(arch)
    flat = flat_reference(params)
    leaves = api.reference_param_leaves(model)
    assert [p for p, _ in leaves] == sorted(flat, key=lambda k: k.split("/"))
    assert {p: s for p, s in leaves} == {p: a.shape for p, a in flat.items()}
    groups = dict(api.param_groups(model))
    assert set(groups) == {p.replace("/", ".") for p in flat}
    n_moe = cfg.num_layers - cfg.first_k_dense
    assert groups["moe_layers.moe.w_in"].stacked
    assert len(groups["moe_layers.moe.w_in"].members) == n_moe
    assert dict(leaves)["moe_layers/moe/w_in"] == (
        n_moe, cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    if cfg.mtp_depth:
        assert not groups["mtp.layer.attn.wkv_b"].stacked


@pytest.mark.parametrize("remat,passes", [("none", 1), ("full", 2)])
def test_kernel_calls_a_step(monkeypatch, remat, passes):
    """K3's forward runs once a layer at (192, 128) without remat and twice
    under "full" (the checkpoint recomputes the layer), the MTP layer's
    once (not under remat, as the reference's); its backward once a layer
    and once for the MTP layer."""
    calls = {"k3": [], "k3_bwd": []}

    def spy(name, key):
        real = getattr(k3, name)

        def wrapped(*a, **kw):
            q, v = (a[0], a[2]) if key == "k3" else (a[1], a[3])
            calls[key].append((q.shape[-1], v.shape[-1]))
            return real(*a, **kw)
        monkeypatch.setattr(k3, name, wrapped)

    spy("flash_attention_fwd", "k3")
    spy("flash_attention_bwd", "k3_bwd")
    _, cfg, _, model = _case("deepseek_v3_671b", remat=remat)
    _port_grads(model, *_batch(cfg))
    assert calls["k3"] == [(192, 128)] * (cfg.num_layers * passes + 1)
    assert calls["k3_bwd"] == [(192, 128)] * (cfg.num_layers + 1)


def test_remat_full_is_bitwise_no_remat():
    _, _, _, plain = _case("deepseek_v3_671b", remat="none")
    _, cfg, _, full = _case("deepseek_v3_671b", remat="full")
    batch = _batch(cfg)
    loss0, _, g0 = _port_grads(plain, *batch)
    loss1, _, g1 = _port_grads(full, *batch)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_three_adafactor_steps_match_the_reference():
    """3 steps of ``make_train_step`` with the config's Adafactor against
    the reference's jitted ``make_train_step``, from the same weights on
    the same batches: losses within 1e-5 relative, parameters within 0.05
    learning rates."""
    rcfg, cfg, params, _ = _case("deepseek_v3_671b")
    model = port_model(params, cfg)
    assert cfg.optimizer == "adafactor" and cfg.remat == "full"
    batches = [dict(zip(("tokens", "labels"), _batch(cfg, 10 + 2 * i)))
               for i in range(3)]
    ropt = roptim.make_optimizer("adafactor", lr=LR, total_steps=3)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = jax.jit(rapi.make_train_step(rapi.build_model(rcfg), ropt))
    opt = optim.make_optimizer("adafactor", lr=LR, total_steps=3)
    state = api.init_train_state(model, opt)
    step = api.make_train_step(api.build_model(cfg), opt)
    rlosses, losses = [], []
    for batch in batches:
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, batch)
        rlosses.append(float(rmet["loss"]))
        losses.append(float(met["loss"]))
        assert float(met["mtp_nll"]) == pytest.approx(float(rmet["mtp_nll"]),
                                                      rel=LOSS_TOL)
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_TOL)
    flat = flat_reference(rstate.params)
    for name, p in state.params.named_parameters():
        diff = np.abs(p.detach().numpy() - reference_leaf(flat, name))
        assert diff.max() <= 0.05 * LR, name


def test_train_restarts_bitwise():
    """``train("deepseek_v2_236b", device="cpu")`` (the reduced config,
    Adafactor, remat "full"): 4 steps with a checkpoint every 2; resuming
    at 2 gives the uninterrupted run's last 2 losses, parameters and
    moments bitwise."""
    kw = dict(steps=4, reduced=True, seq_len=16, batch=2,
              install_signals=False, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("deepseek_v2_236b", ckpt_dir=d, ckpt_every=2,
                             **kw)
        assert np.all(np.isfinite(full))
        shutil.rmtree(os.path.join(d, "step_4"))
        resumed, s_res = train("deepseek_v2_236b", ckpt_dir=d, restore=True,
                               ckpt_every=100, **kw)
    assert isinstance(s_full.params, tt.Transformer)
    assert resumed == full[2:]
    for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
        assert torch.equal(a, b)
    assert api.state_tree(s_full).keys() == api.state_tree(s_res).keys()
    for k, v in api.state_tree(s_full).items():
        assert torch.equal(v, api.state_tree(s_res)[k]), k


def test_train_takes_a_depth_cut():
    """``train(..., depth=2)``: the full config's widths cut to 2 layers
    (1 dense + 1 MoE for v2), as ``chip_smoke.py`` runs it on the card;
    here at the reduced widths on the CPU."""
    losses, state = train("deepseek_v2_236b", steps=1, reduced=True,
                          seq_len=8, batch=1, depth=2, install_signals=False,
                          device="cpu")
    cfg = state.params.cfg
    assert cfg.num_layers == 2 and len(state.params.moe_layers) == 1
    assert np.isfinite(losses[0])
