"""The port's Zamba2 training path (loss, gradients, train step, optimiser
state carried from the reference, ``train()``) against the reference's, on
the CPU.

The reduced ``zamba2_1_2b`` cut to 5 layers (two sites of the shared block,
after layers 2 and 4, and a 1-layer tail): d_model 64, 8 SSM heads of 16,
ds 16, chunk 16, 4 attention heads of 16, vocab 256, float32, with the
reference's ``init_params`` weights carried across by
``params_from_reference`` -- ``dt_bias``, ``A_log``, ``D``, the conv biases
and every norm scale redrawn at random so that their gradients matter --
and tokens drawn with numpy; 48 positions, 3 chunks.  The scan takes K4's
plain forward and backward, the attention K3's (the CPU path).
Tolerances, each stated where it is used, are those of
``tests/test_torch_mamba_train.py``:

* loss: 1e-5 relative; every parameter gradient, the shared block's (the
  sum over its two sites) included: 1e-4 of its reference's scale (max
  |reference|);
* remat "none", "full" and "dots" in the port: bitwise;
* AdamW steps against the reference's jitted ``make_train_step``: losses
  within 1e-5 relative and parameters within 0.05 learning rates absolute;
* a reference ``TrainState`` carried across: every optimiser leaf exact,
  then one more step of each package within 1e-4 of each parameter's scale
  (Adafactor's clip and the int8 blocks over the [L, ...] stacks);
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
from repro.checkpoint import store as rstore
from repro.configs import base as rbase
from repro.models import api as rapi
from repro.models import mamba as rm
from repro.models import transformer as rt
from repro.models import zamba as rz
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ssd_scan as k4
from repro_torch.launch.train import train
from repro_torch.models import api, layers
from repro_torch.models import mamba as tm
from repro_torch.models import transformer as tt
from repro_torch.models import zamba as tz
from repro_torch.optim.adafactor import FactoredV
from repro_torch.optim.adamw import is_moment_leaf

B, S, LAYERS = 2, 48, 5
LR = 1e-3
_DRAWS = {"scale": (0.5, 1.5), "dt_bias": (-4.0, -1.0), "A_log": (-1.0, 1.0),
          "D": (0.5, 1.5)}


def _configs(dtype="float32", **kw):
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


def _case(dtype="float32", **kw):
    rcfg, cfg = _configs(dtype, **kw)
    params = _randomize(rz.init_params(jax.random.PRNGKey(0), rcfg),
                        np.random.default_rng(1))
    model = tz.params_from_reference(_numpy_tree(params), cfg, device="cpu")
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
    loss, metrics = tz.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels))
    return loss, metrics, torch.autograd.grad(loss,
                                              list(model.parameters()))


def _batches(cfg, n, seq=S):
    shape = base.ShapeConfig("train_cli", seq, B, "train")
    return [synth_batch(cfg, shape, DataConfig(seed=7), s) for s in range(n)]


def test_loss_and_every_gradient_match_jax_value_and_grad():
    rcfg, cfg, params, model = _case()
    toks, labels = _tokens()
    (want_loss, want_met), want_g = jax.jit(jax.value_and_grad(
        lambda p: rz.loss_fn(p, rcfg, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True))(params)
    loss, metrics, grads = _port_grads(model, toks, labels)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-5
    assert float(metrics["nll"]) == float(loss.detach())
    assert float(metrics["moe_aux"]) == 0.0
    assert float(want_met["nll"]) == float(want_loss)
    names = [n for n, _ in model.named_parameters()]
    # embed, 5 layers of 15, the shared block's 9, the final norm
    assert len(names) == len(grads) == 1 + LAYERS * 15 + 9 + 1
    for name, g in zip(names, grads):
        assert _rel(g, _ref_leaf(want_g, name)) <= 1e-4, name
    shared = [n for n in names if n.startswith("shared_attn.")]
    assert len(shared) == 9


def test_model_api_trains_the_hybrid_family():
    """``Model.loss`` is ``zamba.loss_fn``; ``check_trainable`` passes."""
    _, cfg, _, model = _case()
    toks, labels = _tokens()
    api.check_trainable(cfg)
    model.requires_grad_(True)
    got, _ = api.build_model(cfg).loss(model, {"tokens": toks,
                                               "labels": labels})
    want, _ = tz.loss_fn(model, torch.from_numpy(toks),
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
def test_kernel_calls_a_step(monkeypatch, remat, scans):
    """K4's forward runs once a layer without remat and twice under "dots"
    and "full" (the checkpoint recomputes it), its backward once a layer;
    the shared block runs outside remat, as the reference's: K3's forward
    and backward once a site, whatever the policy."""
    calls = {"k4": 0, "k4_bwd": 0, "k3": 0, "k3_bwd": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(k4, "_scan", "k4")
    spy(k4, "ssd_scan_bwd", "k4_bwd")
    spy(k3, "flash_attention_fwd", "k3")
    spy(k3, "flash_attention_bwd", "k3_bwd")
    _, cfg, _, model = _case(remat=remat)
    _port_grads(model, *_tokens())
    sites = tz.n_sites(cfg)
    assert calls == {"k4": scans * LAYERS, "k4_bwd": LAYERS, "k3": sites,
                     "k3_bwd": sites}


def test_six_adamw_steps_match_the_reference():
    """6 steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` + AdamW, from the same weights on the same
    batches: losses within 1e-5 relative, parameters within 0.05
    learning rates."""
    rcfg, cfg, params, model = _case()
    batches = _batches(cfg, 6)
    ropt = roptim.make_optimizer("adamw", lr=LR, total_steps=6)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = jax.jit(rapi.make_train_step(rapi.build_model(rcfg), ropt))
    opt = optim.make_optimizer("adamw", lr=LR, total_steps=6)
    state = api.init_train_state(model, opt)
    step = api.make_train_step(api.build_model(cfg), opt)
    rlosses, losses = [], []
    for batch in batches:
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step(state, batch)
        rlosses.append(float(rmet["loss"]))
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    assert state.opt.step == int(rstate.opt.step) == 6
    for name, p in state.params.named_parameters():
        diff = np.abs(p.detach().numpy() - _ref_leaf(rstate.params, name))
        assert diff.max() <= 0.05 * LR, name


# --- the reference's training state -----------------------------------------------


def _reference_state(rcfg, cfg, params, name, steps):
    ropt = roptim.make_optimizer(name, lr=LR, total_steps=10)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = rapi.make_train_step(rapi.build_model(rcfg), ropt)
    if name != "adamw8bit":          # its block quantisation does not jit
        rstep = jax.jit(rstep)
    for batch in _batches(cfg, steps):
        rstate, _ = rstep(rstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    return rstep, rstate


def test_leaf_groups_stack_mamba_layers_and_keep_the_shared_block_whole():
    _, cfg, params, model = _case()
    groups = dict(api.param_groups(model))
    assert len(groups) == len(jax.tree_util.tree_leaves(params))
    names = [n for n, _ in model.named_parameters()]
    for leaf, group in groups.items():
        members = [names[i] for i in group.members]
        if leaf.startswith("mamba_layers."):
            rest = leaf[len("mamba_layers."):]
            assert group.stacked
            assert members == [f"mamba_layers.{i}.{rest}"
                               for i in range(LAYERS)]
        else:
            assert not group.stacked and members == [leaf]
    shapes = dict(api.reference_param_leaves(model))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): a.shape
            for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert shapes == want


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_reference_train_state_carries_and_steps_like_the_reference(name):
    """``api.train_state_from_reference`` over a reference zamba
    ``TrainState`` after a step: one port leaf a reference leaf, a
    ``mamba_layers`` [L, ...] stack one leaf, each copied exactly (int8
    moments block for block, Adafactor's factored statistics); then a
    second step of each package from there: loss within 1e-5 relative,
    every parameter within 1e-4 of its scale -- Adafactor's RMS clip and
    the int8 blocks run over the stacks as the reference's."""
    rcfg, cfg, params, _ = _case()
    rstep, rstate = _reference_state(rcfg, cfg, params, name, 1)
    host = jax.tree_util.tree_map(np.asarray, rstate)
    opt = optim.make_optimizer(name, lr=LR, total_steps=10)
    state = api.train_state_from_reference(host, cfg, opt, device="cpu")
    assert state.opt.step == 1
    groups = api.param_groups(state.params)
    assert len(groups) == len(jax.tree_util.tree_leaves(params))
    stacked = 0
    for k, (leaf, group) in enumerate(groups):
        for field in ("m", "v"):
            ref = getattr(host.opt, field)
            for key in leaf.split("."):
                ref = ref[key]
            mine = getattr(state.opt, field)[k]
            if is_moment_leaf(mine):
                assert np.array_equal(mine["q"].numpy(), np.asarray(ref["q"]))
                assert np.array_equal(mine["scale"].numpy(),
                                      np.asarray(ref["scale"]))
                assert mine["shape"] == tuple(int(d) for d in ref["shape"])
            elif isinstance(mine, FactoredV):
                for part in ("r", "c"):
                    assert np.array_equal(getattr(mine, part).numpy(),
                                          np.asarray(getattr(ref, part)))
            else:
                want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
                assert np.array_equal(mine.float().numpy(), want), leaf
                if group.stacked:
                    assert mine.shape[0] == LAYERS
        stacked += group.stacked
    assert stacked == 15
    batch = _batches(cfg, 2)[1]
    rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, met = api.make_train_step(api.build_model(cfg), opt)(state, batch)
    assert abs(float(met["loss"]) / float(rmet["loss"]) - 1) <= 1e-5
    for n, p in state.params.named_parameters():
        assert _rel(p, _ref_leaf(rstate.params, n)) <= 1e-4, n


def test_reference_checkpoint_restores(tmp_path):
    """A checkpoint the reference's ``store.save`` wrote of a zamba
    ``TrainState`` restores through ``api.restore_train_state`` (the
    reference's leaf order from ``reference_state_paths``)."""
    rcfg, cfg, params, _ = _case()
    _, rstate = _reference_state(rcfg, cfg, params, "adamw", 1)
    rstore.save(str(tmp_path), 1, rstate, extra={"step": 1})
    model = api.build_model(cfg)
    opt = optim.make_optimizer("adamw", lr=LR, total_steps=10)
    fresh = api.init_train_state(
        model.init(torch.Generator().manual_seed(1), device="cpu"), opt)
    step, state, extra = api.restore_train_state(str(tmp_path), fresh, model,
                                                 opt)
    assert step == 1 and extra == {"step": 1} and state.opt.step == 1
    for n, p in state.params.named_parameters():
        assert np.array_equal(p.detach().numpy(),
                              _ref_leaf(rstate.params, n)), n
    for (leaf, _), m in zip(api.param_groups(state.params), state.opt.m):
        ref = rstate.opt.m
        for key in leaf.split("."):
            ref = ref[key]
        assert np.array_equal(m.numpy(), np.asarray(ref)), leaf


def test_train_restarts_bitwise():
    """``train("zamba2_1_2b", device="cpu")`` (the reduced config): 8
    steps with a checkpoint every 4; resuming at 4 gives the uninterrupted
    run's last 4 losses and final parameters and moments bitwise."""
    kw = dict(steps=8, reduced=True, seq_len=32, batch=2,
              install_signals=False, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("zamba2_1_2b", ckpt_dir=d, ckpt_every=4, **kw)
        assert np.all(np.isfinite(full))
        shutil.rmtree(os.path.join(d, "step_8"))
        resumed, s_res = train("zamba2_1_2b", ckpt_dir=d, restore=True,
                               ckpt_every=100, **kw)
    assert isinstance(s_full.params, tz.Zamba)
    assert resumed == full[4:]
    for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s_full.opt.m + s_full.opt.v, s_res.opt.m + s_res.opt.v):
        assert torch.equal(a, b)
    assert s_res.opt.step == s_full.opt.step == 8


# --- the stacked roots leave the dense and SSM families as they were ----------------


def _layers_only_groups(names):
    """``api.leaf_groups`` as it was with ``layers`` the only stacked
    root."""
    order, members = [], {}
    for i, name in enumerate(names):
        parts = name.split(".")
        if parts[0] == "layers":
            leaf, layer = ".".join(["layers"] + parts[2:]), int(parts[1])
        else:
            leaf, layer = name, -1
        if leaf not in members:
            order.append(leaf)
            members[leaf] = []
        members[leaf].append((layer, i))
    return [(leaf, optim.Group(tuple(i for _, i in sorted(members[leaf])),
                               sorted(members[leaf])[0][0] >= 0))
            for leaf in order]


@pytest.mark.parametrize("arch,rmod,tmod", [
    ("stablelm_1_6b", rt, tt), ("mamba2_130m", rm, tm)])
def test_dense_and_ssm_groups_and_copies_are_unchanged(arch, rmod, tmod):
    """The dense and SSM models' ``leaf_groups`` equal those of the
    ``layers``-only rule, and ``copy_reference_params`` splits their
    ``layers`` stacks as before: every parameter the reference's leaf (its
    layer's slice), exactly."""
    rcfg = dataclasses.replace(rbase.get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(base.get_config(arch).reduced(),
                              dtype="float32")
    params = rmod.init_params(jax.random.PRNGKey(0), rcfg)
    model = tmod.params_from_reference(_numpy_tree(params), cfg,
                                       device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert api.leaf_groups(names) == _layers_only_groups(names)
    assert not any(n.startswith("mamba_layers") for n in names)
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = params
        for key in ([parts[0]] + parts[2:] if parts[0] == "layers"
                    else parts):
            leaf = leaf[key]
        want = np.asarray(leaf)
        if parts[0] == "layers":
            want = want[int(parts[1])]
        assert np.array_equal(p.detach().numpy(), want), name
