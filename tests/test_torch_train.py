"""The port's training path (loss, gradients, train step, ``train()``)
against the reference's, on the CPU.

The reduced stablelm config (2 layers, d_model 64, 4 heads of 16, vocab
256) with the reference's ``init_params`` weights carried across by
``params_from_reference`` (norm scales drawn at random so that their
gradients matter), and tokens drawn with numpy.  Attention takes K3's plain
forward and plain backward (the CPU path).  Tolerances, each stated where
it is used:

* loss: 1e-5 relative; every parameter gradient: 1e-4 of its reference's
  scale (max |reference|) -- sums in other orders through two layers and
  the float32 softmax of a 256-way head (measured: loss ~1e-7, gradients
  below 3e-6 of scale);
* remat "none", "full" and "dots" in the port: bitwise (recomputation runs
  the same kernels on the same inputs);
* 12 train steps against the reference's jitted ``make_train_step`` +
  ``apply_adamw``: float32 losses within 1e-5 relative and parameters within
  1e-4 of scale; the config's own bf16 losses within 2e-3 relative and
  parameters within 4 learning rates absolute (a bf16 weight that rounds
  the other way after an update sits about one Adam step apart);
* ``train()`` resumed from a checkpoint: bitwise the uninterrupted run.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.configs import base as rbase
from repro.models import api as rapi
from repro.models import transformer as rt
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch.train import train
from repro_torch.models import api, layers
from repro_torch.models import transformer as tt

B, S = 2, 24


def _configs(dtype, **kw):
    return (dataclasses.replace(rbase.get_config("stablelm_1_6b").reduced(),
                                dtype=dtype, **kw),
            dataclasses.replace(base.get_config("stablelm_1_6b").reduced(),
                                dtype=dtype, **kw))


def _randomize_scales(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_scales(v, rng)
        elif k == "scale":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        else:
            out[k] = v
    return out


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def _case(dtype, **kw):
    rcfg, cfg = _configs(dtype, **kw)
    params = _randomize_scales(rt.init_params(jax.random.PRNGKey(0), rcfg),
                               np.random.default_rng(1))
    model = tt.params_from_reference(_numpy_tree(params), cfg, device="cpu")
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
    loss, metrics = tt.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels))
    params = list(model.parameters())
    return loss, metrics, torch.autograd.grad(loss, params)


def test_loss_and_every_gradient_match_jax_value_and_grad():
    rcfg, cfg, params, model = _case("float32")
    toks, labels = _tokens()
    (want_loss, want_met), want_g = jax.value_and_grad(
        lambda p: rt.loss_fn(p, rcfg, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True)(params)
    loss, metrics, grads = _port_grads(model, toks, labels)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-5
    assert float(metrics["nll"]) == float(loss.detach())
    assert float(metrics["moe_aux"]) == float(want_met["moe_aux"]) == 0.0
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(grads) == 2 * 9 + 3
    for name, g in zip(names, grads):
        assert _rel(g, _ref_leaf(want_g, name)) <= 1e-4, name


def test_loss_ignores_negative_labels():
    _, cfg, _, model = _case("float32")
    toks, labels = _tokens()
    with torch.no_grad():
        _, logits = tt.forward(model, torch.from_numpy(toks))
    lg, lb = logits[:, :-1], torch.from_numpy(labels[:, 1:]).long()
    keep = lb >= 0
    want = torch.nn.functional.cross_entropy(lg[keep], lb[keep])
    from repro_torch.models import layers as L
    torch.testing.assert_close(L.cross_entropy(lg, lb), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise_no_remat(remat):
    """``remat="full"`` (every layer recomputed in the backward) and
    ``"dots"`` (the projections kept): the loss and every gradient bitwise
    those of ``"none"``."""
    toks, labels = _tokens()
    _, _, _, model = _case("float32", remat="none")
    loss0, _, grads0 = _port_grads(model, toks, labels)
    _, cfg, _, model = _case("float32", remat=remat)
    assert model.cfg.remat == remat
    loss1, _, grads1 = _port_grads(model, toks, labels)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))


def test_remat_full_recomputes_attention(monkeypatch):
    """Under ``"full"`` each layer's attention runs twice a step (forward
    and recomputation), its backward once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = k3.flash_attention_fwd, k3.flash_attention_bwd

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(k3, "flash_attention_fwd", spy_fwd)
    monkeypatch.setattr(k3, "flash_attention_bwd", spy_bwd)
    toks, labels = _tokens()
    for remat, want in (("none", 2), ("full", 4)):
        calls.update(fwd=0, bwd=0)
        _, _, _, model = _case("float32", remat=remat)
        _port_grads(model, toks, labels)
        assert calls == {"fwd": want, "bwd": 2}, remat


def test_unknown_remat_raises():
    _, _, _, model = _case("float32", remat="sometimes")
    toks, labels = _tokens()
    with pytest.raises(ValueError, match="remat"):
        _port_grads(model, toks, labels)


def _batches(cfg, n, seq_len=S, batch=B):
    shape = base.ShapeConfig("train_cli", seq_len, batch, "train")
    return [synth_batch(cfg, shape, DataConfig(seed=7), s) for s in range(n)]


LR = 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twelve_train_steps_match_the_reference(dtype):
    """12 steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` + ``apply_adamw``, from the same weights on the same
    batches.  float32: losses within 1e-5 relative (measured 9e-8),
    parameters within 1e-4 of scale (measured 4.3e-5).  The config's own
    bf16: losses within 2e-3 relative (measured 2.4e-5); parameters within
    4 lr absolute (measured 1.95 lr) -- a bf16 weight that rounds the other
    way after one update sits a bf16 ulp, about one Adam step, apart."""
    rcfg, cfg, params, _ = _case(dtype)
    model = tt.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    batches = _batches(cfg, 12)
    ropt = roptim.make_optimizer("adamw", lr=LR, total_steps=12)
    rmodel = rapi.build_model(rcfg)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = jax.jit(rapi.make_train_step(rmodel, ropt))
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
        # the jitted reference fuses the schedule (its cos and divisions)
        # into one XLA computation: within 4 float32 ulps of the port's
        assert abs(float(met["lr"]) / float(rmet["lr"]) - 1) <= 4.8e-7
    np.testing.assert_allclose(losses, rlosses,
                               rtol=1e-5 if dtype == "float32" else 2e-3)
    assert state.opt.step == int(rstate.opt.step) == 12
    for name, p in state.params.named_parameters():
        want = _ref_leaf(rstate.params, name)
        if dtype == "float32" or name.endswith("scale"):
            assert _rel(p, want) <= 1e-4, name
        else:
            assert p.dtype == torch.bfloat16
            assert np.abs(p.detach().float().numpy() - want).max() \
                <= 4 * LR, name


def test_train_step_with_compression_transform():
    """``grad_transform`` sees the gradients before the update: int8
    compression with error feedback (``optim.compression``) takes the step
    the reference's compressed gradients would."""
    from repro_torch.optim import compression
    _, cfg, _, model = _case("float32")
    opt = optim.make_optimizer("adamw", lr=1e-3, total_steps=4)
    state = api.init_train_state(model, opt)
    residual = compression.init_residual(list(model.parameters()))
    seen = []

    def transform(grads):
        sent, residual[:] = compression.compressed_grads_with_feedback(
            grads, residual)
        seen.append([g.clone() for g in sent])
        return sent

    step = api.make_train_step(api.build_model(cfg), opt, transform)
    batch = _batches(cfg, 1)[0]
    state, met = step(state, batch)
    assert len(seen) == 1 and np.isfinite(float(met["loss"]))
    for g in seen[0]:
        assert torch.equal(g, compression.compress_decompress(g).to(g.dtype))


def test_train_improves_and_restarts_bitwise():
    """``tests/test_system.py``'s run of the reference trainer, on the port:
    12 steps with a checkpoint every 6 lower the loss; restoring at 12 and
    going to 16 gives 4 losses.  And resuming at 12 of a 16-step run (the
    same schedule) gives the uninterrupted run's last 4 losses and final
    parameters bitwise."""
    kw = dict(reduced=True, seq_len=32, batch=4, install_signals=False,
              log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        losses1, _ = train("stablelm-1.6b", steps=12, ckpt_dir=d,
                           ckpt_every=6, **kw)
        assert losses1[-1] < losses1[0]
        losses2, _ = train("stablelm-1.6b", steps=16, ckpt_dir=d,
                           restore=True, ckpt_every=100, **kw)
        assert len(losses2) == 4
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("stablelm-1.6b", steps=16, ckpt_dir=d,
                             ckpt_every=6, **kw)
        assert sorted(os.listdir(d)) == ["step_12", "step_6"]
        resumed, s_res = train("stablelm-1.6b", steps=16, ckpt_dir=d,
                               restore=True, ckpt_every=100, **kw)
        assert resumed == full[12:]
        for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
            assert torch.equal(a, b)
        assert s_res.opt.step == s_full.opt.step == 16


def test_train_refuses_a_mesh_and_families_without_a_backward():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train("stablelm-1.6b", steps=1, mesh_shape=(2, 1), device="cpu",
              install_signals=False)
    opt = optim.make_optimizer("adamw")
    # the CNN family trains since K2 has a backward (ResNet training)
    api.check_trainable(base.get_config("resnet50"))
    assert callable(api.make_train_step(
        api.build_model(base.get_config("resnet50")), opt))
    # the SSM family trains since its scan has a backward (K4's)
    api.check_trainable(base.get_config("mamba2_130m"))
    assert callable(api.make_train_step(
        api.build_model(base.get_config("mamba2_130m")), opt))


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train("stablelm-1.6b", steps=1, install_signals=False)


def test_recoverable_step_retries_a_torch_step_then_restores(tmp_path):
    """``runtime.fault_tolerance.recoverable_step`` around the port's train
    step: a transient torch error (``torch.OutOfMemoryError``) raised inside
    the step is retried, ``on_failure`` restores the checkpointed state,
    and the step that then runs equals a clean one."""
    from repro_torch.checkpoint import store
    from repro_torch.runtime.fault_tolerance import recoverable_step
    _, cfg, _, _ = _case("float32")
    model = api.build_model(cfg)
    opt = optim.make_optimizer("adamw", lr=1e-3, total_steps=4)

    def fresh():
        return api.init_train_state(
            model.init(torch.Generator().manual_seed(0), device="cpu"), opt)

    batch = _batches(cfg, 1)[0]
    clean, clean_met = api.make_train_step(model, opt)(fresh(), batch)
    state = fresh()
    store.save(str(tmp_path), 0, api.state_tree(state))
    step = api.make_train_step(model, opt)
    calls, restored = [], []

    def flaky(st, b):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return step(st, b)

    def on_failure(attempt, exc):
        restored.append(type(exc).__name__)
        api.restore_train_state(str(tmp_path), state, model, opt)

    state, met = recoverable_step(flaky, state, batch, on_failure=on_failure)
    assert len(calls) == 2 and restored == ["OutOfMemoryError"]
    assert float(met["loss"]) == float(clean_met["loss"])
    for a, b in zip(state.params.parameters(), clean.params.parameters()):
        assert torch.equal(a, b)


def test_command_line_takes_the_reference_flags(monkeypatch, capsys):
    """``python -m repro_torch.launch.train`` parses the reference's flags
    (``--full`` turns ``reduced`` off, ``--mesh 2x4``) and hands them to
    ``train``, which runs on the card (its default device)."""
    from repro_torch.launch import train as train_mod
    seen = {}

    def fake(arch, **kw):
        seen.update(kw, arch=arch)
        return [2.0, 1.0], None

    monkeypatch.setattr(train_mod, "train", fake)
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "stablelm-1.6b", "--full", "--seq-len", "4096",
        "--batch", "1", "--steps", "4", "--ckpt-dir", "ck", "--restore",
        "--ckpt-every", "2", "--mesh", "2x4", "--lr", "1e-3"])
    train_mod.main()
    assert seen == {"arch": "stablelm-1.6b", "steps": 4, "reduced": False,
                    "seq_len": 4096, "batch": 1, "ckpt_dir": "ck",
                    "restore": True, "ckpt_every": 2, "mesh_shape": (2, 4),
                    "lr": 1e-3}
    assert "first loss 2.0000 -> last 1.0000" in capsys.readouterr().out
