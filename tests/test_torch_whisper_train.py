"""The port's whisper training path (loss, gradients, train step, optimiser
state carried from the reference, ``train()``) against the reference's, on
the CPU.

``whisper_small.reduced()``: d_model 64, 4 heads of 16, 2 encoder and 2
decoder layers, 8 frames, vocab 256, float32, 48 decoder positions, with
the reference's ``init_params`` weights carried across by
``params_from_reference`` -- every layer norm's scale and bias redrawn at
random so that their gradients matter -- and tokens and frames drawn with
numpy; 32 positions.  Every attention -- the encoder's, the decoder's self
and cross attention -- takes K3's plain forward and backward (the CPU
path).  Tolerances, each stated where it is used, are those of
``tests/test_torch_zamba_train.py``:

* loss: 1e-5 relative; every parameter gradient (the frames' positions and
  both stacks included): 1e-4 of its reference's scale (max |reference|);
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
from repro.models import whisper as rw
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, DataIterator, synth_batch
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch import lowering
from repro_torch.launch.train import train
from repro_torch.models import api, layers
from repro_torch.models import whisper as tw
from repro_torch.optim.adafactor import FactoredV
from repro_torch.optim.adamw import is_moment_leaf

B, S, MAX_SEQ = 2, 32, 48
LR = 1e-3


def _configs(dtype="float32", **kw):
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


def _case(dtype="float32", **kw):
    rcfg, cfg = _configs(dtype, **kw)
    params = _randomize(rw.init_params(jax.random.PRNGKey(0), rcfg,
                                       max_seq=MAX_SEQ),
                        np.random.default_rng(1))
    model = tw.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    return rcfg, cfg, params, model


def _batch(cfg, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1                     # pads are ignored
    frames = rng.normal(0, 1, (B, cfg.num_frames, cfg.d_model)) \
        .astype(np.float32)
    return toks[:, :-1], labels, frames


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


def _port_grads(model, toks, labels, frames):
    model.requires_grad_(True)
    loss, metrics = tw.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels),
                               torch.from_numpy(frames))
    return loss, metrics, torch.autograd.grad(loss,
                                              list(model.parameters()))


def _batches(cfg, n, seq=S):
    shape = base.ShapeConfig("train_cli", seq, B, "train")
    return [synth_batch(cfg, shape, DataConfig(seed=7), s) for s in range(n)]


def test_loss_and_every_gradient_match_jax_value_and_grad():
    rcfg, cfg, params, model = _case()
    toks, labels, frames = _batch(cfg)
    (want_loss, want_met), want_g = jax.jit(jax.value_and_grad(
        lambda p: rw.loss_fn(p, rcfg, jnp.asarray(toks), jnp.asarray(labels),
                             jnp.asarray(frames)), has_aux=True))(params)
    loss, metrics, grads = _port_grads(model, toks, labels, frames)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-5
    assert float(metrics["nll"]) == float(loss.detach())
    assert float(metrics["moe_aux"]) == 0.0
    assert float(want_met["nll"]) == float(want_loss)
    names = [n for n, _ in model.named_parameters()]
    # embed, two positions, 2 encoder layers of 10, 2 decoder layers of 16,
    # two final norms of 2
    assert len(names) == len(grads) == 3 + 2 * 10 + 2 * 16 + 4
    for name, g in zip(names, grads):
        assert _rel(g, _ref_leaf(want_g, name)) <= 1e-4, name


def test_model_api_trains_the_audio_family():
    """``Model.loss`` is ``whisper.loss_fn`` on the batch's frames;
    ``check_trainable`` passes."""
    _, cfg, _, model = _case()
    toks, labels, frames = _batch(cfg)
    api.check_trainable(cfg)
    model.requires_grad_(True)
    got, _ = api.build_model(cfg).loss(model, {
        "tokens": toks, "labels": labels, "frames": frames})
    want, _ = tw.loss_fn(model, torch.from_numpy(toks),
                         torch.from_numpy(labels), torch.from_numpy(frames))
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bitwise_no_remat(remat):
    _, _, _, plain = _case(remat="none")
    _, cfg, _, other = _case(remat=remat)
    batch = _batch(cfg)
    loss0, _, g0 = _port_grads(plain, *batch)
    loss1, _, g1 = _port_grads(other, *batch)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat,passes", [("none", 1), ("full", 2)])
def test_kernel_calls_a_step(monkeypatch, remat, passes):
    """K3's forward runs once an attention -- an encoder layer's, a decoder
    layer's self and cross attention -- without remat and twice under
    "full" (the checkpoint recomputes the layer); its backward once an
    attention.  The cross attention's calls take the prompt's queries over
    the frames' keys."""
    calls = {"k3": [], "k3_bwd": []}

    def spy(name, key):
        real = getattr(k3, name)

        def wrapped(*a, **kw):
            q, k = (a[0], a[1]) if key == "k3" else (a[1], a[2])
            calls[key].append((q.shape[1], k.shape[1], kw["causal"]))
            return real(*a, **kw)
        monkeypatch.setattr(k3, name, wrapped)

    spy("flash_attention_fwd", "k3")
    spy("flash_attention_bwd", "k3_bwd")
    _, cfg, _, model = _case(remat=remat)
    _port_grads(model, *_batch(cfg))
    f = cfg.num_frames
    once = ([(f, f, False)] * cfg.encoder_layers
            + [(S, S, True), (S, f, False)] * cfg.num_layers)
    assert sorted(calls["k3"]) == sorted(once * passes)
    assert sorted(calls["k3_bwd"]) == sorted(once)


def test_six_adamw_steps_match_the_reference():
    """6 steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` + AdamW, from the same weights on the same batches
    (tokens, labels and frames of ``synth_batch``): losses within 1e-5
    relative, parameters within 0.05 learning rates."""
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
        assert batch["frames"].shape == (B, cfg.num_frames, cfg.d_model)
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


def test_leaf_groups_stack_enc_and_dec_layers():
    """``enc_layers.<i>.<rest>`` and ``dec_layers.<i>.<rest>`` are one
    stacked leaf each, over their own depths (3 encoder layers beside 2
    decoder layers here); every other parameter a leaf of its own; the
    reference's leaves and shapes."""
    rcfg, cfg = _configs(encoder_layers=3)
    params = rw.init_params(jax.random.PRNGKey(0), rcfg, max_seq=MAX_SEQ)
    model = tw.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    groups = dict(api.param_groups(model))
    assert len(groups) == len(jax.tree_util.tree_leaves(params))
    names = [n for n, _ in model.named_parameters()]
    depth = {"enc_layers": 3, "dec_layers": 2}
    stacked = 0
    for leaf, group in groups.items():
        members = [names[i] for i in group.members]
        root, _, rest = leaf.partition(".")
        if root in depth:
            assert group.stacked
            assert members == [f"{root}.{i}.{rest}"
                               for i in range(depth[root])]
            stacked += 1
        else:
            assert not group.stacked and members == [leaf]
    assert stacked == 10 + 16
    shapes = dict(api.reference_param_leaves(model))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): a.shape
            for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert shapes == want


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_reference_train_state_carries_and_steps_like_the_reference(name):
    """``api.train_state_from_reference`` over a reference whisper
    ``TrainState`` after a step: one port leaf a reference leaf, an
    ``enc_layers`` / ``dec_layers`` [L, ...] stack one leaf, each copied
    exactly (int8 moments block for block, Adafactor's factored
    statistics); then a second step of each package from there: loss within
    1e-5 relative, every parameter within 1e-4 of its scale."""
    rcfg, cfg, params, _ = _case()
    rstep, rstate = _reference_state(rcfg, cfg, params, name, 1)
    host = jax.tree_util.tree_map(np.asarray, rstate)
    opt = optim.make_optimizer(name, lr=LR, total_steps=10)
    state = api.train_state_from_reference(host, cfg, opt, device="cpu")
    assert state.opt.step == 1
    assert state.params.max_seq == MAX_SEQ
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
        stacked += group.stacked
    assert stacked == 10 + 16
    batch = _batches(cfg, 2)[1]
    rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, met = api.make_train_step(api.build_model(cfg), opt)(state, batch)
    assert abs(float(met["loss"]) / float(rmet["loss"]) - 1) <= 1e-5
    for n, p in state.params.named_parameters():
        assert _rel(p, _ref_leaf(rstate.params, n)) <= 1e-4, n


def test_reference_checkpoint_restores(tmp_path):
    """A checkpoint the reference's ``store.save`` wrote of a whisper
    ``TrainState`` restores through ``api.restore_train_state`` (the
    reference's leaf order from ``reference_state_paths``)."""
    rcfg, cfg, params, _ = _case()
    _, rstate = _reference_state(rcfg, cfg, params, "adamw", 1)
    rstore.save(str(tmp_path), 1, rstate, extra={"step": 1})
    model = api.build_model(cfg)
    opt = optim.make_optimizer("adamw", lr=LR, total_steps=10)
    fresh = api.init_train_state(
        model.init(torch.Generator().manual_seed(1), device="cpu",
                   max_seq=MAX_SEQ), opt)
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
    """``train("whisper_small", device="cpu")`` (the reduced config, the
    decoder given ``seq_len`` positions): 8 steps with a checkpoint every
    4; resuming at 4 gives the uninterrupted run's last 4 losses and final
    parameters and moments bitwise."""
    kw = dict(steps=8, reduced=True, seq_len=32, batch=2,
              install_signals=False, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("whisper_small", ckpt_dir=d, ckpt_every=4, **kw)
        assert np.all(np.isfinite(full))
        shutil.rmtree(os.path.join(d, "step_8"))
        resumed, s_res = train("whisper_small", ckpt_dir=d, restore=True,
                               ckpt_every=100, **kw)
    assert isinstance(s_full.params, tw.Whisper)
    assert s_full.params.max_seq == 32
    assert resumed == full[4:]
    for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s_full.opt.m + s_full.opt.v, s_res.opt.m + s_res.opt.v):
        assert torch.equal(a, b)
    assert s_res.opt.step == s_full.opt.step == 8


def test_frames_reach_the_step_on_the_device(monkeypatch):
    """The data iterator's float32 frames reach the encoder on the model's
    device in the model dtype; ``lowering.make_step`` gives train and
    prefill cells frames [B, num_frames, d] in the model dtype, a decoder
    of ``seq_len`` positions, and a decode cell a cache with its cross
    part."""
    _, cfg = _configs("bfloat16")
    shape = base.ShapeConfig("train_cli", S, B, "train")
    data = DataIterator(cfg, shape, DataConfig(seed=3))
    try:
        batch = next(data)
    finally:
        data.close()
    assert batch["frames"].dtype == np.float32
    seen = []
    encode = tw.Whisper.encode

    def spy(self, frames):
        out = encode(self, frames)
        seen.append((self.frames_in(frames).dtype, out.device))
        return out

    monkeypatch.setattr(tw.Whisper, "encode", spy)
    model = api.build_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), device="cpu",
                        max_seq=S)
    state = api.init_train_state(module, optim.make_optimizer("adamw"))
    api.make_train_step(model, optim.make_optimizer("adamw"))(state, batch)
    assert seen == [(torch.bfloat16, torch.device("cpu"))]
    for kind in ("train", "prefill"):
        step = lowering.make_step(cfg, base.ShapeConfig("c", S, B, kind),
                                  "cpu")
        batch = step.args[1]
        assert batch["frames"].dtype == torch.bfloat16
        assert tuple(batch["frames"].shape) == (B, cfg.num_frames,
                                                cfg.d_model)
        module = step.args[0] if kind == "prefill" else step.args[0].params
        assert module.max_seq == S
    step = lowering.make_step(cfg, base.ShapeConfig("c", S, B, "decode"),
                              "cpu")
    cache = step.args[2]
    assert cache["len"] == S - 1 and "frames" not in step.args[1]
    assert tuple(cache["cross"]["k"].shape) == (
        cfg.num_layers, B, cfg.num_frames, cfg.num_kv_heads, cfg.head_dim)
    logits, _ = step.fn(*step.args)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
