"""The port's paligemma training path (loss, gradients, AdamW steps,
``train()``) against the reference's, on the CPU.

``paligemma_3b.reduced()`` in float32: 2 layers, d_model 64, 4 heads of 16,
one kv head, vocab 256, tied embeddings, 8 patches, remat "dots", with the
reference's ``init_params`` weights carried across by
``params_from_reference`` (norm scales redrawn at random so that their
gradients matter); 24 text tokens behind the 8 patch embeddings, drawn with
numpy.  Every attention -- the patches' bidirectional prefix included --
takes K3's plain forward and backward (the CPU path).  Tolerances, each
stated where it is used, are those of ``tests/test_torch_whisper_train.py``:

* loss: 1e-5 relative; every parameter gradient: 1e-4 of its reference's
  scale (max |reference|);
* AdamW steps against the reference's jitted ``make_train_step``: losses
  within 1e-5 relative and parameters within 0.05 learning rates absolute;
* ``train()`` resumed from a checkpoint: bitwise the uninterrupted run.
"""

import dataclasses
import os
import shutil
import tempfile
from unittest import mock

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
from repro_torch.data.pipeline import DataConfig, DataIterator, synth_batch
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch import lowering
from repro_torch.launch.train import train
from repro_torch.models import api, layers
from repro_torch.models import transformer as tt

B, S = 2, 24        # text tokens; 8 patches go in front
LR = 1e-3


def _configs(dtype="float32", **kw):
    kw = dict(dtype=dtype, **kw)
    return (dataclasses.replace(rbase.get_config("paligemma_3b").reduced(),
                                **kw),
            dataclasses.replace(base.get_config("paligemma_3b").reduced(),
                                **kw))


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "scale":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32), v.dtype)
        else:
            out[k] = v
    return out


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def _case(dtype="float32", **kw):
    rcfg, cfg = _configs(dtype, **kw)
    params = _randomize(rt.init_params(jax.random.PRNGKey(0), rcfg),
                        np.random.default_rng(1))
    model = tt.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    return rcfg, cfg, params, model


def _batch(cfg, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1                     # pads are ignored
    patches = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)) \
        .astype(np.float32)
    return toks[:, :-1], labels, patches


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


def _port_grads(model, toks, labels, patches):
    model.requires_grad_(True)
    loss, metrics = tt.loss_fn(model, torch.from_numpy(toks),
                               torch.from_numpy(labels),
                               torch.from_numpy(patches))
    return loss, metrics, torch.autograd.grad(loss,
                                              list(model.parameters()))


def _batches(cfg, n):
    shape = base.ShapeConfig("train_cli", cfg.num_patches + S, B, "train")
    return [synth_batch(cfg, shape, DataConfig(seed=7), s) for s in range(n)]


def test_loss_and_every_gradient_match_jax_value_and_grad():
    """``loss_fn`` with the patches (their logits dropped before the loss)
    and the gradient of every parameter -- the tied embedding's included,
    which the scaled token embeddings and the head both reach -- against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    rcfg, cfg, params, model = _case()
    toks, labels, patches = _batch(cfg)
    (want_loss, want_met), want_g = jax.jit(jax.value_and_grad(
        lambda p: rt.loss_fn(p, rcfg, jnp.asarray(toks), jnp.asarray(labels),
                             prefix_embeds=jnp.asarray(patches)),
        has_aux=True))(params)
    loss, metrics, grads = _port_grads(model, toks, labels, patches)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-5
    assert float(metrics["nll"]) == float(loss.detach())
    assert float(want_met["nll"]) == float(want_loss)
    names = [n for n, _ in model.named_parameters()]
    # the tied embedding, the final norm, 2 layers of 9 (two norms, four
    # attention projections, three MLP matrices)
    assert len(names) == len(grads) == 2 + 2 * 9
    for name, g in zip(names, grads):
        assert _rel(g, _ref_leaf(want_g, name)) <= 1e-4, name


def test_bf16_loss_matches_the_reference():
    """The bf16 model's loss over the same batch: within 2e-2 relative (a
    bf16 ulp where an activation rounds the other way, through 2 layers)."""
    rcfg, cfg, params, model = _case("bfloat16")
    toks, labels, patches = _batch(cfg)
    want, _ = rt.loss_fn(params, rcfg, jnp.asarray(toks), jnp.asarray(labels),
                         prefix_embeds=jnp.asarray(patches))
    got, _, _ = _port_grads(model, toks, labels, patches)
    assert abs(float(got.detach()) / float(want) - 1) <= 2e-2


def test_model_api_trains_the_vlm_family():
    """``Model.loss`` is ``transformer.loss_fn`` on the batch's
    ``prefix_embeds``; ``check_trainable`` passes."""
    _, cfg, _, model = _case()
    toks, labels, patches = _batch(cfg)
    api.check_trainable(cfg)
    model.requires_grad_(True)
    got, _ = api.build_model(cfg).loss(model, {
        "tokens": toks, "labels": labels, "prefix_embeds": patches})
    want, _ = tt.loss_fn(model, torch.from_numpy(toks),
                         torch.from_numpy(labels), torch.from_numpy(patches))
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat,passes", [("none", 1), ("full", 2)])
def test_kernel_calls_a_step(monkeypatch, remat, passes):
    """K3's forward runs once a layer over patches + text with the prefix
    without remat and twice under "full" (the checkpoint recomputes the
    layer); its backward once a layer, with the same prefix."""
    calls = {"k3": [], "k3_bwd": []}

    def spy(name, key):
        real = getattr(k3, name)

        def wrapped(*a, **kw):
            q = a[0] if key == "k3" else a[1]
            calls[key].append((q.shape[1], kw["causal"], kw["prefix_len"]))
            return real(*a, **kw)
        monkeypatch.setattr(k3, name, wrapped)

    spy("flash_attention_fwd", "k3")
    spy("flash_attention_bwd", "k3_bwd")
    _, cfg, _, model = _case(remat=remat)
    _port_grads(model, *_batch(cfg))
    once = [(cfg.num_patches + S, True, cfg.num_patches)] * cfg.num_layers
    assert calls["k3"] == once * passes
    assert calls["k3_bwd"] == once


def test_remat_dots_is_bitwise_no_remat():
    _, _, _, plain = _case(remat="none")
    _, cfg, _, dots = _case(remat="dots")
    batch = _batch(cfg)
    loss0, _, g0 = _port_grads(plain, *batch)
    loss1, _, g1 = _port_grads(dots, *batch)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_six_adamw_steps_match_the_reference():
    """6 steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` + AdamW, from the same weights on the same batches
    (tokens, labels and patch embeddings of ``synth_batch``): losses within
    1e-5 relative, parameters within 0.05 learning rates."""
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
        assert batch["prefix_embeds"].shape == (B, cfg.num_patches,
                                                cfg.d_model)
        assert batch["tokens"].shape == (B, S)
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


def test_train_restarts_bitwise():
    """``train("paligemma_3b", device="cpu")`` (the reduced config; the
    sequence counts the 8 patches and 24 text tokens): 8 AdamW steps with a
    checkpoint every 4; resuming at 4 gives the uninterrupted run's last 4
    losses and final parameters and moments bitwise."""
    kw = dict(steps=8, reduced=True, seq_len=32, batch=2,
              install_signals=False, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("paligemma_3b", ckpt_dir=d, ckpt_every=4, **kw)
        assert np.all(np.isfinite(full))
        shutil.rmtree(os.path.join(d, "step_8"))
        resumed, s_res = train("paligemma_3b", ckpt_dir=d, restore=True,
                               ckpt_every=100, **kw)
    assert isinstance(s_full.params, tt.Transformer)
    assert resumed == full[4:]
    for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s_full.opt.m + s_full.opt.v, s_res.opt.m + s_res.opt.v):
        assert torch.equal(a, b)
    assert s_res.opt.step == s_full.opt.step == 8


def test_patches_reach_the_step_and_the_census_step():
    """The data iterator's float32 patch embeddings reach the model's
    embedding on its device in the model dtype; ``lowering.make_step``
    gives train and prefill cells S - num_patches text tokens (and labels)
    and the patches [B, num_patches, d] in the model dtype, a decode cell
    one token and none."""
    _, cfg = _configs("bfloat16")
    seq = cfg.num_patches + S
    shape = base.ShapeConfig("train_cli", seq, B, "train")
    data = DataIterator(cfg, shape, DataConfig(seed=3))
    try:
        batch = next(data)
    finally:
        data.close()
    assert batch["prefix_embeds"].dtype == np.float32
    seen = []
    real = tt.embed_inputs

    def spy(model, tokens, prefix_embeds=None):
        x, p = real(model, tokens, prefix_embeds)
        seen.append((x.dtype, x.device, tuple(x.shape), p))
        return x, p

    with mock.patch.object(tt, "embed_inputs", spy):
        model = api.build_model(cfg)
        module = model.init(torch.Generator().manual_seed(0), device="cpu")
        opt = optim.make_optimizer("adamw")
        state = api.init_train_state(module, opt)
        api.make_train_step(model, opt)(state, batch)
    assert seen == [(torch.bfloat16, torch.device("cpu"), (B, seq,
                                                           cfg.d_model),
                     cfg.num_patches)]
    for kind in ("train", "prefill"):
        step = lowering.make_step(cfg, base.ShapeConfig("c", seq, B, kind),
                                  "cpu")
        batch = step.args[1]
        assert batch["prefix_embeds"].dtype == torch.bfloat16
        assert tuple(batch["prefix_embeds"].shape) == (B, cfg.num_patches,
                                                       cfg.d_model)
        assert tuple(batch["tokens"].shape) == (B, S)
        out = step.fn(*step.args)
        if kind == "prefill":
            assert tuple(out[0].shape) == (B, seq, cfg.vocab_size)
            assert out[1]["len"] == seq
    step = lowering.make_step(cfg, base.ShapeConfig("c", seq, B, "decode"),
                              "cpu")
    assert "prefix_embeds" not in step.args[1]
    assert tuple(step.args[1]["tokens"].shape) == (B, 1)
    logits, _ = step.fn(*step.args)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
