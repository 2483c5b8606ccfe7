"""The port's checkpoint store and prefetching data iterator against the
reference's, on the CPU.

* A ``TrainState`` written by the port restores bitwise (bf16 through its
  uint16 bits; int8 moments; Adafactor's factored statistics).
* A checkpoint written by the reference's ``store.save`` (its manifest
  holds a pickled JAX treedef, which the port never unpickles) is restored
  by the port from the leaf order of ``TrainState(params, OptState(step, m,
  v))``, and one more port step from it equals the reference's next step:
  loss within 1e-5 relative, parameters within 1e-4 of scale (the float32
  tolerances of ``tests/test_torch_train.py``).
* The store's layout rules: ``latest_step``, ``_gc`` keeps 3, an
  asynchronous write, a ``.tmp`` left by a crash is ignored, an empty
  directory raises.
* ``DataIterator``: batches bitwise the reference's, restart at
  ``start_step``, ``state()``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.checkpoint import store as rstore
from repro.configs import base as rbase
from repro.data import pipeline as rpipe
from repro.models import api as rapi
from repro.models import transformer as rt
from repro_torch import optim
from repro_torch.checkpoint import store
from repro_torch.configs import base
from repro_torch.data import pipeline as pipe
from repro_torch.models import api, layers
from repro_torch.models import transformer as tt
from repro_torch.optim.adafactor import FactoredV
from repro_torch.optim.adamw import is_moment_leaf


def _configs(dtype="float32"):
    return (dataclasses.replace(rbase.get_config("stablelm_1_6b").reduced(),
                                dtype=dtype),
            dataclasses.replace(base.get_config("stablelm_1_6b").reduced(),
                                dtype=dtype))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def _batch(cfg, step, seq_len=24, batch=2):
    shape = base.ShapeConfig("train_cli", seq_len, batch, "train")
    return pipe.synth_batch(cfg, shape, pipe.DataConfig(seed=3), step)


def _state(name, dtype="bfloat16", steps=2):
    """A port TrainState of the reduced stablelm after ``steps`` updates."""
    _, cfg = _configs(dtype)
    model = api.build_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = optim.make_optimizer(name, lr=1e-3, total_steps=10)
    state = api.init_train_state(module, opt)
    step = api.make_train_step(model, opt)
    for i in range(steps):
        state, _ = step(state, _batch(cfg, i))
    return cfg, model, opt, state


def _leaf_equal(a, b):
    if isinstance(a, FactoredV):
        return torch.equal(a.r, b.r) and torch.equal(a.c, b.c)
    if is_moment_leaf(a):
        return (torch.equal(a["q"], b["q"]) and
                torch.equal(a["scale"], b["scale"]) and
                a["shape"] == b["shape"] and a["n"] == b["n"])
    return torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_port_checkpoint_round_trip_is_bitwise(tmp_path, name):
    cfg, model, opt, state = _state(name)
    store.save(str(tmp_path), 2, api.state_tree(state), extra={"step": 2})
    _, _, _, fresh = _state(name, steps=0)
    step, restored, extra = api.restore_train_state(str(tmp_path), fresh,
                                                    model, opt)
    assert step == 2 and extra == {"step": 2}
    assert restored.opt.step == state.opt.step == 2
    for a, b in zip(state.params.parameters(), restored.params.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for field in ("m", "v"):
        for a, b in zip(getattr(state.opt, field),
                        getattr(restored.opt, field)):
            assert _leaf_equal(a, b)
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert "treedef_pkl" not in manifest
    assert manifest["paths"][0] == "params/embed.embed_w"
    assert manifest["dtypes"][0] == "bfloat16"
    assert np.load(tmp_path / "step_2" / "arr_0.npy").dtype == np.uint16


def _reference_state(rcfg, params, name, steps):
    ropt = roptim.make_optimizer(name, lr=1e-3, total_steps=10)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = rapi.make_train_step(rapi.build_model(rcfg), ropt)
    for i in range(steps):
        rstate, _ = rstep(rstate, {k: jnp.asarray(v)
                                   for k, v in _batch(rcfg, i).items()})
    return ropt, rstep, rstate


def test_reference_checkpoint_restores_and_steps_like_the_reference(tmp_path):
    rcfg, cfg = _configs("float32")
    params = rt.init_params(jax.random.PRNGKey(0), rcfg)
    ropt, rstep, rstate = _reference_state(rcfg, params, "adamw", 2)
    rstore.save(str(tmp_path), 2, rstate, extra={"seed": 4, "step": 2})
    assert store.is_reference_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="reference_paths"):
        store.restore(str(tmp_path))

    model = api.build_model(cfg)
    opt = optim.make_optimizer("adamw", lr=1e-3, total_steps=10)
    fresh = api.init_train_state(
        model.init(torch.Generator().manual_seed(1), device="cpu"), opt)
    step, state, extra = api.restore_train_state(str(tmp_path), fresh, model,
                                                 opt)
    assert step == 2 and extra == {"seed": 4, "step": 2}
    assert state.opt.step == 2

    batch = _batch(cfg, 2)
    rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, met = api.make_train_step(model, opt)(state, batch)
    assert abs(float(met["loss"]) / float(rmet["loss"]) - 1) <= 1e-5
    for n, p in state.params.named_parameters():
        path, layer = layers.reference_key(n)
        want = rstate.params
        for key in path.split("/"):
            want = want[key]
        want = np.asarray(want)[layer] if layer is not None \
            else np.asarray(want)
        got = p.detach().numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), n


@pytest.mark.parametrize("name", ["adamw8bit", "adafactor", "adamw_bf16"])
def test_reference_optimizer_states_carry_across(name):
    """``api.train_state_from_reference`` over each optimiser's reference
    state (a reference ``TrainState`` of numpy leaves): one port leaf per
    reference leaf (``api.param_groups``: a stacked [L, ...] layer leaf is
    one leaf), each copied exactly -- float moments, Adafactor's factored
    statistics, and an int8 moment block for block (its q and scales), with
    no re-quantization."""
    rcfg, cfg = _configs("float32")
    params = rt.init_params(jax.random.PRNGKey(0), rcfg)
    _, _, rstate = _reference_state(rcfg, params, name, 2)
    host = jax.tree_util.tree_map(np.asarray, rstate)
    opt = optim.make_optimizer(name, lr=1e-3, total_steps=10)
    state = api.train_state_from_reference(host, cfg, opt, device="cpu")
    assert state.opt.step == 2
    groups = api.param_groups(state.params)
    assert len(groups) == len(jax.tree_util.tree_leaves(params))
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
                assert mine["n"] == int(ref["n"])
            elif isinstance(mine, FactoredV):
                for part in ("r", "c"):
                    assert np.array_equal(getattr(mine, part).numpy(),
                                          np.asarray(getattr(ref, part)))
            else:
                want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
                if group.stacked:
                    assert mine.shape[0] == cfg.num_layers
                assert np.array_equal(mine.float().numpy(), want), leaf


def test_reference_paths_spell_the_reference_leaf_order():
    """``reference_state_paths`` names as many leaves, in the same order, as
    ``jax.tree_util`` flattens a reference ``TrainState`` into, for each
    optimiser (shapes checked leaf by leaf)."""
    rcfg, cfg = _configs("float32")
    params = rt.init_params(jax.random.PRNGKey(0), rcfg)
    module = api.build_model(cfg).init(device="cpu")
    for name in ("adamw", "adamw8bit", "adafactor"):
        ropt = roptim.make_optimizer(name, lr=1e-3, total_steps=10)
        leaves = jax.tree_util.tree_leaves(
            rapi.TrainState(params, ropt.init(params)))
        paths = api.reference_state_paths(module, name)
        assert len(paths) == len(leaves), name
        shapes = dict(api.reference_param_leaves(module))
        for path, leaf in zip(paths, leaves):
            if path.startswith("params/"):
                assert tuple(np.shape(leaf)) == shapes[path[len("params/"):]]
            if path.endswith("/q"):
                assert np.asarray(leaf).dtype == np.int8


def test_latest_step_gc_tmp_and_empty(tmp_path):
    d = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        store.restore(d)
    assert store.latest_step(d) is None
    tree = {"a/x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "a/y": np.int32(7)}
    for s in (1, 2, 3, 4, 5):
        store.save(d, s, tree)
    assert sorted(os.listdir(d)) == ["step_3", "step_4", "step_5"]
    assert store.latest_step(d) == 5
    os.makedirs(os.path.join(d, "step_9.tmp"))      # a crash mid-write
    assert store.latest_step(d) == 5
    step, got, extra = store.restore(d)
    assert step == 5 and extra == {}
    assert torch.equal(got["a"]["x"], tree["a/x"])
    assert int(got["a"]["y"]) == 7
    os.makedirs(os.path.join(d, "step_11"))         # no manifest: not a step
    assert store.latest_step(d) == 5


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The snapshot is taken when ``save_async`` returns: later in-place
    updates (the port's optimiser writes in place) do not reach the disk."""
    t = torch.ones(1000)
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, {"w": t}, extra={"step": 1})
    t.add_(1.0)
    ck.wait()
    _, got, extra = store.restore(str(tmp_path), 1)
    assert torch.equal(got["w"], torch.ones(1000)) and extra == {"step": 1}


def test_data_iterator_matches_the_reference_and_restarts():
    rcfg, cfg = _configs()
    shape = base.ShapeConfig("t", 32, 4, "train")
    rshape = rbase.ShapeConfig("t", 32, 4, "train")
    mine = pipe.DataIterator(cfg, shape, pipe.DataConfig(seed=5))
    ref = rpipe.DataIterator(rcfg, rshape, rpipe.DataConfig(seed=5))
    try:
        for step in range(6):
            a, b = next(mine), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert mine.state() == ref.state() == {"seed": 5,
                                                   "step": step + 1}
    finally:
        mine.close()
        ref.close()
    again = pipe.DataIterator(cfg, shape, pipe.DataConfig(seed=5),
                              start_step=4)
    try:
        assert again.state() == {"seed": 5, "step": 4}
        got = next(again)
        want = pipe.synth_batch(cfg, shape, pipe.DataConfig(seed=5), 4)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert again.state()["step"] == 5
    finally:
        again.close()
    assert iter(again) is again
