"""The port's ResNet inference path against the reference.

Configs, synthetic data, the forward pass (weights carried over from the
reference's ``init_params`` with random batch-norm statistics), the
full-width parameter shapes, and the model API.  Inputs are drawn with
numpy; the forward runs on the CPU, where every stride-1 convolution takes
K2's plain version.  Measured on the reduced ResNet (32x32 and 33x33
images): logits within 3e-7 of their scale in float32, equal in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.data import pipeline as rpipe
from repro.models import resnet as rres
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.kernels import conv2d as k2
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import resnet
from repro_torch.models.api import build_model


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _random_bn(tree, rng):
    """Replace every batch-norm leaf set with random statistics, so the
    carried-over running mean / var and the affine terms all matter."""
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape[0]
        draw = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, .1, c),
                "mean": rng.normal(0, 0.1, c), "var": rng.uniform(0.5, 1.5, c)}
        return {k: jnp.asarray(v.astype(np.float32)) for k, v in draw.items()}
    return {k: _random_bn(v, rng) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  tree)


def _configs(dtype):
    return (dataclasses.replace(rbase.get_config("resnet50").reduced(),
                                dtype=dtype),
            dataclasses.replace(base.get_config("resnet50").reduced(),
                                dtype=dtype))


# --- configs and data ------------------------------------------------------


@pytest.mark.parametrize("name", rbase.ARCH_NAMES)
def test_arch_config_equal_field_by_field(name):
    ref_cfg, cfg = rbase.get_config(name), base.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert (dataclasses.asdict(cfg.reduced())
            == dataclasses.asdict(ref_cfg.reduced()))
    assert ([f.name for f in dataclasses.fields(cfg)]
            == [f.name for f in dataclasses.fields(ref_cfg)])
    assert cfg.param_count() == ref_cfg.param_count()


def test_names_and_shapes_equal():
    assert base.ARCH_NAMES == rbase.ARCH_NAMES
    assert ({k: dataclasses.asdict(v) for k, v in base.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()})
    with pytest.raises(KeyError):
        base.get_config("resnet51")


@pytest.mark.parametrize("name", ["resnet50", "qwen3_14b", "paligemma_3b",
                                  "whisper_small"])
@pytest.mark.parametrize("step", [0, 3])
def test_synth_batch_bitwise(name, step):
    arch, rarch = base.get_config(name), rbase.get_config(name)
    seq = 16 + arch.num_patches          # the vlm's text follows its patches
    shape = base.ShapeConfig("tiny", seq, 4, "train")
    rshape = rbase.ShapeConfig("tiny", seq, 4, "train")
    if arch.family == "cnn":
        arch = dataclasses.replace(arch, image_size=24)
        rarch = dataclasses.replace(rarch, image_size=24)
    got = pipeline.synth_batch(arch, shape, pipeline.DataConfig(seed=5), step)
    want = rpipe.synth_batch(rarch, rshape, rpipe.DataConfig(seed=5), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# --- the forward pass ------------------------------------------------------


@pytest.mark.parametrize("dtype,image_size,tol", [
    ("float32", 32, 1e-4), ("bfloat16", 32, 5e-2), ("float32", 33, 1e-4)])
def test_reduced_forward_matches_reference(dtype, image_size, tol):
    """Port ``ResNet`` with the reference's weights (random BN running stats
    included) vs ``resnet.forward(train=False)``; 33x33 images make every
    stride-2 SAME pad symmetric-odd instead of asymmetric.  Tolerance
    relative to the logits' scale: 1e-4 float32, 5e-2 bf16 (measured:
    float32 2.3e-7 at 32x32 and 2.8e-7 at 33x33, bf16 0)."""
    rcfg, cfg = _configs(dtype)
    params = _random_bn(rres.init_params(jax.random.PRNGKey(0), rcfg),
                        np.random.default_rng(1))
    imgs = np.random.default_rng(2).normal(
        size=(2, image_size, image_size, 3)).astype(np.float32)
    want = np.asarray(rres.forward(params, rcfg, jnp.asarray(imgs),
                                   train=False))
    model = resnet.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
    got = model(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(got.numpy()).all()
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) / scale < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(2, 5, 5, 6)).astype(np.float32), jdt)
    p = _random_bn({"scale": jnp.ones(6), "bias": jnp.zeros(6),
                    "mean": jnp.zeros(6), "var": jnp.ones(6)}, rng)
    want = np.asarray(rres.batchnorm(p, x, train=False).astype(jnp.float32))
    bn = resnet.BatchNorm(6, torch.device("cpu"))
    bn.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in p.items()})
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = bn(xt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6)


def _reference_convs(monkeypatch, rcfg, images_shape):
    """(x shape, w shape, stride) of every convolution the reference's
    ``resnet.forward`` makes, in order, read off an abstract evaluation
    (``jax.eval_shape``: nothing is computed)."""
    seen = []
    real = rres.conv2d

    def spy(x, w, stride=1, padding="SAME"):
        seen.append((tuple(x.shape), tuple(w.shape), stride))
        return real(x, w, stride, padding)

    monkeypatch.setattr(rres, "conv2d", spy)
    jax.eval_shape(lambda k, im: rres.forward(rres.init_params(k, rcfg), rcfg,
                                              im, train=False),
                   jax.random.PRNGKey(0),
                   jax.ShapeDtypeStruct(images_shape, jnp.float32))
    return seen


def test_forward_routes_stride_one_convolutions_to_k2(monkeypatch):
    """On the reduced ResNet the K2 wrapper sees exactly the stride-1
    convolutions of the reference's forward, in order and with their
    shapes; on the CPU none of them is a launch."""
    seen = []
    real = k2.conv2d

    def spy(x, w, *, padding):
        seen.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, padding=padding)

    monkeypatch.setattr(k2, "conv2d", spy)
    rcfg, cfg = _configs("bfloat16")
    model = build_model(cfg).init(torch.Generator().manual_seed(3),
                                  device="cpu")
    k2.reset_launch_counts()
    model(torch.zeros(3, 32, 32, 3))
    want = [(x, w) for x, w, stride in _reference_convs(
        monkeypatch, rcfg, (3, 32, 32, 3)) if stride == 1]
    assert seen == want and len(want) == 6
    assert sum(k2.launch_counts().values()) == 0


def test_full_resnet50_convolutions(monkeypatch):
    """The port's full ResNet-50 at 224x224 makes the reference's 53
    convolutions in order, 46 of them stride 1 (K2) over 16 distinct
    shapes, carrying 81% of the 8.17 GFLOP of convolution per image.  Each
    convolution is recorded and answered with zeros of its output shape, so
    nothing is convolved."""
    seen = []

    def shape_only(x, w, *, stride=1, padding="SAME"):
        seen.append((tuple(x.shape), tuple(w.shape), stride))
        b, h, wd, _ = x.shape
        return torch.zeros((b, -(-h // stride), -(-wd // stride), w.shape[3]),
                           dtype=x.dtype)

    monkeypatch.setattr(ops, "conv2d", shape_only)
    rcfg, cfg = rbase.get_config("resnet50"), base.get_config("resnet50")
    model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert tuple(model(torch.zeros(1, 224, 224, 3)).shape) == (1, 1000)
    assert seen == _reference_convs(monkeypatch, rcfg, (1, 224, 224, 3))

    def flops(c):
        (b, h, wd, cin), (kh, kw, _, cout), stride = c
        return 2 * b * -(-h // stride) * -(-wd // stride) * cout * kh * kw * cin

    k2_convs = [c for c in seen if c[2] == 1]
    total = sum(flops(c) for c in seen)
    k2_total = sum(flops(c) for c in k2_convs)
    assert (len(seen), len(k2_convs)) == (53, 46)
    assert len({(x[1:], w) for x, w, _ in k2_convs}) == 16
    assert round(total / 1e9, 2) == 8.17 and round(k2_total / 1e9, 2) == 6.63
    assert seen[-1][:2] == ((1, 7, 7, 512), (1, 1, 512, 2048))


def test_full_width_parameter_shapes_match_reference():
    """Every parameter and batch-norm buffer of the port's full ResNet-50
    has the path, shape and dtype of the reference's ``init_params`` leaf
    (``jax.eval_shape``: nothing is drawn on the reference side)."""
    rcfg, cfg = rbase.get_config("resnet50"), base.get_config("resnet50")
    want = _flatten(jax.eval_shape(lambda k: rres.init_params(k, rcfg),
                                   jax.random.PRNGKey(0)))
    got = build_model(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu").state_dict()
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(leaf.dtype), key
    n_params = sum(int(np.prod(leaf.shape)) for leaf in want.values())
    assert n_params == sum(t.numel() for t in got.values())


def test_init_is_he_normal_and_seeded():
    cfg = base.get_config("resnet50").reduced()
    a = build_model(cfg).init(torch.Generator().manual_seed(9), device="cpu")
    b = build_model(cfg).init(torch.Generator().manual_seed(9), device="cpu")
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    w = a.stage0_block0.conv2.conv.float()
    assert w.dtype == torch.float32 and a.stem.conv.dtype == torch.bfloat16
    assert abs(float(w.std()) / (2.0 / (9 * 8)) ** 0.5 - 1) < 0.15
    assert torch.equal(a.bn_stem.var, torch.ones(8))
    assert all(not p.requires_grad for p in a.parameters())


# --- carrying weights over, the API ----------------------------------------


def test_params_from_reference_rejects_a_mismatch():
    rcfg, cfg = _configs("float32")
    params = _numpy_tree(rres.init_params(jax.random.PRNGKey(0), rcfg))
    missing = dict(params)
    del missing["fc"]
    with pytest.raises(ValueError, match="only module"):
        resnet.params_from_reference(missing, cfg, device="cpu")
    wrong = dict(params, fc={"fc": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        resnet.params_from_reference(wrong, cfg, device="cpu")


def test_build_model_init_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(base.get_config("resnet50").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        model.init()
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(device="cuda")
    assert isinstance(model.init(device="cpu"), resnet.ResNet)


@pytest.mark.parametrize("name", ["deepseek_v2_236b", "deepseek_v3_671b"])
def test_other_families_are_not_ported_yet(name):
    """Every model family is ported now: the last one, MoE (deepseek v2 /
    v3), builds -- its serving entries and its loss -- where it raised
    before (ROADMAP.md Queue 1 item 12e step 4)."""
    model = build_model(base.get_config(name))
    assert model.prefill and model.decode and model.init_cache and model.loss
    assert model.init(device="meta").cfg.family == "moe"


@pytest.mark.parametrize("name,want", [("bfloat16", torch.bfloat16),
                                       ("float32", torch.float32)])
def test_layers_dtype_of_and_dense_init(name, want):
    cfg = dataclasses.replace(base.get_config("resnet50"), dtype=name)
    assert L.dtype_of(cfg) == want
    w = L.dense_init(torch.Generator().manual_seed(0), (256, 64), want)
    assert w.dtype == want and tuple(w.shape) == (256, 64)
    assert abs(float(w.float().std()) / 0.02 - 1) < 0.05
    with pytest.raises(ValueError):
        L.dtype_of(dataclasses.replace(cfg, dtype="int8"))
