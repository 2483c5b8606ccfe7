"""The port's ResNet training path (K2's gradient, train-mode batch norm,
the loss, the train step, ``train()``) against the reference's, on the CPU.

The reduced ``resnet50`` (stages (1, 1), width 8, 32x32 images, 256
classes) with the reference's ``init_params`` weights carried across by
``params_from_reference`` -- every batch-norm leaf redrawn at random so
that ``scale`` and ``bias`` matter and the stored ``mean`` / ``var`` are
visibly unused in training --, images and labels drawn with numpy, B=4.
Every stride-1 convolution takes K2's plain forward and its plain data and
weight gradients (the CPU path).  Tolerances, each stated where it is used:

* K2's gradient alone against ``jax.vjp`` of ``lax.conv_general_dilated``:
  1e-5 of scale (max |reference|) in float32, 1e-2 in bf16 -- K2's own
  gates (sums in another order; bf16 rounds each output once either way);
* train-mode batch norm: 1e-6 absolute on unit-scale inputs in float32 and
  one bf16 step (2^-7 relative) in bf16, and its input gradient 1e-5 of
  scale;
* loss: 1e-5 relative; every parameter gradient: 1e-4 of its reference's
  scale; the batch-norm ``mean`` / ``var`` gradients exactly 0 on both
  sides;
* 4 train steps against the reference's jitted ``make_train_step``:
  losses within 1e-5 relative, parameters within 0.05 learning rates
  absolute, and within 1 learning rate where the first step's reference
  gradient is below 1e-7 (measured 0.29: such a gradient is float noise
  of an exact zero -- train-mode batch norm after a convolution removes a
  constant shift of the convolution's input channel -- and Adam moves the
  element by |g| / (|g| + 1e-8) of a learning rate a step, on either side
  alike; as in ``tests/test_torch_mamba_train.py``); every ``var``
  bitwise the reference's (its gradient is 0, so AdamW's decoupled decay
  alone moves it, by the same float32 operations);
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
from repro.models import resnet as rres
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import conv2d as k2
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models import api
from repro_torch.models import resnet

B = 4
LR = 1e-3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CLASSES = base.get_config("resnet50").reduced().vocab_size


def _configs(dtype="float32"):
    return (dataclasses.replace(rbase.get_config("resnet50").reduced(),
                                dtype=dtype),
            dataclasses.replace(base.get_config("resnet50").reduced(),
                                dtype=dtype))


def _random_bn(tree, rng):
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape[0]
        draw = {"scale": rng.uniform(0.5, 1.5, c),
                "bias": rng.normal(0, .1, c),
                "mean": rng.normal(0, 0.1, c), "var": rng.uniform(0.5, 1.5, c)}
        return {k: jnp.asarray(v.astype(np.float32)) for k, v in draw.items()}
    return {k: _random_bn(v, rng) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def _case(dtype="float32"):
    rcfg, cfg = _configs(dtype)
    params = _random_bn(rres.init_params(jax.random.PRNGKey(0), rcfg),
                        np.random.default_rng(1))
    model = resnet.params_from_reference(_numpy_tree(params), cfg,
                                         device="cpu")
    return rcfg, cfg, params, model


def _batch(seed=2, size=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, size, size, 3)).astype(np.float32),
            rng.integers(0, CLASSES, B).astype(np.int32))


def _ref_leaf(tree, name):
    leaf = tree
    for key in name.split("."):
        leaf = leaf[key]
    return np.array(jnp.asarray(leaf).astype(jnp.float32))


def _rel(got, want):
    got = np.asarray(got, dtype=np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(TDT[dtype])


# --- K2's gradient alone ------------------------------------------------------


# (x shape, w shape, padding): 1x1, 3x3 SAME, ragged (odd sizes, channels
# not multiples of 8, a 5x3 kernel with asymmetric padding)
GRAD_SHAPES = [((2, 7, 9, 8, 16), (1, 1), ((0, 0), (0, 0))),
               ((2, 8, 8, 16, 8), (3, 3), ((1, 1), (1, 1))),
               ((3, 9, 11, 5, 7), (5, 3), ((2, 1), (1, 0)))]


def _grad_inputs(shape, k, dtype, seed=5):
    b, h, w, cin, cout = shape
    kh, kw = k
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(kh, kw, cin, cout))
          * (2.0 / (kh * kw * cin)) ** 0.5).astype(np.float32)
    if dtype == "bfloat16":      # values that bf16 holds exactly
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        wt = np.asarray(jnp.asarray(wt, jnp.bfloat16).astype(jnp.float32))
    return x, wt


def _jax_vjp(x, wt, dy, pads, dtype):
    def conv(a, b):
        return jax.lax.conv_general_dilated(
            a, b, (1, 1), pads, dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y, vjp = jax.vjp(conv, jnp.asarray(x, JDT[dtype]),
                     jnp.asarray(wt, JDT[dtype]))
    dx, dw = vjp(jnp.asarray(dy, JDT[dtype]))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _dy(y_shape, dtype, seed=6):
    dy = np.random.default_rng(seed).normal(size=y_shape).astype(np.float32)
    if dtype == "bfloat16":
        dy = np.asarray(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    return dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,pads", GRAD_SHAPES)
def test_plain_gradients_match_jax_vjp(shape, k, pads, dtype):
    x, wt = _grad_inputs(shape, k, dtype)
    (pt, pb), (pl, pr) = pads
    y_shape = (shape[0], shape[1] + pt + pb - k[0] + 1,
               shape[2] + pl + pr - k[1] + 1, shape[4])
    dy = _dy(y_shape, dtype)
    _, want_dx, want_dw = _jax_vjp(x, wt, dy, pads, dtype)
    dx = k2.conv2d_dgrad(_t(dy, dtype), _t(wt, dtype), padding=pads)
    dw = k2.conv2d_wgrad(_t(x, dtype), _t(dy, dtype), *k, padding=pads)
    assert dx.dtype == dw.dtype == TDT[dtype]
    assert tuple(dx.shape) == x.shape and tuple(dw.shape) == wt.shape
    assert torch.equal(dx, k2.conv2d_dgrad_plain(_t(dy, dtype), _t(wt, dtype),
                                                 padding=pads))
    assert torch.equal(dw, k2.conv2d_wgrad_plain(_t(x, dtype), _t(dy, dtype),
                                                 *k, padding=pads))
    assert _rel(dx.float(), want_dx) <= GRAD_TOL[dtype]
    assert _rel(dw.float(), want_dw) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,pads", GRAD_SHAPES)
def test_autograd_function_matches_jax_vjp(shape, k, pads, dtype):
    x, wt = _grad_inputs(shape, k, dtype)
    xt = _t(x, dtype).requires_grad_(True)
    wtt = _t(wt, dtype).requires_grad_(True)
    y = k2.conv2d_trainable(xt, wtt, padding=pads)
    dy = _dy(tuple(y.shape), dtype)
    want_y, want_dx, want_dw = _jax_vjp(x, wt, dy, pads, dtype)
    y.backward(_t(dy, dtype))
    assert _rel(y.detach().float(), want_y) <= GRAD_TOL[dtype]
    assert _rel(xt.grad.float(), want_dx) <= GRAD_TOL[dtype]
    assert _rel(wtt.grad.float(), want_dw) <= GRAD_TOL[dtype]


def test_autograd_function_computes_only_the_gradients_asked_for(monkeypatch):
    """dx only where x requires grad, dw only where w does; dy is made
    contiguous first; no launch is counted on the CPU."""
    calls = []
    for name in ("conv2d_dgrad", "conv2d_wgrad"):
        real = getattr(k2, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[0].is_contiguous()))
            return _real(*a, **kw)
        monkeypatch.setattr(k2, name, spy)
    x, wt = _grad_inputs((2, 6, 6, 8, 8), (3, 3), "float32")
    pads = ((1, 1), (1, 1))
    k2.reset_launch_counts()
    w_only = _t(wt, "float32").requires_grad_(True)
    y = k2.conv2d_trainable(_t(x, "float32"), w_only, padding=pads)
    # a transposed cotangent: not contiguous until the backward copies it
    y.backward(torch.ones(2, 6, 8, 6).transpose(2, 3) * 0.5)
    assert calls == [("conv2d_wgrad", True)]
    calls.clear()
    x_only = _t(x, "float32").requires_grad_(True)
    k2.conv2d_trainable(x_only, _t(wt, "float32"),
                        padding=pads).sum().backward()
    assert calls == [("conv2d_dgrad", True)] and x_only.grad is not None
    assert sum(k2.launch_counts().values()) == 0
    assert sum(k2.bwd_launch_counts().values()) == 0


def test_ops_conv2d_records_only_under_autograd(monkeypatch):
    """``ops.conv2d`` at stride 1 goes through ``Conv2dK2`` where an input
    requires grad and gradients are on, else straight to K2's forward."""
    seen = []
    real = k2.conv2d_trainable

    def spy(x, w, *, padding):
        seen.append(padding)
        return real(x, w, padding=padding)

    monkeypatch.setattr(k2, "conv2d_trainable", spy)
    x = torch.randn(1, 5, 5, 4)
    w = torch.randn(3, 3, 4, 8, requires_grad=True)
    y = ops.conv2d(x, w)
    assert seen == [((1, 1), (1, 1))] and y.requires_grad
    with torch.no_grad():
        ops.conv2d(x, w)
    ops.conv2d(x, w.detach())
    assert len(seen) == 1


def test_dgrad_refuses_a_padding_past_the_kernel():
    with pytest.raises(ValueError, match="past"):
        k2.conv2d_dgrad(torch.zeros(1, 6, 6, 2), torch.zeros(1, 1, 2, 2),
                        padding=((1, 1), (0, 0)))


@pytest.mark.parametrize("shape,k,pads,variant,split", [
    ((32, 56, 56, 64, 64), (3, 3), ((1, 1), (1, 1)), k2.WG_TC, 44),
    ((32, 7, 7, 512, 2048), (1, 1), ((0, 0), (0, 0)), k2.WG_TC, 1),
    ((2, 9, 9, 12, 20), (3, 3), ((1, 1), (1, 1)), k2.WG_SIMT, 1)])
def test_wgrad_plan(shape, k, pads, variant, split):
    """The plan's variant and pixel split: the slices fill at most one wave
    of resident blocks, each of at least ``MIN_WGRAD_SLICE_PIXELS`` pixels,
    and cover every step once, in order."""
    b, h, w, cin, cout = shape
    p = k2.plan_wgrad(b, h, w, cin, cout, *k, pads, torch.bfloat16,
                      k2.H100_SMS)
    assert (p.variant, p.split) == (variant, split)
    assert p.grid == (-(-cin // p.bm), -(-cout // p.bn),
                      k[0] * k[1] // p.taps * split)
    assert p.grid[0] * p.grid[1] * p.grid[2] <= k2.H100_SMS * (
        k2.WGRAD_RESIDENT[variant]) or split == 1
    bounds = [p.slice_bounds(z) for z in range(p.split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == p.steps
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert min(e - s for s, e in bounds) * p.bk >= min(
        k2.MIN_WGRAD_SLICE_PIXELS, p.steps * p.bk)
    assert k2.plan_wgrad(b, h, w, cin, cout, *k, pads, torch.float32,
                         k2.H100_SMS).variant == k2.WG_F32


# ResNet-50's 16 distinct stride-1 convolutions (H = W, Cin, Cout, k), B=32
RESNET50_WGRAD_SHAPES = [
    (56, 64, 64, 1), (56, 256, 64, 1), (56, 64, 64, 3), (56, 64, 256, 1),
    (56, 256, 128, 1), (28, 512, 128, 1), (28, 128, 128, 3),
    (28, 128, 512, 1), (28, 512, 256, 1), (14, 1024, 256, 1),
    (14, 256, 256, 3), (14, 256, 1024, 1), (14, 1024, 512, 1),
    (7, 2048, 512, 1), (7, 512, 512, 3), (7, 512, 2048, 1)]


@pytest.mark.parametrize("h,cin,cout,k", RESNET50_WGRAD_SHAPES)
def test_wgrad_plan_fits_resnet50(h, cin, cout, k):
    """At each ResNet-50 shape the tensor-core variant is chosen; no tile
    carries a zero-filled channel and the boxes tile the pixels exactly (no
    product runs on zero fill); the grid is within CUDA's limits and the
    ring fits shared memory; the slices cover every step once, in order."""
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    p = k2.plan_wgrad(32, h, h, cin, cout, k, k, pads, torch.bfloat16,
                      k2.H100_SMS)
    assert p.variant == k2.WG_TC
    assert (p.bm, p.bn, p.taps) in k2.WGRAD_TILES
    assert cin % p.bm == 0 and cout % p.bn == 0
    assert p.grid == (cin // p.bm, cout // p.bn, k * k // p.taps * p.split)
    assert p.grid[0] < 2 ** 31 and max(p.grid[1:]) <= 65535
    # the walk: whole boxes of a multiple of 16 pixels, exactly the pixels
    bw, bh, bb = p.box
    walk = (32 * h * h, 1, 1) if p.flat else (h, h, 32)
    assert p.flat == (k == 1)
    assert p.bk == bw * bh * bb and p.bk % 16 == 0
    assert p.bk <= k2.WGRAD_MAX_ROWS
    assert all(g % e == 0 for g, e in zip(walk, p.box))
    assert p.boxes == tuple(g // e for g, e in zip(walk, p.box))
    assert p.steps * p.bk == 32 * h * h
    origins = {p.box_origin(s) for s in range(p.steps)}
    assert len(origins) == p.steps and all(
        o[d] % p.box[d] == 0 and o[d] < walk[d] for o in origins
        for d in range(3))
    # the ring: at least three stages, in the card's shared memory
    stage = (p.taps * p.bm // 64 + p.bn // 64) * p.bk * 128
    assert 3 <= p.stages <= k2.WGRAD_MAX_STAGES
    assert p.stages * stage + 16 * p.stages + 1024 <= k2.WGRAD_SMEM_BYTES
    # the slices: contiguous, in order, covering every step once
    steps = [s for z in range(p.split) for s in range(*p.slice_bounds(z))]
    assert steps == list(range(p.steps))
    assert p.grid[0] * p.grid[1] * p.grid[2] <= k2.H100_SMS or p.split == 1


def test_wgrad_plan_matches_the_source():
    """The plan's limits and tiles are the kernel's: its largest box, its
    deepest ring, the shared memory a block may take and its instances;
    the ``mma.sync`` kernel and its ``ldmatrix`` helper are gone."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC_DIR / k2.BWD_SOURCE).read_text()
    const = dict(re.findall(r"constexpr int (kWg\w+) = (\d+);", src))
    assert int(const["kWgMaxRows"]) == k2.WGRAD_MAX_ROWS
    assert int(const["kWgMaxStages"]) == k2.WGRAD_MAX_STAGES
    assert int(const["kWgMaxSmem"]) == k2.WGRAD_SMEM_BYTES
    launched = set(re.findall(r"launch_wgmma<(\d+), (\d+), (\d+)>\(", src))
    assert {tuple(map(int, t)) for t in launched} == set(k2.WGRAD_TILES)
    assert "mma.sync" not in src and "ldmatrix" not in src
    assert "k2_wgrad_bf16_tc_kernel" not in src
    assert ".f32.bf16.bf16" in src and "p, 1, 1, 1, 1;" in src
    assert "hopper.cuh" in build.local_headers(k2.BWD_SOURCE)


@pytest.mark.parametrize("tile,k", [((64, 256, 1), 1), ((128, 64, 3), 3),
                                     ((64, 64, 3), 1)])
def test_wgrad_plan_refuses_a_tile_without_an_instance(tile, k):
    """A tile the kernel has no instance for, or taps that do not divide the
    kernel's, is refused before any launch."""
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    with pytest.raises(ValueError, match="no tensor-core"):
        k2.plan_wgrad(2, 8, 8, 64, 64, k, k, pads, torch.bfloat16,
                      k2.H100_SMS, True, tile)


def _box(t, c0, w0, h0, b0, box):
    """A TMA box of the [N, H, W, C] tensor t: 64 channels from c0, (bw, bh,
    bb) pixels from (w0, h0, b0), zero where it lies outside t (TMA's
    out-of-bounds fill); rows pixel-major, W fastest."""
    bw, bh, bb = box
    n, hh, ww, cc = t.shape
    out = torch.zeros((bb, bh, bw, 64), dtype=torch.float32)
    lo = [max(0, -v) for v in (b0, h0, w0, -c0)]
    hi = [min(e, lim - v) for e, lim, v in ((bb, n, b0), (bh, hh, h0),
                                           (bw, ww, w0))]
    c_hi = min(64, cc - c0)
    if min(e - s for s, e in zip(lo[:3], hi)) > 0 and c_hi > 0:
        out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], :c_hi] = t[
            b0 + lo[0]:b0 + hi[0], h0 + lo[1]:h0 + hi[1],
            w0 + lo[2]:w0 + hi[2], c0:c0 + c_hi].float()
    return out.reshape(bb * bh * bw, 64)


def _replay_box_walk(x, dy, kh, kw, padding, p):
    """The tensor-core kernel's walk replayed in plain float32 PyTorch:
    for each tap group, pixel slice and (Cin, Cout) tile, the steps' boxes
    (x's at the tap's offset) multiplied box by box into a float32 partial
    tile, the partials added in slice order."""
    b, h, w, cin = x.shape
    cout = dy.shape[3]
    (pt, _), (pl, _) = padding
    if p.flat:
        x, dy = x.reshape(1, 1, -1, cin), dy.reshape(1, 1, -1, cout)
    gx, gy, _ = p.grid
    ws = torch.zeros((p.split, kh * kw, gx * p.bm, gy * p.bn))
    for g in range(kh * kw // p.taps):
        for z in range(p.split):
            for s in range(*p.slice_bounds(z)):
                w0, h0, b0 = p.box_origin(s)
                for tp in range(p.taps):
                    tap = g * p.taps + tp
                    i, j = divmod(tap, kw)
                    for c0 in range(0, gx * p.bm, 64):
                        a = _box(x, c0, w0 + j - pl, h0 + i - pt, b0, p.box)
                        for n0 in range(0, gy * p.bn, 64):
                            d = _box(dy, n0, w0, h0, b0, p.box)
                            ws[z, tap, c0:c0 + 64, n0:n0 + 64] += a.T @ d
    dw = ws[0]
    for z in range(1, p.split):
        dw = dw + ws[z]
    return dw[:, :cin, :cout].reshape(kh, kw, cin, cout)


# (x shape, kernel, padding): a padded 3x3 whose boxes run past the image
# and whose tiles past Cin and Cout (ragged), the 7x7 box (7, 1, 16) split
# in two slices, a 1x1 walked flat, 5x3 with asymmetric padding in tap
# groups of three, 136 -> 264 channels over two and three 128-wide tiles
WALK_SHAPES = [((2, 9, 11, 16, 24), (3, 3), ((1, 1), (1, 1))),
               ((16, 7, 7, 8, 16), (3, 3), ((1, 1), (1, 1))),
               ((2, 7, 9, 8, 16), (1, 1), ((0, 0), (0, 0))),
               ((3, 9, 11, 8, 16), (5, 3), ((2, 1), (1, 0))),
               ((2, 6, 6, 136, 264), (3, 3), ((1, 1), (1, 1)))]


@pytest.mark.parametrize("shape,k,pads", WALK_SHAPES)
def test_wgrad_box_walk_matches_plain_and_jax_vjp(shape, k, pads):
    """The tensor-core kernel's box walk (TMA boxes with out-of-bounds zero
    fill, tap offsets, slices added in order) gives the weight gradient:
    within 1e-5 of scale of ``conv2d_wgrad_plain`` (float32 sums in another
    order) and of ``jax.vjp`` of ``lax.conv_general_dilated`` (float32),
    on bf16-exact inputs."""
    b, h, w, cin, cout = shape
    x, wt = _grad_inputs(shape, k, "bfloat16")
    (pt, pb), (pl, pr) = pads
    dy = _dy((b, h + pt + pb - k[0] + 1, w + pl + pr - k[1] + 1, cout),
             "bfloat16")
    p = k2.plan_wgrad(b, h, w, cin, cout, *k, pads, torch.bfloat16,
                      k2.H100_SMS)
    assert p.variant == k2.WG_TC
    got = _replay_box_walk(_t(x, "bfloat16"), _t(dy, "bfloat16"), *k, pads,
                           p)
    plain = k2.conv2d_wgrad_plain(_t(x, "float32"), _t(dy, "float32"), *k,
                                  padding=pads)
    _, _, want = _jax_vjp(x, wt, dy, pads, "float32")
    assert _rel(got, plain.numpy()) <= GRAD_TOL["float32"]
    assert _rel(got, want) <= GRAD_TOL["float32"]


def test_gradient_on_meta_books_the_census_and_launches_nothing():
    """On the meta device (the workload census) the gradient takes the
    shape-only route and books one entry per call under its own names."""
    from repro_torch.core import census
    x = torch.empty(2, 8, 8, 16, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.empty(3, 3, 16, 32, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)

    def step():
        y = k2.conv2d_trainable(x, w, padding=((1, 1), (1, 1)))
        torch.autograd.grad(y.sum(), [x, w])

    k2.reset_launch_counts()
    got = census.analyze_step(step)
    assert set(got["kernels"]) == {k2.TC, k2.DGRAD[k2.TC], k2.WG_TC}
    flops = 2 * 2 * 8 * 8 * 9 * 16 * 32
    for name in got["kernels"]:
        assert got["kernels"][name]["launches"] == 1
        assert got["kernels"][name]["flops"] == flops
    assert sum(k2.bwd_launch_counts().values()) == 0


# --- batch norm, loss and gradients --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batchnorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(3, 5, 4, 6)).astype(np.float32)
    p = _random_bn({"scale": jnp.ones(6), "bias": jnp.zeros(6),
                    "mean": jnp.zeros(6), "var": jnp.ones(6)}, rng)
    xj = jnp.asarray(x, JDT[dtype])
    want, vjp = jax.vjp(lambda a: rres.batchnorm(p, a, train=True), xj)
    want = np.asarray(want.astype(jnp.float32))
    bn = resnet.BatchNorm(6, torch.device("cpu"))
    bn.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in p.items()})
    xt = _t(np.asarray(xj.astype(jnp.float32)), dtype).requires_grad_(True)
    got = bn(xt, train=True)
    assert got.dtype == xt.dtype
    atol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=atol)
    # the stored statistics are neither read nor written in training
    assert torch.equal(bn.mean, torch.from_numpy(np.array(p["mean"])))
    if dtype == "float32":
        dy = rng.normal(size=x.shape).astype(np.float32)
        (want_dx,) = vjp(jnp.asarray(dy))
        got.backward(torch.from_numpy(dy))
        assert _rel(xt.grad.numpy(), np.asarray(want_dx)) <= 1e-5


def _port_grads(model, images, labels):
    model.requires_grad_(True)
    loss, metrics = resnet.loss_fn(model, torch.from_numpy(images),
                                   torch.from_numpy(labels))
    return loss, metrics, api.grads_of(loss, list(model.parameters()))


def test_parameters_are_the_reference_leaves_in_its_order():
    """``named_parameters()`` (batch-norm ``mean`` / ``var`` included) is
    the reference's ``jax.tree_util`` leaf order, and so are the optimiser's
    leaves."""
    rcfg, cfg, params, model = _case()
    want = ["/".join(str(k.key) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(params)[0]]
    names = [n for n, _ in model.named_parameters()]
    assert [n.replace(".", "/") for n in names] == want
    assert [leaf for leaf, _ in api.param_groups(model)] == names
    assert [p for p, _ in api.reference_param_leaves(model)] == want
    assert "stage0_block0.bn1.var" in names and not list(model.buffers())


def test_loss_and_every_gradient_match_jax_value_and_grad():
    rcfg, cfg, params, model = _case()
    images, labels = _batch()
    (want_loss, want_met), want_g = jax.jit(jax.value_and_grad(
        lambda p: rres.loss_fn(p, rcfg, jnp.asarray(images),
                               jnp.asarray(labels)), has_aux=True))(params)
    loss, metrics, grads = _port_grads(model, images, labels)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-5
    assert float(metrics["nll"]) == float(loss.detach())
    assert set(metrics) == set(want_met) == {"nll"}
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(grads) == len(jax.tree_util.tree_leaves(params))
    for name, g in zip(names, grads):
        want = _ref_leaf(want_g, name)
        if name.endswith((".mean", ".var")):
            assert not want.any() and not g.any(), name
        else:
            assert _rel(g.float().numpy(), want) <= 1e-4, name


def test_bf16_loss_and_gradients_match_jax_value_and_grad():
    """The model's own dtype: every convolution in bf16 on both sides,
    batch norm's statistics in float32.  bf16 rounds activations in other
    places (the reference's XLA convolution, each output once here), so
    the loss is held within 1e-2 relative and the gradients' global norm
    within 5e-2."""
    rcfg, cfg, params, model = _case("bfloat16")
    images, labels = _batch()
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: rres.loss_fn(p, rcfg, jnp.asarray(images),
                               jnp.asarray(labels)), has_aux=True))(params)
    loss, _, grads = _port_grads(model, images, labels)
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= 1e-2
    for p, g in zip(model.parameters(), grads):
        assert g.dtype == p.dtype
    norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    want_norm = float(roptim.adamw.global_norm(want_g))
    assert abs(norm / want_norm - 1) <= 5e-2


def test_inference_is_unchanged_by_training_mode():
    """``forward(images)`` runs under no_grad with the stored statistics;
    training leaves them as they were and takes the batch's."""
    _, _, _, model = _case()
    images, _ = _batch()
    before = model(images)
    assert not before.requires_grad
    model.requires_grad_(True)
    train_logits = model(torch.from_numpy(images), train=True)
    assert train_logits.requires_grad
    assert not torch.allclose(train_logits.detach(), before)
    assert torch.equal(model(images), before)


# --- the train step, the state, the trainer -----------------------------------


def _batches(cfg, n):
    shape = base.ShapeConfig("train_cli", 0, B, "train")
    return [synth_batch(cfg, shape, DataConfig(seed=7), s) for s in range(n)]


def test_model_api_trains_the_cnn_family():
    """``Model.loss`` is ``resnet.loss_fn`` over ``batch["images"]`` and
    ``batch["labels"]``; ``check_trainable`` passes."""
    _, cfg, _, model = _case()
    images, labels = _batch()
    api.check_trainable(cfg)
    model.requires_grad_(True)
    got, _ = api.build_model(cfg).loss(model, {"images": images,
                                               "labels": labels})
    want, _ = resnet.loss_fn(model, torch.from_numpy(images),
                             torch.from_numpy(labels))
    assert torch.equal(got, want)


def _reference_run(rcfg, params, batches, total):
    ropt = roptim.make_optimizer("adamw", lr=LR, total_steps=total)
    rstate = rapi.TrainState(params, ropt.init(params))
    rstep = jax.jit(rapi.make_train_step(rapi.build_model(rcfg), ropt))
    losses = []
    for batch in batches:
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        losses.append(float(rmet["loss"]))
    return rstate, losses


def test_four_train_steps_match_the_reference():
    rcfg, cfg, params, model = _case()
    batches = _batches(cfg, 4)
    rstate, rlosses = _reference_run(rcfg, params, batches, 4)
    first = jax.grad(lambda p: rres.loss_fn(
        p, rcfg, jnp.asarray(batches[0]["images"]),
        jnp.asarray(batches[0]["labels"]))[0])(params)
    opt = optim.make_optimizer("adamw", lr=LR, total_steps=4)
    state = api.init_train_state(model, opt)
    step = api.make_train_step(api.build_model(cfg), opt)
    losses = []
    for batch in batches:
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        assert set(met) == {"nll", "grad_norm", "lr", "loss"}
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    assert state.opt.step == int(rstate.opt.step) == 4
    decayed = 0
    for name, p in state.params.named_parameters():
        want = _ref_leaf(rstate.params, name)
        got = p.detach().float().numpy()
        if name.endswith(".var"):
            np.testing.assert_array_equal(got, want)
            decayed += int((got < _ref_leaf(params, name)).all())
            continue
        # an element whose gradient is float noise of an exact zero
        # (a channel that is positive everywhere after its ReLU and feeds
        # only convolutions followed by train-mode batch norm, which
        # removes any constant shift: here a few of bn_stem.bias) moves
        # by |g| / (|g| + 1e-8) of a learning rate a step on either side
        noise = np.abs(_ref_leaf(first, name)) < 1e-7
        diff = np.abs(got - want)
        assert diff[~noise].max(initial=0) <= 0.05 * LR, name
        assert diff[noise].max(initial=0) <= LR, name
    assert decayed == sum(1 for n, _ in model.named_parameters()
                          if n.endswith(".var"))


def test_reference_train_state_carries_across_and_restores(tmp_path):
    """A reference ``TrainState`` after 2 steps -- its AdamW moments per
    leaf, the batch-norm leaves' zeros included -- carried onto the port
    (``train_state_from_reference``) and read back from the reference's
    checkpoint (``restore_train_state``): equal leaf for leaf, and one more
    port step equals the reference's next one."""
    rcfg, cfg, params, _ = _case()
    batches = _batches(cfg, 3)
    rstate, _ = _reference_run(rcfg, params, batches[:2], 10)
    opt = optim.make_optimizer("adamw", lr=LR, total_steps=10)
    host = jax.tree_util.tree_map(np.asarray, rstate)
    carried = api.train_state_from_reference(host, cfg, opt, device="cpu")
    rstore.save(str(tmp_path), 2, rstate, extra={"step": 2})
    model = api.build_model(cfg)
    fresh = api.init_train_state(
        model.init(torch.Generator().manual_seed(1), device="cpu"), opt)
    step, restored, extra = api.restore_train_state(str(tmp_path), fresh,
                                                    model, opt)
    assert step == 2 and extra == {"step": 2}
    for state in (carried, restored):
        assert state.opt.step == 2
        for (name, _), p, m, v in zip(api.param_groups(state.params),
                                      state.params.parameters(),
                                      state.opt.m, state.opt.v):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          _ref_leaf(rstate.params, name))
            np.testing.assert_array_equal(m.numpy(),
                                          _ref_leaf(rstate.opt.m, name))
            np.testing.assert_array_equal(v.numpy(),
                                          _ref_leaf(rstate.opt.v, name))
    ropt = roptim.make_optimizer("adamw", lr=LR, total_steps=10)
    rstep = jax.jit(rapi.make_train_step(rapi.build_model(rcfg), ropt))
    rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                  for k, v in batches[2].items()})
    restored, met = api.make_train_step(model, opt)(restored, batches[2])
    assert abs(float(met["loss"]) / float(rmet["loss"]) - 1) <= 1e-5
    for name, p in restored.params.named_parameters():
        want = _ref_leaf(rstate.params, name)
        assert np.abs(p.detach().numpy() - want).max() <= 0.05 * LR, name


def test_train_learns_and_restarts_bitwise(monkeypatch):
    """``train("resnet50", device="cpu")`` (the reduced config, bf16): the
    loss falls over 8 steps on one repeated batch at a large learning rate,
    and 8 steps with a checkpoint every 4 resumed at 4 give the
    uninterrupted run's last 4 losses, parameters and moments bitwise."""
    from repro_torch.launch import train as train_mod
    kw = dict(reduced=True, batch=2, install_signals=False, log_every=100,
              device="cpu")
    same = synth_batch(base.get_config("resnet50").reduced(),
                       base.ShapeConfig("train_cli", 0, 2, "train"),
                       DataConfig(seed=1), 0)

    class Repeat:
        def __init__(self, *a, **k):
            pass

        def __next__(self):
            return same

        def close(self):
            pass

    with monkeypatch.context() as m:
        m.setattr(train_mod, "DataIterator", Repeat)
        losses, _ = train("resnet50", steps=8, lr=1e-2, **kw)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    with tempfile.TemporaryDirectory() as d:
        full, s_full = train("resnet50", steps=8, ckpt_dir=d, ckpt_every=4,
                             **kw)
        shutil.rmtree(os.path.join(d, "step_8"))
        resumed, s_res = train("resnet50", steps=8, ckpt_dir=d, restore=True,
                               ckpt_every=100, **kw)
    assert resumed == full[4:]
    for a, b in zip(s_full.params.parameters(), s_res.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s_full.opt.m + s_full.opt.v, s_res.opt.m + s_res.opt.v):
        assert torch.equal(a, b)
    assert s_res.opt.step == s_full.opt.step == 8
