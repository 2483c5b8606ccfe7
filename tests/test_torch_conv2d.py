"""The port's convolution (K2's plain version, the stride-1 routing, the
library path for stride 2, the SAME max pool) against the reference.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
On the CPU the K2 wrapper takes its plain version (a float32 sum of
``kh*kw`` shifted-window matmuls, the reference kernel's own arithmetic); the
CUDA kernel itself is held to that plain version on the card by
``chip_smoke.py``.  Measured here: float32 within 2.4e-6 (absolute) of the
reference kernel in interpret mode and of ``ref.conv2d_ref``, bf16 within
one bf16 ulp; the stride-2 library path equals ``lax`` in float32 and is
within one bf16 ulp in bf16; the max pool equals ``reduce_window``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro_torch.kernels import build
from repro_torch.kernels import conv2d as k2
from repro_torch.kernels import ops
from repro_torch.models import resnet

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, x_shape, w_shape, dtype, w_scale=0.1):
    """The same numbers for both packages, rounded to ``dtype`` once."""
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(rng.normal(size=x_shape).astype(np.float32), jdt)
    w = jnp.asarray((rng.normal(size=w_shape) * w_scale).astype(np.float32),
                    jdt)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    wt = torch.from_numpy(np.array(w.astype(jnp.float32))).to(tdt)
    return x, w, xt, wt


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# --- stride 1: K2's plain version against the reference kernel -------------


@pytest.mark.parametrize("HW,cin,cout,kh", [
    (16, 8, 16, 3),
    (16, 4, 8, 1),
    (24, 8, 8, 5),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_matches_reference_kernel(HW, cin, cout, kh, dtype):
    """``tests/test_kernels.py``'s cases and tolerances: port ``ops.conv2d``
    (SAME, stride 1) vs the reference ``ops.conv2d`` running the Pallas
    kernel in interpret mode.  Measured: float32 max abs diff 9.5e-7, bf16
    1.9e-6 (one bf16 ulp, on the 5x5 case; 0 on the others)."""
    rng = np.random.default_rng(42)
    x, w, xt, wt = _pair(rng, (2, HW, HW, cin), (kh, kh, cin, cout), dtype)
    o_ref = rops.conv2d(x, w, padding="SAME", interpret=True)
    o = ops.conv2d(xt, wt, padding="SAME")
    assert o.dtype == DTYPES[dtype][1]
    assert tuple(o.shape) == (2, HW, HW, cout)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(o), _f32(o_ref), atol=tol * 10, rtol=tol)


@pytest.mark.parametrize("h_out", [7, 14, 28])
@pytest.mark.parametrize("kh", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_any_h_out(h_out, kh, dtype):
    """ResNet-50's 28x28, 14x14 and 7x7 stages: the reference kernel's
    default ``tile_h=8`` does not divide these (it asserts), the port has no
    row tile.  Held against ``ref.conv2d_ref`` on the pre-padded input and
    against the Pallas kernel with a ``tile_h`` that divides ``H_out``.
    Measured: float32 max abs diff 2.4e-6, bf16 1.2e-4 (one bf16 ulp)."""
    rng = np.random.default_rng(h_out * 10 + kh)
    cin, cout = 16, 24
    x, w, xt, wt = _pair(rng, (2, h_out, h_out + 1, cin),
                         (kh, kh, cin, cout), dtype)
    pads = ((kh // 2, (kh - 1) // 2), (kh // 2, (kh - 1) // 2))
    xp = jnp.pad(x, ((0, 0), *pads, (0, 0)))
    o = k2.conv2d(xt, wt, padding=pads)
    assert tuple(o.shape) == (2, h_out, h_out + 1, cout)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(o), _f32(ref.conv2d_ref(xp, w)),
                               atol=tol * 10, rtol=tol)
    o_pallas = rops.conv2d(x, w, padding="SAME", tile_h=7, interpret=True)
    np.testing.assert_allclose(_f32(o), _f32(o_pallas), atol=tol * 10,
                               rtol=tol)


@pytest.mark.parametrize("padding", [((0, 0), (0, 0)), ((2, 0), (0, 3)),
                                     ((1, 1), (1, 1))])
def test_conv2d_explicit_padding_matches_valid_on_padded_input(padding):
    """The kernel's padding is a bounds check: padding (top, bottom),
    (left, right) must equal a VALID convolution of the zero-padded input,
    asymmetric and one-sided pads included."""
    rng = np.random.default_rng(7)
    x, w, xt, wt = _pair(rng, (3, 9, 11, 5), (3, 2, 5, 7), "float32")
    xp = jnp.pad(x, ((0, 0), *padding, (0, 0)))
    o = k2.conv2d(xt, wt, padding=padding)
    want = ref.conv2d_ref(xp, w)
    assert tuple(o.shape) == want.shape
    np.testing.assert_allclose(_f32(o), _f32(want), atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(3)
    _, _, xt, wt = _pair(rng, (2, 8, 8, 4), (3, 3, 4, 8), "float32")
    k2.reset_launch_counts()
    pads = ((1, 1), (1, 1))
    out = k2.conv2d(xt, wt, padding=pads)
    assert torch.equal(out, k2.conv2d_plain(xt, wt, padding=pads))
    assert k2.launch_counts() == {"conv2d_bf16_tc": 0, "conv2d_bf16_simt": 0,
                                  "conv2d_f32": 0}
    assert k2._bound is None and "conv2d.cu" not in build._libs


@pytest.mark.parametrize("case", ["float64", "mixed_dtype", "cin_mismatch",
                                  "not_contiguous", "negative_pad",
                                  "empty_output", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(1, 6, 6, 4)
    w = torch.zeros(3, 3, 4, 8)
    pads = k2.NO_PADDING
    exc = ValueError
    if case == "float64":
        x, w, exc = x.double(), w.double(), TypeError
    elif case == "mixed_dtype":
        w, exc = w.to(torch.bfloat16), TypeError
    elif case == "cin_mismatch":
        w = torch.zeros(3, 3, 5, 8)
    elif case == "not_contiguous":
        x = torch.zeros(1, 6, 4, 6).transpose(2, 3)
    elif case == "negative_pad":
        pads = ((-1, 0), (0, 0))
    elif case == "empty_output":
        x = torch.zeros(1, 2, 6, 4)
    elif case == "rank":
        x = torch.zeros(6, 6, 4)
    with pytest.raises(exc):
        k2.conv2d(x, w, padding=pads)


def test_ops_routes_stride_one_to_k2_with_same_padding(monkeypatch):
    """Stride 1 reaches the K2 wrapper with the reference's SAME padding
    ``(kh//2, (kh-1)//2)``; stride 2 never does."""
    calls = []
    real = k2.conv2d

    def spy(x, w, *, padding):
        calls.append((tuple(w.shape[:2]), padding))
        return real(x, w, padding=padding)

    monkeypatch.setattr(k2, "conv2d", spy)
    x = torch.zeros(1, 8, 8, 2)
    for kh, kw in ((3, 3), (1, 1), (4, 2)):
        ops.conv2d(x, torch.zeros(kh, kw, 2, 3), stride=1, padding="SAME")
    ops.conv2d(x, torch.zeros(3, 3, 2, 3), stride=1, padding="VALID")
    ops.conv2d(x, torch.zeros(3, 3, 2, 3), stride=2, padding="SAME")
    ops.conv2d(x, torch.zeros(1, 1, 2, 3), stride=2, padding="SAME")
    assert calls == [((3, 3), ((1, 1), (1, 1))), ((1, 1), ((0, 0), (0, 0))),
                     ((4, 2), ((2, 1), (1, 0))), ((3, 3), ((0, 0), (0, 0)))]


# --- the launch plan (pure Python: what the CUDA side is told to run) -------

# (H = W, Cin, Cout, k) of ResNet-50's 16 distinct stride-1 convolutions:
# per stage the bottleneck's 1x1 in, 3x3 (stride 1 after the first block),
# 1x1 out, and the 1x1 in of the stage's first block (stage 1 also the
# stride-1 projection 64 -> 256); 46 calls per forward
RESNET50_STRIDE1 = (
    (56, 64, 64, 1), (56, 64, 64, 3), (56, 64, 256, 1), (56, 256, 64, 1),
    (56, 256, 128, 1), (28, 128, 512, 1), (28, 512, 128, 1),
    (28, 128, 128, 3), (28, 512, 256, 1), (14, 256, 1024, 1),
    (14, 1024, 256, 1), (14, 256, 256, 3), (14, 1024, 512, 1),
    (7, 512, 2048, 1), (7, 2048, 512, 1), (7, 512, 512, 3))
H100_SMS = 132


def _same(k):
    return ((k // 2, (k - 1) // 2),) * 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("shape", RESNET50_STRIDE1,
                         ids=[f"{h}x{h}_{ci}to{co}_k{k}"
                              for h, ci, co, k in RESNET50_STRIDE1])
def test_plan_of_resnet50_shapes(shape, batch, dtype):
    """Every ResNet-50 stride-1 shape at B = 1, 8, 32 on 132 SMs: bf16
    takes the tensor-core variant (TMA for 1x1 inputs, gathers for 3x3; a
    128 x 64 tile for a short K walk, a ring no longer than the walk),
    float32 the 16-byte float32 kernel; the K slices cover the walk once, in
    order; the grid is (tiles of M, tiles of N, slices); a split plan fills
    at least one wave of resident blocks unless its slices are already
    ``MIN_SLICE_STEPS`` short, and a plan that fills a wave is not split."""
    h, cin, cout, k = shape
    tdt = DTYPES[dtype][1]
    p = k2.plan(batch, h, h, cin, cout, k, k, _same(k), tdt, H100_SMS)
    if tdt == torch.bfloat16:
        assert (p.variant, p.bk, p.bm) == (k2.TC, 64, 128)
        assert p.gather == (k == 3)
        short = p.steps <= k2.SHORT_K
        assert p.bn == (64 if cout == 64 or short else 128)
        assert p.stages == min(k2.MAX_STAGES[p.bn], p.steps) >= 1
    else:
        assert (p.variant, p.bk, p.vec) == (k2.F32, 16, 4)
        assert p.bn == (128 if cout >= 128 else 64)
    assert p.steps == k * k * -(-cin // p.bk)
    bounds = [p.slice_bounds(z) for z in range(p.split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == p.steps
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
    assert all(e - b >= k2.MIN_SLICE_STEPS or p.split == 1
               for b, e in bounds)
    m = batch * h * h
    tiles = -(-m // p.bm) * -(-cout // p.bn)
    assert p.grid == (-(-m // p.bm), -(-cout // p.bn), p.split)
    wave = H100_SMS * k2.RESIDENT[(p.variant, p.bn)]
    if tiles >= wave:
        assert p.split == 1
    else:
        cap = max(1, p.steps // k2.MIN_SLICE_STEPS)
        assert tiles * p.split >= wave or p.split == cap
        assert tiles * (p.split - 1) < wave     # the fewest slices that do


def test_plan_splits_the_small_late_stages_at_batch_one():
    """The late stages at B=1: 7x7 512->512 3x3 (4 tiles, 72 steps)
    and 14x14 1024->256 1x1 (4 tiles of 128, 16 steps) at B=1."""
    p = k2.plan(1, 7, 7, 512, 512, 3, 3, _same(3), torch.bfloat16, 132)
    assert (p.grid, p.steps) == ((1, 4, 33), 72)
    p = k2.plan(1, 14, 14, 1024, 256, 1, 1, _same(1), torch.bfloat16, 132)
    assert (p.grid, p.steps, p.gather) == ((2, 2, 8), 16, False)
    # the same shapes at B=32 fill the card without a split of 1x1 convs
    p = k2.plan(32, 56, 56, 64, 256, 1, 1, _same(1), torch.bfloat16, 132)
    assert p.split == 1


@pytest.mark.parametrize("case,variant,vec", [
    ("cin_not_8", k2.SIMT, 0), ("cout_not_8", k2.SIMT, 0),
    ("misaligned", k2.SIMT, 0), ("padded_1x1", k2.TC, 0),
    ("f32_cin_not_4", k2.F32, 1), ("f32_misaligned", k2.F32, 1),
    ("f32_ragged_ok", k2.F32, 4)])
def test_plan_routes_what_the_tensor_core_kernel_cannot_take(case, variant,
                                                             vec):
    """Decided by shape and alignment before any launch, never by a failed
    launch: bf16 with Cin or Cout not a multiple of 8, or x / w off a
    16-byte boundary, takes the SIMT kernel (no split); float32 copies 4
    bytes at a time where 16-byte copies do not fit."""
    dt = torch.float32 if case.startswith("f32") else torch.bfloat16
    b, hw, cin, cout, k, pads, ok = 2, 16, 64, 64, 3, _same(3), True
    if case == "cin_not_8":
        cin = 4
    elif case == "cout_not_8":
        cout = 12
    elif case in ("misaligned", "f32_misaligned"):
        ok = False
    elif case == "padded_1x1":
        k, pads = 1, ((1, 0), (0, 1))
    elif case == "f32_cin_not_4":
        cin = 5
    elif case == "f32_ragged_ok":
        cin, cout = 12, 20
    p = k2.plan(b, hw, hw, cin, cout, k, k, pads, dt, H100_SMS, ok)
    assert (p.variant, p.vec) == (variant, vec)
    if variant == k2.SIMT:
        assert (p.bn, p.split) == (64, 1)
    if case == "padded_1x1":
        assert p.gather       # TMA over x takes only unpadded 1x1


def test_alignment_of_a_view():
    """A contiguous view that starts one element into its storage is not
    16-byte aligned; the plan then routes bf16 to the SIMT kernel."""
    base = torch.zeros(1 + 2 * 8 * 8 * 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)
    x0 = base[:-1].view(2, 8, 8, 16)
    x1 = base[1:].view(2, 8, 8, 16)
    assert x1.is_contiguous()
    assert k2.aligned(x0, w) and not k2.aligned(x1, w)


def test_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        k2.plan(1, 8, 8, 8, 8, 3, 3, _same(3), torch.float16, 132)


# --- stride 2 and the max pool: JAX's asymmetric SAME ----------------------


@pytest.mark.parametrize("size,k,stride", [
    (224, 7, 2), (56, 3, 2), (56, 1, 2), (57, 3, 2), (15, 3, 2), (112, 3, 2),
    (113, 3, 2), (56, 3, 1), (24, 5, 1), (9, 4, 3)])
def test_same_pads_match_lax(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert ops.same_pads(size, k, stride) == tuple(want)


@pytest.mark.parametrize("H,k,cin,cout", [
    (224, 7, 3, 64),     # the stem, 224 -> 112, pads (2, 3)
    (56, 3, 16, 16),     # a stride-2 conv2, 56 -> 28, pads (0, 1)
    (56, 1, 16, 32),     # a stride-2 projection, no padding
    (57, 3, 8, 8),       # odd size, pads (1, 1)
    (15, 3, 4, 4),       # odd size, 15 -> 8
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_conv_matches_lax_same(H, k, cin, cout, dtype):
    """Stride 2 goes to the library convolution with JAX's SAME padding
    written out by ``F.pad``; PyTorch's symmetric ``padding=`` would differ
    (by 6.7 on the 56x56 3x3 case here, 9.7 on the stem).  Measured: float32
    equal, bf16 within one bf16 ulp (max abs diff 0.016)."""
    rng = np.random.default_rng(H + k)
    x, w, xt, wt = _pair(rng, (1, H, H, cin), (k, k, cin, cout), dtype)
    want = jax.lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = ops.conv2d(xt, wt, stride=2, padding="SAME")
    assert tuple(got.shape) == want.shape
    assert got.dtype == DTYPES[dtype][1]
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("H", [112, 113, 8, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_matches_reduce_window_same(H, dtype):
    """``reduce_window(max, (3, 3), (2, 2), "SAME")`` pads (0, 1) with -inf
    at 112; ``F.max_pool2d(3, 2, padding=1)`` would differ.  Exact."""
    rng = np.random.default_rng(H)
    x, _, xt, _ = _pair(rng, (2, H, H + 1, 5), (1, 1, 1, 1), dtype)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    got = resnet.max_pool_same(xt)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_f32(got), _f32(want))


# --- the build ------------------------------------------------------------


def test_conv2d_source_and_per_source_flags():
    """K2 keeps FMA contraction (it is held to a tolerance); the DSE-sweep
    kernels keep ``-fmad=false`` (held bitwise).  The flags are part of each
    library's content hash."""
    src = (build.CSRC_DIR / "conv2d.cu").read_text()
    for sym in ("conv2d_f32", "conv2d_bf16_tc", "conv2d_bf16_simt",
                "conv2d_error_string"):
        assert f"{sym}(" in src
    # every kernel of a K2 call carries the profiler's symbol for K2
    kernels = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    assert len(kernels) == 4
    assert all(k.startswith("k2_conv2d_") for k in kernels)
    assert "-fmad=false" not in build.flags("conv2d.cu")
    assert "-fmad=false" in build.flags("dse_sweep.cu")
    for s in ("conv2d.cu", "dse_sweep.cu"):
        assert build.flags(s)[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
        assert build.library_path(s).name.startswith(f"lib{s[:-3]}_")
