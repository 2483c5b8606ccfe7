"""The flash-attention kernel's plain version (K3) against the reference.

On the CPU the wrapper takes ``flash_attention_plain``, the reference
kernel's own arithmetic in tensor code; the CUDA kernel itself is held to
it on the card by ``chip_smoke.py``.  Inputs are drawn with numpy and go
through both packages.  Tolerances: float32 atol = rtol = 5e-6 and bf16
atol = rtol = 2e-2, those of ``tests/test_kernels.py`` (measured: float32
within 4e-7 of the Pallas kernel in interpret mode, bf16 within 2.5e-4).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops

TOL = {"float32": 5e-6, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """numpy draws rounded to ``dtype`` once, as (jax arrays, torch
    tensors) holding the same values."""
    rng = np.random.default_rng(seed)
    jx, tt = [], []
    for shape in shapes:
        a = jnp.asarray(rng.normal(size=shape).astype(np.float32), JNP[dtype])
        jx.append(a)
        tt.append(torch.from_numpy(np.array(a.astype(jnp.float32))
                                   ).to(TORCH[dtype]))
    return jx, tt


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("S,H,KV,hd", [
    (128, 2, 2, 32),
    (256, 4, 2, 64),
    (256, 4, 1, 64),      # MQA
    (384, 2, 2, 128),     # three blocks of 128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(S, H, KV, hd, dtype):
    """The four cases of ``tests/test_kernels.py``, B=2, against the
    reference's ``ops.flash_attention`` (the Pallas kernel, interpret mode
    on the CPU)."""
    (q, k, v), (qt, kt, vt) = _inputs(
        S + H + KV, [(2, S, H, hd), (2, S, KV, hd), (2, S, KV, hd)], dtype)
    want = rops.flash_attention(q, k, v, block_q=128, block_k=128)
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (2, S, H, hd)
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_non_causal_matches_reference_kernel(dtype):
    (q, k, v), (qt, kt, vt) = _inputs(7, [(1, 128, 2, 32)] * 3, dtype)
    want = rops.flash_attention(q, k, v, causal=False)
    _close(ops.flash_attention(qt, kt, vt, causal=False),
           want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("S", [77, 200, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_attention_ref(S, causal):
    """Any S: the reference kernel asserts S % block == 0, so the oracle is
    ``ref.attention_ref`` (one softmax over the whole row) on K / V
    repeated for GQA."""
    (q, k, v), (qt, kt, vt) = _inputs(
        S, [(1, S, 4, 32), (1, S, 2, 32), (1, S, 2, 32)], "float32")
    want = ref.attention_ref(q, jnp.repeat(k, 2, 2), jnp.repeat(v, 2, 2),
                             causal=causal)
    _close(ops.flash_attention(qt, kt, vt, causal=causal), want, "float32")


@pytest.mark.parametrize("hd,hv", [(64, 32), (32, 128)])
def test_value_width_may_differ(hd, hv):
    (q, k, v), (qt, kt, vt) = _inputs(
        hd + hv, [(2, 160, 2, hd), (2, 160, 2, hd), (2, 160, 2, hv)],
        "float32")
    got = ops.flash_attention(qt, kt, vt)
    assert tuple(got.shape) == (2, 160, 2, hv)
    _close(got, ref.attention_ref(q, k, v), "float32")


def test_scale_argument():
    (q, k, v), (qt, kt, vt) = _inputs(3, [(1, 64, 2, 32)] * 3, "float32")
    _close(ops.flash_attention(qt, kt, vt, scale=0.3),
           ref.attention_ref(q, k, v, scale=0.3), "float32")


def test_gqa_never_repeats_kv(monkeypatch):
    """The plain version receives the KV heads as given, and groups the
    query heads over them."""
    seen = []
    real = k3.flash_attention_plain

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(k3, "flash_attention_plain", spy)
    _, (qt, kt, vt) = _inputs(5, [(1, 64, 8, 32), (1, 64, 2, 32),
                                  (1, 64, 2, 32)], "float32")
    ops.flash_attention(qt, kt, vt)
    assert seen == [(8, 2, 2)]


def test_cpu_tensors_never_launch():
    k3.reset_launch_counts()
    _, (qt, kt, vt) = _inputs(1, [(1, 32, 2, 16)] * 3, "bfloat16")
    ops.flash_attention(qt, kt, vt)
    assert k3.launch_counts() == {"flash_attention_bf16_tc": 0,
                                  "flash_attention_bf16_mma": 0,
                                  "flash_attention_f32": 0,
                                  "flash_attention_bwd_bf16": 0,
                                  "flash_attention_bwd_f32": 0}
    assert k3._bound is None and k3._bwd_bound is None


@pytest.mark.parametrize("bad,err", [
    (dict(k=(1, 32, 3, 16), v=(1, 32, 3, 16)), ValueError),   # 4 % 3
    (dict(k=(1, 16, 2, 16)), ValueError),                     # other S
    (dict(q=(1, 32, 4)), ValueError),                         # not 4-D
])
def test_wrapper_rejects_bad_shapes(bad, err):
    shapes = {"q": (1, 32, 4, 16), "k": (1, 32, 2, 16), "v": (1, 32, 2, 16)}
    shapes.update(bad)
    q, k, v = (torch.zeros(shapes[n]) for n in "qkv")
    with pytest.raises(err):
        ops.flash_attention(q, k, v)


def test_wrapper_rejects_mixed_dtypes():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), q.double(), q.double())


def test_kernel_operand_copies_only_what_the_kernel_cannot_read():
    """Dense-last-dim, 16-byte aligned BSHD views go to the kernel in place
    (a slice of the sequence or of the heads included); anything else is
    copied to fresh contiguous memory first, which the kernels read in
    place -- a dense view whose base lies off 16 bytes too."""
    t = torch.zeros((2, 16, 4, 32), dtype=torch.bfloat16)
    assert k3._kernel_operand(t) is t
    assert k3._kernel_operand(t[:, 4:]).data_ptr() == t[:, 4:].data_ptr()
    heads = t[:, :, 1:3]
    assert k3._kernel_operand(heads).data_ptr() == heads.data_ptr()
    swapped = t.transpose(2, 3)
    assert k3._kernel_operand(swapped).is_contiguous()
    odd = torch.zeros((1, 8, 2, 33))[..., 1:]
    assert k3._kernel_operand(odd).data_ptr() != odd.data_ptr()
    shifted = torch.zeros(1 + 8 * 2 * 32, dtype=torch.bfloat16)[1:].view(
        1, 8, 2, 32)
    assert shifted.is_contiguous() and not k3.kernel_ready(shifted)
    for view in (odd, shifted):  # head sizes of whole 16 bytes
        copy = k3._kernel_operand(view)
        assert k3.kernel_ready(copy) and torch.equal(copy, view)


def test_cuda_source_defines_the_bound_entry_points():
    """The wrapper binds one C entry point per forward ``LAUNCHES`` key
    (and the two that also write the log-sum-exp); the source defines each,
    runs wgmma fed by TMA on the tensor-core path and mma.sync on the other
    bf16 one, names every kernel with one profiler prefix per dtype, and
    names the TPU kernel it replaces."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    for name in list(k3.FWD_VARIANTS) + [
            k3.TC + "_lse", k3.F32 + "_lse", "flash_attention_error_string"]:
        assert re.search(rf"\b{name}\(", src), name
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "setmaxnreg.dec" in src and "setmaxnreg.inc" in src
    assert "tma_load_4d(" in src and '#include "hopper.cuh"' in src
    assert "repro/kernels/flash_attention.py::_flash_kernel" in src
    assert "-1e30f" in src and "1e-30f" in src
    # each __global__ function's name opens the line after its bounds
    kernels = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert len(kernels) == src.count("__global__") == 3
    assert sorted(kernels) == ["flash_bf16_mma_kernel", "flash_bf16_tc_kernel",
                               "flash_f32_kernel"]


# --- the launch plan -------------------------------------------------------


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,dtype,want", [
    # stablelm-1.6b prefills (a), (b): 32 heads of 64; the tensor-core
    # kernel runs one persistent block an SM over 1024 / 2048 tiles
    ((1, 4096, 32, 32, 64, 64), BF16, (k3.TC, 128, 128, (132, 1))),
    ((8, 1024, 32, 32, 64, 64), BF16, (k3.TC, 128, 128, (132, 1))),
    # qwen3-14b prefill (c): 40 heads, 8 kv heads of 128: 640 tiles
    ((1, 2048, 40, 8, 128, 128), BF16, (k3.TC, 128, 128, (132, 1))),
    # stablelm float32 prefill (d) and the float32 headline shape
    ((2, 1024, 32, 32, 64, 64), F32, (k3.F32, 64, 64, (64, 16))),
    ((1, 4096, 32, 32, 64, 64), F32, (k3.F32, 64, 64, (32, 64))),
    # a ragged S rounds the tiles up: 8 x 8, fewer than the SMs
    ((2, 1000, 4, 2, 64, 64), BF16, (k3.TC, 128, 128, (64, 1))),
    ((2, 1000, 4, 2, 64, 64), F32, (k3.F32, 64, 64, (8, 16))),
])
def test_plan_of_the_model_shapes(shape, dtype, want):
    p = k3.plan(*shape, dtype)
    assert (p.variant, p.block_q, p.block_k, p.grid) == want


@pytest.mark.parametrize("shape", [
    (2, 128, 2, 2, 32, 32),      # hd 32
    (2, 256, 4, 2, 64, 32),      # hv != hd
    (2, 320, 2, 1, 32, 128),     # hd 32, hv != hd
    (2, 256, 4, 2, 128, 64),     # hv != hd, both tensor-core dims
    (1, 4096, 32, 32, 32, 32),   # hd 32 at a model's size
])
def test_plan_routes_the_rest_of_bf16_to_mma_sync(shape):
    p = k3.plan(*shape, BF16)
    b, s, h = shape[:3]
    assert (p.variant, p.block_q, p.block_k) == (k3.MMA, 64, 64)
    assert p.grid == (b * h, -(-s // 64))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        k3.plan(1, 128, 2, 2, 64, 64, dtype)


def test_plan_fits_the_persistent_grid_to_the_card():
    p = k3.plan(1, 4096, 32, 32, 64, 64, BF16, 114)
    assert p.grid == (114, 1)
    assert k3.plan(1, 4096, 32, 32, 64, 64, F32, 114).grid == (32, 64)
    # fewer tiles than SMs: one block a tile
    assert k3.plan(2, 7, 4, 2, 128, 128, BF16, 114).grid == (8, 1)


def test_plan_is_pure():
    a = k3.plan(1, 2048, 40, 8, 128, 128, BF16)
    assert k3.plan(1, 2048, 40, 8, 128, 128, BF16) is a
    assert k3.plan(1, 2048, 40, 8, 128, 128, BF16, k3.H100_SMS) == a


def test_plan_for_plans_the_operands_as_launched():
    """Every view plans by shape and dtype alone: one the kernels cannot
    read in place is copied to one they can before the launch, so a
    misaligned bf16 view takes the tensor-core kernel like any other."""
    t = torch.zeros((1, 256, 6, 64), dtype=torch.bfloat16)
    q, k, v = t[:, :, :2], t[:, :, 2:4], t[:, :, 4:]
    assert k3.plan_for(q, k, v).variant == k3.TC
    odd = torch.zeros((1, 256, 2, 72), dtype=torch.bfloat16)[..., 4:68]
    assert not k3.kernel_ready(odd)
    assert k3.kernel_ready(k3._kernel_operand(odd))
    assert k3.plan_for(odd, k[:, :, :2], v[:, :, :2]).variant == k3.TC
    assert k3.plan_for(q.float(), k.float(), v.float()).variant == k3.F32
    assert k3.plan_for(q[..., :32], k[..., :32], v[..., :32]).variant == k3.MMA


def test_library_name_hashes_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """An edited header gives every source that includes it, directly or
    through another header, a new library name."""
    (tmp_path / "a.cu").write_text('#include "x.cuh"\nint a;\n')
    (tmp_path / "x.cuh").write_text('#include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text("// v1\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.local_headers("a.cu") == ["x.cuh", "y.cuh"]
    assert build.local_headers("b.cu") == []
    a1, b1 = build.library_path("a.cu"), build.library_path("b.cu")
    (tmp_path / "y.cuh").write_text("// v2\n")
    assert build.library_path("a.cu") != a1
    assert build.library_path("b.cu") == b1


def test_flash_and_conv_sources_share_the_hopper_header():
    for src in (k3.SOURCE, "conv2d.cu", k3.BWD_SOURCE, "ssd_scan.cu"):
        assert "hopper.cuh" in build.local_headers(src)
