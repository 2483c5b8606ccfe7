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
from repro.models import layers as rL
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
            k3.TC + "_lse", k3.F32 + "_lse", k3.F32_TC_ENTRY,
            k3.F32_TC_ENTRY + "_lse", "flash_attention_error_string"]:
        assert re.search(rf"\b{name}\(", src), name
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "setmaxnreg.dec" in src and "setmaxnreg.inc" in src
    assert "tma_load_4d(" in src and '#include "hopper.cuh"' in src
    assert "repro/kernels/flash_attention.py::_flash_kernel" in src
    assert "-1e30f" in src and "1e-30f" in src
    # each __global__ function's name opens the line after its bounds
    kernels = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert len(kernels) == src.count("__global__") == 6
    assert sorted(kernels) == ["flash_bf16_mma_kernel", "flash_bf16_tc_kernel",
                               "flash_f32_kernel", "flash_f32_split_kernel",
                               "flash_f32_tc_kernel", "flash_f32_vt_kernel"]


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


# --- keys apart from the queries (cross attention) ----------------------------

# (B, Sq, Sk, H, KV, hd): fewer queries than keys over several kv blocks of
# 128; more queries than keys, ragged, GQA; ragged both, GQA G = 3 over
# 1000 keys (the card's ragged cross case)
CROSS_SHAPES = [(1, 48, 300, 4, 4, 32), (2, 200, 77, 4, 2, 16),
                (2, 77, 1000, 6, 2, 64)]


@pytest.mark.parametrize("shape", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_length_matches_attention_ref(shape, dtype):
    """q [B, Sq, H, hd] over k, v [B, Sk, KV, hd], not causal: the plain
    version against ``ref.attention_ref(..., causal=False)`` on K / V
    repeated for GQA."""
    b, sq, sk, h, kv, d = shape
    (q, k, v), (qt, kt, vt) = _inputs(
        sq + sk, [(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)], dtype)
    g = h // kv
    want = ref.attention_ref(q, jnp.repeat(k, g, 2), jnp.repeat(v, g, 2),
                             causal=False)
    got = ops.flash_attention(qt, kt, vt, causal=False)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, sq, h, d)
    _close(got, want.astype(jnp.float32), dtype)


def test_cross_length_value_width_may_differ():
    (q, k, v), (qt, kt, vt) = _inputs(
        9, [(2, 40, 2, 64), (2, 130, 2, 64), (2, 130, 2, 32)], "float32")
    got = ops.flash_attention(qt, kt, vt, causal=False)
    assert tuple(got.shape) == (2, 40, 2, 32)
    _close(got, ref.attention_ref(q, k, v, causal=False), "float32")


def test_causal_with_another_key_length_raises():
    """Causal attention between lengths has no alignment in the reference:
    the wrapper, the plain versions, the work counts and the plans
    refuse it."""
    q, k = torch.zeros((1, 16, 2, 16)), torch.zeros((1, 24, 2, 16))
    for fn in (ops.flash_attention, k3.flash_attention,
               k3.flash_attention_plain, k3.flash_attention_fwd):
        with pytest.raises(ValueError, match="causal"):
            fn(q, k, k)
        fn(q, k, k, causal=False)
    with pytest.raises(ValueError, match="causal"):
        k3._validate(q, k, k, True)
    with pytest.raises(ValueError, match="causal"):
        k3.fwd_work(1, 16, 2, 2, 16, 16, True, F32, sk=24)


def test_cross_length_work_equals_closed_forms():
    """``fwd_work`` counts Sq Sk pairs when not causal, q and o bytes by Sq
    and k and v bytes by Sk; with Sk == Sq (or None) it is what it was."""
    b, sq, sk, h, kv, hd, hv = 2, 448, 1500, 12, 4, 64, 32
    el = 2
    flops, nbytes = k3.fwd_work(b, sq, h, kv, hd, hv, False, BF16, sk=sk)
    assert flops == (2 * hd + 2 * hv) * b * h * sq * sk
    assert nbytes == el * b * (sq * h * (hd + hv) + sk * kv * (hd + hv))
    _, with_lse = k3.fwd_work(b, sq, h, kv, hd, hv, False, BF16, lse=True,
                              sk=sk)
    assert with_lse == nbytes + 4 * b * h * sq
    for causal in (True, False):
        same = k3.fwd_work(b, sq, h, kv, hd, hv, causal, F32)
        assert k3.fwd_work(b, sq, h, kv, hd, hv, causal, F32, sk=sq) == same
        pairs = sq * (sq + 1) // 2 if causal else sq * sq
        assert same == ((2 * hd + 2 * hv) * b * h * pairs,
                        4 * b * sq * (h * hd + h * hv + kv * hd + kv * hv))
    # the census's whisper cross entry: B=1, 448 queries over 1500 frames
    flops, nbytes = k3.fwd_work(1, 448, 12, 12, 64, 64, False, BF16,
                                sk=1500)
    assert flops == 2_064_384_000 and nbytes == 5_984_256


def test_cross_length_plan_walks_the_query_rows():
    """The forward's tiles are query rows: the plan of a cross call is the
    plan of its queries, whatever the key length."""
    q = torch.zeros((1, 448, 12, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1500, 12, 64), dtype=torch.bfloat16)
    assert k3.plan_for(q, k, k) == k3.plan(1, 448, 12, 12, 64, 64, BF16)
    assert k3.plan_for(q, k, k).grid == (12 * 4, 1)
    assert k3.plan_for(q.float(), k.float(), k.float()).grid == (12, 7)


def test_cuda_sources_take_the_key_length():
    """Every forward and backward C entry point takes S and Sk, and the
    K / V tensor maps are encoded over Sk rows."""
    for source, names in ((k3.SOURCE, list(k3.FWD_VARIANTS)
                           + [k3.TC + "_lse", k3.F32 + "_lse"]),
                          (k3.BWD_SOURCE, list(k3.BWD_VARIANTS))):
        src = (build.CSRC_DIR / source).read_text()
        for name in names:
            m = re.search(rf"\nint {name}\(([^)]*)\)", src)
            assert m and re.search(r"int S, int Sk, int H", " ".join(
                m[1].split())), name
        assert re.search(r"encode_bshd\(&tm_k, [^;]*\bSk\b", src)
        assert re.search(r"encode_bshd\(&tm_v, [^;]*\bSk\b", src)


# --- the bidirectional prefix and head dim 256 (paligemma) -----------------------

# (B, S, H, KV, d): MQA and GQA at head dims 16, 64 and 256; S within the
# reference's first chunk (min(1024, S)), where its XLA attention is the
# exact prefix mask
PREFIX_SHAPES = [(2, 40, 4, 1, 16), (1, 72, 4, 2, 64), (1, 36, 2, 1, 256)]


@pytest.mark.parametrize("shape", PREFIX_SHAPES)
@pytest.mark.parametrize("prefix", ["0", "1", "7", "S"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_matches_reference_xla_attention(shape, prefix, dtype):
    """``prefix_len`` P: key ``j`` visible to row ``i`` where ``j <= i`` or
    ``j < P`` -- the plain version against the reference's XLA attention
    (``layers.flash_attention(..., prefix_len=P)``, the oracle of the
    prefix: the reference's TPU kernel has no prefix rule)."""
    b, s, h, kv, d = shape
    p = s if prefix == "S" else int(prefix)
    (q, k, v), (qt, kt, vt) = _inputs(s + d + p, [(b, s, h, d), (b, s, kv, d),
                                                  (b, s, kv, d)], dtype)
    want = rL.flash_attention(q, k, v, scale=d ** -0.5, prefix_len=p)
    got = ops.flash_attention(qt, kt, vt, prefix_len=p)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, s, h, d)
    _close(got, want.astype(jnp.float32), dtype)


def test_prefix_of_the_whole_sequence_is_full_attention():
    """P >= S opens every pair: the causal call with the prefix equals the
    non-causal one bitwise; P = 0 is plain causal attention."""
    _, (qt, kt, vt) = _inputs(11, [(2, 50, 4, 32), (2, 50, 2, 32),
                                   (2, 50, 2, 32)], "float32")
    full = ops.flash_attention(qt, kt, vt, causal=False)
    for p in (50, 51, 1000):
        assert torch.equal(ops.flash_attention(qt, kt, vt, prefix_len=p),
                           full)
    assert torch.equal(ops.flash_attention(qt, kt, vt, prefix_len=0),
                       ops.flash_attention(qt, kt, vt))


def test_prefix_needs_causal_attention_over_its_own_keys():
    q, k = torch.zeros((1, 16, 2, 16)), torch.zeros((1, 24, 2, 16))
    for fn in (ops.flash_attention, k3.flash_attention,
               k3.flash_attention_plain, k3.flash_attention_fwd):
        with pytest.raises(ValueError, match="prefix"):
            fn(q, q, q, causal=False, prefix_len=3)
        with pytest.raises(ValueError, match="causal"):
            fn(q, k, k, prefix_len=3)
        with pytest.raises(ValueError, match="prefix"):
            fn(q, q, q, prefix_len=-1)
    with pytest.raises(ValueError, match="prefix"):
        k3.fwd_work(1, 16, 2, 2, 16, 16, False, F32, prefix=3)


@pytest.mark.parametrize("s,p", [(1, 0), (1, 1), (40, 0), (40, 1), (40, 7),
                                 (40, 40), (40, 90), (300, 77), (4096, 256)])
def test_pairs_count_the_visible_pairs(s, p):
    """``_pairs`` (and so ``fwd_work`` and ``bwd_work``, the census's K3
    entries) counts the pairs of the mask: S(S+1)/2 causal pairs plus
    P(P-1)/2 opened above the diagonal, against a brute-force count."""
    if s <= 300:
        i = np.arange(s)[:, None]
        j = np.arange(s)[None, :]
        want = int(((j <= i) | (j < p)).sum())
    else:
        want = 8_423_296                 # paligemma: 256 patches + 3,840
    assert k3._pairs(s, True, prefix=p) == want
    b, h, kv, d = 2, 8, 1, 256
    assert k3.fwd_work(b, s, h, kv, d, d, True, BF16, prefix=p)[0] == \
        4 * d * b * h * want
    assert k3.bwd_work(b, s, h, kv, d, d, True, BF16, prefix=p)[0] == \
        10 * d * b * h * want
    # the bytes do not depend on the mask
    assert k3.fwd_work(b, s, h, kv, d, d, True, BF16, prefix=p)[1] == \
        k3.fwd_work(b, s, h, kv, d, d, True, BF16)[1]


@pytest.mark.parametrize("dtype,want", [
    # bf16 on wgmma: 128 query rows a tile, kv tiles of 64 keys (S of 128
    # would not fit the registers beside O's 128), 256 tiles walked by one
    # persistent block an SM
    (BF16, (k3.TC, 128, 64, (132, 1))),
    # float32 as 3xTF32 on wgmma: 64 x 64 tiles, 512 of them walked by one
    # persistent block an SM (was the CUDA cores' (8, 64) grid)
    (F32, (k3.F32, 64, 64, (132, 1)))])
def test_plan_routes_head_dim_256(dtype, want):
    """paligemma's shape, hd = hv = 256; the prefix does not change the
    plan; float32 takes the wgmma kernel's own C entry point, counted under
    the float32 variant's key."""
    p = k3.plan(1, 4096, 8, 1, 256, 256, dtype)
    assert (p.variant, p.block_q, p.block_k, p.grid) == want
    assert p.entry == (k3.F32_TC_ENTRY if dtype == F32 else None)
    q = torch.zeros((1, 4096, 8, 256), dtype=dtype)
    k = torch.zeros((1, 4096, 1, 256), dtype=dtype)
    assert k3.plan_for(q, k, k) == p


def test_tc_plan_at_head_dim_256_matches_the_source_constants():
    """The ``wgmma`` forward's kv tile (``tc_bn``: 64 keys at 256, 128 at 64,
    128 and deepseek's (192, 128)) is the plan's ``block_k``; its shared
    memory, evaluated from ``tc_smem_bytes`` -- Q of 128 rows, two K / V
    stages of 64 keys at 256; at (192, 128) Q 48 KB, two K stages of 48 KB
    and two V stages of 32 KB -- fits a block's 227 KB; each consumer
    warpgroup's rows start on a kv tile boundary (``tc_tiles_align``), so
    only its first tile is masked."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    m = re.search(r"tc_bn\(\) {\s*return D == 256 \? (\d+) : (\d+);", src)
    assert m and (int(m[1]), int(m[2])) == (k3._tc_bn(256), k3._tc_bn(64)) \
        == (64, 128)
    m = re.search(r"tc_stages\(\) {\s*return D == 64 \? (\d+) : (\d+);", src)
    assert m
    body = re.search(r"constexpr int tc_smem_bytes\(\) {\s*return (.*?);",
                     src, re.S)[1]
    for hd, hv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        expr = body.replace("tc_stages<HD>()", m[1] if hd == 64 else m[2])
        expr = expr.replace("tc_bn<HD>()", str(k3._tc_bn(hd)))
        expr = re.sub(r"\bHD\b", str(hd), expr)
        expr = re.sub(r"\bHV\b", str(hv), expr).replace("kTcBM", "128")
        expr = " ".join(expr.split()).replace("/", "//")
        assert re.fullmatch(r"[\d\s+*/()]+", expr), expr
        assert eval(expr) <= 232_448
        assert k3.plan(1, 4096, 8, 8, hd, hv, BF16).block_k == \
            k3._tc_bn(hd)
        if (hd, hv) == (192, 128):
            assert eval(expr) == 1024 + 48 * 1024 + 2 * (48 + 32) * 1024 + \
                10 * 8
    assert "static_assert(tc_tiles_align<64>() && tc_tiles_align<128>() &&" \
        in src
    # paligemma's B=8 prefill: 512 tiles of 128 rows on the 132 SMs
    assert k3.plan(8, 1024, 8, 1, 256, 256, BF16) == k3.Plan(
        k3.TC, 128, 64, (132, 1))


def test_head_dim_256_only_with_an_equal_value_width():
    """The kernels take head dim 256 only with hd == hv (the model shape);
    the wrapper refuses the rest before any launch -- here on the meta
    device, where the plan's route runs without a card."""
    for hd, hv in ((256, 64), (64, 256), (192, 192)):
        q = torch.zeros((1, 8, 2, hd), device="meta")
        v = torch.zeros((1, 8, 2, hv), device="meta")
        with pytest.raises(ValueError, match="head dims"):
            k3.flash_attention(q, q, v)
    q = torch.zeros((1, 8, 2, 256), device="meta")
    assert tuple(k3.flash_attention(q, q, q, prefix_len=4).shape) == \
        (1, 8, 2, 256)


def test_cuda_sources_take_the_prefix():
    """Every forward and backward C entry point takes ``int prefix`` after
    ``causal``; every kernel's mask goes through ``hidden`` and its
    horizon through ``causal_end``."""
    for source, names in ((k3.SOURCE, list(k3.FWD_VARIANTS)
                           + [v + "_lse" for v in k3.LSE_VARIANTS]),
                          (k3.BWD_SOURCE, list(k3.BWD_VARIANTS))):
        src = (build.CSRC_DIR / source).read_text()
        for name in names:
            m = re.search(rf"\nint {name}\(([^)]*)\)", src)
            assert m and re.search(r"int causal, int prefix,", " ".join(
                m[1].split())), name
        assert "int prefix;" in src and "causal_end(p, " in src
        code = re.sub(r"//[^\n]*", "", src)
        assert not re.search(r"causal && key > row\)", code)


# --- deepseek's MLA: head dims (192, 128) ----------------------------------------


MLA_SHAPES = [(2, 40, 2, 2), (1, 300, 2, 2)]     # (B, S, H == KV)


@pytest.mark.parametrize("shape", MLA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_head_dims_match_reference_xla_attention(shape, causal, dtype):
    """q / k of 192 columns (128 nope + 64 rope), v of 128, H == KV, the
    softmax scale 192 ** -0.5 (``mla.py``): the plain version against the
    reference's XLA attention (causal: ``layers.flash_attention``, what
    ``mla_prefill`` calls) or its TPU kernel's oracle (not causal:
    ``kernels/ref.py``); this file's tolerances."""
    b, s, h = shape[:3]
    (q, k, v), (qt, kt, vt) = _inputs(s + h, [(b, s, h, 192), (b, s, h, 192),
                                              (b, s, h, 128)], dtype)
    scale = 192 ** -0.5
    if causal:
        want = rL.flash_attention(q, k, v, scale=scale)
    else:
        want = ref.attention_ref(q, k, v, causal=False, scale=scale)
    got = ops.flash_attention(qt, kt, vt, causal=causal, scale=scale)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, s, h, 128)
    _close(got, jnp.asarray(want).astype(jnp.float32), dtype)


@pytest.mark.parametrize("shape,dtype,want", [
    # deepseek v2 / v3 prefill (a): B=1 S=4096, 128 heads: 4096 tiles of
    # 128 rows, kv tiles of 128 keys, on the wgmma kernel
    ((1, 4096, 128, 128, 192, 128), BF16, (k3.TC, 128, 128, (132, 1))),
    ((8, 1024, 128, 128, 192, 128), BF16, (k3.TC, 128, 128, (132, 1))),
    # float32 on the 3xTF32 wgmma kernel: 8,192 tiles of 64 rows, kv tiles
    # of 64 keys, one persistent block an SM
    ((1, 4096, 128, 128, 192, 128), F32, (k3.F32, 64, 64, (132, 1))),
    ((2, 300, 4, 4, 192, 128), BF16, (k3.TC, 128, 128, (24, 1))),
    # a ragged float32 call: 2 x 4 heads x 16 tiles, fewer than the SMs
    ((2, 1000, 4, 4, 192, 128), F32, (k3.F32, 64, 64, (128, 1))),
])
def test_plan_routes_mla_head_dims(shape, dtype, want):
    p = k3.plan(*shape, dtype)
    assert (p.variant, p.block_q, p.block_k, p.grid) == want
    # the float32 wgmma kernel has a C entry point of its own, counted under
    # the float32 variant's LAUNCHES key
    assert p.entry == (k3.F32_TC_ENTRY if dtype == F32 else None)


def test_mla_pair_is_the_only_rectangular_pair_past_128():
    """(192, 128) is taken everywhere -- forward, the LSE forward and the
    backward (on meta, the plan's route without a card); (192, 192),
    (128, 192) and (192, 64) stay refused before any launch."""
    assert k3.RECT_PAIRS == ((192, 128),)
    q = torch.zeros((1, 8, 2, 192), device="meta")
    v = torch.zeros((1, 8, 2, 128), device="meta")
    assert tuple(k3.flash_attention(q, q, v, scale=0.1).shape) == \
        (1, 8, 2, 128)
    o, lse = k3.flash_attention_fwd(q, q, v)
    assert tuple(o.shape) == (1, 8, 2, 128) and tuple(lse.shape) == (1, 2, 8)
    for hd, hv in ((192, 192), (128, 192), (192, 64)):
        qq = torch.zeros((1, 8, 2, hd), device="meta")
        vv = torch.zeros((1, 8, 2, hv), device="meta")
        with pytest.raises(ValueError, match="head dims"):
            k3.flash_attention(qq, qq, vv)


def test_mla_instances_are_in_the_sources():
    """The bf16 wgmma kernel and the float32 wgmma kernel have (192, 128)
    instances, with and without the LSE; the bf16 kernel's tiles align at
    192."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    for inst in ("launch_tc<192, 128, false>", "launch_tc<192, 128, true>",
                 "launch_f32_tc<192, 128, true>",
                 "launch_f32_tc<192, 128, false>",
                 "flash_f32_tc_kernel<HD, HV, kLse>"):
        assert inst in src, inst
    # the CUDA-core float32 kernel no longer takes (192, 128)
    assert "launch_f32<192, 128" not in src
    assert "tc_tiles_align<192>()" in src
    assert "tc_smem_bytes<192, 128>() <= 232448" in src


def _tc_tile_loads(bh, nq, ctas, group):
    """Each persistent block's work (kv tiles of 128 keys) under
    ``flash_attention.cu``'s order: ``tile_of`` (groups of ``group`` heads,
    inside a group q-block by q-block from the heaviest) dealt round by
    round, the blocks in reverse order on odd rounds; and every tile's
    (head, q-block) once."""
    seen, loads = set(), [0] * ctas
    for j in range(-(-bh * nq // ctas)):
        for c in range(ctas):
            lin = j * ctas + (c if j % 2 == 0 else ctas - 1 - c)
            if lin >= bh * nq:
                continue
            g = lin // (group * nq)
            size = min(group, bh - g * group)
            r = lin - g * group * nq
            head, qb = g * group + r % size, nq - 1 - r // size
            seen.add((head, qb))
            loads[c] += qb + 1
    assert len(seen) == bh * nq
    return loads


def test_tc_tile_order_goes_head_by_head_past_the_l2():
    """The wgmma forward runs its tiles head by head (``tc_group`` 1) where
    the K and V a round of the grid streams in q-block order -- as many
    heads as blocks, their kv heads' K and V -- pass ``kL2Group`` (64 MB,
    ``L2_GROUP_BYTES``): deepseek's prefills (a) and (b); every other model
    shape keeps one group.  Head by head, the rounds' alternating order
    keeps every block within 4 % of the even split at deepseek's shapes."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    assert "constexpr int64_t kL2Group = 64ll << 20;" in src
    assert k3.L2_GROUP_BYTES == 64 << 20
    assert "p.group = tc_group(B, Sk, H, KV, hd, hv, gx);" in src
    assert "return round_bytes > kL2Group ? 1 : B * H;" in src

    def round_bytes(b, s, h, kv, hd, hv):
        heads = min(k3.plan(b, s, h, kv, hd, hv, BF16).grid[0], b * h)
        return -(-heads // (h // kv)) * s * (hd + hv) * 2

    grouped = {(b, s, h, kv, hd, hv): round_bytes(b, s, h, kv, hd, hv)
               > k3.L2_GROUP_BYTES for b, s, h, kv, hd, hv in (
                   (1, 4096, 128, 128, 192, 128), (8, 1024, 128, 128, 192,
                                                   128),
                   (1, 4096, 32, 32, 64, 64), (8, 1024, 32, 32, 64, 64),
                   (1, 2048, 40, 8, 128, 128), (1, 4096, 8, 1, 256, 256),
                   (8, 1024, 8, 1, 256, 256), (8, 1500, 12, 12, 64, 64))}
    assert [k[:3] for k, v in grouped.items() if v] == [
        (1, 4096, 128), (8, 1024, 128)]
    for b, s in ((1, 4096), (8, 1024)):
        nq = -(-s // 128)
        loads = _tc_tile_loads(b * 128, nq, k3.H100_SMS, 1)
        assert max(loads) <= 1.04 * sum(loads) / len(loads)
        # one group of every head: the same tiles, evenly spread as well
        loads = _tc_tile_loads(b * 128, nq, k3.H100_SMS, b * 128)
        assert max(loads) <= 1.04 * sum(loads) / len(loads)


def test_mla_work_counts_each_width_once():
    """``fwd_work`` at (192, 128): (2 hd + 2 hv) B H pairs, q and k read at
    192 columns, v and o at 128."""
    flops, nbytes = k3.fwd_work(1, 4096, 128, 128, 192, 128, True, BF16)
    pairs = 4096 * 4097 // 2
    assert flops == (2 * 192 + 2 * 128) * 128 * pairs
    assert nbytes == 2 * 4096 * 128 * (192 + 128 + 192 + 128)


# --- the float32 wgmma kernel's arithmetic, emulated ------------------------------


def _tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, on the 13 low mantissa bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_tf32(a, b, passes=3, acc=None):
    """``a @ b`` (batched float32) as the wgmma kernel's tensor cores do it,
    into a float32 accumulator (``_add_truncated``) -- fresh, or ``acc``
    where a chunk is chained onto the one before: the small terms first,
    lo(a) hi(b) and hi(a) lo(b) of every k8 step, then hi(a) hi(b) of every
    step (``passes`` 1: hi(a) hi(b) alone, one-pass TF32)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    steps = range(0, a.shape[-1], 8)
    terms = [(x, y, k0) for k0 in steps for x, y in ((al, bh), (ah, bl))
             ] if passes == 3 else []
    terms += [(ah, bh, k0) for k0 in steps]
    if acc is None:
        acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for x, y, k0 in terms:
        acc = _add_truncated(acc, np.matmul(
            x[..., k0:k0 + 8].astype(np.float64),
            y[..., k0:k0 + 8, :].astype(np.float64)))
    return acc


def _add_truncated(acc, step):
    """acc + step rounded toward zero to float32: the tensor cores add each
    product's k8 sum into a float32 accumulator without rounding to
    nearest."""
    exact = acc.astype(np.float64) + step
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _scores_tf32(qt, kk, passes):
    """S of a 64 x 64 tile as ``flash_f32_tc_kernel`` sums it, over 64-column
    K chunks: at hd 192 each chunk a fresh accumulator, (c0 + c1) + c2 in
    float32; at hd 256 chunks 0, 1 chained in one accumulator and 2, 3 in
    another, added in float32."""
    kt = kk.swapaxes(-1, -2)
    hd = qt.shape[-1]
    if hd == 256:
        pair = [None, None]
        for c in range(4):
            pair[c // 2] = _mm_tf32(qt[..., 64 * c:64 * c + 64],
                                    kt[..., 64 * c:64 * c + 64, :], passes,
                                    pair[c // 2])
        return pair[0] + pair[1]
    chunks = [_mm_tf32(qt[..., c:c + 64], kt[..., c:c + 64, :], passes)
              for c in range(0, hd, 64)]
    return (chunks[0] + chunks[1]) + chunks[2]


def _emulated_f32_tc(q, k, v, causal, scale, passes=3, prefix=0):
    """``flash_f32_tc_kernel`` in numpy, q [B, S, H, hd], k [B, S, KV, hd],
    v [B, S, KV, hv] at (192, 128) or hd = hv = 256, GQA by the kv head h //
    (H / KV): kv tiles of 64 keys from the last visible one down (causal:
    the rows' last key or the prefix's, whichever lies further); S of a
    tile as ``_scores_tf32``; for a positive scale masked scores -inf, the
    row max over the raw scores, p = 2^(s scale log2 e - m); else s scaled
    by scale log2 e first, masked scores -1e30, p = 2^(s - m); P V of a tile
    a fresh 3xTF32 accumulator (at hv 256 32 columns at a time, which
    changes no column's sum), O = O corr + P V; O / max(l, 1e-30)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    heads = lambda t: np.ascontiguousarray(t.transpose(0, 2, 1, 3))
    qh = heads(q)
    kh, vh = heads(k)[:, np.arange(h) // g], heads(v)[:, np.arange(h) // g]
    sl2 = np.float32(scale) * np.float32(1.4426950408889634)
    fold = sl2 > 0
    out = np.zeros(vh.shape[:2] + (s, vh.shape[-1]), np.float32)
    rows = np.arange(s)
    for q0 in range(0, s, 64):
        qt = qh[:, :, q0:q0 + 64]
        r = rows[q0:q0 + 64]
        end = max(min(q0 + 64, s), min(prefix, s)) if causal else s
        n_kv = -(-end // 64)
        o = np.zeros(qt.shape[:3] + (vh.shape[-1],), np.float32)
        m = np.full(qt.shape[:3], -1e30, np.float32)
        l = np.zeros(qt.shape[:3], np.float32)
        for kt in range(n_kv - 1, -1, -1):
            kk, vv = kh[:, :, kt * 64:kt * 64 + 64], vh[:, :, kt * 64:
                                                         kt * 64 + 64]
            sc = _scores_tf32(qt, kk, passes)
            if not fold:
                sc = sc * sl2
            key = np.arange(kt * 64, kt * 64 + kk.shape[2])
            if causal:
                seen = (key[None, :] <= r[:, None]) | (key[None, :] < prefix)
                sc = np.where(seen, sc, -np.inf if fold else np.float32(-1e30))
            row_max = sc.max(-1) * sl2 if fold else sc.max(-1)
            m_new = np.maximum(m, row_max)
            corr = np.exp2(m - m_new)
            p = np.exp2((sc * sl2 if fold else sc) - m_new[..., None]
                        ).astype(np.float32)
            l = l * corr + p.sum(-1, dtype=np.float32)
            m = m_new
            o = o * corr[..., None] + _mm_tf32(p, vv, passes)
        out[:, :, q0:q0 + 64] = o / np.maximum(l, np.float32(1e-30))[..., None]
    return out.transpose(0, 2, 1, 3)


def _f32_tc_against_references(b, s, h, causal, scale, kv=None, hd=192,
                               hv=128, prefix=0, seed=None):
    """The emulated kernel (``_emulated_f32_tc``) on seeded inputs (kv heads
    ``kv``, default ``h``); returns its output, the plain version's, a
    float64 attention's, the reference's XLA attention's (non-causal: its
    bidirectional prefix over the whole sequence) and the one-pass-TF32
    emulation's."""
    kv = h if kv is None else kv
    rng = np.random.default_rng(s + h if seed is None else seed)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hv)).astype(np.float32)
    got = _emulated_f32_tc(q, k, v, causal, scale, prefix=prefix)
    plain = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal, scale=scale,
                                prefix_len=prefix).numpy()
    g = h // kv
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                   np.repeat(k, g, 2).astype(np.float64)) * scale
    if causal:
        i, j = np.arange(s)[:, None], np.arange(s)[None, :]
        sc = np.where((j <= i) | (j < prefix), sc, -np.inf)
    pr = np.exp(sc - sc.max(-1, keepdims=True))
    want64 = np.einsum("bhqk,bkhd->bqhd", pr / pr.sum(-1, keepdims=True),
                       np.repeat(v, g, 2).astype(np.float64))
    want_jax = np.asarray(rL.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        prefix_len=prefix if causal else s))
    one_pass = _emulated_f32_tc(q, k, v, causal, scale, passes=1,
                                prefix=prefix)
    return got, plain, want64, want_jax, one_pass


@pytest.mark.parametrize("b,s,h,causal", [
    (1, 150, 2, True),      # ragged: a partial last tile, the diagonal
    (2, 64, 2, True),       # one tile
    (1, 130, 2, False),     # ragged, every key of every row
])
def test_3xtf32_forward_holds_the_float32_gate(b, s, h, causal):
    """The float32 wgmma kernel's arithmetic at (192, 128) -- S and P V as
    3xTF32 with cvt.rna splits, in k8 steps, fresh accumulators per chunk
    and tile -- stays within 1e-5 of scale (``chip_smoke.py``'s float32
    gate) of the plain version, of float64 and of the reference's XLA
    attention (non-causal: its bidirectional prefix over the whole
    sequence); one-pass TF32 in the same place misses that gate."""
    got, plain, want64, want_jax, one_pass = _f32_tc_against_references(
        b, s, h, causal, 192 ** -0.5)
    assert got.shape == plain.shape == want64.shape == want_jax.shape
    for ref_ in (plain, want64, want_jax):
        assert np.abs(got - ref_).max() <= 1e-5 * np.abs(ref_).max()
    assert np.abs(one_pass - want64).max() > 1e-5 * np.abs(want64).max()


# (B, S, H, KV, prefix) at hd = hv = 256, scale 1/16, causal: paligemma's
# MQA with its patches' prefix (a ragged S, the prefix past the first
# tile), GQA KV = 2 with a ragged prefix, plain causal MQA
D256_EMULATED = [(1, 300, 4, 1, 256), (1, 200, 4, 2, 77), (2, 130, 2, 1, 0)]


@pytest.mark.parametrize("b,s,h,kv,prefix", D256_EMULATED)
def test_3xtf32_forward_at_head_dim_256_holds_the_float32_gate(b, s, h, kv,
                                                              prefix):
    """The hd-256 kernel's arithmetic (``flash_f32_tc_kernel<256, 256>``: S
    of two chained pairs of 64-column chunks, P V in fresh 3xTF32
    accumulators added in float32, the prefix's horizon and mask, GQA)
    stays within 1e-5 of scale of the plain version, of float64 and of the
    reference's XLA attention with the same prefix; one-pass TF32 misses
    that gate."""
    got, plain, want64, want_jax, one_pass = _f32_tc_against_references(
        b, s, h, True, 256 ** -0.5, kv=kv, hd=256, hv=256, prefix=prefix)
    assert got.shape == plain.shape == want64.shape == want_jax.shape
    for ref_ in (plain, want64, want_jax):
        assert np.abs(got - ref_).max() <= 1e-5 * np.abs(ref_).max()
    assert np.abs(one_pass - want64).max() > 1e-5 * np.abs(want64).max()


@pytest.mark.parametrize("scale", [0.3, -0.2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv,hd,hv", [(4, 192, 128), (2, 256, 256)])
def test_3xtf32_forward_holds_the_float32_gate_at_other_scales(scale, causal,
                                                               kv, hd, hv):
    """As ``test_3xtf32_forward_holds_the_float32_gate`` at ``chip_smoke.py``'s
    other softmax scales (a positive scale folded into the exp2, a negative
    one multiplied first) on its scale shapes, B=1 S=300 H=4 at (192, 128)
    and at hd 256 (KV = 2).  The plain version's own distance from float64
    is printed: at these scales the scores reach ~15 (~20 at 256), and its
    float32 sums over 192 columns move its output by ~1e-5 of scale on
    their own, so at (192, 128) the emulated kernel, with a fresh
    accumulator a 64-column chunk of S, lies closer to float64 than the
    plain version does.  At 256, whose S chains two chunks in each of two
    accumulators, the two lie about as far (~3e-6 of scale at 0.3), both
    within 1e-5 of scale of float64."""
    got, plain, want64, want_jax, one_pass = _f32_tc_against_references(
        1, 300, 4, causal, scale, kv=kv, hd=hd, hv=hv,
        seed=None if hd == 192 else 300 + 4 + hd)
    assert got.shape == plain.shape == want64.shape == want_jax.shape
    scale64 = np.abs(want64).max()
    print(f"hd {hd} scale {scale} causal {causal}: emulated - float64 "
          f"{np.abs(got - want64).max() / scale64:.3e}, plain - float64 "
          f"{np.abs(plain - want64).max() / scale64:.3e} of scale")
    for ref_ in (plain, want64, want_jax):
        assert np.abs(got - ref_).max() <= 1e-5 * np.abs(ref_).max()
    assert np.abs(plain - want64).max() <= 1e-5 * scale64
    if hd == 192:
        assert np.abs(got - want64).max() < np.abs(plain - want64).max()
    assert np.abs(one_pass - want64).max() > 1e-5 * np.abs(want64).max()


def test_f32_tc_plan_matches_the_source_constants():
    """The float32 wgmma kernel at (192, 128) and at hd 256: the plan's tile
    is the source's (kF3Rows, kF3Keys), its ring slots ``f32_tc_slots`` (4
    beside (192, 128)'s Q, 3 beside hd 256's), its shared memory --
    evaluated from ``f32_tc_smem_bytes``: Q's hi and lo (96 or 128 KB), the
    32 KB ring slots, the mbarriers, the 1 KiB alignment -- is
    ``k3.f32_tc_smem`` and fits a block's 227 KB, and the scratch the
    wrapper allocates is the pre-pass's layout over the B KV kv heads (k
    split; v transposed and split, keys rounded up to a tile; q the kernel
    splits in shared memory)."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    const = {name: int(val) for name, val in re.findall(
        r"constexpr int (kF3\w+) = (\d+);", src)}
    assert const == {"kF3Rows": k3.F32_TC_ROWS, "kF3Keys": k3.F32_TC_ROWS,
                     "kF3Threads": 160, "kF3Slot": k3.F32_TC_SLOT_BYTES,
                     "kF3Box": 8192}
    # a slot holds a chunk's hi and lo boxes
    assert const["kF3Slot"] == 4 * const["kF3Box"] == \
        2 * 32 * const["kF3Keys"] * 4 * 2
    m = re.search(r"f32_tc_slots\(\) {\s*return HD == 256 \? (\d+) : (\d+);",
                  src)
    assert m and (int(m[1]), int(m[2])) == (k3.f32_tc_slots(256),
                                            k3.f32_tc_slots(192)) == (3, 4)
    m = re.search(r"f32_tc_vt_rows\(\) {\s*return HV == 256 \? 64 : HV;",
                  src)
    assert m
    body = re.search(r"constexpr int f32_tc_smem_bytes\(\) {\s*return "
                     r"(.*?);", src, re.S)[1]
    for hd, want in ((192, 1024 + 96 * 1024 + 4 * 32 * 1024 + 10 * 8),
                     (256, 1024 + 128 * 1024 + 3 * 32 * 1024 + 8 * 8)):
        expr = body.replace("f32_tc_slots<HD>()", str(k3.f32_tc_slots(hd)))
        expr = re.sub(r"\bHD\b", str(hd), expr)
        for name, val in const.items():
            expr = re.sub(rf"\b{name}\b", str(val), expr)
        expr = " ".join(expr.split())
        assert re.fullmatch(r"[\d\s+*()]+", expr), expr
        assert eval(expr) == k3.f32_tc_smem(hd) == want
        assert k3.f32_tc_smem(hd) <= 232_448
    assert "static_assert(f32_tc_smem_bytes<192, 128>() <= 232448 &&" in src
    assert "f32_tc_smem_bytes<256, 256>() <= 232448," in src
    for hd, hv, h, kv in ((192, 128, 128, 128), (256, 256, 8, 1)):
        p = k3.plan(1, 4096, h, kv, hd, hv, F32)
        assert (p.block_q, p.block_k) == (const["kF3Rows"], const["kF3Keys"])
        assert p.entry == k3.F32_TC_ENTRY
    for b, s, sk, h, kv, hd, hv in (
            (1, 4096, 4096, 128, 128, 192, 128), (2, 1000, 1000, 4, 4, 192, 128),
            (1, 77, 1000, 2, 2, 192, 128), (1, 4096, 4096, 8, 1, 256, 256),
            (2, 1000, 1000, 4, 2, 256, 256)):
        skp = -(-sk // 64) * 64
        assert k3.f32_tc_scratch_floats(b, s, sk, h, kv, hd, hv) == 2 * (
            b * kv * sk * hd + b * kv * hv * skp)
    assert "const int64_t skp = (int64_t)(p.Sk + kF3Keys - 1) / kF3Keys * " \
        "kF3Keys;" in src
    assert "float* ks = scratch;" in src and "float* vt = ks + 2 * kn;" in src


def test_f32_tc_head_dim_256_instances_replace_the_cuda_core_ones():
    """At hd = hv = 256 float32 launches the 3xTF32 wgmma kernel, with and
    without the LSE (``launch_f32_tc<256, 256, ...>``); the CUDA-core
    kernel's hd-256 instances and their one-buffer path are gone, so the
    CUDA-core entry points refuse 256 (their head dims 32, 64, 128); the
    float32 plan routes 256 with every kv head count and prefix the model
    uses."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    for inst in ("launch_f32_tc<256, 256, false>",
                 "launch_f32_tc<256, 256, true>",
                 "const bool pair = (hd == 192 && hv == 128) || (hd == 256 "
                 "&& hv == 256);"):
        assert inst in src, inst
    for gone in ("launch_f32<256", "f32_stages", "ST == 1"):
        assert gone not in src, gone
    assert "const bool square = hd == hv && (hd == 64 || hd == 128);" in src
    assert k3.F32_TC_PAIRS == ((192, 128), (256, 256))
    for b, s, h, kv in ((1, 4096, 8, 1), (8, 1024, 8, 1), (2, 1000, 4, 2),
                        (1, 300, 4, 4)):
        p = k3.plan(b, s, h, kv, 256, 256, F32)
        assert p.entry == k3.F32_TC_ENTRY and p.variant == k3.F32
        assert p.grid == (min(b * h * -(-s // 64), k3.H100_SMS), 1)
    # the other float32 head dims keep the CUDA cores
    assert k3.plan(1, 4096, 32, 32, 64, 64, F32).entry is None


def test_f32_tc_kernel_runs_3xtf32_on_wgmma():
    """The float32 wgmma kernel's products are TF32 wgmma instructions
    (hopper.cuh) fed by TMA: S = Q K^T with both operands from shared
    memory, P V with P from registers; every product three of them (lo hi,
    hi lo, hi hi); its operands split by cvt.rna; its tiles head by head
    past the L2 as the bf16 kernel's, at 8 bytes a K / V column (hi and lo);
    P's register fragments in the order of V^T's keys (hopper.cuh
    ``tf32_key``: 0 2 4 6 1 3 5 7 within each 8)."""
    src = (build.CSRC_DIR / k3.SOURCE).read_text()
    hdr = (build.CSRC_DIR / "hopper.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in hdr
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in hdr
    assert "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32" in hdr
    body = src[src.index("flash_f32_tc_kernel(const __grid_constant__"):]
    body = body[:body.index("\n}\n")]
    assert body.count("wgmma_tf32_ss_m64n64k8(") == 3
    # P V: (192, 128) m64n128k8; hd 256 m64n32k8, a fresh accumulator of 32
    # of O's columns beside O's 128 registers
    assert body.count("wgmma_tf32_rs_m64n128k8(") == 3
    assert body.count("wgmma_tf32_rs_m64n32k8(") == 3
    assert "tma_load_4d(" in body and "mma.sync" not in body
    assert "split_tf32<true>(" in src and "cvt.rna.tf32.f32" in hdr
    # Q lands as float32 and is split in place, made visible to the tensor
    # cores' proxy before the first product reads it
    assert body.count("split_f32(") == 4
    assert body.index("split_f32(") < body.index(
        "fence.proxy.async.shared::cta") < body.index("bar_sync(1, 128);") \
        < body.index("for (int it = 0; it < n_kv; ++it, r += KC + VC)")
    assert "p.group = tc_group(B, Sk, H, KV, hd, hv, gx, 8);" in src
    m = re.search(r"constexpr int tf32_key\(int u\) {\s*return (.*?);", hdr)
    assert m[1] == "u < 4 ? 2 * u : 2 * u - 7"
    assert "split_tile<HV>(v, " in src and "tf32_key(u & 7)" in hdr
    vt_key = [2 * u if u < 4 else 2 * u - 7 for u in range(8)]
    assert vt_key == [0, 2, 4, 6, 1, 3, 5, 7]
    # P's A fragment of key group n: k-slot t (a[0], a[1]: rows g, g + 8)
    # holds key 2 t, k-slot t + 4 (a[2], a[3]) key 2 t + 1 -- the
    # accumulator's [4 n], [4 n + 2] and [4 n + 1], [4 n + 3]
    for e, a in ((0, 0), (2, 1), (1, 2), (3, 3)):
        assert f"split_tf32<true>(s[4 * n{f' + {e}' if e else ''}], " \
            f"ph[n][{a}], pl[n][{a}]);" in body
    for t in range(4):      # thread t's k-slots t and t + 4 hold its keys
        assert (vt_key[t], vt_key[t + 4]) == (2 * t, 2 * t + 1)
