"""The SSD scan kernel's plain version (K4) against the reference.

On the CPU the wrapper takes ``ssd_scan_plain``, the reference kernel's own
arithmetic in tensor code; the CUDA kernel itself is held to it on the card
by ``chip_smoke.py``.  Inputs are drawn with numpy (``tests/test_kernels.py``'s
distributions: dt in U(0.01, 0.2), A in -U(0.5, 2)) and go through both
packages.  Tolerances, max |diff| over the scale max |reference|: float32
1e-5 and bf16 6e-2, those of ``tests/test_kernels.py`` (measured: float32
within 2.1e-6 of the Pallas kernel in interpret mode, bf16 within 1.3e-3 --
the reference kernel rounds y to bf16 where the oracle ``ref.ssd_ref`` keeps
float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro.models import ssd as rssd
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as k4

TOL = {"float32": 1e-5, "bfloat16": 6e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (S, nh, hp, ds, chunk): tests/test_kernels.py's three cases, then one at
# mamba2-130m's chunk and head sizes
CASES = [(128, 2, 16, 16, 32), (256, 3, 16, 32, 64), (128, 4, 32, 16, 128)]
MODEL_CASE = (512, 2, 64, 128, 256)


def _inputs(seed, S, nh, hp, ds, dtype, b=2):
    """(jax arrays, torch tensors) holding the same values: x, B, C drawn
    in float32 and rounded to ``dtype`` once; dt, A float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, S, nh)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, nh)).astype(np.float32)
    B = rng.normal(size=(b, S, 1, ds)).astype(np.float32)
    C = rng.normal(size=(b, S, 1, ds)).astype(np.float32)
    jx = [jnp.asarray(x, JNP[dtype]), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(B, JNP[dtype]), jnp.asarray(C, JNP[dtype])]
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jx]
    for i in (0, 3, 4):
        tt[i] = tt[i].to(TORCH[dtype])
    return jx, tt


def _rel(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return (float(np.abs(got.float().numpy() - want).max())
            / (float(np.abs(want).max()) + 1e-6))


@pytest.mark.parametrize("S,nh,hp,ds,chunk", CASES + [MODEL_CASE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_and_oracle(S, nh, hp, ds, chunk,
                                                   dtype):
    """``ops.ssd_scan`` on the CPU against the reference's
    ``ops.ssd_scan`` (the Pallas kernel, interpret mode) and the
    sequential oracle ``ref.ssd_ref``."""
    jx, tt = _inputs(S + nh + ds, S, nh, hp, ds, dtype)
    y, state = ops.ssd_scan(*tt, chunk=chunk)
    assert y.dtype == TORCH[dtype] and tuple(y.shape) == (2, S, nh, hp)
    assert state.dtype == torch.float32
    assert tuple(state.shape) == (2, nh, hp, ds)
    assert _rel(y, rops.ssd_scan(*jx, chunk=chunk)) < TOL[dtype]
    assert _rel(y, ref.ssd_ref(*jx)) < TOL[dtype]


@pytest.mark.parametrize("S,nh,hp,ds,chunk", CASES + [MODEL_CASE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_state_and_float32_output_match_ssd_chunked(S, nh, hp, ds,
                                                          chunk, dtype):
    """The final state, and y with ``out_dtype=float32``, against the
    reference's XLA scan ``models/ssd.ssd_chunked`` (float32 y, final
    state) on the same inputs: float32 arithmetic throughout, so 1e-5 of
    scale for both input types."""
    jx, tt = _inputs(S * 3 + hp, S, nh, hp, ds, dtype)
    y, state = ops.ssd_scan(*tt, chunk=chunk, out_dtype=torch.float32)
    want_y, want_state = rssd.ssd_chunked(*jx, chunk)
    assert y.dtype == torch.float32
    assert _rel(y, want_y) < 1e-5
    assert _rel(state, want_state) < 1e-5


def test_float32_output_rounds_to_the_default_output():
    """``out_dtype`` changes only the rounding of the one float32 result:
    bf16 y equals the float32 y rounded to bf16."""
    _, tt = _inputs(3, 128, 2, 16, 16, "bfloat16")
    y16, s16 = ops.ssd_scan(*tt, chunk=32)
    y32, s32 = ops.ssd_scan(*tt, chunk=32, out_dtype=torch.float32)
    assert torch.equal(y16, y32.to(torch.bfloat16))
    assert torch.equal(s16, s32)


def test_strided_b_c_views_equal_contiguous_copies():
    """B and C as column slices of one [b, S, 2 ds] tensor (row stride
    2 ds), as the model passes them, give what contiguous copies give."""
    jx, (x, dt, A, _, _) = _inputs(4, 128, 2, 16, 16, "bfloat16")
    bc = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 128, 32)).astype(np.float32)).to(torch.bfloat16)
    Bv, Cv = bc[..., :16].reshape(2, 128, 1, 16), bc[..., 16:].reshape(
        2, 128, 1, 16)
    assert Bv.stride(1) == 32 and not Bv.is_contiguous()
    y, state = ops.ssd_scan(x, dt, A, Bv, Cv, chunk=32)
    y_c, state_c = ops.ssd_scan(x, dt, A, Bv.contiguous(), Cv.contiguous(),
                                chunk=32)
    assert torch.equal(y, y_c) and torch.equal(state, state_c)
    want = ref.ssd_ref(jx[0], jx[1], jx[2],
                       jnp.asarray(Bv.float().numpy(), jnp.bfloat16),
                       jnp.asarray(Cv.float().numpy(), jnp.bfloat16))
    assert _rel(y, want) < TOL["bfloat16"]


def test_chunk_longer_than_the_sequence_is_one_chunk():
    """``Q = min(chunk, S)``: chunk 256 on S = 64 is one chunk of 64."""
    jx, tt = _inputs(6, 64, 2, 16, 16, "float32")
    y, _ = ops.ssd_scan(*tt, chunk=256)
    assert _rel(y, ref.ssd_ref(*jx)) < TOL["float32"]


def test_ngroups_other_than_one_raises():
    _, (x, dt, A, B, C) = _inputs(7, 64, 2, 16, 16, "float32")
    B2, C2 = B.expand(2, 64, 2, 16), C.expand(2, 64, 2, 16)
    with pytest.raises(ValueError, match="ngroups == 1"):
        ops.ssd_scan(x, dt, A, B2, C2, chunk=32)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    _, (x, dt, A, B, C) = _inputs(8, 96, 2, 16, 16, "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, dt, A, B, C, chunk=64)


def test_dtypes_are_checked():
    _, (x, dt, A, B, C) = _inputs(9, 64, 2, 16, 16, "float32")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssd_scan(x, dt, A, B.to(torch.bfloat16), C, chunk=32)
    with pytest.raises(TypeError, match="dt and A"):
        ops.ssd_scan(x, dt.double(), A, B, C, chunk=32)
    with pytest.raises(TypeError, match="out_dtype"):
        ops.ssd_scan(x, dt, A, B, C, chunk=32, out_dtype=torch.float16)


def test_cpu_call_launches_nothing_and_builds_nothing():
    """CPU tensors take the plain version: no launch is counted and the
    library is never loaded."""
    _, tt = _inputs(10, 64, 2, 16, 16, "float32")
    k4.reset_launch_counts()
    ops.ssd_scan(*tt, chunk=32)
    assert k4.launch_counts() == {"ssd_scan_f32": 0, "ssd_scan_bf16": 0,
                                  "ssd_scan_bwd_f32": 0,
                                  "ssd_scan_bwd_bf16": 0}
    assert k4._bound is None


# --- the launch plan (pure Python; the card runs what it says) -------------

MAMBA2 = get_config("mamba2_130m")
# mamba2-130m's prefill shapes as chip_smoke.py drives them: (b, S)
MODEL_SHAPES = [(1, 4096), (8, 1024)]


def _model_plan(b, s, dtype, cfg=MAMBA2):
    return k4.plan(b, s, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                   min(cfg.ssm_chunk, s), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", MODEL_SHAPES)
def test_model_shapes_plan_the_shared_cb_variant(b, s, dtype):
    """Every mamba2-130m prefill shape takes the variant that computes
    C B^T once per (b, chunk): its four launches, the C B^T grid over the
    lower-triangle 64 x 64 tiles of each (b, chunk), the outputs over
    (chunk, b * nh, row tile), and the card filled at B = 1."""
    p = _model_plan(b, s, dtype)
    nc, nh = s // 256, MAMBA2.ssm_nheads
    assert p.variant == k4.SHARED_CB
    assert tuple(p.grids) == k4.LAUNCH_NAMES[k4.SHARED_CB]
    assert p.grids["cb"] == (10, b * nc, 1)
    assert p.grids["chunk_state"] == (nc, b * nh, 2)
    assert p.grids["output"] == (nc, b * nh, 4)
    assert p.blocks_per_sm["output"] >= 4
    assert p.scratch["cb"] == (b, nc, 256, 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,nh,hp,ds,chunk", CASES)
def test_test_kernels_shapes_plan_the_general_variant(S, nh, hp, ds, chunk,
                                                      dtype):
    p = k4.plan(2, S, nh, hp, ds, min(chunk, S), dtype)
    assert p.variant == k4.GENERAL
    assert tuple(p.grids) == k4.LAUNCH_NAMES[k4.GENERAL]
    assert "cb" not in p.scratch


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_reduced_mamba2_plans_the_general_variant(dtype):
    p = _model_plan(2, 96, dtype, MAMBA2.reduced())
    assert p.variant == k4.GENERAL


def test_plan_is_pure_and_builds_nothing():
    """The plan depends on its arguments alone and loads no library."""
    args = (1, 4096, 24, 64, 128, 256, torch.bfloat16)
    assert k4.plan(*args) == k4.plan(*args)
    assert k4.plan(*args, sms=66).grids == k4.plan(*args).grids
    assert k4.plan(*args, sms=66).blocks_per_sm["output"] == \
        2 * k4.plan(*args).blocks_per_sm["output"]
    assert k4._bound is None


@pytest.mark.parametrize("b,s,nh,hp,ds,q", [(1, 4096, 24, 64, 128, 256),
                                            (2, 128, 2, 16, 16, 32)])
def test_scratch_the_plan_asks_for_is_what_the_wrapper_allocates(b, s, nh,
                                                                 hp, ds, q):
    """states [b, nh, nc, hp, ds] and cum [b, nh, nc, Q] in both variants,
    cb [b, nc, Q, Q] in shared_cb only: float32, as ``scratch_tensors``
    allocates them for the launch."""
    p = k4.plan(b, s, nh, hp, ds, q, torch.float32)
    nc = s // q
    want = {"states": (b, nh, nc, hp, ds), "cum": (b, nh, nc, q)}
    if p.variant == k4.SHARED_CB:
        want["cb"] = (b, nc, q, q)
    assert p.scratch == want
    got = k4.scratch_tensors(p, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())


def test_kernel_ready_needs_16_byte_base_and_strides():
    """The shared_cb kernels read the model's column slices in place; a
    base off 16 bytes is not ready (the wrapper copies it first)."""
    xbc = torch.zeros((2, 64, 3 * 64 + 2 * 128), dtype=torch.bfloat16)
    assert k4.kernel_ready(xbc[..., 192:320].reshape(2, 64, 1, 128))
    flat = torch.zeros(1 + 2 * 64 * 128, dtype=torch.bfloat16)
    assert not k4.kernel_ready(flat[1:].view(2, 64, 1, 128))
