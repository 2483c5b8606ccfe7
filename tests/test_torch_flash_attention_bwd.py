"""K3's backward (``repro_torch.kernels.flash_attention``) on the CPU.

The reference defines no backward for its TPU kernel: it trains through its
XLA attention, ``repro.models.layers.flash_attention``, and ``jax.vjp``
differentiates that.  The port's plain backward, ``flash_attention_bwd_plain``
(from the forward's output and log-sum-exp), is held against that
``jax.vjp`` in float32 on the same numpy inputs: causal, MHA and GQA (G =
4), S not a multiple of the kv block of either package (the reference's
chunk set to 128), head sizes 16 and 64.  Tolerance: each gradient within
1e-5 of its own scale (max |reference|); measured below 1e-6 -- sums over
the keys in other orders.  The CUDA kernels are held to the plain version
on the card by ``chip_smoke.py`` (its ``training`` phase).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rL
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops

TOL = 1e-5


def _draw(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, s, h, d))]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])     # MHA, GQA G=4
@pytest.mark.parametrize("s", [64, 300])
@pytest.mark.parametrize("d", [16, 64])
def test_plain_backward_matches_jax_vjp_of_the_reference(h, kv, s, d):
    q, k, v, do = _draw(s + h + d, 2, s, h, kv, d)
    scale = d ** -0.5

    def attn(q, k, v):
        return rL.flash_attention(q, k, v, scale=scale, chunk=128)

    o_ref, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = k3.flash_attention_fwd(_t(q), _t(k), _t(v), scale=scale)
    assert _rel(o, o_ref) <= TOL
    got = k3.flash_attention_bwd_plain(_t(do), _t(q), _t(k), _t(v), o, lse,
                                       scale=scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= TOL, name


def _naive(q, k, v, causal, scale):
    """float64 softmax attention with GQA by repetition (the oracle of the
    non-causal case, which the reference's XLA attention does not take)."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        n = q.shape[1]
        s = s.masked_fill(~torch.tril(torch.ones(n, n, dtype=torch.bool)),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_float64_autograd(causal):
    q, k, v, do = (_t(a).double() for a in _draw(7, 1, 200, 8, 2, 32))
    for t in (q, k, v):
        t.requires_grad_(True)
    want = torch.autograd.grad(_naive(q, k, v, causal, 0.3), (q, k, v), do)
    qf, kf, vf, dof = (t.detach().float() for t in (q, k, v, do))
    o, lse = k3.flash_attention_fwd(qf, kf, vf, causal=causal, scale=0.3)
    got = k3.flash_attention_bwd_plain(dof, qf, kf, vf, o, lse,
                                       causal=causal, scale=0.3)
    for g, w in zip(got, want):
        assert _rel(g, w.detach().numpy()) <= TOL


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    q, k, v, _ = (_t(a).double() for a in _draw(3, 2, 150, 4, 2, 16))
    _, lse = k3.flash_attention_fwd(q.float(), k.float(), v.float(),
                                    scale=0.25)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) * 0.25
    s = s.masked_fill(~torch.tril(torch.ones(150, 150, dtype=torch.bool)),
                      float("-inf"))
    assert lse.shape == (2, 4, 150) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_forward_with_lse_returns_the_plain_output():
    q, k, v, _ = (_t(a) for a in _draw(4, 1, 90, 4, 4, 16))
    o, _ = k3.flash_attention_fwd(q, k, v)
    assert torch.equal(o, k3.flash_attention_plain(q, k, v))


def test_autograd_on_the_cpu_reaches_the_plain_backward(monkeypatch):
    """``ops.flash_attention`` records K3's ``FlashAttention`` where an input
    requires a gradient; its backward on CPU tensors is
    ``flash_attention_bwd_plain``, once a call, and nothing launches."""
    calls = []
    real = k3.flash_attention_bwd_plain

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(k3, "flash_attention_bwd_plain", spy)
    k3.reset_launch_counts()
    q, k, v, do = (_t(a) for a in _draw(5, 1, 70, 8, 2, 16))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ops.flash_attention(qg, kg, vg, scale=0.2)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    o.backward(do)
    assert len(calls) == 1 and calls[0] == {"causal": True, "scale": 0.2}
    o2, lse = k3.flash_attention_fwd(q, k, v, scale=0.2)
    want = real(do, q, k, v, o2, lse, scale=0.2)
    for t, w in zip((qg, kg, vg), want):
        assert torch.equal(t.grad, w)
    assert k3.launch_counts() == {key: 0 for key in k3.LAUNCHES}
    assert k3._bwd_bound is None


def test_no_grad_takes_the_prefill_path(monkeypatch):
    """Under ``no_grad`` (prefill) the call is the plain forward, exactly as
    before: no autograd function, no log-sum-exp."""
    monkeypatch.setattr(k3, "flash_attention_fwd", None)
    q, k, v, _ = (_t(a).requires_grad_(True) for a in _draw(6, 1, 20, 2, 2,
                                                              16))
    with torch.no_grad():
        o = ops.flash_attention(q, k, v)
    assert o.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_keeps_the_input_dtypes(dtype):
    q, k, v, do = (_t(a).to(dtype) for a in _draw(8, 1, 40, 4, 2, 16))
    o, lse = k3.flash_attention_fwd(q, k, v)
    for g, t in zip(k3.flash_attention_bwd(do, q, k, v, o, lse), (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape


def test_backward_rejects_mismatched_saved_tensors():
    q, k, v, do = (_t(a) for a in _draw(9, 1, 16, 2, 2, 16))
    o, lse = k3.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        k3.flash_attention_bwd(do[:, :8], q, k, v, o, lse)
    with pytest.raises(ValueError):
        k3.flash_attention_bwd(do, q, k, v, o, lse[:, :1])
    with pytest.raises(ValueError):
        k3.flash_attention_bwd(do, q, k, v, o, lse.double())


# --- the backward's launch plan --------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
SMEM_LIMIT = 232_448      # shared memory a block may use on an H100 (227 KB)


@pytest.mark.parametrize("shape,dtype,want", [
    # stablelm-1.6b training, B=1 S=4096: 32 heads of 64; 1,024 items of
    # each kernel over the 132 SMs; the dQ kernel steps 128 keys at hd 64
    ((1, 4096, 32, 32, 64), BF16, (k3.BWD_BF16, 128, 128, 64, 128, (4, 4),
                                   (132, 1), (132, 1), (197792, 134240))),
    # qwen3-14b: 40 heads, 8 kv heads of 128: 640 dQ items, 128 dK / dV
    # items (one a block); three ring slots fill the 227 KB
    ((1, 2048, 40, 8, 128), BF16, (k3.BWD_BF16, 128, 128, 64, 64, (3, 3),
                                   (132, 1), (128, 1), (230528, 232016))),
    ((1, 512, 32, 32, 64), F32, (k3.BWD_F32, 32, 32, 32, 32, (0, 0),
                                 (32, 16), (32, 16), (41984, 41984))),
    ((2, 1000, 4, 2, 128), F32, (k3.BWD_F32, 32, 32, 32, 32, (0, 0),
                                 (8, 32), (4, 32), (74752, 74752))),
])
def test_plan_bwd_of_the_model_shapes(shape, dtype, want):
    p = k3.plan_bwd(*shape, dtype)
    assert (p.variant, p.q_rows, p.kv_rows, p.q_step, p.kv_step, p.stages,
            p.grid_dq, p.grid_dkdv, p.smem) == want
    assert max(p.smem) <= SMEM_LIMIT
    assert k3.plan_bwd(*shape, dtype) is p          # pure, cached


# (B, S, H, KV): stablelm, qwen3, a ragged S with GQA, more items than SMs
SCHEDULE_SHAPES = [(1, 4096, 32, 32), (1, 2048, 40, 8), (2, 1000, 4, 2),
                   (8, 1024, 32, 32)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_bwd_schedule_covers_every_item_once_heaviest_first(shape, causal):
    """Each kernel's schedule holds every (b, head or kv head, block) item
    exactly once; every block's list runs heaviest first; no block gets
    more than the even share plus one item (LPT's bound); the grid is the
    SM count or the item count, whichever is smaller."""
    b, s, h, kv = shape
    p = k3.plan_bwd(b, s, h, kv, 64, BF16, causal)
    nq = -(-s // 128)
    work_dq, work_dkdv = k3.bwd_item_work(b, s, h, kv, causal)
    assert len(work_dq) == b * h * nq and len(work_dkdv) == b * kv * nq
    for sched, work, grid in ((p.schedule_dq, work_dq, p.grid_dq),
                              (p.schedule_dkdv, work_dkdv, p.grid_dkdv)):
        assert grid == (min(len(work), k3.H100_SMS), 1)
        assert len(sched) == grid[0] and all(sched)
        assert sorted(i for items in sched for i in items) \
            == list(range(len(work)))
        for items in sched:
            w = [work[i] for i in items]
            assert w == sorted(w, reverse=True)
        loads = [sum(work[i] for i in items) for items in sched]
        assert max(loads) <= sum(work) / len(sched) + max(work)
        # the first item of every block is among the heaviest
        firsts = sorted((work[items[0]] for items in sched), reverse=True)
        assert firsts == sorted(work, reverse=True)[:len(sched)]


def test_bwd_item_work_counts_the_tiles_each_item_walks():
    # S = 300: 3 dQ items of 128 rows a head, 5 kv tiles of 64 keys
    dq, dkdv = k3.bwd_item_work(1, 300, 4, 2, causal=True)
    assert dq == [2 + 1, 4 + 1, 5 + 1] * 4
    # a dK / dV item walks G = 2 heads from its first visible q tile
    assert dkdv == [2 * 5 + 1, 2 * 3 + 1, 2 * 1 + 1] * 2
    dq, dkdv = k3.bwd_item_work(1, 300, 4, 2, causal=False)
    assert dq == [6] * 12 and dkdv == [11] * 6


def test_schedule_words_are_offsets_then_items_per_kernel():
    p = k3.plan_bwd(1, 300, 4, 2, 64, BF16)
    words = k3.schedule_words(p)
    n_dq, n_kv = p.grid_dq[0], p.grid_dkdv[0]
    offsets, rest = words[:n_dq + 1], words[n_dq + 1:]
    assert offsets[0] == 0 and offsets[-1] == 12
    for c, items in enumerate(p.schedule_dq):
        assert tuple(rest[offsets[c]:offsets[c + 1]]) == items
    rest = rest[12:]
    assert rest[:n_kv + 1][-1] == 6 and len(rest) == n_kv + 1 + 6
    assert tuple(rest[n_kv + 1:]) == sum(p.schedule_dkdv, ())


def test_bwd_plan_matches_the_source_constants():
    """The plan's tiles, ring depths and shared memory are the ones the
    kernels are compiled with (``kRows``, ``kStep``, ``dq_step``,
    ``dq_stages``, ``dkdv_stages``; the layout ``_bwd_smem`` mirrors)."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    assert re.search(rf"constexpr int kRows = {k3.BWD_ROWS};", src)
    assert re.search(rf"constexpr int kStep = {k3.BWD_STEP};", src)
    assert re.search(rf"constexpr int kF = {k3.F32_BWD_ROWS};", src)
    for fn, want in (("dq_stages", k3._bwd_stages), ("dkdv_stages",
                                                     k3._bwd_stages),
                     ("dq_step", k3._dq_step)):
        m = re.search(rf"{fn}\(\) {{\s*return D == 64 \? (\d+) : (\d+);",
                      src)
        assert m and (int(m[1]), int(m[2])) == (want(64), want(128)), fn
    for hd in (64, 128):
        assert max(k3._bwd_smem(hd, k3._bwd_stages(hd))) <= SMEM_LIMIT


def test_bwd_source_adds_no_float_atomics_to_its_outputs():
    """dQ, dK and dV are each written once, by plain stores from the block
    that owns them, so two runs are bitwise equal: no atomicAdd, no red.
    (reduction) instruction, no atom. anywhere in the source."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for word in ("atomicAdd", "atomicCAS", "red.", "atom."):
        assert word not in code, word


@pytest.mark.parametrize("hd", [16, 32, 256])
def test_plan_bwd_refuses_other_head_dims(hd):
    with pytest.raises(ValueError):
        k3.plan_bwd(1, 128, 2, 2, hd, BF16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_bwd_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        k3.plan_bwd(1, 128, 2, 2, 64, dtype)


def test_bwd_source_defines_the_bound_entry_points():
    """One C entry point per backward ``LAUNCHES`` key; bf16 on ``wgmma``
    fed by TMA and a loader warpgroup (no ``mma.sync``); every kernel's name
    starts with ``flash_bwd_`` (the profiler's symbol); the build compiles
    the source with FMA contraction and without fast math, like the
    forward."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    for name in list(k3.BWD_VARIANTS) + ["flash_attention_bwd_error_string"]:
        assert re.search(rf"\b{name}\(", src), name
    assert "atomicAdd" not in src and "red.global" not in src
    assert "mma.sync" not in src and "ldmatrix" not in src
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    assert "setmaxnreg.dec" in src and "setmaxnreg.inc" in src
    assert "tma_load_4d(" in src
    kernels = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert len(kernels) == src.count("__global__") == 4
    assert all(name.startswith("flash_bwd_") for name in kernels)
    assert {"flash_bwd_dq_bf16_tc_kernel",
            "flash_bwd_dkdv_bf16_tc_kernel"} <= set(kernels)
    assert "repro/kernels/flash_attention.py::_flash_kernel" in src
    assert "--use_fast_math" not in build.flags(k3.BWD_SOURCE)
    assert "-fmad=false" not in build.flags(k3.BWD_SOURCE)
    assert "hopper.cuh" in build.local_headers(k3.BWD_SOURCE)
