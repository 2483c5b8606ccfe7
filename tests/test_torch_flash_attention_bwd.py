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
on the card by ``chip_smoke.py`` (its ``training`` phase); here a numpy
emulation of the float32 kernels' 3xTF32 arithmetic shows, before any
card, that it holds their 1e-4-of-scale gate.
"""

import dataclasses
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
    assert len(calls) == 1 and calls[0] == {"causal": True, "prefix_len": 0,
                                            "scale": 0.2}
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
    # float32: items of 64 rows or keys, one block each; 32-row steps at
    # hd 64, 16 at hd 128; two blocks an SM
    ((1, 512, 32, 32, 64), F32, (k3.BWD_F32, 64, 64, 32, 32, (2, 2),
                                 (256, 1), (256, 1), (69632, 80384))),
    ((2, 1000, 4, 2, 128), F32, (k3.BWD_F32, 64, 64, 16, 16, (2, 2),
                                 (128, 1), (128, 1), (101376, 107776))),
])
def test_plan_bwd_of_the_model_shapes(shape, dtype, want):
    p = k3.plan_bwd(*shape, dtype)
    assert (p.variant, p.q_rows, p.kv_rows, p.q_step, p.kv_step, p.stages,
            p.grid_dq, p.grid_dkdv, p.smem) == want
    assert max(p.smem) <= SMEM_LIMIT
    assert k3.plan_bwd(*shape, dtype) is p          # pure, cached


@pytest.mark.parametrize("shape,hd", [
    ((1, 4096, 32, 32), 64),        # stablelm
    ((1, 2048, 40, 8), 128),        # qwen3: 1,280 items, not 256 of 5 heads
    ((8, 2048, 40, 8), 128),
    ((1, 512, 8, 2), 128),          # non-causal GQA's case
])
def test_f32_plan_gives_every_head_its_own_items(shape, hd):
    """Both float32 kernels take one block an item of 64 rows or keys of
    one head, so GQA's dK / dV items are as many and as even as dQ's."""
    b, s, h, kv = shape
    p = k3.plan_bwd(b, s, h, kv, hd, F32)
    assert p.grid_dq == p.grid_dkdv == (b * h * -(-s // 64), 1)
    assert not p.schedule_dq and not p.schedule_dkdv


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
    assert re.search(rf"constexpr int kFStages = {k3.F32_BWD_STAGES};", src)
    for fn, want in (("dq_stages", k3._bwd_stages), ("dkdv_stages",
                                                     k3._bwd_stages),
                     ("f32_step", k3._f32_step)):
        m = re.search(rf"{fn}\(\) {{\s*return D == 64 \? (\d+) : (\d+);",
                      src)
        assert m and (int(m[1]), int(m[2])) == (want(64), want(128)), fn
    m = re.search(r"dq_step\(\) {\s*return D == 64 \? (\d+) : D == 128 \? "
                  r"(\d+) : D == 192 \? (\d+) : (\d+);", src)
    assert m and tuple(map(int, m.groups())) == tuple(
        k3._dq_step(hd) for hd in (64, 128, 192, 256))
    for hd in (64, 128):
        assert max(k3._bwd_smem(hd, k3._bwd_stages(hd))) <= SMEM_LIMIT
        # two float32 blocks (and the 1 KB the card reserves for each) fit
        # an SM's 228 KB
        assert 2 * (max(k3._f32_bwd_smem(hd)) + 1024) <= 233_472


def test_bwd_source_adds_no_float_atomics_to_its_outputs():
    """dQ, dK and dV are each written once, by plain stores from the block
    that owns them, so two runs are bitwise equal: no atomicAdd, no red.
    (reduction) instruction, no atom. anywhere in the source."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for word in ("atomicAdd", "atomicCAS", "red.", "atom."):
        assert word not in code, word


@pytest.mark.parametrize("hd", [16, 32, 96])
def test_plan_bwd_refuses_other_head_dims(hd):
    with pytest.raises(ValueError):
        k3.plan_bwd(1, 128, 2, 2, hd, BF16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_bwd_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        k3.plan_bwd(1, 128, 2, 2, 64, dtype)


def test_bwd_source_defines_the_bound_entry_points():
    """One C entry point per backward ``LAUNCHES`` key; bf16 on ``wgmma``
    fed by TMA and a loader warpgroup (no bf16 ``mma.sync``, no
    ``ldmatrix``); float32 as 3xTF32 on ``mma.sync`` m16n8k8, each operand
    split by ``cvt.rna.tf32.f32`` (from the shared header); every kernel's
    name starts with ``flash_bwd_`` (the profiler's symbol); the build
    compiles the source with FMA contraction and without fast math, like
    the forward."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    for name in list(k3.BWD_VARIANTS) + [k3.BWD_F32_TC_ENTRY,
                                         "flash_attention_bwd_error_string"]:
        assert re.search(rf"\b{name}\(", src), name
    assert "atomicAdd" not in src and "red.global" not in src
    header = (build.CSRC_DIR / "hopper.cuh").read_text()
    assert not re.search(r"mma\.sync\.aligned\.m16n8k16[.\w]*bf16", src)
    assert "ldmatrix" not in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "cvt.rna.tf32.f32" in header
    assert "mma_tf32(" in src and "split_tf32<true>(" in src
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    assert "setmaxnreg.dec" in src and "setmaxnreg.inc" in src
    assert "tma_load_4d(" in src
    kernels = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert len(kernels) == src.count("__global__") == 10
    assert all(name.startswith("flash_bwd_") for name in kernels)
    assert {"flash_bwd_dq_bf16_tc_kernel", "flash_bwd_dkdv_bf16_tc_kernel",
            "flash_bwd_dkdv_bf16_split_kernel",
            "flash_bwd_dq_f32_tc_kernel", "flash_bwd_dkdv_f32_tc_kernel",
            "flash_bwd_dkdv_sum_f32_kernel",
            # float32 at (192, 128): the pre-pass and the wgmma passes
            "flash_bwd_f32_split_kernel", "flash_bwd_f32_t_kernel",
            "flash_bwd_f32_dd_kernel", "flash_bwd_f32_wgmma_kernel"} == \
        set(kernels)
    # TF32 wgmma: S and dP from shared memory, the outputs with dS (or P)
    # from registers
    assert "wgmma_tf32_ss_m64n64k8(" in src
    assert "wgmma_tf32_rs_m64n64k8(" in src
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in header
    # head dim 256 on wgmma: S and dP of 32 keys, P V-like products 256 wide
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in src
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" in header
    # no CUDA-core product loop is left
    assert "dot_rows" not in src
    assert "repro/kernels/flash_attention.py::_flash_kernel" in src
    assert "--use_fast_math" not in build.flags(k3.BWD_SOURCE)
    assert "-fmad=false" not in build.flags(k3.BWD_SOURCE)
    assert "hopper.cuh" in build.local_headers(k3.BWD_SOURCE)


# --- the float32 kernels' arithmetic, emulated in numpy --------------------


def _tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, on the 13 low mantissa bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """``a @ b`` (batched float32) as the kernels' tensor cores compute it:
    each operand split into TF32 hi = tf32(x), lo = tf32(x - hi); per
    k-slice of 8, lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) into a float32
    accumulator."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc += np.matmul(x[..., k0:k0 + 8], y[..., k0:k0 + 8, :])
    return acc


def _add_truncated(acc, step):
    """acc + step rounded toward zero to float32: the tensor cores add each
    k8 step's sum into a float32 accumulator without rounding to nearest."""
    exact = acc.astype(np.float64) + step
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _mm_wgmma(a, b, chunk):
    """``a @ b`` as the 3xTF32 wgmma passes sum it into one accumulator: the
    reduction index in chunks of ``chunk`` (a ring slot's 64 or 32
    columns), each chunk's small terms first -- lo(a) hi(b) and hi(a)
    lo(b) of every k8 step -- then hi(a) hi(b) of every step, each step's
    sum added rounded toward zero (``_add_truncated``)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    n = a.shape[-1]

    def add(x, y, k0):
        return _add_truncated(acc, np.matmul(
            x[..., k0:k0 + 8].astype(np.float64),
            y[..., k0:k0 + 8, :].astype(np.float64)))

    for c0 in range(0, n, chunk):
        steps = range(c0, min(c0 + chunk, n), 8)
        for k0 in steps:
            for x, y in ((al, bh), (ah, bl)):
                acc = add(x, y, k0)
        for k0 in steps:
            acc = add(ah, bh, k0)
    return acc


def _mm_tiles(a, b):
    """``a @ b`` over a reduction index of rows or keys, as the wgmma passes
    add an output: a fresh accumulator a 64-wide tile (``_mm_wgmma``), the
    tiles' sums added in float32 in tile order."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for t0 in range(0, a.shape[-1], 64):
        out = out + _mm_wgmma(a[..., t0:t0 + 64], b[..., t0:t0 + 64, :], 64)
    return out


def _emulated_f32_bwd(do, q, k, v, o, lse, causal, scale, prefix=0,
                      wgmma=False):
    """The float32 kernels' backward in numpy: D = rowsum(dO o) in float32;
    S, dP, dQ, dK and dV as 3xTF32 products; P = exp(S scale - lse) and dS
    = P (dP - D) in float32, 0 where the causal mask with a bidirectional
    prefix of ``prefix`` keys hides the pair; the scale applied to dQ and
    dK at the end; dK and dV summed over a group's heads in one
    accumulation, as the dK / dV kernel walks them.  v, do and o may be
    narrower than q, k (hv < hd).  ``wgmma``: the order of the wgmma
    passes at hd 256 -- S over 64-column chunks and dP over 32-column ones
    chained in one accumulator each (``_mm_wgmma``), P = 2^(S scale log2 e
    - lse log2 e), every output a fresh accumulator a 64-row tile added in
    float32 (``_mm_tiles``), dK and dV per head summed over the group in
    head order."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    heads = lambda t: np.ascontiguousarray(t.transpose(0, 2, 1, 3))
    qh, doh = heads(q), heads(do)                      # [b, h, s, d]
    kh, vh = heads(k)[:, np.arange(h) // g], heads(v)[:, np.arange(h) // g]
    dd = heads((do * o).sum(-1, dtype=np.float32)[..., None])[..., 0]
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    seen = (j <= i) | (j < prefix)
    if wgmma:
        log2e = np.float32(1.4426950408889634)
        sc = _mm_wgmma(qh, kh.swapaxes(-1, -2), 64)
        p = np.exp2(sc * (np.float32(scale) * log2e)
                    - lse[..., None] * log2e).astype(np.float32)
        if causal:
            p = np.where(seen, p, np.float32(0))
        dp = _mm_wgmma(doh, vh.swapaxes(-1, -2), 32)
        ds = p * (dp - dd[..., None])
        dq = _mm_tiles(ds, kh) * np.float32(scale)
        dk_h = _mm_tiles(ds.swapaxes(-1, -2), qh) * np.float32(scale)
        dv_h = _mm_tiles(p.swapaxes(-1, -2), doh)
        dk, dv = (np.zeros((b, kv, s, x.shape[-1]), np.float32)
                  for x in (dk_h, dv_h))
        for gi in range(g):               # the sum kernel, in head order
            dk = dk + dk_h.reshape(b, kv, g, s, -1)[:, :, gi]
            dv = dv + dv_h.reshape(b, kv, g, s, -1)[:, :, gi]
        return (dq.transpose(0, 2, 1, 3), dk.transpose(0, 2, 1, 3),
                dv.transpose(0, 2, 1, 3))
    sc = _mm_3xtf32(qh, kh.swapaxes(-1, -2))
    p = np.exp(sc * np.float32(scale) - lse[..., None]).astype(np.float32)
    if causal:
        p = np.where(seen, p, np.float32(0))
    dp = _mm_3xtf32(doh, vh.swapaxes(-1, -2))
    ds = p * (dp - dd[..., None])
    dq = _mm_3xtf32(ds, kh) * np.float32(scale)
    # [b, kv, keys, g * rows]: the group's heads one after another
    by_key = lambda t: np.ascontiguousarray(
        t.reshape(b, kv, g, s, s).transpose(0, 1, 4, 2, 3)
        .reshape(b, kv, s, g * s))
    rows = lambda t: t.reshape(b, kv, g * s, t.shape[-1])
    dk = _mm_3xtf32(by_key(ds), rows(qh)) * np.float32(scale)
    dv = _mm_3xtf32(by_key(p), rows(doh))
    return (dq.transpose(0, 2, 1, 3), dk.transpose(0, 2, 1, 3),
            dv.transpose(0, 2, 1, 3))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3],
                 np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                     -(1.0 + 2.0 ** -10), 1.0, np.float32(3.0e-3)],
                    np.float32)
    got = _tf32(x)
    np.testing.assert_array_equal(got[:5], want[:5])
    # a split keeps all but the last bits: hi + lo is x to 2^-21 relative
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert np.all(np.abs(hi + lo - x) <= 2.0 ** -21 * np.abs(x))
    assert abs(float(got[5]) - 3.0e-3) <= 2.0 ** -11 * 3.0e-3


@pytest.mark.parametrize("b,s,h,kv,d,causal", [
    (2, 128, 4, 4, 64, True),       # causal MHA
    (1, 150, 4, 2, 64, True),       # causal GQA G = 2, S ragged
    (1, 96, 8, 2, 64, False),       # non-causal GQA G = 4
    (1, 80, 4, 2, 128, True),       # hd 128
    (1, 100, 2, 2, (192, 128), True),   # deepseek's MLA, S ragged
])
def test_3xtf32_backward_holds_the_float32_gates(b, s, h, kv, d, causal):
    """The float32 kernels' arithmetic -- every product as 3xTF32 -- keeps
    dq, dk and dv within 1e-4 of scale (the gate of ``chip_smoke.py``'s
    training (d) and (b)) of the float64 autograd, of ``jax.vjp`` of the
    reference's attention (non-causal: its bidirectional prefix over the
    whole sequence) and of ``flash_attention_bwd_plain``; one-pass TF32
    would not."""
    hd, hv = d if isinstance(d, tuple) else (d, d)
    q, k, v, do = _draw(s * hd + h, b, s, h, kv, hd)
    if hv != hd:            # v and do of their own width
        rng = np.random.default_rng(s * hv + h)
        v, do = (rng.normal(size=shape[:3] + (hv,)).astype(np.float32)
                 for shape in (v.shape, do.shape))
    scale = hd ** -0.5
    o, lse = k3.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                    scale=scale)
    got = _emulated_f32_bwd(do, q, k, v, o.numpy(), lse.numpy(), causal,
                            scale)
    q64, k64, v64 = (_t(x).double().requires_grad_(True) for x in (q, k, v))
    want64 = torch.autograd.grad(_naive(q64, k64, v64, causal, scale),
                                 (q64, k64, v64), _t(do).double())

    def attn(q, k, v):
        return rL.flash_attention(q, k, v, scale=scale, chunk=128,
                                  prefix_len=0 if causal else s)

    _, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_jax = vjp(jnp.asarray(do))
    plain = k3.flash_attention_bwd_plain(_t(do), _t(q), _t(k), _t(v), o, lse,
                                         causal=causal, scale=scale)
    for i, name in enumerate(("dq", "dk", "dv")):
        g = torch.from_numpy(np.ascontiguousarray(got[i]))
        assert g.shape == plain[i].shape and g.dtype == torch.float32
        for ref in (want64[i].numpy(), want_jax[i], plain[i].numpy()):
            assert _rel(g, ref) <= 1e-4, name
    # one-pass TF32 products in the same place miss the gate
    one_pass = _tf32(_tf32(q[0, :, 0]) @ _tf32(k[0, :, 0]).T)
    exact = q[0, :, 0].astype(np.float64) @ k[0, :, 0].T.astype(np.float64)
    assert np.abs(one_pass - exact).max() > 1e-4 * np.abs(exact).max()


# (B, S, H, KV, prefix) at hd 256: paligemma's MQA (G = 8) with its
# patches' prefix at a ragged S; GQA G = 2 with a ragged prefix
D256_BWD_EMULATED = [(1, 300, 8, 1, 256), (1, 200, 4, 2, 77)]


@pytest.mark.parametrize("b,s,h,kv,prefix", D256_BWD_EMULATED)
def test_3xtf32_backward_at_head_dim_256_holds_the_float32_gates(b, s, h, kv,
                                                                prefix):
    """The hd-256 wgmma passes' arithmetic (``_emulated_f32_bwd(...,
    wgmma=True)``: their chunk order, truncating accumulation, a fresh
    accumulator a tile for every output, the group's per-head dK / dV
    partials summed in head order) with the prefix's mask keeps dq, dk and
    dv within 1e-4 of scale (``chip_smoke.py``'s float32 gate) of the
    float64 autograd, of ``jax.vjp`` of the reference's attention with the
    same prefix and of ``flash_attention_bwd_plain``."""
    d = 256
    q, k, v, do = _draw(s * d + h + prefix, b, s, h, kv, d)
    scale = d ** -0.5
    o, lse = k3.flash_attention_fwd(_t(q), _t(k), _t(v), prefix_len=prefix,
                                    scale=scale)
    got = _emulated_f32_bwd(do, q, k, v, o.numpy(), lse.numpy(), True,
                            scale, prefix, wgmma=True)
    q64, k64, v64 = (_t(x).double().requires_grad_(True) for x in (q, k, v))
    g = h // kv
    sc = torch.einsum("bqhd,bkhd->bhqk", q64, k64.repeat_interleave(g, 2)) \
        * scale
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    sc = sc.masked_fill(~((j <= i) | (j < prefix)), float("-inf"))
    o64 = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1),
                       v64.repeat_interleave(g, 2))
    want64 = torch.autograd.grad(o64, (q64, k64, v64), _t(do).double())

    def attn(q, k, v):      # one chunk: the prefix within its first
        return rL.flash_attention(q, k, v, scale=scale, prefix_len=prefix)

    _, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_jax = vjp(jnp.asarray(do))
    plain = k3.flash_attention_bwd_plain(_t(do), _t(q), _t(k), _t(v), o, lse,
                                         prefix_len=prefix, scale=scale)
    for idx, name in enumerate(("dq", "dk", "dv")):
        gx = torch.from_numpy(np.ascontiguousarray(got[idx]))
        assert gx.shape == plain[idx].shape and gx.dtype == torch.float32
        for ref in (want64[idx].numpy(), want_jax[idx], plain[idx].numpy()):
            assert _rel(gx, ref) <= 1e-4, name
        print(f"hd 256 {name}: emulated - float64 "
              f"{_rel(gx, want64[idx].numpy()):.3e} of scale")


# --- keys apart from the queries (cross attention) ----------------------------

# (B, Sq, Sk, H, KV, d): fewer queries than keys; more queries than keys,
# ragged, GQA G = 4
CROSS_SHAPES = [(1, 48, 300, 4, 4, 32), (2, 200, 77, 8, 2, 16)]
CROSS_TOL = {torch.float32: TOL, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("shape", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_length_backward_matches_jax_vjp_of_attention_ref(shape,
                                                                 dtype):
    """q [B, Sq, H, d] over k, v [B, Sk, KV, d], not causal: the plain
    backward from the plain forward's o and log-sum-exp against ``jax.vjp``
    of ``ref.attention_ref(..., causal=False)`` on K / V repeated for GQA
    (the repeat's VJP sums each group), each gradient within 1e-5 of its
    scale in float32 and 2e-2 in bf16."""
    from repro.kernels import ref
    b, sq, sk, h, kv, d = shape
    rng = np.random.default_rng(sq + sk)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v, do = (jnp.asarray(rng.normal(size=s).astype(np.float32), jdt)
                   for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                             (b, sq, h, d)))
    g = h // kv

    def attn(q, k, v):
        return ref.attention_ref(q, jnp.repeat(k, g, 2), jnp.repeat(v, g, 2),
                                 causal=False)

    o_ref, vjp = jax.vjp(attn, q, k, v)
    want = vjp(do)
    qt, kt, vt, dot = (_t(np.asarray(a.astype(jnp.float32))).to(dtype)
                       for a in (q, k, v, do))
    o, lse = k3.flash_attention_fwd(qt, kt, vt, causal=False)
    assert lse.shape == (b, h, sq)
    assert _rel(o, o_ref.astype(jnp.float32)) <= CROSS_TOL[dtype]
    got = k3.flash_attention_bwd(dot, qt, kt, vt, o, lse, causal=False)
    for gr, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert gr.shape == w.shape and gr.dtype == dtype, name
        assert _rel(gr, w.astype(jnp.float32)) <= CROSS_TOL[dtype], name


def test_cross_length_autograd_reaches_the_plain_backward():
    """``ops.flash_attention`` under autograd with Sk != Sq: gradients of
    the keys' and values' own shape, equal to float64 autograd of the
    naive attention."""
    rng = np.random.default_rng(5)
    q, do = (_t(rng.normal(size=(2, 30, 4, 16)).astype(np.float32))
             for _ in range(2))
    k, v = (_t(rng.normal(size=(2, 90, 2, 16)).astype(np.float32))
            for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=False),
                              leaves, do)
    dbl = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_naive(*dbl, False, 16 ** -0.5), dbl,
                               do.double())
    for gr, w in zip(got, want):
        assert gr.shape == w.shape
        assert _rel(gr, w.numpy()) <= TOL


def test_cross_length_backward_rejects_causal_and_mismatched_shapes():
    q, o, do = (torch.zeros((1, 16, 2, 64)) for _ in range(3))
    k = torch.zeros((1, 40, 2, 64))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="causal"):
        k3.flash_attention_bwd(do, q, k, k, o, lse, causal=True)
    with pytest.raises(ValueError, match="causal"):
        k3.flash_attention_bwd_plain(do, q, k, k, o, lse, causal=True)
    with pytest.raises(ValueError, match="lse"):
        k3.flash_attention_bwd(do, q, k, k, o, torch.zeros((1, 2, 40)),
                               causal=False)
    with pytest.raises(ValueError, match="causal"):
        k3.plan_bwd(1, 16, 2, 2, 64, BF16, True, sk=40)
    with pytest.raises(ValueError, match="causal"):
        k3.bwd_item_work(1, 16, 2, 2, True, sk=40)
    dq, dk, dv = k3.flash_attention_bwd(do, q, k, k, o, lse, causal=False)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_cross_length_bwd_work_equals_closed_forms():
    """``bwd_work`` counts Sq Sk pairs when not causal; q, o, dO, dq bytes
    by Sq, k, v, dk, dv by Sk, the LSE and D by Sq; with Sk == Sq (or None)
    it is what it was."""
    b, sq, sk, h, kv, hd = 8, 448, 1500, 12, 12, 64
    flops, nbytes = k3.bwd_work(b, sq, h, kv, hd, hd, False, BF16, sk=sk)
    assert flops == 10 * hd * b * h * sq * sk
    assert nbytes == 2 * b * (4 * sq * h * hd + 4 * sk * kv * hd) \
        + 2 * 4 * b * h * sq
    for causal in (True, False):
        same = k3.bwd_work(b, sq, h, kv, hd, hd, causal, F32)
        assert k3.bwd_work(b, sq, h, kv, hd, hd, causal, F32, sk=sq) == same
        pairs = sq * (sq + 1) // 2 if causal else sq * sq
        assert same == (10 * hd * b * h * pairs,
                        4 * b * sq * (4 * h * hd + 4 * kv * hd)
                        + 2 * 4 * b * h * sq)


def test_cross_length_bwd_item_work_counts_the_tiles_each_item_walks():
    # Sq = 300 (3 dQ items of 128 rows a head, 5 q tiles of 64), Sk = 500
    # (4 dK / dV items of 128 keys, 8 kv tiles of 64)
    dq, dkdv = k3.bwd_item_work(1, 300, 4, 2, False, sk=500)
    assert dq == [8 + 1] * (3 * 4)
    assert dkdv == [2 * 5 + 1] * (4 * 2)
    for causal in (True, False):
        assert k3.bwd_item_work(1, 300, 4, 2, causal, sk=300) == \
            k3.bwd_item_work(1, 300, 4, 2, causal)


@pytest.mark.parametrize("b,sq,sk,h,kv", [(8, 448, 1500, 12, 12),
                                          (16, 4, 1500, 12, 12),
                                          (2, 77, 1000, 6, 2)])
def test_cross_length_plans_cover_both_lengths(b, sq, sk, h, kv):
    """bf16: the dQ schedule holds B H ceil(Sq / 128) items, the dK / dV
    schedule B KV ceil(Sk / 128), each exactly once; float32: grids of B H
    ceil(Sq / 64) and B H ceil(Sk / 64) blocks.  With Sk == Sq the plan is
    the same object as the one made without Sk."""
    p = k3.plan_bwd(b, sq, h, kv, 64, BF16, False, sk=sk)
    n_dq, n_kv = b * h * -(-sq // 128), b * kv * -(-sk // 128)
    work_dq, work_dkdv = k3.bwd_item_work(b, sq, h, kv, False, sk)
    assert (len(work_dq), len(work_dkdv)) == (n_dq, n_kv)
    for sched, n in ((p.schedule_dq, n_dq), (p.schedule_dkdv, n_kv)):
        assert len(sched) == min(n, k3.H100_SMS)
        assert sorted(i for items in sched for i in items) == list(range(n))
    f = k3.plan_bwd(b, sq, h, kv, 64, F32, False, sk=sk)
    assert f.grid_dq == (b * h * -(-sq // 64), 1)
    assert f.grid_dkdv == (b * h * -(-sk // 64), 1)
    assert k3.plan_bwd(b, sq, h, kv, 64, BF16, False, sk=sq) is \
        k3.plan_bwd(b, sq, h, kv, 64, BF16, False)


# --- the bidirectional prefix and head dim 256 (paligemma) -----------------------

# (B, S, H, KV, d): MQA and GQA at head dims 16, 64 and 256; S within the
# reference's first chunk, where its XLA attention is the exact prefix mask
PREFIX_SHAPES = [(2, 40, 4, 1, 16), (1, 72, 4, 2, 64), (1, 36, 2, 1, 256)]


@pytest.mark.parametrize("shape", PREFIX_SHAPES)
@pytest.mark.parametrize("prefix", ["0", "1", "7", "S"])
def test_prefix_backward_matches_jax_vjp_of_the_reference(shape, prefix):
    """The plain forward (with its log-sum-exp) and backward with
    ``prefix_len`` P against ``jax.vjp`` of the reference's XLA attention
    with the same prefix, float32: each gradient within 1e-5 of its
    scale."""
    b, s, h, kv, d = shape
    p = s if prefix == "S" else int(prefix)
    q, k, v, do = _draw(s + d + p, b, s, h, kv, d)
    scale = d ** -0.5

    def attn(q, k, v):
        return rL.flash_attention(q, k, v, scale=scale, prefix_len=p)

    o_ref, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = k3.flash_attention_fwd(_t(q), _t(k), _t(v), prefix_len=p,
                                    scale=scale)
    assert _rel(o, o_ref) <= TOL
    got = k3.flash_attention_bwd(_t(do), _t(q), _t(k), _t(v), o, lse,
                                 prefix_len=p, scale=scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= TOL, name


def test_prefix_reaches_the_backward_through_autograd():
    """``ops.flash_attention(..., prefix_len=P)`` under autograd carries P
    to ``flash_attention_bwd``: the gradients equal the plain backward's
    with P, and differ from the plain causal ones."""
    q, k, v, do = (_t(a) for a in _draw(12, 1, 30, 4, 1, 16))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.flash_attention(qg, kg, vg, prefix_len=9).backward(do)
    o, lse = k3.flash_attention_fwd(q, k, v, prefix_len=9)
    want = k3.flash_attention_bwd_plain(do, q, k, v, o, lse, prefix_len=9)
    for t, w in zip((qg, kg, vg), want):
        assert torch.equal(t.grad, w)
    o0, lse0 = k3.flash_attention_fwd(q, k, v)
    causal = k3.flash_attention_bwd_plain(do, q, k, v, o0, lse0)
    assert not torch.equal(causal[1], want[1])


@pytest.mark.parametrize("s,p", [(300, 77), (300, 128), (300, 300),
                                 (1000, 256), (64, 1), (130, 129)])
def test_bwd_item_work_with_a_prefix_counts_the_tiles_of_the_mask(s, p):
    """With a prefix, each bf16 item walks the tiles a brute-force mask
    says it must: a dQ item's keys up to its rows' last visible key (the
    prefix's last where that lies further), a dK / dV item's q tiles from
    the first row that sees one of its keys (row 0 for an item that holds
    a key of the prefix)."""
    b, h, kv = 1, 4, 2
    dq, dkdv = k3.bwd_item_work(b, s, h, kv, True, prefix=p)
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    seen = (j <= i) | (j < p)
    rows, step = k3.BWD_ROWS, k3.BWD_STEP
    nq = -(-s // rows)
    want_dq = [-(-(int(np.nonzero(seen[qb * rows:(qb + 1) * rows].any(0))[0]
                               .max()) + 1) // step) + 1 for qb in range(nq)]
    nstep = -(-s // step)
    want_kv = []
    for kb in range(nq):
        first = int(np.nonzero(seen[:, kb * rows:(kb + 1) * rows].any(1))[0]
                    .min())
        want_kv.append((h // kv) * (nstep - first // step) + 1)
    assert dq == want_dq * (b * h) and dkdv == want_kv * (b * kv)
    assert k3.bwd_item_work(b, s, h, kv, True, prefix=0) == \
        k3.bwd_item_work(b, s, h, kv, True)


@pytest.mark.parametrize("dtype,want", [
    # bf16 on wgmma: dQ items of 128 rows stepping 32 keys through 3 slots
    # (one Q / dO item slot), dK / dV items of 64 keys of one head stepping
    # 64 rows through 2 slots (the split kernel); paligemma B=1 S=4096 H=8:
    # 256 dQ and 512 dK / dV items over the 132 SMs
    (BF16, (k3.BWD_BF16, 128, 64, 64, 32, (3, 2), (132, 1), (132, 1),
            (230512, 231504))),
    # float32: 3xTF32 on wgmma; items of 64 rows or keys, 64-row tiles
    # through 3 ring slots, one block an item (512 of each; was mma.sync
    # with 16-row steps, 2 slots, 199680 and 206080 bytes)
    (F32, (k3.BWD_F32, 64, 64, 64, 64, (3, 3), (512, 1), (512, 1),
           (231480, 231480))),
])
def test_plan_bwd_of_head_dim_256(dtype, want):
    p = k3.plan_bwd(1, 4096, 8, 1, 256, dtype, True, k3.H100_SMS, None, 256)
    assert (p.variant, p.q_rows, p.kv_rows, p.q_step, p.kv_step, p.stages,
            p.grid_dq, p.grid_dkdv, p.smem) == want
    assert max(p.smem) <= SMEM_LIMIT
    assert k3.bwd_variant(dtype) == want[0]
    plain_causal = k3.plan_bwd(1, 4096, 8, 1, 256, dtype)
    if dtype == BF16:
        # persistent grids with schedules; the prefix moves the items' work
        assert p.schedule_dq and p.schedule_dkdv
        assert plain_causal.schedule_dkdv != p.schedule_dkdv
        assert dataclasses.replace(plain_causal, schedule_dq=(),
                                   schedule_dkdv=()) == \
            dataclasses.replace(p, schedule_dq=(), schedule_dkdv=())
    else:
        # the prefix does not change the float32 grids; the wgmma passes'
        # own entry point
        assert not p.schedule_dq and not p.schedule_dkdv
        assert plain_causal == p
        assert p.entry == k3.BWD_F32_TC_ENTRY


def test_tf32_smem_matches_the_source_layout():
    """``_f32_bwd_smem`` mirrors ``f32_dq_smem_bytes`` / ``f32_dkdv_smem_
    bytes``: float32 rows of hd elements and 16 bytes, lse, D and P^T; two
    blocks of the dK / dV kernel an SM at hd 64 and 128, the mma.sync
    route's head dims; hd 256 and (192, 128) go to the wgmma kernels (the
    mma.sync kernels' hd-256 instances and their one-block-an-SM bound are
    gone)."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    assert "f32_kv_blocks" not in src and "launch_tf32<256" not in src
    assert "__global__ void __launch_bounds__(kKVThreads, 2)" in src
    assert re.search(r"row_ld\(\) {\s*return D \+ 4;", src)
    assert "const bool square = hd == hv && (hd == 64 || hd == 128);" in src
    for hd in (64, 128):
        dq, dkdv = k3._f32_bwd_smem(hd)
        pair = 2 * (hd + 4) * 4
        st = k3._f32_step(hd)
        assert dq == (64 + 2 * st) * pair
        assert dkdv == 64 * pair + 64 * (st + 8) * 4 + 2 * (st * pair
                                                            + 2 * st * 4)
        assert max(dq, dkdv) <= SMEM_LIMIT
    assert k3._f32_bwd_smem(128) == (101376, 107776)
    assert re.search(r"int launch_tf32\([^{]*{\s*static_assert\(HD == HV,",
                     src)
    assert k3.plan_bwd(1, 300, 4, 4, 192, torch.float32, hv=128).entry == \
        k3.BWD_F32_TC_ENTRY
    assert k3.plan_bwd(1, 300, 4, 1, 256, torch.float32).entry == \
        k3.BWD_F32_TC_ENTRY
    assert k3.plan_bwd(1, 300, 4, 1, 128, torch.float32).entry is None


@pytest.mark.parametrize("b,s,h,kv,causal,p", [
    (1, 80, 4, 1, True, 24),        # MQA with a prefix
    (1, 96, 4, 2, True, 0),         # GQA, plain causal
    (1, 64, 2, 2, False, 0),        # not causal
])
def test_one_pass_tf32_bf16_backward_holds_the_bf16_gate(b, s, h, kv, causal,
                                                         p):
    """The bf16 kernels at hd 256 (``flash_attention_bwd_bf16``'s ``wgmma``
    dQ kernel and split dK / dV kernel, which replace the one-pass TF32
    route), emulated in numpy on bf16 q, k, v and dO: S and dP exact
    products in float32, P = exp(S scale - lse) and dS = P (dP - D) in
    float32, P and dS rounded to bf16 for the products dQ = dS K, dV_h =
    P^T dO and dK_h = dS^T Q (float32 accumulation, the scale once at the
    end), each head's dK / dV partial summed over its group in head order:
    dq, dk and dv within the bf16 gate (2e-2 of scale) of the float32 plain
    backward, and within 1e-2."""
    d = 256
    q, k, v, do = (a.astype(np.float32) for a in _draw(s + p, b, s, h, kv, d))
    q, k, v, do = (_bf16(a) for a in (q, k, v, do))
    scale = d ** -0.5
    o, lse = k3.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                    prefix_len=p, scale=scale)
    o = o.to(torch.bfloat16).float()
    plain = k3.flash_attention_bwd_plain(_t(do), _t(q), _t(k), _t(v), o, lse,
                                         causal=causal, prefix_len=p,
                                         scale=scale)
    g = h // kv
    heads = lambda t: np.ascontiguousarray(t.transpose(0, 2, 1, 3))
    qh, doh = heads(q), heads(do)
    kh, vh = heads(k)[:, np.arange(h) // g], heads(v)[:, np.arange(h) // g]
    dd = heads((do * o.numpy()).sum(-1, dtype=np.float32)[..., None])[..., 0]
    sc = np.matmul(qh, kh.swapaxes(-1, -2))
    pm = np.exp(sc * np.float32(scale) - lse.numpy()[..., None])
    if causal:
        i, j = np.arange(s)[:, None], np.arange(s)[None, :]
        pm = np.where((j <= i) | (j < p), pm, np.float32(0))
    ds = pm * (np.matmul(doh, vh.swapaxes(-1, -2)) - dd[..., None])
    pb, dsb = _bf16(pm), _bf16(ds)
    dq = np.matmul(dsb, kh) * np.float32(scale)
    dk_h = np.matmul(dsb.swapaxes(-1, -2), qh) * np.float32(scale)
    dv_h = np.matmul(pb.swapaxes(-1, -2), doh)
    got = [dq]
    for part in (dk_h, dv_h):    # [b, h, s, d] -> the group's heads in order
        part = part.reshape(b, kv, g, s, d)
        acc = np.zeros((b, kv, s, d), np.float32)
        for gi in range(g):
            acc += part[:, :, gi]
        got.append(acc)
    for i, name in enumerate(("dq", "dk", "dv")):
        x = np.ascontiguousarray(got[i].transpose(0, 2, 1, 3))
        assert _rel(torch.from_numpy(x), plain[i].numpy()) <= 1e-2, name


# --- head dim 256: the dQ kernel's one item slot, the split dK / dV kernel -----


def _cpp_int(src, fn, d, consts, hv=None):
    """The value of ``constexpr int fn()`` of ``src`` at head dims ``d``
    (hd) and ``hv`` (default ``d``): its return expression with ``D`` and
    ``HD``, ``HV``, the ``name<D>()`` / ``name<HD>()`` helpers and the
    named constants replaced by ``consts``' values, integer division."""
    m = re.search(rf"constexpr int {fn}\(\) {{\s*return (.*?);\s*}}", src,
                  re.S)
    assert m, fn
    expr = re.sub(r"(\w+)<H?D>\(\)", lambda x: str(consts[x[1]]), m[1])
    expr = re.sub(r"\bH?D\b", str(d), expr)
    expr = re.sub(r"\bHV\b", str(d if hv is None else hv), expr)
    for name, value in consts.items():
        expr = re.sub(rf"\b{name}\b", str(value), expr)
    expr = " ".join(expr.split()).replace("/", "//")
    assert re.fullmatch(r"[\d\s+*/()-]+", expr), expr
    return eval(expr)


def test_bwd_plan_at_head_dim_256_matches_the_source_constants():
    """The hd-256 and (192, 128) plans' tile steps, ring depths, item slots
    and shared memory are the source's: ``dq_step``, ``dq_stages``,
    ``dq_slots``, ``split_stages``; ``_bwd_smem`` equals ``dq_smem_bytes``
    and ``split_smem_bytes`` evaluated from the source (and, at 64 and 128,
    ``dq_smem_bytes`` and ``dkdv_smem_bytes``), every one within a block's
    227 KB."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    m = re.search(r"split_stages\(\) {\s*return D == 256 \? (\d+) : (\d+);",
                  src)
    assert m and (int(m[1]), int(m[2])) == (k3._split_stages(256),
                                            k3._split_stages(192)) == (2, 3)
    assert re.search(r"constexpr int kSplitPt = 128 \* \(kStep / 2\);", src)
    m = re.search(r"dq_slots\(\) {\s*return D >= 192 \? (\d+) : (\d+);", src)
    assert m and (int(m[1]), int(m[2])) == (k3._dq_slots(256),
                                            k3._dq_slots(64)) == (1, 2)
    assert k3._dq_slots(192) == 1
    assert re.search(r"constexpr bool kSplit = HD >= 192;", src)
    assert [hd for hd in (64, 128, 192, 256) if k3._split(hd)] == [192, 256]
    p = k3.plan_bwd(1, 4096, 8, 1, 256, BF16)
    assert (p.kv_step, p.q_step, p.q_rows, p.kv_rows, p.stages) == (
        32, 64, 128, 64, (3, k3._split_stages(256)))
    for hd, hv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        st = k3._bwd_stages(hd)
        st_kv = k3._split_stages(hd) if k3._split(hd) else st
        consts = {"kRows": k3.BWD_ROWS, "kStep": k3.BWD_STEP,
                  "kBoxBig": k3.BWD_ROWS * 128, "kBoxStep": k3.BWD_STEP * 128,
                  "split_stages": k3._split_stages(hd),
                  "kSplitPt": 128 * (k3.BWD_STEP // 2),
                  "dq_slots": k3._dq_slots(hd), "dq_stages": st,
                  "dkdv_stages": st, "dq_step": k3._dq_step(hd)}
        dq, dkdv = k3._bwd_smem(hd, st, st_kv, hv)
        assert dq == _cpp_int(src, "dq_smem_bytes", hd, consts, hv)
        assert dkdv == _cpp_int(src, "split_smem_bytes" if k3._split(hd)
                                else "dkdv_smem_bytes", hd, consts, hv)
        assert max(dq, dkdv) <= SMEM_LIMIT
    assert k3._bwd_smem(256, 3, 2) == (230512, 231504)
    # (192, 128): one 80 KB item slot and 3 stages of 64-key K / V tiles
    # (40 KB a stage); the split kernel's resident K / V (40 KB), 3 ring
    # slots of Q / dO with lse2 and D (40.5 KB a slot), two P^T buffers
    assert k3._bwd_smem(192, 3, 3, 128) == (
        1024 + 80 * 1024 + 3 * 40 * 1024 + (2 + 12) * 8,
        1024 + 40 * 1024 + 3 * (40 * 1024 + 512) + 32 * 1024 + 12 * 8)


# (B, S, H, KV), prefix: paligemma's two shapes, a ragged GQA with a ragged
# prefix, a plain causal GQA
D256_SHAPES = [((1, 4096, 8, 1), 256), ((8, 1024, 8, 1), 256),
               ((2, 1000, 4, 2), 77), ((1, 300, 4, 2), 0)]


def _want_group(per_head, heads, round_bytes):
    """The items of a schedule group: one head's where the operands the
    first round of blocks streams pass 64 MB (more than the card's 50 MB
    L2 holds), else every item."""
    return per_head if round_bytes > 64 << 20 else per_head * heads


def _check_schedule(sched, work, grid, group):
    """Every item exactly once; every block's list runs group by group
    (runs of ``group`` consecutive items), heaviest first inside each; no
    block gets more than the even share plus one item (LPT's bound); the
    blocks' first items are the first of that order; the grid is the SM
    count or the item count, whichever is smaller."""
    assert grid == (min(len(work), k3.H100_SMS), 1)
    assert len(sched) == grid[0] and all(sched)
    assert sorted(i for items in sched for i in items) \
        == list(range(len(work)))

    def key(i):
        return i // group, -work[i], i

    for items in sched:
        assert [key(i) for i in items] == sorted(key(i) for i in items)
    loads = [sum(work[i] for i in items) for items in sched]
    assert max(loads) <= sum(work) / len(sched) + max(work)
    order = sorted(range(len(work)), key=key)
    assert sorted(items[0] for items in sched) == sorted(order[:len(sched)])


@pytest.mark.parametrize("shape,prefix", D256_SHAPES)
def test_bwd_schedule_at_head_dim_256_covers_every_item_once_heaviest_first(
        shape, prefix):
    """At hd 256 each kernel's schedule holds every item exactly once --
    dQ items of 128 rows of one (b, head), dK / dV items of 64 keys of one
    (b, head) -- each block's list heaviest first, within LPT's bound, the
    blocks' first items among the heaviest."""
    b, s, h, kv = shape
    p = k3.plan_bwd(b, s, h, kv, 256, BF16, True, k3.H100_SMS, None, prefix)
    work_dq, work_dkdv = k3.bwd_item_work(b, s, h, kv, True, prefix=prefix,
                                          hd=256)
    assert len(work_dq) == b * h * -(-s // 128)
    assert len(work_dkdv) == b * h * -(-s // 64)
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
        firsts = sorted((work[items[0]] for items in sched), reverse=True)
        assert firsts == sorted(work, reverse=True)[:len(sched)]
    # the kernel reads the dK / dV schedule after the dQ one's
    words = k3.schedule_words(p)
    assert len(words) == (p.grid_dq[0] + 1 + len(work_dq)
                          + p.grid_dkdv[0] + 1 + len(work_dkdv))


# (B, S, H == KV) at (192, 128): deepseek's training (r) and prefill (a)
# shape, its B=8 prefill (b), a ragged one
MLA_SCHEDULE_SHAPES = [(1, 4096, 128), (8, 1024, 128), (2, 1000, 4)]


@pytest.mark.parametrize("shape", MLA_SCHEDULE_SHAPES)
def test_bwd_schedule_at_mla_head_dims_covers_every_item_once_heaviest_first(
        shape):
    """At (192, 128) each kernel's schedule holds every item exactly once
    -- dQ items of 128 rows of one (b, head), dK / dV items of 64 keys of
    one (b, head), the split kernel's -- head by head where the operands a
    round of 132 blocks streams pass the L2 (deepseek: K / V and Q / dO of
    128 heads, 2.6 MB each at S = 4096), heaviest first inside each head,
    within LPT's bound; the item work is ``bwd_item_work``'s at hd 192."""
    b, s, h = shape
    p = k3.plan_bwd(b, s, h, h, 192, BF16, hv=128)
    work_dq, work_dkdv = k3.bwd_item_work(b, s, h, h, True, hd=192)
    nq, nk = -(-s // 128), -(-s // 64)
    assert len(work_dq) == b * h * nq and len(work_dkdv) == b * h * nk
    round_bytes = min(k3.H100_SMS, b * h) * s * (192 + 128) * 2
    group_dq = _want_group(nq, b * h, round_bytes)
    group_kv = _want_group(nk, b * h, round_bytes)
    assert (group_dq, group_kv) == ((nq, nk) if h == 128 else
                                    (b * h * nq, b * h * nk))
    for sched, work, grid, group in (
            (p.schedule_dq, work_dq, p.grid_dq, group_dq),
            (p.schedule_dkdv, work_dkdv, p.grid_dkdv, group_kv)):
        _check_schedule(sched, work, grid, group)


@pytest.mark.parametrize("s,p", [(300, 0), (1000, 77), (4096, 0)])
def test_bwd_item_work_at_mla_head_dims_counts_the_kernels_tiles(s, p):
    """At (192, 128) each item walks the kernels' own tiles a brute-force
    mask says it must, plus one for its set-up: a dQ item of 128 rows the
    64-key tiles (``_dq_step(192)``) up to its rows' last visible key; a
    dK / dV item of 64 keys of one head (the split kernel's) the 64-row q
    tiles from the first row that sees one of its keys.  Not causal: every
    tile."""
    b, h = 2, 4
    assert k3._dq_step(192) == k3.BWD_STEP == 64
    dq, dkdv = k3.bwd_item_work(b, s, h, h, True, prefix=p, hd=192)
    n = min(s, 1024)             # the brute force at a prefix of the rows
    i = np.arange(s)[:, None]
    j = np.arange(n)[None, :]
    seen = (j <= i) | (j < p)
    want_dq = []
    for qb in range(-(-s // 128)):
        rows = np.arange(qb * 128, min(qb * 128 + 128, s))
        last = max(int(rows.max()), min(p, s) - 1)
        want_dq.append(-(-(last + 1) // 64) + 1)
    want_kv = []
    for kb in range(-(-s // 64)):
        if kb * 64 < n:
            first = int(np.nonzero(seen[:, kb * 64:kb * 64 + 64].any(1))[0]
                        .min())
        else:                     # past the brute force: past the prefix
            first = kb * 64
        want_kv.append(-(-s // 64) - first // 64 + 1)
    assert dq == want_dq * (b * h) and dkdv == want_kv * (b * h)
    nc_dq, nc_kv = k3.bwd_item_work(b, s, h, h, False, hd=192)
    assert nc_dq == [-(-s // 64) + 1] * (b * h * -(-s // 128))
    assert nc_kv == [-(-s // 64) + 1] * (b * h * -(-s // 64))


def test_lpt_groups_run_in_order_heaviest_first_inside_each():
    """``_lpt`` with a group: the groups' items in group order, each
    group's heaviest first, every item to the least loaded block; without
    one, heaviest first over every item; ``_group_items`` takes one head's
    items past ``L2_GROUP_BYTES``."""
    work = [1, 5, 3, 2, 9, 4]
    # 9, 5, 4, 3, 2, 1 in turn to the lighter block (ties: block 0)
    assert k3._lpt(work, 2) == ((4, 2), (1, 5, 3, 0))
    # items 0-2 (5, 3, 1), then items 3-5 (9, 4, 2)
    assert k3._lpt(work, 2, 3) == ((1, 5, 3), (2, 0, 4))
    assert k3.L2_GROUP_BYTES == 64 << 20
    assert k3._group_items(32, 128, k3.L2_GROUP_BYTES) == 32 * 128
    assert k3._group_items(32, 128, k3.L2_GROUP_BYTES + 1) == 32


@pytest.mark.parametrize("s,p", [(300, 77), (300, 256), (1000, 256),
                                 (130, 129), (64, 1), (4096, 256)])
def test_bwd_item_work_at_head_dim_256_counts_the_tiles_of_the_mask(s, p):
    """At hd 256 each item walks the kernel's own tiles a brute-force mask
    says it must, plus one for its set-up: a dQ item of 128 rows the 32-key
    tiles up to its rows' last visible key; a dK / dV item of 64 keys of one
    head the 64-row q tiles from the first row that sees one of its keys.
    Not causal: every tile."""
    b, h, kv = 2, 4, 2
    dq, dkdv = k3.bwd_item_work(b, s, h, kv, True, prefix=p, hd=256)
    n = min(s, 1024)             # the brute force at a prefix of the rows
    i = np.arange(s)[:, None]
    j = np.arange(n)[None, :]
    seen = (j <= i) | (j < p)
    want_dq = []
    for qb in range(-(-s // 128)):
        rows = np.arange(qb * 128, min(qb * 128 + 128, s))
        last = max(int(rows.max()), min(p, s) - 1)
        want_dq.append(-(-(last + 1) // 32) + 1)
    want_kv = []
    for kb in range(-(-s // 64)):
        if kb * 64 < n:
            first = int(np.nonzero(seen[:, kb * 64:kb * 64 + 64].any(1))[0]
                        .min())
        else:                     # past the brute force: past the prefix
            first = kb * 64
        want_kv.append(-(-s // 64) - first // 64 + 1)
    assert dq == want_dq * (b * h) and dkdv == want_kv * (b * h)
    # the brute-force dQ horizon, where the mask was drawn
    for qb in range(-(-min(s, 1024) // 128)):
        block = seen[qb * 128:(qb + 1) * 128]
        assert int(np.nonzero(block.any(0))[0].max()) + 1 == min(
            n, max(min(qb * 128 + 128, s), min(p, s)))
    nc_dq, nc_kv = k3.bwd_item_work(b, s, h, kv, False, hd=256)
    assert nc_dq == [-(-s // 32) + 1] * (b * h * -(-s // 128))
    assert nc_kv == [-(-s // 64) + 1] * (b * h * -(-s // 64))


def _bf16(a):
    """float32 rounded to bf16 (to nearest, ties to even) and back."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


# --- deepseek's MLA: head dims (192, 128), H == KV ----------------------------------


@pytest.mark.parametrize("s,causal", [(64, True), (300, True), (100, False)])
def test_mla_backward_matches_jax_vjp_of_the_reference(s, causal):
    """q / k of 192 columns, v / dO of 128, H == KV, scale 192 ** -0.5: the
    plain backward against ``jax.vjp`` of the reference's XLA attention
    (causal, what ``mla_block`` trains through) or of ``attention_ref``
    (not causal), float32, each gradient within ``TOL`` of its scale."""
    from repro.kernels import ref
    rng = np.random.default_rng(s)
    b, h = 2, 2
    q, k = (rng.normal(size=(b, s, h, 192)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.normal(size=(b, s, h, 128)).astype(np.float32)
             for _ in range(2))
    scale = 192 ** -0.5

    def attn(q, k, v):
        if causal:
            return rL.flash_attention(q, k, v, scale=scale, chunk=128)
        return ref.attention_ref(q, k, v, causal=False, scale=scale)

    o_ref, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = k3.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                    scale=scale)
    assert _rel(o, o_ref) <= TOL
    got = k3.flash_attention_bwd(_t(do), _t(q), _t(k), _t(v), o, lse,
                                 causal=causal, scale=scale)
    assert [tuple(g.shape) for g in got] == [(b, s, h, 192), (b, s, h, 192),
                                             (b, s, h, 128)]
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("dtype,want", [
    # bf16 on wgmma: dQ items of 128 rows stepping 64 keys through 3 slots
    # (one Q / dO item slot, 80 KB), dK / dV items of 64 keys of one head
    # stepping 64 rows through 3 slots (the split kernel): 4,096 dQ and
    # 8,192 dK / dV items over the 132 SMs
    (BF16, (k3.BWD_BF16, 128, 64, 64, 64, (3, 3), (132, 1), (132, 1),
            (205936, 199264))),
    # float32: 3xTF32 on wgmma; items of 64 rows or keys, 64-row tiles
    # through rings of 4 slots, one block an item
    (F32, (k3.BWD_F32, 64, 64, 64, 64, (4, 4), (128 * 64, 1),
           (128 * 64, 1), (230472, 230472))),
])
def test_plan_bwd_of_mla_head_dims(dtype, want):
    """deepseek's (192, 128) at its training shape B=1 S=4096 H=KV=128:
    bf16 on the wgmma kernels (the split dK / dV kernel, as at 256) with
    persistent grids of at most one block an SM, float32 on the 3xTF32
    wgmma passes (``BWD_F32_TC_ENTRY``); with GQA it is refused in either
    dtype."""
    p = k3.plan_bwd(1, 4096, 128, 128, 192, dtype, hv=128)
    assert p.variant == want[0] == k3.bwd_variant(dtype)
    assert (p.variant, p.q_rows, p.kv_rows, p.q_step, p.kv_step, p.stages,
            p.grid_dq, p.grid_dkdv, p.smem) == want
    assert max(p.smem) <= SMEM_LIMIT
    if dtype == BF16:
        assert p.smem == k3._bwd_smem(192, 3, 3, 128)
        assert max(p.grid_dq[0], p.grid_dkdv[0]) <= k3.H100_SMS
        assert p.schedule_dq and p.schedule_dkdv
    else:
        assert p.smem == (k3.f32_tc_bwd_smem(192, 128),) * 2
        assert not p.schedule_dq and not p.schedule_dkdv
        assert p.entry == k3.BWD_F32_TC_ENTRY
    with pytest.raises(ValueError, match="GQA"):
        k3.plan_bwd(1, 256, 4, 2, 192, dtype, hv=128)


def test_mla_bwd_work_separates_the_widths():
    """``bwd_work`` at (192, 128): (6 hd + 4 hv) B H pairs; q, k, dq, dk at
    192 columns, v, o, dO, dv at 128."""
    flops, nbytes = k3.bwd_work(1, 4096, 128, 128, 192, 128, True,
                                torch.bfloat16)
    pairs = 4096 * 4097 // 2
    assert flops == (6 * 192 + 4 * 128) * 128 * pairs
    assert nbytes == 2 * 4096 * (2 * 128 * 192 + 2 * 128 * 128
                                 + 2 * (128 * 192 + 128 * 128)) \
        + 2 * 4 * 128 * 4096


def test_mla_bwd_instances_are_in_the_source():
    """The bf16 wgmma kernels are templated on both widths and have (192,
    128) instances -- the dQ kernel and the split dK / dV kernel, with the
    m64n192k16 product for dS K and dS^T Q --, float32 the three passes of
    the 3xTF32 wgmma kernel (the mma.sync kernels no longer take it); the
    TF32 route with bf16 tiles is gone, and each entry takes ``int hd, int
    hv``."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    assert "launch_tf32<192, 128>" not in src
    for inst in ("launch_bf16<192, 128>", "launch_b3<192, 128>",
                 "launch_b3_pass<kPassDQ, HD, HV>",
                 "launch_b3_pass<kPassDK, HD, HV>",
                 "launch_b3_pass<kPassDV, HD, HV>",
                 "flash_bwd_dq_bf16_tc_kernel<HD, HV>",
                 "flash_bwd_dkdv_bf16_split_kernel<HD, HV>",
                 "dq_smem_bytes<192, 128>() <= 232448",
                 "split_smem_bytes<192, 128>() <= 232448",
                 "wgmma_rs<192>(float (&d)[96]"):
        assert inst in src, inst
    hopper = (build.CSRC_DIR / "hopper.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16" in hopper
    assert "flash_attention_bwd_bf16_mma" not in src
    assert "tf32_entry" not in src and "typename T, int HD" not in src
    assert k3.BWD_VARIANTS == (k3.BWD_BF16, k3.BWD_F32)
    assert not hasattr(k3, "BWD_BF16_MMA")
    for name in k3.BWD_VARIANTS:
        m = re.search(rf"\nint {name}\(([^)]*)\)", src)
        assert m and "int hd, int hv," in " ".join(m[1].split()), name


def test_f32_wgmma_smem_and_scratch_match_the_source_layout():
    """The float32 wgmma backward at (192, 128) and at hd 256:
    ``f32_tc_bwd_smem`` mirrors ``b3_smem_bytes`` -- the resident tile's
    TF32 hi and lo (64 rows of 192 or 256 floats), 32 KB ring slots
    (``b3_slots``: 4, or 3 at 256), the staged lse2 and D (``b3_stat_bytes``:
    1 KB at 256), the mbarriers, the 1 KiB alignment -- and fits a block's
    227 KB; the scratch the wrapper allocates is ``b3_scratch``'s layout (q,
    k, v, do split; q, k, do transposed and split, rows rounded up to 64;
    D; with GQA the dK / dV partials), over B H query heads and B KV kv
    heads."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    const = {name: int(val) for name, val in re.findall(
        r"constexpr int (kB3\w+) = (\d+);", src)}
    assert const == {"kB3Rows": k3.F32_TC_ROWS, "kB3Threads": 160,
                     "kB3Box": 8192}
    assert "constexpr int kB3Slot = 4 * kB3Box;" in src
    const["kB3Slot"] = 4 * const["kB3Box"]
    assert const["kB3Slot"] == k3.F32_TC_SLOT_BYTES
    m = re.search(r"b3_slots\(\) {\s*return HD == 256 \? (\d+) : (\d+);",
                  src)
    assert m and (int(m[1]), int(m[2])) == (k3.f32_tc_slots(256),
                                            k3.f32_tc_slots(192)) == (3, 4)
    m = re.search(r"b3_stat_bytes\(\) {\s*return HD == 256 \? (.*?) : 0;",
                  src)
    assert m and eval(m[1].replace("kB3Rows", "64")) == \
        k3.f32_tc_bwd_stat_bytes(256) == 1024
    assert k3.f32_tc_bwd_stat_bytes(192) == 0
    body = re.search(r"constexpr int b3_smem_bytes\(\) {\s*return "
                     r"(.*?);", src, re.S)[1]
    for hd, hv, want in (
            (192, 128, 1024 + 2 * 64 * 192 * 4 + 4 * 32768 + 9 * 8),
            (256, 256, 1024 + 2 * 64 * 256 * 4 + 3 * 32768 + 1024 + 7 * 8)):
        expr = body.replace("b3_slots<HD>()", str(k3.f32_tc_slots(hd)))
        expr = expr.replace("b3_stat_bytes<HD>()",
                            str(k3.f32_tc_bwd_stat_bytes(hd)))
        expr = re.sub(r"\bHD\b", str(hd), expr)
        expr = re.sub(r"\bHV\b", str(hv), expr)
        for name, val in sorted(const.items(), key=lambda kv: -len(kv[0])):
            expr = re.sub(rf"\b{name}\b", str(val), expr)
        expr = " ".join(expr.split())
        assert re.fullmatch(r"[\d\s+*()]+", expr), expr
        assert eval(expr) == k3.f32_tc_bwd_smem(hd, hv) == want <= SMEM_LIMIT
    assert "static_assert(b3_smem_bytes<192, 128>() <= 232448 &&" in src
    assert "b3_smem_bytes<256, 256>() <= 232448," in src
    for b, s, sk, h, kv, hd, hv in ((1, 4096, 4096, 128, 128, 192, 128),
                                    (2, 1000, 1000, 4, 4, 192, 128),
                                    (1, 77, 1000, 2, 2, 192, 128),
                                    (1, 4096, 4096, 8, 1, 256, 256),
                                    (2, 1001, 1001, 4, 2, 256, 256)):
        sp, skp = -(-s // 64) * 64, -(-sk // 64) * 64
        n, nkv = b * h, b * kv
        want = 2 * (n * s * hd + nkv * sk * hd + nkv * sk * hv + n * s * hv
                    + n * hd * sp + nkv * hd * skp + n * hv * sp)
        want += -(-(n * s) // 4) * 4 if h > kv else n * s
        want += (h > kv) * 2 * b * sk * h * hd
        assert k3.f32_tc_bwd_scratch_floats(b, s, sk, h, kv, hd, hv) == want
    for line in ("s.dout = s.v + 2 * s.nv;", "s.qt = s.dout + 2 * s.ndo;",
                 "s.kt = s.qt + 2 * s.nqt;", "s.dot = s.kt + 2 * s.nkt;",
                 "s.dd = s.dot + 2 * s.ndot;",
                 "s.part = s.dd + (n * S + 3) / 4 * 4;",
                 "s.nk = nkv * Sk * HD;", "s.nkt = nkv * HD * s.skp;"):
        assert line in src, line


def test_f32_wgmma_backward_at_head_dim_256_runs_3xtf32_with_gqa():
    """The hd-256 float32 backward's passes are the wgmma kernel's
    ``<kPass*, 256, 256>`` instances: both shared-memory operands K-major,
    every product three TF32 wgmma (S, dP from shared memory, the outputs
    with dS or P from registers), dP from 32-column chunks that hold A and
    B in one ring slot (3 slots), lse2 and D staged in shared memory for the
    dK / dV passes; the item's operands over its heads (a_head) and the
    streamed tiles' over the others (t_head), so GQA's kv heads are read in
    place; with GQA the dK / dV items write per-head partials that
    ``flash_bwd_dkdv_sum_f32_kernel<float, 256>`` adds in head order, and
    nothing adds with an atomic."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    for line in ("launch_b3<256, 256>(p, B, sc, ctas_dq, ctas_kv, parts,",
                 "const bool wide = hd == 256 && hv == 256;",
                 "const bool rect = hd == 192 && hv == 128 && H == KV;",
                 "constexpr bool kOneSlotDP = kSlots == 3;",
                 "issue_ss(dp, box, [box](int) { return box(1); }, c == 0,",
                 "const int a_head = kByRow ? bh : kvbh;",
                 "const int t_head = kByRow ? kvbh : bh;",
                 "const bool partial = !kByRow && p.H > p.KV;",
                 "err = launch_sum<float, HD>(p, B, stream);",
                 "if constexpr (kStage) bar_sync(1, 128);"):
        assert line in src, line
    body = src[src.index("flash_bwd_f32_wgmma_kernel(const __grid_constant__"):]
    body = body[:body.index("\n}\n")]
    assert body.count("wgmma_tf32_ss_m64n64k8(") == 3
    assert body.count("wgmma_tf32_rs_m64n64k8(") == 3
    assert "mma.sync" not in body and "atomic" not in body
    for hd, kv in ((256, 1), (256, 2), (256, 8)):
        p = k3.plan_bwd(2, 300, 8, kv, hd, torch.float32, prefix=77)
        assert p.entry == k3.BWD_F32_TC_ENTRY and p.stages == (3, 3)
        assert p.smem == (k3.f32_tc_bwd_smem(256, 256),) * 2
        assert p.grid_dq == p.grid_dkdv == (2 * 8 * -(-300 // 64), 1)
