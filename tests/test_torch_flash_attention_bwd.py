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


@pytest.mark.parametrize("shape,dtype,want", [
    # stablelm-1.6b training, B=1 S=4096: 32 heads of 64
    ((1, 4096, 32, 32, 64), BF16, (k3.BWD_BF16, 64, 64, 64, 64, (32, 64),
                                   (32, 64))),
    # qwen3-14b: 40 heads, 8 kv heads of 128 (dK / dV step 32 query rows)
    ((1, 2048, 40, 8, 128), BF16, (k3.BWD_BF16, 64, 64, 32, 64, (40, 32),
                                   (8, 32))),
    ((1, 512, 32, 32, 64), F32, (k3.BWD_F32, 32, 32, 32, 32, (32, 16),
                                 (32, 16))),
    ((2, 1000, 4, 2, 128), F32, (k3.BWD_F32, 32, 32, 32, 32, (8, 32),
                                 (4, 32))),
])
def test_plan_bwd_of_the_model_shapes(shape, dtype, want):
    p = k3.plan_bwd(*shape, dtype)
    assert (p.variant, p.q_rows, p.kv_rows, p.q_step, p.kv_step, p.grid_dq,
            p.grid_dkdv) == want
    assert k3.plan_bwd(*shape, dtype) is p          # pure, cached


@pytest.mark.parametrize("hd", [16, 32, 256])
def test_plan_bwd_refuses_other_head_dims(hd):
    with pytest.raises(ValueError):
        k3.plan_bwd(1, 128, 2, 2, hd, BF16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_bwd_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        k3.plan_bwd(1, 128, 2, 2, 64, dtype)


def test_bwd_source_defines_the_bound_entry_points():
    """One C entry point per backward ``LAUNCHES`` key; no float atomics
    (two runs bitwise); mma.sync on bf16; every kernel's name starts with
    ``flash_bwd_`` (the profiler's symbol); the build compiles the source
    with FMA contraction and without fast math, like the forward."""
    src = (build.CSRC_DIR / k3.BWD_SOURCE).read_text()
    for name in list(k3.BWD_VARIANTS) + ["flash_attention_bwd_error_string"]:
        assert re.search(rf"\b{name}\(", src), name
    assert "atomicAdd" not in src and "red.global" not in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    kernels = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert len(kernels) == src.count("__global__") == 4
    assert all(name.startswith("flash_bwd_") for name in kernels)
    assert "repro/kernels/flash_attention.py::_flash_kernel" in src
    assert "--use_fast_math" not in build.flags(k3.BWD_SOURCE)
    assert "-fmad=false" not in build.flags(k3.BWD_SOURCE)
    assert "hopper.cuh" in build.local_headers(k3.BWD_SOURCE)
