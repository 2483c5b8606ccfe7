"""K4's backward (``repro_torch.kernels.ssd_scan``) on the CPU.

The reference has no backward kernel for its SSD scan: it trains through
its XLA chunked form, ``repro.models.ssd.ssd_chunked``, and ``jax.vjp``
differentiates that.  The port's plain backward, ``ssd_scan_bwd_plain``
(the chunked algebra, chunk by chunk), is held against that ``jax.vjp`` in
float32 on the same numpy inputs -- 2 and 3 chunks, ``ngroups == 1``, with
and without a cotangent of the final state -- and against float64
``torch.autograd`` of the chunked forward.  Tolerance: each gradient within
1e-5 of its own scale (max |reference|); measured below 2e-6 -- sums in
other orders.  The CUDA kernels (``csrc/ssd_scan_bwd.cu``) are held to the
plain version on the card by ``chip_smoke.py`` (its ``training`` phase,
part h); here the routing, the plan and the source's rules.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as rssd
from repro_torch.core import census
from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as k4

TOL = 1e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (b, S, nh, hp, ds, chunk): 3 chunks of 16; 2 chunks at the shared_cb
# forward's head size 64 with a 64-wide state
SHAPES = [(2, 48, 3, 8, 16, 16), (1, 128, 2, 64, 64, 64)]


def _draw(seed, b, s, nh, hp, ds):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, nh, hp)).astype(np.float32)
    dt = (rng.uniform(size=(b, s, nh)) * 0.19 + 0.01).astype(np.float32)
    A = -(rng.uniform(size=(nh,)) * 1.5 + 0.5).astype(np.float32)
    B = rng.normal(size=(b, s, 1, ds)).astype(np.float32)
    C = rng.normal(size=(b, s, 1, ds)).astype(np.float32)
    dy = rng.normal(size=(b, s, nh, hp)).astype(np.float32)
    df = rng.normal(size=(b, nh, hp, ds)).astype(np.float32)
    return (x, dt, A, B, C), dy, df


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_final", [True, False])
def test_plain_backward_matches_jax_vjp_of_the_reference(shape, with_final):
    b, s, nh, hp, ds, q = shape
    inputs, dy, df = _draw(1, b, s, nh, hp, ds)
    (_, final), vjp = jax.vjp(lambda *a: rssd.ssd_chunked(*a, q),
                              *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(df) if with_final else jnp.zeros_like(final)))
    got = k4.ssd_scan_bwd_plain(_t(dy), _t(df) if with_final else None,
                                *map(_t, inputs), chunk=q)
    for name, g, w, t in zip(NAMES, got, want, inputs):
        assert g.dtype == torch.float32 and tuple(g.shape) == t.shape
        assert _rel(g, w) <= TOL, name


def _scan64(x, dt, A, B, C, q):
    """The reference's chunked form (``ssd_chunked``, ngroups == 1) as
    float64 tensor code: (y, final state)."""
    b, s, nh, hp = x.shape
    nc = s // q
    xc = x.reshape(b, nc, q, nh, hp)
    dtc = dt.reshape(b, nc, q, nh)
    Bc, Cc = B.reshape(b, nc, q, -1), C.reshape(b, nc, q, -1)
    dA = dtc * A
    cum = torch.cumsum(dA, dim=2)
    seg = cum.transpose(2, 3)[..., :, None] - cum.transpose(2, 3)[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool).tril()
    L = torch.exp(seg.masked_fill(~mask, float("-inf")))
    CB = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bchqk,bckhp->bcqhp", CB[:, :, None] * L, xdt)
    decay_end = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bcqs,bcqh,bcqhp->bchps", Bc, decay_end, xdt)
    st = torch.zeros((b, nh, hp, Bc.shape[-1]), dtype=x.dtype)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(cum[:, c, -1])[..., None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)
    y = y + torch.einsum("bcqs,bcqh,bchps->bcqhp", Cc, torch.exp(cum), prev)
    return y.reshape(b, s, nh, hp), st


def test_plain_backward_matches_float64_autograd():
    b, s, nh, hp, ds, q = SHAPES[0]
    inputs, dy, df = _draw(2, b, s, nh, hp, ds)
    leaves = [_t(a).double().requires_grad_(True) for a in inputs]
    y, final = _scan64(*leaves, q)
    want = torch.autograd.grad((y * _t(dy).double()).sum()
                               + (final * _t(df).double()).sum(), leaves)
    got = k4.ssd_scan_bwd_plain(_t(dy), _t(df), *map(_t, inputs), chunk=q)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w.numpy()) <= TOL, name


def test_autograd_on_the_cpu_reaches_the_plain_backward(monkeypatch):
    """``ops.ssd_scan`` records ``SSDScan`` where an input requires a
    gradient; on CPU tensors its backward is ``ssd_scan_bwd_plain``, once a
    call, and nothing launches or loads."""
    calls = []
    real = k4.ssd_scan_bwd_plain

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(k4, "ssd_scan_bwd_plain", spy)
    k4.reset_launch_counts()
    b, s, nh, hp, ds, q = SHAPES[0]
    inputs, dy, df = _draw(3, b, s, nh, hp, ds)
    leaves = [_t(a).requires_grad_(True) for a in inputs]
    y, final = ops.ssd_scan(*leaves, chunk=q, out_dtype=torch.float32)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    torch.autograd.backward((y, final), (_t(dy), _t(df)))
    assert calls == [{"chunk": q}]
    want = real(_t(dy), _t(df), *map(_t, inputs), chunk=q)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    assert k4.launch_counts() == {k: 0 for k in k4.LAUNCHES}
    assert k4._bwd_bound is None and k4._bound is None


def test_unused_final_state_gives_no_cotangent(monkeypatch):
    """The model discards the final state in training: the backward gets no
    cotangent for it (None, not a tensor of zeros)."""
    seen = []
    real = k4.ssd_scan_bwd

    def spy(dy, d_final, *args, **kw):
        seen.append(d_final)
        return real(dy, d_final, *args, **kw)

    monkeypatch.setattr(k4, "ssd_scan_bwd", spy)
    b, s, nh, hp, ds, q = SHAPES[0]
    inputs, dy, _ = _draw(4, b, s, nh, hp, ds)
    leaves = [_t(a).requires_grad_(True) for a in inputs]
    y, _ = ops.ssd_scan(*leaves, chunk=q, out_dtype=torch.float32)
    (y * _t(dy)).sum().backward()
    assert seen == [None]


def test_no_grad_takes_the_prefill_path(monkeypatch):
    """Under ``no_grad`` (prefill) the call is K4's forward as before: no
    autograd function."""
    monkeypatch.setattr(k4, "SSDScan", None)
    b, s, nh, hp, ds, q = SHAPES[0]
    inputs, _, _ = _draw(5, b, s, nh, hp, ds)
    leaves = [_t(a).requires_grad_(True) for a in inputs]
    with torch.no_grad():
        y, final = ops.ssd_scan(*leaves, chunk=q)
    assert y.grad_fn is None
    want = k4.ssd_scan_plain(*map(_t, inputs), chunk=q)
    assert torch.equal(y, want[0]) and torch.equal(final, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_keeps_the_input_dtypes(dtype):
    b, s, nh, hp, ds, q = SHAPES[0]
    (x, dt, A, B, C), dy, _ = _draw(6, b, s, nh, hp, ds)
    x, B, C = (_t(a).to(dtype) for a in (x, B, C))
    got = k4.ssd_scan_bwd(_t(dy), None, x, _t(dt), _t(A), B, C, chunk=q)
    for g, t in zip(got, (x, _t(dt), _t(A), B, C)):
        assert g.dtype == t.dtype and g.shape == t.shape


def test_backward_checks_its_cotangents():
    b, s, nh, hp, ds, q = SHAPES[0]
    inputs, dy, df = _draw(7, b, s, nh, hp, ds)
    args = list(map(_t, inputs))
    with pytest.raises(ValueError, match="dy"):
        k4.ssd_scan_bwd(_t(dy)[:, :-1], None, *args, chunk=q)
    with pytest.raises(ValueError, match="d_final"):
        k4.ssd_scan_bwd(_t(dy), _t(df)[..., :-1], *args, chunk=q)


def test_meta_route_books_both_kernels_and_launches_nothing():
    """The census's shape-only route: on meta tensors the forward and the
    backward return empty outputs of the right shapes, count no launch and
    each book one census entry (the forward's also saves its meta
    scratch)."""
    b, s, nh, hp, ds, q = 2, 512, 24, 64, 128, 256
    dev = "meta"
    x = torch.empty((b, s, nh, hp), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    dt = torch.empty((b, s, nh), device=dev, requires_grad=True)
    A = torch.empty((nh,), device=dev, requires_grad=True)
    B = torch.empty((b, s, 1, ds), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    C = torch.empty((b, s, 1, ds), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    k4.reset_launch_counts()

    def step():
        y, _ = ops.ssd_scan(x, dt, A, B, C, chunk=q, out_dtype=torch.float32)
        return torch.autograd.grad(y.sum(), (x, dt, A, B, C))

    got = census.analyze_step(step)
    assert k4.launch_counts() == {k: 0 for k in k4.LAUNCHES}
    kern = got["kernels"]
    assert kern["ssd_scan_bf16"]["launches"] == 1
    assert kern["ssd_scan_bwd_bf16"]["launches"] == 1
    flops, nbytes = k4.census_work_bwd(b, s, nh, hp, ds, q, torch.bfloat16,
                                       False)
    assert kern["ssd_scan_bwd_bf16"]["flops"] == flops
    assert kern["ssd_scan_bwd_bf16"]["bytes"] == nbytes


def test_plan_bwd_of_the_model_shape():
    """mamba2-130m's training shape takes the tensor-core variant: 4 row
    tiles of the 256-step chunk (10 lower-triangle tile pairs), 16 chunks,
    24 heads; per row tile one d(xdt) block and one dB / dC block per 64
    columns of ds, 1536 blocks at B=8, so its heads stay in one group."""
    p = k4.plan_bwd(8, 4096, 24, 64, 128, 256, torch.bfloat16)
    assert p.variant == k4.BWD_TC and p.groups == 1
    assert p.grids == {"dcb": (10, 128, 1), "state_grad": (16, 192, 2),
                       "state_pass": (32, 192, 1), "dxbc": (4, 3, 128),
                       "dcum": (16, 192, 1), "bc_sum": (8192, 1, 1),
                       "da": (1, 1, 1)}
    assert tuple(p.grids) == k4.BWD_LAUNCH_NAMES[k4.BWD_TC]
    assert tuple(p.scratch) == k4.BWD_SCRATCH
    assert p.scratch["dstate"] == (8, 24, 16, 64, 128)
    assert p.scratch["rowpart"] == (8, 24, 16, 4, 256)
    assert p.scratch["yoff"] == (8, 24, 16, 2, 256)
    assert p.scratch["bcpart"] == (1, 2, 8, 4096, 128)
    # the dcum kernel's chunk; the tc kernels' ring of three slices of two
    # operands, 64 x (32 + 4) floats each (dcb's bf16 C and B rows, 2 x 64
    # x 136 bf16, fit in its space)
    ring = 3 * 2 * 64 * 36 * 4
    assert p.smem == {"dcum": 4 * 256, "dcb": ring, "state_grad": ring,
                      "dxbc": ring}
    assert 2 * 64 * 136 * 2 < ring
    assert k4.plan_bwd(8, 4096, 24, 64, 128, 256, torch.float32).smem == \
        p.smem


@pytest.mark.parametrize("b, nh, want", [(1, 24, 2), (2, 24, 1), (8, 24, 1),
                                         (1, 2, 2), (1, 1, 1)])
def test_plan_bwd_splits_the_heads_until_the_card_is_full(b, nh, want):
    """The dxbc launch has three blocks per (batch, chunk, row tile) at ds
    128 and each walks its heads in order; where that is under two blocks
    an SM the plan splits the heads into groups of consecutive heads (never
    more groups than heads), and the scratch holds one float32 dB / dC
    partial per group."""
    p = k4.plan_bwd(b, 4096, nh, 64, 128, 256, torch.bfloat16)
    per = -(-nh // p.groups)
    assert p.groups == want and p.grids["dxbc"] == (4, 3 * want, b * 16)
    assert (p.groups - 1) * per < nh <= p.groups * per
    assert p.scratch["bcpart"] == (want, 2, b, 4096, 128)
    # a card of more SMs takes as many groups or more, never past the heads
    more = k4.plan_bwd(b, 4096, nh, 64, 128, 256, torch.bfloat16,
                       sms=4 * 132).groups
    assert want <= more <= nh


def test_plan_bwd_of_the_zamba2_shape():
    """zamba2-1.2b's scan (hp 64, ds 64, 64 heads) at B=1: the tensor-core
    variant, one 64-column tile of ds (so two dxbc blocks a row tile), and
    three head groups of 22 heads."""
    p = k4.plan_bwd(1, 4096, 64, 64, 64, 256, torch.bfloat16)
    assert p.variant == k4.BWD_TC and p.groups == 3
    assert p.grids["state_grad"] == (16, 64, 1)
    assert p.grids["dxbc"] == (4, 6, 16)
    assert p.grids["bc_sum"] == (-(-2 * 4096 * 64 // 1024), 1, 1)
    assert p.scratch["yoff"] == (1, 64, 16, 1, 256)
    assert p.scratch["bcpart"] == (3, 2, 1, 4096, 64)


@pytest.mark.parametrize("shape, variant", [
    ((8, 4096, 24, 64, 128, 256), "tc"),      # mamba2-130m
    ((1, 4096, 64, 64, 64, 256), "tc"),       # zamba2-1.2b
    ((2, 512, 3, 64, 256, 64), "tc"),         # the widest state, Q 64
    ((2, 48, 3, 8, 16, 16), "general"),       # head size off 64
    ((1, 128, 2, 64, 64, 64), "tc"),
    ((1, 300, 2, 72, 40, 100), "general"),
    ((1, 512, 2, 64, 320, 256), "general"),   # state over 256
    ((1, 1024, 2, 64, 128, 512), "general"),  # chunk over 256
    ((1, 512, 2, 64, 96, 256), "general"),    # state off 64
    ((1, 512, 2, 128, 128, 256), "general"),  # head size 128
])
def test_plan_bwd_variant_follows_the_forward_rule(shape, variant):
    """The tensor-core variant takes exactly the sizes the forward's
    shared_cb variant takes (hp 64, ds a multiple of 64 up to 256, Q a
    multiple of 64 up to 256); every other shape the forward takes runs on
    the general variant, for either input dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        p = k4.plan_bwd(*shape, dtype)
        assert p.variant == variant
        assert (variant == "tc") == (k4.plan(*shape, dtype).variant
                                     == k4.SHARED_CB)
        assert tuple(p.grids) == k4.BWD_LAUNCH_NAMES[variant]
        assert ("bcpart" in p.scratch) == (variant == "tc")
        assert "yoff" in p.scratch


@pytest.mark.parametrize("shape", [(2, 48, 3, 8, 16, 16),
                                   (1, 300, 2, 72, 40, 100)])
def test_plan_bwd_covers_every_forward_shape(shape):
    """Any shape the forward takes: the general variant's tiles rounded up
    (hp 72 and ds 40 as two and one 64-wide tiles, a 100-step chunk as two
    row tiles), y_off's partial row sums one per 64 columns of ds."""
    b, s, nh, hp, ds, q = shape
    p = k4.plan_bwd(b, s, nh, hp, ds, q, torch.float32)
    t = -(-q // 64)
    assert p.variant == k4.GENERAL and p.groups == 1
    assert p.grids["dx"] == (t, s // q, b * nh)
    assert p.grids["dbc"] == (t, -(-ds // 64), b * s // q)
    assert p.grids["state_grad"][2] == -(-hp // 64) * -(-ds // 64)
    assert p.scratch["yoff"] == (b, nh, s // q, -(-ds // 64), q)
    with pytest.raises(ValueError, match="chunk"):
        k4.plan_bwd(1, 16384, 1, 8, 8, 16384, torch.float32)


def test_bwd_plan_matches_the_source_constants():
    """The plan's tile, threads, largest chunk, scratch tensors, launches
    and shared memory are the ones ``csrc/ssd_scan_bwd.cu`` builds with."""
    src = (build.CSRC_DIR / k4.BWD_SOURCE).read_text()
    assert re.search(rf"constexpr int kTile = {k4._TILE};", src)
    assert re.search(rf"constexpr int kThreads = {k4._PASS_THREADS};", src)
    assert re.search(rf"constexpr int kNT = {k4._BWD_TC_THREADS};", src)
    assert re.search(rf"constexpr int kMaxQ = {k4.BWD_MAX_Q};", src)
    assert re.search(rf"constexpr int kScratch = {len(k4.BWD_SCRATCH)};",
                     src)
    assert re.search(r"constexpr int kBK = (\d+);", src).group(1) == \
        str(k4._BWD_TC_SLICE)
    assert re.search(r"constexpr int kStages = 3;", src)
    assert re.search(r"constexpr int kTcBlocksPerSm = "
                     rf"{k4._BWD_TC_BLOCKS_PER_SM};", src)
    for variant in (k4.GENERAL, k4.BWD_TC):
        assert re.search(rf"constexpr int kLaunches = "
                         rf"{len(k4.BWD_LAUNCH_NAMES[variant])};", src)
    # the scratch pointers in the C interface's order
    order = re.findall(r"p\.(\w+) = sc\[(\d+)\]", src)
    assert [name for name, _ in sorted(order, key=lambda t: int(t[1]))] == \
        list(k4.BWD_SCRATCH)
    # one launch statement per planned launch, in the plan's order: the
    # tensor-core variant's first, then the general variant's
    kernels = re.findall(r"(ssd_bwd_\w+?)_kernel(?:<Tin>)?\s*<<<l\[(\d)\]",
                         src)
    tc = ["ssd_bwd_" + n for n in ("dcb_tc", "state_grad_tc", "state_pass",
                                   "dxbc_tc", "dcum", "bc_sum", "da")]
    general = ["ssd_bwd_" + n for n in ("dcb", "state_grad", "state_pass",
                                        "dx", "dbc", "dcum", "da")]
    assert [k for k, _ in kernels] == tc + general
    assert [int(i) for _, i in kernels] == list(range(7)) * 2
    for names, plain in ((tc, k4.BWD_LAUNCH_NAMES[k4.BWD_TC]),
                         (general, k4.BWD_LAUNCH_NAMES[k4.GENERAL])):
        assert [n[len("ssd_bwd_"):].replace("_tc", "") for n in names] == \
            list(plain)
    for name in k4.BWD_KEYS + ("ssd_scan_bwd_launch_shape",
                               "ssd_scan_bwd_error_string"):
        assert re.search(rf"\b{name}\(", src), name
    assert "--use_fast_math" not in build.flags(k4.BWD_SOURCE)


def test_bwd_source_has_no_c_sin_product():
    """dcum's y_off term is the row sum of C (.) (e^cum dY S_in), from the
    product dC needs: no kernel forms C S_in^T (a product over ds of C
    against the entering state)."""
    src = re.sub(r"//[^\n]*", "", (build.CSRC_DIR / k4.BWD_SOURCE)
                 .read_text())
    # the entering state is read by dY S_in (dbc, dxbc) and <S_in, dS> only
    uses = re.findall(r"\b(?:Sin|p\.states)\b[^;]*;", src)
    assert uses and all("Cp" not in u and "Cc" not in u for u in uses)
    assert "C S_in^T" not in src


def test_bwd_source_adds_no_float_atomics_to_its_outputs():
    """dB, dC and dA are shared by heads and positions, yet every output is
    written once by plain stores: no atomicAdd, no red. or atom.
    instruction anywhere in the source, so two runs are bitwise equal."""
    src = (build.CSRC_DIR / k4.BWD_SOURCE).read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for word in ("atomicAdd", "atomicCAS", "red.", "atom."):
        assert word not in code, word
