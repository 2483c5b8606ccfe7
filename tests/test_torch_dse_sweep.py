"""The fused campaign tile (K1 + K1a + K1b in one launch on the card) as far
as a machine without a card reaches: its launch plan, its plain version
``sweep_reduce_plain`` against the reference, the packed result and its
unpacking, and the lazy full rows of the overflow fallback.

The same numpy inputs go through both packages on the CPU.  float32: the
reference's jitted fused sweep (``sweep_workloads_reduced_jit``); survivors,
counts and lanes EQUAL, values ``rtol 1e-6`` (two compilers, the same
single-precision arithmetic).  float64: the reference's numpy sweep
(``xp=np``), its screen and ``_compact_rows_host``; the reference cubes
with ``pow`` and the port with ``x*x*x``, so energies agree to ``rtol
1e-15`` and everything else is EQUAL."""

import jax
import numpy as np
import pytest
import torch

from repro.core import costmodel as ref_cm
from repro.dse_campaign import SliceVariant as RefVariant
from repro.dse_campaign import SpaceSpec as RefSpace
from repro_torch.core import costmodel as cm
from repro_torch.kernels import dse_sweep as kern
from repro_torch.kernels import ops

BASE = np.asarray([3.2e14, 4.5e13, 5e11, 7e11])
FIELDS = ("surv_idx", "surv_energy", "surv_latency", "n_survivors",
          "n_feasible", "ref_energy", "ref_latency")
CONS = {"hbm_power": dict(max_power_w=40_000),
        "latency": dict(max_latency_s=30.0, min_hbm_fit=False),
        "none_feasible": dict(max_power_w=1e-3, min_hbm_fit=False)}


def seeded_workloads(seed: int, w: int = 4) -> np.ndarray:
    """[W, 6] workload rows: the base census scaled log-uniformly over two
    decades, base chips and state per device drawn from the seed."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(w):
        scale = 10.0 ** rng.uniform(-1.5, 0.5)
        rows.append([*(BASE * scale), float(rng.choice([64, 256])),
                     float(rng.uniform(0.1, 2.0))])
    return np.asarray(rows, np.float64)


def seeded_tile(seed: int, n_valid=None, n_pad: int = 0):
    """Padded column arrays of a small reference space, its lanes in an
    order drawn from the seed, the first ``n_valid`` valid."""
    spec = RefSpace(chips=("tpu-v5e", "tpu-v5p", "tpu-edge"),
                    chip_counts=(16, 64), freq_points=7, mesh_dims=3,
                    variants=(RefVariant(), RefVariant("bin85", 0.85)),
                    chunk_size=64)
    b = spec.slice(0, len(spec), with_candidates=False)
    order = np.random.default_rng(seed).permutation(len(b))
    n = len(b) + n_pad
    n_valid = len(b) if n_valid is None else n_valid
    take = np.concatenate([order, np.repeat(order[:1], n_pad)])
    valid = (np.arange(n) < n_valid).astype(np.float64)
    arrays = {"n_chips": b.n_chips[take], "freq_mhz": b.freq_mhz[take],
              "mesh_pod": b.pod_axis()[take],
              "mesh_data": b.mesh_data[take],
              "mesh_model": b.mesh_model[take], "valid": valid}
    arrays.update({k: np.asarray(b.chip_cols[k])[take]
                   for k in ref_cm.SWEEP_GATHER_FIELDS})
    return arrays


def ref_args(wl, arrays):
    chip_cols = {k: arrays[k] for k in ref_cm.SWEEP_GATHER_FIELDS}
    return (wl, chip_cols, arrays["n_chips"], arrays["freq_mhz"],
            arrays["mesh_pod"], arrays["mesh_data"], arrays["mesh_model"],
            arrays["valid"])


def ref_numpy_reduced(wl, arrays, max_survivors, max_power_w=None,
                      max_latency_s=None, min_hbm_fit=True):
    """The reference's float64 reduction: its numpy sweep (the expressions
    of ``_jit_sweep_reduced`` with ``xp=np``), its screen in float64, then
    ``_compact_rows_host``.  Returns a dict of ``FIELDS`` and the rows."""
    row = lambda a: np.asarray(a, np.float64)[None, :]
    wlc = {k: wl[:, i:i + 1] for i, k in enumerate(ref_cm.WL_COLS)}
    cols = {k: row(arrays[k]) for k in ref_cm.SWEEP_GATHER_FIELDS}
    nc = row(arrays["n_chips"])
    ana = ref_cm.scale_census(wlc, wlc["base_chips"], nc, xp=np)
    b = ref_cm.simulate_batch(ana, None, nc, row(arrays["freq_mhz"]),
                              xp=np, gathered=cols,
                              mesh_pod=row(arrays["mesh_pod"]),
                              mesh_data=row(arrays["mesh_data"]),
                              mesh_model=row(arrays["mesh_model"]))
    feas = ref_cm.sweep_feasibility(
        b.power_w, b.latency_s, nc, cols["hbm_bytes"], wlc["base_chips"],
        wlc["state_gb_per_device"], row(arrays["valid"]), max_power_w,
        max_latency_s, min_hbm_fit, xp=np)
    e, l, feas = (np.ascontiguousarray(a) for a in np.broadcast_arrays(
        b.energy_j, b.latency_s, feas))
    with jax.enable_x64(True):
        import jax.numpy as jnp
        keep, ns, nf, re_, rl = (np.asarray(x) for x in ref_cm._screen_rows(
            jnp.asarray(e), jnp.asarray(l), jnp.asarray(feas)))
    idx, se, sl = ref_cm._compact_rows_host(keep, e, l, max_survivors)
    out = dict(zip(FIELDS, (idx, se, sl, ns, nf, re_, rl)))
    return out, (e, l, feas)


def port_packed(wl, arrays, dtype, max_survivors, **cons):
    cand = cm.pack_cand_cols(arrays, dtype)
    wl_t = torch.as_tensor(wl).to(dtype)
    packed = kern.sweep_reduce_plain(cand, wl_t, **cons,
                                     max_survivors=max_survivors)
    p = kern.plan_for(cand, wl_t, max_survivors)
    return kern.unpack(packed.numpy(), p, lambda: None), cand, wl_t


# --- the launch plan ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, clusters, threads",
                         [(4096, 8, 512), (65536, 16, 1024)])
def test_plan_fuses_both_campaign_tiles(dtype, n, clusters, threads):
    p = kern.plan(6, n, dtype, 2048)
    assert p.variant == kern.FUSED
    assert p.clusters == clusters and p.grid == (clusters, 6)
    assert p.threads == threads
    assert p.clusters * p.lanes >= n and p.lanes % 32 == 0
    assert p.smem_bytes == kern.fused_smem(p.lanes, dtype)
    assert p.smem_bytes <= kern.FUSED_SMEM_MAX
    assert p.k == 2048 and p.portable == (clusters <= 8)


# (W, N, dtype) -> (variant, C, lanes, threads, dynamic shared memory bytes)
PLANS = [
    ((1, 1, torch.float64), ("fused", 1, 32, 32, 544)),
    ((3, 15, torch.float32), ("fused", 1, 32, 32, 288)),
    ((2, 600, torch.float64), ("fused", 2, 320, 320, 5440)),
    ((6, 4096, torch.float64), ("fused", 8, 512, 512, 8704)),
    ((6, 4096, torch.float32), ("fused", 8, 512, 512, 4608)),
    ((6, 16384, torch.float32), ("fused", 16, 1024, 512, 9216)),
    ((6, 65536, torch.float64), ("fused", 16, 4096, 1024, 69632)),
    ((6, 65536, torch.float32), ("fused", 16, 4096, 1024, 36864)),
    ((6, 100_000, torch.float32), ("fused", 16, 6272, 1024, 56448)),
    # the last float64 width the shared memory takes, and the first past it
    ((6, 16 * 13_408, torch.float64), ("fused", 16, 13_408, 1024, 227_936)),
    ((6, 16 * 13_408 + 1, torch.float64), ("general", 0, 0, 256, 0)),
    ((6, 500_000, torch.float32), ("general", 0, 0, 256, 0)),
]


@pytest.mark.parametrize("shape, want", PLANS)
def test_plan_shapes(shape, want):
    w, n, dtype = shape
    p = kern.plan(w, n, dtype, 2048)
    assert (p.variant, p.clusters, p.lanes, p.threads, p.smem_bytes) == want
    if p.variant == kern.GENERAL:
        assert p.grid == (-(-n // kern.SWEEP_THREADS), w)
    else:                       # every CTA of the cluster owns lanes
        assert (p.clusters - 1) * p.lanes < n <= p.clusters * p.lanes
    # the plan is a pure function of its arguments, cached
    assert kern.plan(w, n, dtype, 2048) is p
    assert p.blocks_per_sm == p.grid[0] * w / kern.H100_SMS


def test_plan_refuses_what_no_variant_takes():
    with pytest.raises(ValueError, match="grid limit"):
        kern.plan(kern.GRID_Y_MAX + 1, 4096, torch.float64, 2048)
    assert kern.plan(kern.GRID_Y_MAX, 4096, torch.float64, 16).variant \
        == kern.FUSED
    with pytest.raises(TypeError, match="float16"):
        kern.plan(6, 4096, torch.float16, 2048)
    with pytest.raises(ValueError, match="empty"):
        kern.plan(6, 0, torch.float64, 2048)
    with pytest.raises(ValueError, match="max_survivors"):
        kern.plan(6, 64, torch.float64, -1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w, k", [(1, 1), (6, 2048), (5, 7)])
def test_packed_layout_is_aligned_and_dense(dtype, w, k):
    layout, nbytes = kern.packed_layout(w, k, dtype)
    assert list(layout) == ["n_survivors", "n_feasible", "ref_energy",
                            "ref_latency", "surv_idx", "surv_energy",
                            "surv_latency"]
    at = 0
    for name, f in layout.items():
        size = torch.empty((), dtype=f.dtype).element_size()
        assert f.np_dtype.itemsize == size
        assert f.offset == at and f.offset % size == 0
        assert f.nbytes == size * int(np.prod(f.shape))
        at += f.nbytes
    assert at == nbytes
    assert layout["surv_idx"].shape == (w, k)


# --- the plain version against the reference ----------------------------------


@pytest.mark.parametrize("max_survivors", [1, 2, 2048])
@pytest.mark.parametrize("cons", list(CONS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_float64_equals_reference_numpy(seed, cons, max_survivors):
    wl = seeded_workloads(seed)
    arrays = seeded_tile(seed, n_valid=200, n_pad=9)   # a partial tile
    got, _, _ = port_packed(wl, arrays, torch.float64, max_survivors,
                            **CONS[cons])
    want, (e, l, feas) = ref_numpy_reduced(wl, arrays, max_survivors,
                                           **CONS[cons])
    for f in FIELDS:
        g, r = getattr(got, f), want[f]
        assert g.shape == r.shape and g.dtype == r.dtype, f
        if f == "surv_energy":
            np.testing.assert_allclose(g, r, rtol=1e-15, err_msg=f)
        elif f == "ref_energy":
            np.testing.assert_allclose(g, r, rtol=1e-15, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)
    assert not feas[:, 200:].any()                     # padding is masked
    if cons == "none_feasible":
        assert int(got.n_feasible.sum()) == 0 == int(got.n_survivors.sum())
        assert np.isneginf(got.ref_energy).all()
        assert (got.surv_idx == 0).all() and (got.surv_energy == 0).all()
    else:
        assert got.n_feasible.sum() > 0


@pytest.mark.parametrize("max_survivors", [1, 2, 2048])
@pytest.mark.parametrize("cons", list(CONS))
def test_plain_float32_equals_reference_jit(cons, max_survivors):
    wl = seeded_workloads(3)
    arrays = seeded_tile(3, n_pad=5)
    got, _, _ = port_packed(wl, arrays, torch.float32, max_survivors,
                            **CONS[cons])
    want = ref_cm.sweep_workloads_reduced_jit(
        *ref_args(wl, arrays), **CONS[cons], max_survivors=max_survivors)
    for f in FIELDS:
        g, r = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == r.shape, f
        if f in ("surv_energy", "surv_latency", "ref_energy", "ref_latency"):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


# --- the packed result and the host path -------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("max_survivors", [1, 2, 2048])
def test_unpacked_equals_build_sweep_reduced(dtype, max_survivors):
    wl = seeded_workloads(4)
    arrays = seeded_tile(4, n_valid=150, n_pad=3)
    red, cand, wl_t = port_packed(wl, arrays, dtype, max_survivors,
                                  max_power_w=40_000)
    e, l, f = kern.dse_sweep(cand, wl_t, max_power_w=40_000)
    want = cm.build_sweep_reduced(kern.screen_rows(e, l, f) + (e, l, f),
                                  max_survivors)
    for name in FIELDS:
        g, r = getattr(red, name), getattr(want, name)
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert red.max_survivors == want.max_survivors == max_survivors
    overflowed = [red.overflowed(i) for i in range(wl.shape[0])]
    assert overflowed == [want.overflowed(i) for i in range(wl.shape[0])]
    if max_survivors == 1:
        assert any(overflowed)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lazy_full_rows_equal_eager_rows(dtype):
    """On the CPU path ``ops.dse_sweep`` keeps no rows: the overflow
    fallback's rows are swept again when first read, once, and equal the
    rows the plain tensor path keeps."""
    wl = seeded_workloads(5)
    arrays = seeded_tile(5, n_pad=4)
    cand = cm.pack_cand_cols(arrays, dtype)
    wl_t = torch.as_tensor(wl).to(dtype)

    class Cons:
        max_power_w, max_latency_s, min_hbm_fit = 40_000, None, True

    calls = []

    def rows():
        calls.append(1)
        return kern.dse_sweep(cand, wl_t, max_power_w=40_000)

    red = ops.dse_sweep(cand, wl_t, constraint=Cons, max_survivors=1)
    packed = kern.sweep_reduce_plain(cand, wl_t, max_power_w=40_000,
                                     max_survivors=1)
    lazy = kern.unpack(packed.numpy(), kern.plan_for(cand, wl_t, 1), rows)
    eager = cm.sweep_workloads_reduced(*ref_args(wl, arrays),
                                       max_power_w=40_000, max_survivors=1,
                                       dtype=dtype, device="cpu")
    n = len(arrays["valid"])
    assert not calls
    for i in range(wl.shape[0]):
        for a, b, c in zip(red.full_rows(i, n - 4), lazy.full_rows(i),
                           eager.full_rows(i)):
            np.testing.assert_array_equal(a, c[:n - 4])
            np.testing.assert_array_equal(b, c)
    assert len(calls) == 1                    # swept once, on first read
    assert torch.equal(lazy.feasible_full, eager.feasible_full)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(red, f), getattr(eager, f))


def test_sweep_reduce_takes_plain_version_on_cpu_and_counts_no_launch():
    wl = seeded_workloads(6)
    arrays = seeded_tile(6)
    cand = cm.pack_cand_cols(arrays, torch.float64)
    wl_t = torch.as_tensor(wl)
    before = kern.launch_counts()
    assert {"sweep_reduce_f64", "sweep_reduce_f32"} <= set(before)
    packed = kern.sweep_reduce_packed(cand, wl_t, max_survivors=64)
    assert torch.equal(packed, kern.sweep_reduce_plain(cand, wl_t,
                                                       max_survivors=64))
    assert packed.dtype == torch.uint8
    assert packed.numel() == kern.packed_layout(4, 64, torch.float64)[1]
    red = kern.sweep_reduce(cand, wl_t, max_survivors=64,
                            host_buffer=kern.ResultBuffer())
    assert red.surv_idx.shape == (4, 64)
    assert kern.launch_counts() == before    # CPU tensors launch nothing
    with pytest.raises(ValueError, match="cand_cols"):
        kern.sweep_reduce(cand[:17], wl_t)
    with pytest.raises(TypeError, match="dtype"):
        kern.sweep_reduce_packed(cand, wl_t.to(torch.float32))
