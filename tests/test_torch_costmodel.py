"""Port parity: ``repro_torch.core.costmodel`` against ``repro.core.costmodel``.

The same numpy inputs go through both packages on the CPU.  float64: every
``simulate`` / ``simulate_batch`` field is bitwise equal except ``power_w``
and ``energy_j``, which may differ in the last bits because the reference
cubes with ``pow`` and the port with ``x*x*x`` (tolerance ``rtol 1e-15``,
about 4 ulp).  float32: ``rtol 1e-6`` against the reference's jitted sweep
(two compilers, same single-precision arithmetic)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import costmodel as ref_cm, dse as ref_dse
from repro.dse_campaign import SliceVariant as RefVariant
from repro.dse_campaign import SpaceSpec as RefSpace
from repro.hw import get_chip as ref_get_chip
from repro_torch.core import costmodel as cm, dse
from repro_torch.dse_campaign import SliceVariant, SpaceSpec
from repro_torch.hw import get_chip
from repro_torch.kernels import dse_sweep as kern
from repro_torch.kernels import ops

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
EXACT_FIELDS = ("t_compute", "t_memory", "t_collective", "latency_s",
                "cycles", "utilization")
CUBED_FIELDS = ("power_w", "energy_j")
WL_ROWS = np.asarray([
    [3.2e14, 4.5e13, 5e11, 7e11, 256, 0.5],
    [6.4e13, 9.0e12, 1e11, 1.4e11, 256, 0.1],
    [1.1e15, 2.0e14, 4e12, 5e12, 64, 2.0]], np.float64)


def small_spec(mod_space, mod_variant, **kw):
    kw.setdefault("chips", ("tpu-v5e", "tpu-v5p", "tpu-edge"))
    kw.setdefault("chip_counts", (16, 64))
    kw.setdefault("freq_points", 7)
    kw.setdefault("mesh_dims", 3)
    kw.setdefault("variants", (mod_variant(), mod_variant("bin85", 0.85)))
    kw.setdefault("chunk_size", 64)
    return mod_space(**kw)


def tile_arrays(n_pad=0):
    """Padded column arrays of one whole small space (reference-built)."""
    spec = small_spec(RefSpace, RefVariant)
    b = spec.slice(0, len(spec), with_candidates=False)
    n = len(b)

    def pad(a):
        a = np.asarray(a)
        return a if not n_pad else np.concatenate(
            [a, np.repeat(a[:1], n_pad)])

    valid = np.ones(n + n_pad)
    valid[n:] = 0.0
    arrays = {"n_chips": pad(b.n_chips), "freq_mhz": pad(b.freq_mhz),
              "mesh_pod": pad(b.pod_axis()), "mesh_data": pad(b.mesh_data),
              "mesh_model": pad(b.mesh_model), "valid": valid}
    arrays.update({k: pad(b.chip_cols[k])
                   for k in ref_cm.SWEEP_GATHER_FIELDS})
    return arrays, n


def test_constants_identical():
    assert cm.SIM_MODEL_VERSION == ref_cm.SIM_MODEL_VERSION == 3
    assert cm.MESHLESS_LINKS == ref_cm.MESHLESS_LINKS
    assert cm.WL_COLS == ref_cm.WL_COLS
    assert cm.SIM_GATHER_FIELDS == ref_cm.SIM_GATHER_FIELDS
    assert cm.SWEEP_GATHER_FIELDS == ref_cm.SWEEP_GATHER_FIELDS
    assert cm.BOTTLENECKS == ref_cm.BOTTLENECKS
    assert cm.COLL_MODEL_FRAC == ref_cm.COLL_MODEL_FRAC
    np.testing.assert_array_equal(cm._PROBE_WEIGHTS, ref_cm._PROBE_WEIGHTS)
    from repro.kernels.dse_sweep import CAND_COLS
    assert cm.CAND_COLS == CAND_COLS and len(CAND_COLS) == 18
    assert dataclasses.asdict(cm.SimConfig()) == \
        dataclasses.asdict(ref_cm.SimConfig())


@pytest.mark.parametrize("mesh", [True, False])
def test_scalar_simulate_matches_reference(mesh):
    ref_space, space = ref_dse.default_space(), dse.default_space()
    assert len(ref_space) == len(space) == 192
    for rc, pc in zip(ref_space, space):
        assert dataclasses.astuple(rc) == dataclasses.astuple(pc)
        ra = ref_dse._scale_analysis(BASE, 256, rc)
        pa = dse._scale_analysis(BASE, 256, pc)
        assert ra == pa
        kw = {"mesh": rc.mesh} if mesh else {}
        r = ref_cm.simulate(ra, ref_get_chip(rc.chip), rc.n_chips,
                            freq_mhz=rc.freq_mhz, **kw)
        p = cm.simulate(pa, get_chip(pc.chip), pc.n_chips,
                        freq_mhz=pc.freq_mhz, **kw)
        for f in EXACT_FIELDS:
            assert getattr(r, f) == getattr(p, f), f
        assert r.bottleneck == p.bottleneck
        for f in CUBED_FIELDS:
            assert getattr(p, f) == pytest.approx(getattr(r, f), rel=1e-15)


@pytest.mark.parametrize("mesh", [True, False])
def test_simulate_batch_float64_matches_reference(mesh):
    rb, pb = ref_dse.default_space_batch(), dse.default_space_batch()
    kw = dict(mesh_pod=rb.pod_axis(), mesh_data=rb.mesh_data,
              mesh_model=rb.mesh_model) if mesh else {}
    r = ref_cm.simulate_batch(
        ref_dse._scale_analysis_batch(BASE, 256, rb.n_chips), rb.chip_idx,
        rb.n_chips, rb.freq_mhz, **kw)
    nc = torch.as_tensor(pb.n_chips).to(torch.float64)
    p = cm.simulate_batch(dse._scale_analysis_batch(BASE, 256, nc),
                          pb.chip_idx, pb.n_chips, pb.freq_mhz,
                          device="cpu", **kw)
    for f in EXACT_FIELDS + ("bottleneck_idx",):
        np.testing.assert_array_equal(getattr(r, f), getattr(p, f).numpy(),
                                      err_msg=f)
    for f in CUBED_FIELDS:
        np.testing.assert_allclose(getattr(p, f).numpy(), getattr(r, f),
                                   rtol=1e-15, atol=0)
    assert len(p) == len(r) == 192
    assert p.result(5).bottleneck == r.result(5).bottleneck


def test_port_scalar_agrees_with_port_batch():
    """Scalar and batch agree to the last bits (``rtol 1e-15``), exactly as
    in the reference: the scalar path sums the three roofline times with
    python's compensated ``sum``, the tensor path adds them in order."""
    pb = dse.default_space_batch()
    b = dse.evaluate_space(BASE, 256, pb, device="cpu")
    for i, cand in enumerate(pb.candidates):
        s = cm.simulate(dse._scale_analysis(BASE, 256, cand),
                        get_chip(cand.chip), cand.n_chips,
                        freq_mhz=cand.freq_mhz, mesh=cand.mesh)
        r = b.result(i)
        assert r.bottleneck == s.bottleneck
        for f in EXACT_FIELDS + CUBED_FIELDS:
            assert getattr(r, f) == pytest.approx(getattr(s, f), rel=1e-15)


def test_simulate_batch_default_frequency_and_missing_mesh_axis():
    pb = dse.default_space_batch()
    a = cm.simulate_batch({k: torch.tensor(v, dtype=torch.float64)
                           for k, v in BASE.items()}, pb.chip_idx, pb.n_chips,
                          device="cpu")
    rb = ref_dse.default_space_batch()
    r = ref_cm.simulate_batch(BASE, rb.chip_idx, rb.n_chips)
    np.testing.assert_array_equal(r.latency_s, a.latency_s.numpy())
    with pytest.raises(ValueError, match="mesh_data"):
        cm.simulate_batch(BASE, pb.chip_idx, pb.n_chips, pb.freq_mhz,
                          mesh_model=pb.mesh_model, device="cpu")


def test_roofline_terms_and_by_name_equal():
    ana = dict(BASE)
    assert cm.roofline_terms(ana, get_chip("tpu-v5e"), 256) == \
        ref_cm.roofline_terms(ana, ref_get_chip("tpu-v5e"), 256)
    a = cm.simulate_by_name(ana, "tpu-v4", 64, 900.0, mesh=(8, 8))
    b = ref_cm.simulate_by_name(ana, "tpu-v4", 64, 900.0, mesh=(8, 8))
    assert a.latency_s == b.latency_s and a.bottleneck == b.bottleneck


CONSTRAINTS = [
    dict(max_power_w=None, max_latency_s=None, min_hbm_fit=True),
    dict(max_power_w=None, max_latency_s=500.0, min_hbm_fit=False),
    dict(max_power_w=40_000, max_latency_s=500.0, min_hbm_fit=True),
    dict(max_power_w=1e-3, max_latency_s=None, min_hbm_fit=False),
]


@pytest.mark.parametrize("cons", CONSTRAINTS)
def test_fused_sweep_float32_matches_reference_jit(cons):
    """float32 fused sweep vs ``sweep_workloads_reduced_jit``: energy /
    latency ``rtol 1e-6``, ``feasible`` and the feasible counts equal."""
    arrays, n = tile_arrays(n_pad=9)
    chip_cols = {k: arrays[k] for k in ref_cm.SWEEP_GATHER_FIELDS}
    args = (WL_ROWS, chip_cols, arrays["n_chips"], arrays["freq_mhz"],
            arrays["mesh_pod"], arrays["mesh_data"], arrays["mesh_model"],
            arrays["valid"])
    r = ref_cm.sweep_workloads_reduced_jit(*args, **cons)
    p = cm.sweep_workloads_reduced(*args, **cons, dtype=torch.float32,
                                   device="cpu")
    assert p.energy_full.dtype == torch.float32
    np.testing.assert_allclose(p.energy_full.numpy(),
                               np.asarray(r.energy_full), rtol=1e-6)
    np.testing.assert_allclose(p.latency_full.numpy(),
                               np.asarray(r.latency_full), rtol=1e-6)
    np.testing.assert_array_equal(p.feasible_full.numpy(),
                                  np.asarray(r.feasible_full))
    np.testing.assert_array_equal(p.n_feasible, np.asarray(r.n_feasible))
    assert not p.feasible_full[:, n:].any()         # padding is masked
    if cons["max_power_w"] == 1e-3:
        assert int(p.n_feasible.sum()) == 0 == int(p.n_survivors.sum())
        assert np.isneginf(p.ref_energy).all()


@pytest.mark.parametrize("cons", CONSTRAINTS[:3])
def test_fused_sweep_float64_matches_scalar_oracle(cons):
    """The three constraint branches (HBM fit, latency cap, all three) each
    split the space, and the float64 fused sweep reproduces the reference's
    scalar-simulator mask exactly."""
    ref_spec = small_spec(RefSpace, RefVariant)
    arrays, n = tile_arrays()
    chip_cols = {k: arrays[k] for k in ref_cm.SWEEP_GATHER_FIELDS}
    p = cm.sweep_workloads_reduced(
        WL_ROWS[2:], chip_cols, arrays["n_chips"], arrays["freq_mhz"],
        arrays["mesh_pod"], arrays["mesh_data"], arrays["mesh_model"],
        arrays["valid"], **cons, device="cpu")
    wl = ref_dse.Workload("a", "s", dict(zip(ref_cm.WL_COLS[:4],
                                             WL_ROWS[2, :4])), 64, 2.0)
    e, l, f = [], [], []
    for i in range(n):
        cand = ref_spec.candidate(i)
        chip = ref_get_chip(cand.chip)
        res = ref_cm.simulate(
            ref_dse._scale_analysis(wl.base_analysis, wl.base_chips, cand),
            chip, cand.n_chips, freq_mhz=cand.freq_mhz, mesh=cand.mesh)
        ok = True
        if cons["min_hbm_fit"]:
            ok &= (wl.state_gb_per_device * wl.base_chips / cand.n_chips
                   * 1e9 <= chip.hbm_bytes * 0.9)
        if cons["max_power_w"] is not None:
            ok &= res.power_w * cand.n_chips <= cons["max_power_w"]
        if cons["max_latency_s"] is not None:
            ok &= res.latency_s <= cons["max_latency_s"]
        e.append(res.energy_j), l.append(res.latency_s), f.append(ok)
    f = np.asarray(f)
    assert 0 < f.sum() < n                       # the mask actually bites
    np.testing.assert_array_equal(p.feasible_full.numpy()[0], f)
    np.testing.assert_array_equal(p.latency_full.numpy()[0], np.asarray(l))
    np.testing.assert_allclose(p.energy_full.numpy()[0], np.asarray(e),
                               rtol=1e-15)
    assert int(p.n_feasible[0]) == int(f.sum())
    # survivors: a feasible superset of the exact skyline
    keep, n_feas, _, _ = ref_cm.skyline_reduce(np.asarray(e), np.asarray(l), f)
    k = int(p.n_survivors[0])
    surv = set(p.surv_idx[0][:k].tolist())
    assert set(np.flatnonzero(keep).tolist()) <= surv
    assert all(f[i] for i in surv)


def random_rows(seed, w=4, n=96, dtype=np.float64, empty_row=True):
    rng = np.random.default_rng(seed)
    e = rng.uniform(1.0, 100.0, (w, n)).astype(dtype)
    l = rng.uniform(1.0, 100.0, (w, n)).astype(dtype)
    # ties in score and in value: repeated points and quantized rows
    e[1] = np.round(e[1] / 10) * 10
    l[1] = np.round(l[1] / 10) * 10
    e[2, 10:20] = e[2, 0]
    l[2, 10:20] = l[2, 0]
    feas = rng.random((w, n)) < 0.6
    if empty_row:
        feas[w - 1] = False
    return e, l, feas


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_screen_rows_equals_reference(seed, np_dtype):
    """Plain screen vs the reference's ``_screen_rows`` on the same [W, N]
    arrays, in the same dtype: keep, counts and reference maxima EQUAL (ties
    and an all-infeasible row included)."""
    e, l, feas = random_rows(seed, dtype=np_dtype)
    with jax.enable_x64(np_dtype == np.float64):
        import jax.numpy as jnp
        ref = [np.asarray(x) for x in ref_cm._screen_rows(
            jnp.asarray(e), jnp.asarray(l), jnp.asarray(feas))]
    assert ref[3].dtype == np_dtype
    got = cm._screen_rows(torch.as_tensor(e), torch.as_tensor(l),
                          torch.as_tensor(feas))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g.numpy())
    assert not got[0][-1].any() and int(got[1][-1]) == 0
    assert np.isneginf(got[3][-1].item())


def test_screen_keeps_superset_of_skyline_and_skyline_matches_reference():
    e, l, feas = random_rows(5, empty_row=False)
    keep = cm._screen_rows(torch.as_tensor(e), torch.as_tensor(l),
                           torch.as_tensor(feas))[0].numpy()
    for w in range(e.shape[0]):
        r = ref_cm.skyline_reduce(e[w], l[w], feas[w])
        p = cm.skyline_reduce(torch.as_tensor(e[w]), torch.as_tensor(l[w]),
                              torch.as_tensor(feas[w]))
        np.testing.assert_array_equal(r[0], p[0].numpy())
        assert int(r[1]) == int(p[1])
        assert float(r[2]) == float(p[2]) and float(r[3]) == float(p[3])
        assert not (r[0] & ~keep[w]).any()
        assert not (keep[w] & ~feas[w]).any()
    none = cm.skyline_reduce(torch.as_tensor(e[0]), torch.as_tensor(l[0]),
                             torch.zeros(e.shape[1], dtype=torch.bool))
    assert not none[0].any() and int(none[1]) == 0
    assert np.isneginf(float(none[2]))


@pytest.mark.parametrize("max_survivors", [1, 16, 4096])
def test_compact_rows_device_matches_host(max_survivors):
    rng = np.random.default_rng(7)
    keep = rng.random((3, 64)) < 0.2
    keep[2] = False
    e, l = rng.random((3, 64)), rng.random((3, 64))
    hi, he, hl = cm._compact_rows_host(keep, e, l, max_survivors)
    ri, re_, rl = ref_cm._compact_rows_host(keep, e, l, max_survivors)
    di, de, dl = cm._compact_rows_device(
        torch.as_tensor(keep), torch.as_tensor(e), torch.as_tensor(l),
        max_survivors)
    for a, b, c in ((hi, ri, di), (he, re_, de), (hl, rl, dl)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.numpy())
    assert di.shape == (3, min(max_survivors, 64))


def test_sweep_reduced_contract_and_overflow_flag():
    arrays, n = tile_arrays(n_pad=3)
    chip_cols = {k: arrays[k] for k in ref_cm.SWEEP_GATHER_FIELDS}
    args = (WL_ROWS, chip_cols, arrays["n_chips"], arrays["freq_mhz"],
            arrays["mesh_pod"], arrays["mesh_data"], arrays["mesh_model"],
            arrays["valid"])
    red = cm.sweep_workloads_reduced(*args, min_hbm_fit=False,
                                     max_survivors=2, device="cpu")
    w = WL_ROWS.shape[0]
    assert red.surv_idx.shape == red.surv_energy.shape == (w, 2)
    assert red.surv_idx.dtype == np.int64
    assert all(red.overflowed(i) for i in range(w))
    e, l, f = red.full_rows(1, n)
    assert e.shape == l.shape == f.shape == (n,) and f.dtype == np.bool_
    wide = cm.sweep_workloads_reduced(*args, min_hbm_fit=False, device="cpu")
    for i in range(w):
        k = int(wide.n_survivors[i])
        assert not wide.overflowed(i) and 0 < k <= n
        idx = wide.surv_idx[i][:k]
        assert (np.diff(idx) > 0).all()              # ascending lanes
        np.testing.assert_array_equal(wide.surv_energy[i][:k],
                                      wide.energy_full[i].numpy()[idx])
        assert (wide.surv_idx[i][k:] == 0).all()
    with pytest.raises(ValueError, match="wl_cols"):
        cm.sweep_workloads_reduced(WL_ROWS[:, :5], *args[1:], device="cpu")


# --- the kernel wrappers, as far as a machine without a card reaches ---------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrappers_take_plain_version_on_cpu_and_count_no_launch(dtype):
    arrays, n = tile_arrays(n_pad=5)
    cand = cm.pack_cand_cols(arrays, dtype)
    wl = torch.as_tensor(WL_ROWS).to(dtype)
    before = kern.launch_counts()
    e, l, f = kern.dse_sweep(cand, wl, max_power_w=40_000)
    pe, pl, pf = kern.dse_sweep_plain(cand, wl, max_power_w=40_000)
    assert torch.equal(e, pe) and torch.equal(l, pl) and torch.equal(f, pf)
    assert e.dtype == dtype and f.dtype == torch.bool
    got = kern.screen_rows(e, l, f)
    want = kern.screen_rows_plain(e, l, f)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kern.launch_counts() == before     # CPU tensors launch nothing

    class Cons:
        max_power_w, max_latency_s, min_hbm_fit = 40_000, None, True

    red = ops.dse_sweep(cand, wl, constraint=Cons, max_survivors=64)
    np.testing.assert_array_equal(red.n_survivors, got[1].numpy())
    np.testing.assert_array_equal(red.n_feasible, got[2].numpy())


def test_wrappers_reject_bad_inputs():
    arrays, _ = tile_arrays()
    cand = cm.pack_cand_cols(arrays, torch.float64)
    wl = torch.as_tensor(WL_ROWS)
    with pytest.raises(ValueError, match="cand_cols"):
        kern.dse_sweep(cand[:17], wl)
    with pytest.raises(TypeError, match="dtype"):
        kern.dse_sweep(cand, wl.to(torch.float32))
    with pytest.raises(TypeError, match="float64 or float32"):
        kern.dse_sweep(cand.to(torch.float16), wl.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        kern.dse_sweep(cand.t().contiguous().t(), wl)
    with pytest.raises(ValueError, match="shape"):
        kern.dse_sweep(cand, wl[:, :5].contiguous())
    e = torch.ones(2, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="feasible"):
        kern.screen_rows(e, e, torch.ones(2, 8))
    with pytest.raises(ValueError, match="shape"):
        kern.screen_rows(e, e[:, :4].contiguous(),
                         torch.ones(2, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="staging buffer"):
        cm.pack_cand_cols(arrays, torch.float64,
                          out=torch.empty(18, 3, dtype=torch.float64))


def test_importing_kernels_builds_nothing():
    """The CUDA library is built and loaded inside the first launching call;
    importing the modules (as every CPU test does) must not try."""
    from repro_torch.kernels import build
    assert kern._bound is None and not build._libs
    assert (build.CSRC_DIR / kern.SOURCE).is_file()
    assert "-fmad=false" in build.flags(kern.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in build.flags(kern.SOURCE)
    assert build.default_build_dir().parts[-2:] == ("build", "repro_torch")
