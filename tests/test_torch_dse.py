"""Port parity: ``repro_torch.core.dse`` (slow path + Pareto) against the
reference ``repro.core.dse`` on the 192-point default space."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dse as ref_dse
from repro_torch.core import dse

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
SMALL = {k: v * 0.2 for k, v in BASE.items()}


def workloads(mod):
    return [mod.Workload("qwen3_14b", "train_4k", BASE, 256, 0.5),
            mod.Workload("stablelm_1_6b", "train_4k", SMALL, 256, 0.1)]


def cand_tuples(cands):
    return [dataclasses.astuple(c) for c in cands]


CONSTRAINTS = [dict(), dict(max_power_w=40_000, min_hbm_fit=False),
               dict(max_latency_s=300.0), dict(max_power_w=1e-3)]


@pytest.mark.parametrize("cons", CONSTRAINTS)
def test_pareto_search_same_candidate_set(cons):
    ref = ref_dse.pareto_search(workloads(ref_dse), ref_dse.default_space(),
                                ref_dse.Constraint(**cons))
    got = dse.pareto_search(workloads(dse), dse.default_space(),
                            dse.Constraint(**cons), device="cpu")
    assert ref.keys() == got.keys()
    for key in ref:
        a, b = ref[key], got[key]
        assert cand_tuples(a.candidates) == cand_tuples(b.candidates)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.latency_s, b.latency_s)
        np.testing.assert_allclose(b.energy_j, a.energy_j, rtol=1e-15)
        assert a.feasible_count == b.feasible_count
        assert len(a) == len(b)


def test_pareto_search_rejects_duplicate_keys_and_takes_one_workload():
    wl = workloads(dse)[0]
    with pytest.raises(ValueError, match="duplicate"):
        dse.pareto_search([wl, wl], dse.default_space(), device="cpu")
    one = dse.pareto_search(wl, dse.default_space_batch(), device="cpu")
    assert list(one) == [("qwen3_14b", "train_4k")]


def test_pareto_mask_ties_match_reference():
    """Equal duplicates never dominate each other; tied latencies keep only
    the group's energy minimum; infeasible points never survive."""
    e = np.asarray([3.0, 3.0, 2.0, 2.0, 5.0, 1.0, 1.0, 0.5])
    l = np.asarray([1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 0.1])
    feas = np.asarray([1, 1, 1, 1, 1, 1, 1, 0], bool)
    want = ref_dse.pareto_mask(e, l, feas)
    got = dse.pareto_mask(e, l, feas)
    np.testing.assert_array_equal(want, got)
    assert got.tolist() == [True, True, True, True, False, True, True, False]
    assert not dse.pareto_mask(e, l, np.zeros(8, bool)).any()
    rng = np.random.default_rng(0)
    for _ in range(20):
        e = np.round(rng.uniform(0, 5, 64), 1)
        l = np.round(rng.uniform(0, 5, 64), 1)
        feas = rng.random(64) < 0.7
        np.testing.assert_array_equal(ref_dse.pareto_mask(e, l, feas),
                                      dse.pareto_mask(e, l, feas))


@pytest.mark.parametrize("objective", ["energy", "latency"])
def test_slow_path_search_matches_reference_and_scalar(objective):
    cons_kw = dict(max_power_w=40_000)
    r_best, r_res, _ = ref_dse.slow_path_search(
        "qwen3_14b", "train_4k", BASE, 256, 0.5, ref_dse.default_space(),
        ref_dse.Constraint(**cons_kw), objective)
    p_best, p_res, _ = dse.slow_path_search(
        "qwen3_14b", "train_4k", BASE, 256, 0.5, dse.default_space(),
        dse.Constraint(**cons_kw), objective, device="cpu")
    s_best, s_res, _ = dse.slow_path_search_scalar(
        "qwen3_14b", "train_4k", BASE, 256, 0.5, dse.default_space(),
        dse.Constraint(**cons_kw), objective)
    assert dataclasses.astuple(p_best) == dataclasses.astuple(r_best)
    assert s_best == p_best
    np.testing.assert_array_equal(p_res.feasible.numpy(), r_res.feasible)
    assert len(p_res) == 192
    first = p_res[p_best]
    assert first["feasible"] and first["sim"].latency_s == \
        r_res[r_best]["sim"].latency_s
    assert [v["feasible"] for v in s_res.values()] == \
        p_res.feasible.tolist()


def test_slow_path_search_no_feasible_point():
    best, _, _ = dse.slow_path_search(
        "a", "s", BASE, 256, 0.5, dse.default_space(),
        dse.Constraint(max_power_w=1e-3), device="cpu")
    assert best is None


def test_evaluate_workload_tile_is_tile_invariant():
    """Evaluating a space tile by tile equals one pass over the whole batch,
    bitwise — what makes streamed campaigns exact."""
    wl = workloads(dse)[0]
    space = dse.default_space()
    whole, feas = dse.evaluate_workload_tile(
        wl, dse.as_batch(space), dse.Constraint(max_power_w=40_000),
        device="cpu")
    e, f = [], []
    for lo in range(0, len(space), 50):
        res, ok = dse.evaluate_workload_tile(
            wl, dse.as_batch(space[lo:lo + 50]),
            dse.Constraint(max_power_w=40_000), device="cpu")
        e.append(res.energy_j), f.append(ok)
    assert torch.equal(torch.cat(e), whole.energy_j)
    assert torch.equal(torch.cat(f), feas)


def test_candidate_batch_matches_reference():
    rb, pb = ref_dse.default_space_batch(), dse.default_space_batch()
    for f in ("chip_idx", "n_chips", "mesh_data", "mesh_model", "freq_mhz",
              "mesh_pod"):
        np.testing.assert_array_equal(getattr(rb, f), getattr(pb, f))
    np.testing.assert_array_equal(rb.hbm_bytes(), pb.hbm_bytes())
    assert dataclasses.astuple(pb[3]) == dataclasses.astuple(rb[3])
    bare = dataclasses.replace(pb, candidates=None, mesh_pod=None)
    with pytest.raises(TypeError, match="array-only"):
        bare[0]
    assert (bare.pod_axis() == 1).all()


def test_float32_tile_close_to_float64():
    wl = workloads(dse)[1]
    b = dse.default_space_batch()
    r64, f64 = dse.evaluate_workload_tile(wl, b, device="cpu")
    r32, f32 = dse.evaluate_workload_tile(wl, b, dtype=torch.float32,
                                          device="cpu")
    assert r32.energy_j.dtype == torch.float32
    np.testing.assert_allclose(r32.energy_j.numpy(), r64.energy_j.numpy(),
                               rtol=1e-5)
    assert torch.equal(f32, f64)
