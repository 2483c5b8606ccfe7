"""The first slice of the port as a whole: ``repro_torch.dse_campaign``
against the reference ``repro.dse_campaign`` on the CPU.

Gates: the port's float64 tiers (``"torch"`` and the fused ``"cuda"`` path,
here on ``device="cpu"`` through the kernels' plain versions) end on the
SAME frontier candidate set as the reference ``evaluator="numpy"``, with
hypervolume within ``1e-12`` relative (the values themselves may differ in
the last bits: the reference cubes with ``pow``, the port with ``x*x*x``);
the float32 fused tier is within ``1e-5`` of the reference ``"jit"`` tier;
resume == fresh; the overflow fallback changes nothing; a half-finished
reference campaign carried across finishes on the reference's frontier."""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.dse_campaign as ref_camp
from repro.core import dse as ref_dse
from repro.hw import CHIP_TABLE as REF_TABLE
from repro.hw import _TABLE_FIELDS
from repro_torch.core import dse
from repro_torch.dse_campaign import (Campaign, CampaignConfig, SliceVariant,
                                      SpaceSpec, StreamingFrontier,
                                      TileEvaluator, canonical_frontier,
                                      default_campaign_space,
                                      frontiers_identical, hypervolume_2d,
                                      hypervolume_gain_2d,
                                      state_from_reference, store,
                                      tiny_campaign_space)
from repro_torch.dse_campaign.runner import _TilePrefetcher
from repro_torch.telemetry import Telemetry

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
CONS_KW = dict(max_power_w=40_000, min_hbm_fit=False)


def workloads(mod):
    return [mod.Workload("qwen3_14b", "train_4k", BASE, 256, 0.5),
            mod.Workload("stablelm_1_6b", "train_4k",
                         {k: v * 0.2 for k, v in BASE.items()}, 256, 0.1)]


def small_spec(space_cls, variant_cls, **kw):
    kw.setdefault("chips", ("tpu-v5e", "tpu-edge"))
    kw.setdefault("chip_counts", (16,))
    kw.setdefault("freq_points", 5)
    kw.setdefault("variants", (variant_cls(), variant_cls("bin85", 0.85)))
    kw.setdefault("chunk_size", 64)
    return space_cls(**kw)


SPACES = {
    "small": (lambda c: small_spec(ref_camp.SpaceSpec, ref_camp.SliceVariant,
                                   chunk_size=c),
              lambda c: small_spec(SpaceSpec, SliceVariant, chunk_size=c)),
    "tiny": (ref_camp.tiny_campaign_space, tiny_campaign_space),
}


def run_ref(space, evaluator="numpy", cons_kw=CONS_KW, **run_kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        camp = ref_camp.Campaign(workloads(ref_dse), ref_camp.CampaignConfig(
            space=space, evaluator=evaluator,
            constraint=ref_dse.Constraint(**cons_kw)))
        return camp, camp.run(**run_kw)


def port_config(space, evaluator, dtype=torch.float64, cons_kw=CONS_KW, **kw):
    return CampaignConfig(space=space, evaluator=evaluator, dtype=dtype,
                          device="cpu", constraint=dse.Constraint(**cons_kw),
                          **kw)


def run_port(space, evaluator, dtype=torch.float64, cons_kw=CONS_KW,
             telemetry=None, **kw):
    camp = Campaign(workloads(dse), port_config(space, evaluator, dtype,
                                                cons_kw, **kw),
                    telemetry=telemetry)
    return camp, camp.run()


def cand_tuples(cands):
    return [dataclasses.astuple(c) for c in cands]


def assert_same_candidate_set(a, b, rtol):
    """``a`` may be a reference frontier and ``b`` a port frontier: compare
    the canonical candidate tuples, the indices, and the values to rtol."""
    ca, ea, la, ia = ref_camp.canonical_frontier(a) \
        if isinstance(a, ref_dse.ParetoFrontier) else canonical_frontier(a)
    cb, eb, lb, ib = canonical_frontier(b)
    assert cand_tuples(ca) == cand_tuples(cb)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(eb, ea, rtol=rtol)
    np.testing.assert_allclose(lb, la, rtol=rtol)


def hv_rel(a, b, key):
    ha = a.trajectories[key][-1].hypervolume
    hb = b.trajectories[key][-1].hypervolume
    return abs(ha - hb) / ha if ha else abs(hb)


# --- the north-star gate ------------------------------------------------------


@pytest.mark.parametrize("evaluator", ["torch", "cuda"])
@pytest.mark.parametrize("name,chunk", [("small", 1), ("small", 7),
                                        ("small", 4096), ("tiny", 7),
                                        ("tiny", 256), ("tiny", 4096)])
def test_float64_tiers_match_reference_numpy(name, chunk, evaluator):
    ref_space, port_space = (mk(chunk) for mk in SPACES[name])
    assert len(ref_space) == len(port_space)
    _, a = run_ref(ref_space)
    _, b = run_port(port_space, evaluator)
    assert b.complete and b.n_tiles == a.n_tiles
    for key in a.frontiers:
        assert_same_candidate_set(a.frontiers[key], b.frontiers[key], 1e-12)
        assert a.frontiers[key].feasible_count == \
            b.frontiers[key].feasible_count
        assert hv_rel(a, b, key) <= 1e-12
        assert a.trajectories[key][-1].evaluated == \
            b.trajectories[key][-1].evaluated == len(port_space)
        assert [s.frontier_size for s in a.trajectories[key]] == \
            [s.frontier_size for s in b.trajectories[key]]


@pytest.mark.parametrize("name,chunk", [("small", 7), ("tiny", 256)])
def test_float32_fused_tier_matches_reference_jit(name, chunk):
    ref_space, port_space = (mk(chunk) for mk in SPACES[name])
    _, a = run_ref(ref_space, "jit")
    _, b = run_port(port_space, "cuda", torch.float32)
    _, exact = run_ref(ref_space)
    for key in a.frontiers:
        assert hv_rel(a, b, key) <= 1e-5
        assert hv_rel(exact, b, key) <= 1e-5
        assert_same_candidate_set(a.frontiers[key], b.frontiers[key], 1e-5)


def test_default_campaign_space_two_workloads():
    """The full 125,440-candidate default space, fused float64 path against
    the reference's exact tier."""
    _, a = run_ref(ref_camp.default_campaign_space(),
                   cons_kw=dict(max_power_w=40_000))
    camp, b = run_port(default_campaign_space(), "cuda",
                       cons_kw=dict(max_power_w=40_000))
    assert camp.engine.fused_launches == b.n_tiles == 31
    for key in a.frontiers:
        assert len(b.frontiers[key]) > 100
        assert_same_candidate_set(a.frontiers[key], b.frontiers[key], 1e-12)
        assert hv_rel(a, b, key) <= 1e-12


# --- fused-path mechanics -----------------------------------------------------


def test_fused_launches_equal_tiles_and_telemetry_spans():
    tel = Telemetry()
    space = small_spec(SpaceSpec, SliceVariant, chunk_size=7)
    camp, res = run_port(space, "cuda", telemetry=tel)
    assert camp.fused and camp.engine.fused_launches == res.n_tiles == 6
    names = [r.name for r in tel.tracer.records]
    for span in ("pad", "launch", "compact", "merge", "tile_eval"):
        assert names.count(span) == res.n_tiles
    snap = tel.snapshot()
    from repro_torch.telemetry import metric_value
    assert metric_value(snap, "evaluator_fused_launches_total") == 6
    assert metric_value(snap, "evaluator_candidates_total") == \
        len(space) * 2 == res.candidates_evaluated
    assert metric_value(snap, "campaign_tiles_total") == 6
    # instrumented == uninstrumented
    _, plain = run_port(space, "cuda")
    for key in res.frontiers:
        assert frontiers_identical(res.frontiers[key], plain.frontiers[key])
    t_camp, t_res = run_port(space, "torch")
    assert not t_camp.fused and t_camp.engine.fused_launches == 0


def test_overflow_fallback_identical():
    """max_survivors=1 forces the full-row fallback on every tile; the
    frontier and its trajectory must not change."""
    space = small_spec(SpaceSpec, SliceVariant)
    _, a = run_port(space, "cuda")
    _, b = run_port(space, "cuda", max_survivors=1)
    for key in a.frontiers:
        assert frontiers_identical(a.frontiers[key], b.frontiers[key])
        assert ([s.as_dict() for s in a.trajectories[key]]
                == [s.as_dict() for s in b.trajectories[key]])


def test_partial_tile_padding_is_masked():
    ref_space, port_space = (mk(15) for mk in SPACES["small"])
    assert len(port_space) % 15 != 0
    _, a = run_ref(ref_space)
    _, b = run_port(port_space, "cuda")
    for key in a.frontiers:
        assert_same_candidate_set(a.frontiers[key], b.frontiers[key], 1e-12)
        assert b.trajectories[key][-1].evaluated == len(port_space)
    eng = TileEvaluator(workloads(dse), port_config(port_space, "cuda"))
    batch = port_space.slice(30, len(port_space), with_candidates=False)
    arrays = eng.padded_tile_arrays(batch)
    assert all(len(v) == 15 for v in arrays.values())
    assert arrays["valid"].tolist() == [1.0] * 10 + [0.0] * 5
    red = eng.sweep_reduced(batch)
    assert not red.feasible_full[:, 10:].any()
    assert red.energy_full.shape == (2, 15)


def test_all_infeasible_matches_reference():
    cons = dict(max_power_w=1e-3, min_hbm_fit=False)
    ref_space, port_space = (mk(64) for mk in SPACES["small"])
    _, a = run_ref(ref_space, cons_kw=cons)
    for evaluator in ("torch", "cuda"):
        _, b = run_port(port_space, evaluator, cons_kw=cons)
        for key in a.frontiers:
            assert len(a.frontiers[key]) == len(b.frontiers[key]) == 0
            assert ([s.as_dict() for s in a.trajectories[key]]
                    == [s.as_dict() for s in b.trajectories[key]])


def test_reduce_tile_is_a_pure_function_of_the_span():
    space = tiny_campaign_space(chunk_size=64)
    eng = TileEvaluator(workloads(dse), port_config(space, "cuda"))
    exact = TileEvaluator(workloads(dse), port_config(space, "torch"))
    batch = space.slice(128, 192, with_candidates=False)
    a, b = eng.reduce_tile(batch, 128), eng.reduce_tile(batch, 128)
    c = exact.reduce_tile(batch, 128)
    assert (a.lo, a.hi, a.n_workloads) == (128, 192, 2)
    for wi in range(2):
        np.testing.assert_array_equal(a.surv_gidx[wi], b.surv_gidx[wi])
        np.testing.assert_array_equal(a.surv_energy[wi], b.surv_energy[wi])
        # the screen keeps a feasible superset of the exact skyline
        assert set(c.surv_gidx[wi].tolist()) <= set(a.surv_gidx[wi].tolist())
        assert a.n_feasible[wi] == c.n_feasible[wi]
        assert a.ref_energy_j[wi] == c.ref_energy_j[wi]
        assert a.ref_latency_s[wi] == c.ref_latency_s[wi]
    assert a.n_survivors >= c.n_survivors


# --- checkpoint / resume -------------------------------------------------------


@pytest.mark.parametrize("evaluator,dtype", [("torch", "float64"),
                                             ("cuda", "float64"),
                                             ("cuda", "float32")])
def test_resume_equals_fresh(tmp_path, evaluator, dtype):
    space = small_spec(SpaceSpec, SliceVariant, chunk_size=16,
                       chip_counts=(16, 64))
    ckpt = str(tmp_path / "ckpt.json")
    cfg = port_config(space, evaluator, dtype)
    partial = Campaign(workloads(dse), cfg).run(checkpoint_path=ckpt,
                                                max_tiles=2)
    assert not partial.complete and partial.tiles_done == 2
    resumed = Campaign.from_checkpoint(ckpt, device="cpu")
    assert resumed.evaluator == evaluator and resumed.next_tile == 2
    assert resumed.config.dtype_name == dtype
    final = resumed.run(checkpoint_path=ckpt)
    assert final.complete
    _, fresh = run_port(space, evaluator, dtype)
    for key in fresh.frontiers:
        assert frontiers_identical(final.frontiers[key], fresh.frontiers[key])
        assert ([s.as_dict() for s in final.trajectories[key]]
                == [s.as_dict() for s in fresh.trajectories[key]])
    state = json.load(open(ckpt))
    assert "device" not in state and state["dtype"] == dtype


def test_checkpoint_refuses_other_cost_model_and_recovers_from_corruption(
        tmp_path):
    space = small_spec(SpaceSpec, SliceVariant, chunk_size=8)
    camp = Campaign(workloads(dse), port_config(space, "cuda"))
    ckpt = str(tmp_path / "c.json")
    camp.run(checkpoint_path=ckpt, max_tiles=1)
    camp.run(checkpoint_path=ckpt, max_tiles=1)
    state = camp.state_dict()
    with pytest.raises(ValueError, match="cost-model version"):
        Campaign.from_state({**state, "sim_model_version": 2}, device="cpu")
    with pytest.raises(ValueError, match="state_from_reference"):
        Campaign.from_state({**state, "evaluator": "numpy"}, device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        Campaign.from_state(state, device="cpu", bogus=1)
    # flip bytes in the published file: the load falls back a generation
    raw = open(ckpt, "rb").read()
    open(ckpt, "wb").write(raw[:len(raw) // 2])
    with pytest.raises(store.CheckpointCorruptionError):
        store.load_checkpoint(ckpt, fallback=False)
    recovered, report = store.load_checkpoint_recovering(ckpt)
    assert report["fallback_generation"] is not None and report["quarantined"]
    assert Campaign.from_state(recovered, device="cpu").next_tile == 2
    records, torn = store.CheckpointJournal(ckpt).records()
    assert torn == 0 and [r["next_tile"] for r in records][-1] == 2


# --- state carried across from the reference package --------------------------


def reference_chip_table():
    cols = {f: np.asarray(getattr(REF_TABLE, f)) for f in _TABLE_FIELDS}
    cols["names"] = REF_TABLE.names
    return cols


@pytest.mark.parametrize("ref_eval,port_eval,dtype,rtol", [
    ("numpy", "torch", "float64", 1e-12),
    ("jit", "cuda", "float32", 1e-5)])
def test_reference_half_run_finishes_in_port(tmp_path, ref_eval, port_eval,
                                             dtype, rtol):
    ref_space = ref_camp.tiny_campaign_space(chunk_size=100)
    half, partial = run_ref(ref_space, ref_eval, max_tiles=4)
    assert partial.tiles_done == 4 and not partial.complete
    # through a real reference checkpoint file, read by the port's store
    ckpt = str(tmp_path / "ref.json")
    ref_camp.store.save_checkpoint(half.state_dict(), ckpt)
    state = store.load_checkpoint(ckpt)
    camp = state_from_reference(state, chip_table=reference_chip_table(),
                                device="cpu")
    assert camp.evaluator == port_eval and camp.next_tile == 4
    assert camp.config.dtype_name == dtype
    assert camp.space.to_dict() == ref_space.to_dict()
    final = camp.run()
    assert final.complete and final.tiles_done == ref_space.n_tiles()
    _, full = run_ref(ref_space, ref_eval)
    for key in full.frontiers:
        assert_same_candidate_set(full.frontiers[key], final.frontiers[key],
                                  rtol)
        assert hv_rel(full, final, key) <= rtol
        assert full.frontiers[key].feasible_count == \
            final.frontiers[key].feasible_count


def test_state_from_reference_refusals():
    half, _ = run_ref(ref_camp.tiny_campaign_space(chunk_size=100),
                      max_tiles=1)
    state = half.state_dict()
    with pytest.raises(ValueError, match="cost-model version"):
        state_from_reference({**state, "sim_model_version": 2}, device="cpu")
    with pytest.raises(ValueError, match="no counterpart"):
        state_from_reference({**state, "evaluator": "fast"}, device="cpu")
    with pytest.raises(ValueError, match="no counterpart"):
        state_from_reference({**state, "evaluator": "jit",
                              "pipeline": False}, device="cpu")
    table = reference_chip_table()
    table["hbm_bw"] = table["hbm_bw"] * 2
    with pytest.raises(ValueError, match="hbm_bw"):
        state_from_reference(state, chip_table=table, device="cpu")
    fused = state_from_reference({**state, "evaluator": "pallas"},
                                 device="cpu")
    assert fused.evaluator == "cuda" and fused.config.dtype_name == "float64"


# --- configuration -------------------------------------------------------------


def test_config_asking_for_the_card_raises_without_one():
    """The default device is the card; nothing lands on the CPU unasked."""
    space = tiny_campaign_space()
    if torch.cuda.is_available():
        assert CampaignConfig(space=space).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        CampaignConfig(space=space, evaluator="cuda", device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        CampaignConfig(space=space)
    with pytest.raises(RuntimeError, match="is_available"):
        Campaign(workloads(dse), space, evaluator="cuda")


def test_config_validation():
    space = tiny_campaign_space()
    with pytest.raises(ValueError, match="power_model"):
        CampaignConfig(space=space, evaluator="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown evaluator"):
        CampaignConfig(space=space, evaluator="warp", device="cpu")
    with pytest.raises(ValueError, match="float64 tier"):
        CampaignConfig(space=space, evaluator="torch", dtype="float32",
                       device="cpu")
    with pytest.raises(TypeError, match="SpaceSpec"):
        CampaignConfig(space="tiny", device="cpu")
    with pytest.raises(ValueError, match="max_survivors"):
        CampaignConfig(space=space, device="cpu", max_survivors=0)
    cfg = CampaignConfig(space=space, device="cpu", chunk_size=32)
    assert cfg.resolved_space.chunk_size == 32 and cfg.dtype_name == "float64"
    assert cfg.replace(dtype="float32", evaluator="cuda").dtype is \
        torch.float32
    with pytest.raises(TypeError, match="AdaptiveConfig"):
        cfg.replace(adaptive={"budget_fraction": 0.1})
    with pytest.raises(ValueError, match="duplicate"):
        TileEvaluator(workloads(dse) * 2, cfg)
    short = Campaign(workloads(dse), space, evaluator="cuda", device="cpu")
    assert short.fused and short.config.device.type == "cpu"
    with pytest.raises(TypeError, match="not both"):
        Campaign(workloads(dse), cfg, evaluator="cuda")
    with pytest.raises(TypeError, match="unexpected keyword"):
        Campaign(workloads(dse), space, pipeline=True, device="cpu")


# --- the host-side pieces carried over -----------------------------------------


@pytest.mark.parametrize("mk_ref,mk_port", [
    (ref_camp.tiny_campaign_space, tiny_campaign_space),
    (ref_camp.default_campaign_space, default_campaign_space)])
def test_space_spec_matches_reference(mk_ref, mk_port):
    a, b = mk_ref(), mk_port()
    assert len(a) == len(b) and a.n_rows == b.n_rows
    assert a.n_tiles() == b.n_tiles() and a.to_dict() == b.to_dict()
    lo, hi = len(a) // 3, len(a) // 3 + 500
    sa = a.slice(lo, hi, with_candidates=False)
    sb = b.slice(lo, hi, with_candidates=False)
    for f in ("chip_idx", "n_chips", "mesh_data", "mesh_model", "freq_mhz",
              "mesh_pod"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    for k in sa.chip_cols:
        np.testing.assert_array_equal(sa.chip_cols[k], sb.chip_cols[k])
    idx = [0, lo, len(a) - 1]
    assert cand_tuples(a.candidates_at(idx)) == \
        cand_tuples(b.candidates_at(idx))
    assert SpaceSpec.from_dict(a.to_dict()) == b
    with pytest.raises(IndexError):
        b.candidates_at([len(b)])


def test_hypervolume_helpers_match_reference():
    rng = np.random.default_rng(11)
    e, l = rng.uniform(1, 10, 40), rng.uniform(1, 10, 40)
    assert hypervolume_2d(e, l, 9.0, 9.5) == \
        ref_camp.hypervolume_2d(e, l, 9.0, 9.5)
    assert hypervolume_2d(e, l, None, None) == 0.0
    np.testing.assert_array_equal(
        hypervolume_gain_2d(e, l, e[:7], l[:7], 9.0, 9.5),
        ref_camp.hypervolume_gain_2d(e, l, e[:7], l[:7], 9.0, 9.5))


def test_streaming_frontier_merge_reduced_equals_raw_merge():
    rng = np.random.default_rng(2)
    e, l = rng.uniform(1, 50, 60), rng.uniform(1, 50, 60)
    feas = rng.random(60) < 0.7
    cands = [dse.Candidate("tpu-v5e", 1, (1, 1), 1000.0 + i)
             for i in range(60)]
    raw, red = StreamingFrontier(), StreamingFrontier()
    for lo in range(0, 60, 20):
        hi = lo + 20
        raw.merge(cands[lo:hi], e[lo:hi], l[lo:hi], feas[lo:hi],
                  indices=np.arange(lo, hi), tile=lo)
        idx = lo + np.flatnonzero(feas[lo:hi])       # a feasible superset
        red.merge_reduced([cands[i] for i in idx], e[idx], l[idx], idx,
                          span=(lo, hi), n_feasible=idx.size,
                          ref_energy_j=e[idx].max(),
                          ref_latency_s=l[idx].max(), tile=lo)
    np.testing.assert_array_equal(raw.indices, red.indices)
    np.testing.assert_array_equal(raw.energy_j, red.energy_j)
    assert ([s.as_dict() for s in raw.trajectory]
            == [s.as_dict() for s in red.trajectory])
    again = StreamingFrontier.from_state(red.state_dict())
    np.testing.assert_array_equal(again.indices, red.indices)
    assert again.candidates == red.candidates
    with pytest.raises(ValueError, match="partially overlaps"):
        red.merge_reduced(cands[55:56], [1.0], [1.0], [55], span=(50, 70),
                          n_feasible=1, ref_energy_j=1.0, ref_latency_s=1.0)


def test_tile_prefetcher_propagates_and_closes():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    pf = _TilePrefetcher(gen())
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    pf.close()
    slow = _TilePrefetcher(iter(range(100)))
    assert next(slow) == 0
    slow.close()                                 # early stop must not hang
    slow._thread.join(timeout=5)
    assert not slow._thread.is_alive()
