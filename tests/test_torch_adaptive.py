"""Port parity: the adaptive (surrogate-guided) campaign, the training
subsample on ``TileReduction`` and the ``"fast"`` evaluator tier of
``repro_torch.dse_campaign`` against the reference ``repro.dse_campaign``,
on the CPU, on ``tiny_campaign_space(chunk_size=64)`` (800 candidates, 13
tiles).

Cross-package gates run the reference's exact ``"numpy"`` tier against the
port's ``"torch"`` tier (both float64): the same ``rounds``, identical
frontier candidate sets, ``hv_history`` within 1e-12 relative.  The
surrogates' training rows: features bitwise, targets within 1e-15 relative
(the port cubes as ``x*x*x`` where the reference calls ``pow``, so a few
targets differ in the last bit — and a split whose score ties another
feature's to the last bit may then fall to the other feature, as one split
of one tree does in the ``seed7`` case); so the forests are held by
replaying the reference's own rows through the port's ``partial_fit``,
round by round: tree arrays bitwise.  Port-only gates carried over
from ``tests/test_adaptive.py``: budget 1.0 is bitwise the exact sweep, the
frontier is a subset of the evaluated tiles, resume == fresh, a plain
checkpoint is refused.  The distributed runner (``run_adaptive_distributed``,
real ``spawn`` workers on the fused tier's plain versions) runs the same
rounds, ``hv_history``, stop and frontiers as the single-process campaign,
bitwise, clean and with a worker crash and a duplicate delivery, and on
the reference's candidate sets; a pool whose every worker dies raises."""

import dataclasses
import time
import warnings

import numpy as np
import pytest

import repro.dse_campaign as ref_camp
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.core import costmodel as ref_costmodel
from repro.core import dse as ref_dse
from repro.core import features as ref_features
from repro.core import predictors as R
from repro.hw import get_chip as ref_get_chip
from repro_torch.core import dse
from repro_torch.core import predictors as P
from repro_torch.dse_campaign import (AdaptiveCampaign, AdaptiveConfig,
                                      Campaign, CampaignConfig,
                                      FaultInjection, canonical_frontier,
                                      frontiers_identical,
                                      run_adaptive_distributed,
                                      state_from_reference, tile_span,
                                      tiny_campaign_space)
from repro_torch.dse_campaign.adaptive import _WorkerPool

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
CONS = dict(max_power_w=50_000)
ACFG = dict(budget_fraction=0.6, seed_fraction=0.15, round_fraction=0.08,
            train_sample=48, plateau_rounds=2)


def workloads(mod):
    return [mod.Workload("qwen3_14b", "train_4k", BASE, 256, 0.5),
            mod.Workload("stablelm_1_6b", "train_4k",
                         {k: v * 0.2 for k, v in BASE.items()}, 256, 0.1)]


def ref_config(acfg=None, evaluator="numpy", **kw):
    return ref_camp.CampaignConfig(
        space=ref_camp.tiny_campaign_space(chunk_size=64),
        evaluator=evaluator, constraint=ref_dse.Constraint(**CONS),
        adaptive=acfg, **kw)


def port_config(acfg=None, evaluator="torch", **kw):
    return CampaignConfig(space=tiny_campaign_space(chunk_size=64),
                          evaluator=evaluator, device="cpu",
                          constraint=dse.Constraint(**CONS), adaptive=acfg,
                          **kw)


def run_ref_adaptive(**acfg):
    ad = ref_camp.AdaptiveCampaign(
        workloads(ref_dse), ref_config(ref_camp.AdaptiveConfig(**acfg)))
    return ad, ad.run()


def run_port_adaptive(evaluator="torch", **acfg):
    ad = AdaptiveCampaign(workloads(dse),
                          port_config(AdaptiveConfig(**acfg), evaluator))
    return ad, ad.run()


def same_frontier_set(ref_front, port_front):
    ca, _, _, ia = ref_camp.canonical_frontier(ref_front)
    cb, _, _, ib = canonical_frontier(port_front)
    return ([dataclasses.astuple(c) for c in ca]
            == [dataclasses.astuple(c) for c in cb]
            and np.array_equal(ia, ib))


# --- config ------------------------------------------------------------------


def test_adaptive_config_is_the_reference_and_validates():
    assert AdaptiveConfig().to_dict() == ref_camp.AdaptiveConfig().to_dict()
    acfg = AdaptiveConfig(**ACFG, explore_weight=1.7, seed=3)
    assert AdaptiveConfig.from_dict(acfg.to_dict()) == acfg
    for bad in [dict(budget_fraction=0.0), dict(budget_fraction=1.5),
                dict(seed_fraction=0.0), dict(round_fraction=0.0),
                dict(plateau_rounds=0), dict(train_sample=0),
                dict(n_trees=0), dict(refresh_trees=9, n_trees=8)]:
        with pytest.raises(ValueError):
            AdaptiveConfig(**bad)
    with pytest.raises(TypeError, match="AdaptiveConfig"):
        port_config(acfg=dict(ACFG))
    with pytest.raises(ValueError, match="config.adaptive"):
        AdaptiveCampaign(workloads(dse), port_config())


# --- the adaptive loop against the reference ---------------------------------


@pytest.mark.parametrize("acfg", [dict(ACFG), dict(ACFG, seed=7,
                                                   explore_weight=0.5)],
                         ids=["default", "seed7"])
def test_adaptive_matches_reference(acfg):
    ref, rr = run_ref_adaptive(**acfg)
    port, pr = run_port_adaptive(**acfg)
    assert pr.rounds == rr.rounds
    assert pr.stopped_on == rr.stopped_on
    assert (pr.tiles_evaluated, pr.candidates_evaluated) == (
        rr.tiles_evaluated, rr.candidates_evaluated)
    np.testing.assert_allclose(pr.hv_history, rr.hv_history, rtol=1e-12,
                               atol=0)
    assert port.acq_refs.keys() == ref.acq_refs.keys()
    # rows each round adds: its tiles' subsample sizes, in sorted-tile order
    space = port.space
    round_rows = [sum(min(acfg["train_sample"], hi - lo) for lo, hi in
                      (tile_span(space, t) for t in set(r)))
                  for r in pr.rounds]
    for wi, key in enumerate(ref.frontiers):
        np.testing.assert_allclose(port.acq_refs[key], ref.acq_refs[key],
                                   rtol=1e-15)
        assert same_frontier_set(rr.frontiers[key], pr.frontiers[key]), key
        for target in ("energy", "latency"):
            a, b = ref.models[key][target], port.models[key][target]
            assert (b._fit_calls, b._next_slot, b.n_rows) == (
                a._fit_calls, a._next_slot, a.n_rows) == (
                len(pr.rounds), b._next_slot, sum(round_rows))
            np.testing.assert_array_equal(b._X, a._X)
            np.testing.assert_allclose(b._y, a._y, rtol=1e-15, atol=0)
            same_y = np.array_equal(b._y, a._y)
            for ta, tb in zip(a._trees, b._trees):
                structure = all(np.array_equal(getattr(tb, f), getattr(ta, f))
                                for f in ("feature", "threshold", "left",
                                          "right"))
                assert structure or not same_y
                if structure:
                    np.testing.assert_allclose(tb.value, ta.value,
                                               rtol=1e-12)
            replay = P.RandomForestRegressor(
                n_trees=a.n_trees, max_depth=a.max_depth,
                min_leaf=a.min_leaf, refresh_trees=a.refresh_trees,
                log_target=False, device="cpu")
            seed = ref._model_seed(wi, target)
            for lo, hi in zip(np.cumsum([0] + round_rows[:-1]),
                              np.cumsum(round_rows)):
                replay.partial_fit(a._X[lo:hi], a._y[lo:hi], seed=seed)
            for ta, tb in zip(a._trees, replay._trees):
                for f in ("feature", "threshold", "left", "right", "value"):
                    np.testing.assert_array_equal(getattr(tb, f),
                                                  getattr(ta, f))


def test_fused_tier_on_the_cpu_runs_the_same_rounds():
    """The ``"cuda"`` evaluator (here its kernels' plain versions) float64:
    the same rounds, frontiers and hypervolumes as the ``"torch"`` tier."""
    exact, er = run_port_adaptive(**ACFG)
    fused, fr = run_port_adaptive("cuda", **ACFG)
    assert fr.rounds == er.rounds and fr.stopped_on == er.stopped_on
    np.testing.assert_allclose(fr.hv_history, er.hv_history, rtol=1e-12,
                               atol=0)
    for key in er.frontiers:
        assert frontiers_identical(er.frontiers[key], fr.frontiers[key])


# --- the training subsample --------------------------------------------------


def test_tile_reduction_carries_the_reference_training_sample():
    acfg = AdaptiveConfig(**ACFG)
    batch = tiny_campaign_space(chunk_size=64).slice(192, 256)
    ref_batch = ref_camp.tiny_campaign_space(chunk_size=64).slice(192, 256)
    want = ref_camp.TileEvaluator(
        workloads(ref_dse), ref_config(ref_camp.AdaptiveConfig(**ACFG))
    ).reduce_tile(ref_batch, 192)
    for evaluator in ("torch", "cuda"):
        tr = Campaign(workloads(dse), port_config(acfg, evaluator)
                      ).engine.reduce_tile(batch, 192)
        np.testing.assert_array_equal(tr.sample_lidx, want.sample_lidx)
        assert tr.sample_lidx.size == 48
        for wi in range(2):
            np.testing.assert_allclose(tr.sample_energy[wi],
                                       want.sample_energy[wi], rtol=1e-15)
            np.testing.assert_allclose(tr.sample_latency[wi],
                                       want.sample_latency[wi], rtol=1e-15)
    plain = Campaign(workloads(dse), port_config()).engine.reduce_tile(
        batch, 192)
    assert plain.sample_lidx is None and plain.sample_energy is None


# --- port-only gates (from tests/test_adaptive.py) ---------------------------


def test_budget_100_is_bitwise_exact_sweep():
    exact = Campaign(workloads(dse), port_config())
    er = exact.run()
    ad, ar = run_port_adaptive(**dict(ACFG, budget_fraction=1.0))
    for key in exact.frontiers:
        assert frontiers_identical(ad.frontiers[key], er.frontiers[key])
    assert ar.candidates_evaluated == er.space_size == ar.space_size
    assert ar.fraction_evaluated == 1.0
    assert ar.tiles_evaluated == ar.n_tiles and ar.stopped_on == "budget"


def test_adaptive_respects_budget_and_frontier_is_exact():
    ad, res = run_port_adaptive("cuda", **ACFG)
    assert res.stopped_on in ("plateau", "budget", "exhausted")
    assert res.fraction_evaluated <= ad.acfg.budget_fraction + 1e-12
    evaluated = set()
    for rtiles in res.rounds:
        for t in rtiles:
            evaluated.update(range(*tile_span(ad.space, t)))
    assert res.candidates_evaluated == len(evaluated)
    for key, fr in ad.frontiers.items():
        assert len(fr.indices), key
        assert {int(i) for i in fr.indices} <= evaluated, key
    assert np.all(np.diff(res.hv_history) >= -1e-12)


def test_adaptive_resume_matches_fresh(tmp_path):
    fresh, fr = run_port_adaptive("cuda", **ACFG)
    ckpt = str(tmp_path / "adaptive.ckpt.json")
    part = AdaptiveCampaign(workloads(dse),
                            port_config(AdaptiveConfig(**ACFG), "cuda"))
    pr = part.run(checkpoint_path=ckpt, max_rounds=2)
    assert pr.stopped_on == "max_rounds" and len(pr.rounds) == 2
    state = part.state_dict()
    refs = state["adaptive"]["acq_refs"]
    for (a, s), v in part.acq_refs.items():
        assert refs[f"{a}|{s}"] == [v[0], v[1]]
    resumed = AdaptiveCampaign.from_checkpoint(ckpt, device="cpu")
    assert resumed.rounds == fr.rounds[:2]
    assert resumed.acq_refs == part.acq_refs
    assert resumed.config.evaluator == "cuda"
    rr = resumed.run(checkpoint_path=ckpt)
    assert rr.rounds == fr.rounds and rr.hv_history == fr.hv_history
    assert rr.stopped_on == fr.stopped_on
    assert rr.candidates_evaluated == fr.candidates_evaluated
    for key in fresh.frontiers:
        assert frontiers_identical(resumed.frontiers[key],
                                   fresh.frontiers[key])


def test_plain_and_reference_states_are_refused(tmp_path):
    ckpt = str(tmp_path / "plain.ckpt.json")
    Campaign(workloads(dse), port_config()).run(checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="no 'adaptive' state"):
        AdaptiveCampaign.from_checkpoint(ckpt, device="cpu")
    ref = ref_camp.AdaptiveCampaign(
        workloads(ref_dse), ref_config(ref_camp.AdaptiveConfig(**ACFG)))
    ref.run(max_rounds=1)
    with pytest.raises(ValueError, match="adaptive"):
        state_from_reference(ref.state_dict(), device="cpu")


# --- distributed == single-process -------------------------------------------


@pytest.mark.parametrize("fault", [
    None,
    FaultInjection(kill_worker=1, kill_after_tiles=1, duplicate=True),
], ids=["clean", "worker_crash"])
def test_adaptive_distributed_matches_single_process(fault):
    cfg = port_config(AdaptiveConfig(**ACFG), "cuda", n_workers=2)
    single = AdaptiveCampaign(workloads(dse), cfg)
    sr = single.run()
    t0 = time.monotonic()
    dr, stats = run_adaptive_distributed(workloads(dse), cfg, fault=fault)
    assert time.monotonic() - t0 < 60
    assert dr.rounds == sr.rounds
    assert dr.hv_history == sr.hv_history
    assert dr.stopped_on == sr.stopped_on
    assert dr.candidates_evaluated == sr.candidates_evaluated
    for key in single.frontiers:
        assert frontiers_identical(dr.frontiers[key], sr.frontiers[key]), key
    _, rr = run_ref_adaptive(**ACFG)
    assert dr.rounds == rr.rounds
    for key in rr.frontiers:
        assert same_frontier_set(rr.frontiers[key], dr.frontiers[key]), key
    assert stats["n_workers"] == 2
    assert stats["deliveries"] == sum(len(set(r)) for r in dr.rounds)
    if fault is not None:
        assert stats["lost_workers"] == [1]
        assert stats["reissued_tiles"] >= 1
        assert stats["duplicates"] == 1
        assert list(stats["worker_metrics"]) == [0]
    else:
        assert sorted(stats["worker_metrics"]) == [0, 1]


def test_adaptive_pool_raises_when_every_worker_dies():
    cfg = port_config(AdaptiveConfig(**ACFG), "cuda", n_workers=1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="adaptive pool stalled"):
        run_adaptive_distributed(
            workloads(dse), cfg,
            fault=FaultInjection(kill_worker=0, kill_after_tiles=1))
    assert time.monotonic() - t0 < 60
    with pytest.raises(ValueError):
        _WorkerPool(Campaign(workloads(dse), cfg).engine, 0)
    with pytest.raises(ValueError, match="LocalFabric"):
        _WorkerPool(Campaign(workloads(dse), cfg).engine, 1,
                    fault=FaultInjection(hang_worker=0))


# --- the "fast" tier ---------------------------------------------------------


def fitted_models():
    """Power and cycles forests fitted by the reference on
    ``features.extract`` rows of the first workload's cell, and carried
    across (10 trees: their predictions are bitwise the reference's).  Not
    a KNN: on the second workload's cell the arch columns, constant in
    training (standard deviation clamped to 1e-6), put every query a
    million z-units from the training set, where float32 distances no
    longer tell neighbours apart and the two packages' roundings pick
    different ones."""
    cfg, shape = ref_get_config("qwen3_14b"), REF_SHAPES["train_4k"]
    X, yp, yc = [], [], []
    for c in ref_dse.default_space(freq_points=6):
        chip = ref_get_chip(c.chip)
        r = ref_costmodel.simulate(ref_dse._scale_analysis(BASE, 256, c),
                                   chip, c.n_chips, freq_mhz=c.freq_mhz,
                                   mesh=c.mesh)
        X.append(ref_features.extract(cfg, shape, chip, c.n_chips, c.mesh,
                                      c.freq_mhz))
        yp.append(r.power_w)
        yc.append(r.cycles)
    X, yp, yc = np.asarray(X), np.asarray(yp), np.asarray(yc)
    rf = R.RandomForestRegressor(n_trees=10, max_depth=10).fit(X, yp, seed=1)
    rc = R.RandomForestRegressor(n_trees=10, max_depth=10).fit(X, yc, seed=2)
    carry = lambda m: P.params_from_reference(P.model_state(m), device="cpu")
    return (rf, rc), (carry(rf), carry(rc))


def test_fast_campaign_matches_reference_and_resumes(tmp_path):
    (rf, knn), (pf, pk) = fitted_models()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_camp.Campaign(workloads(ref_dse), ref_config(
            evaluator="fast", power_model=rf, cycles_model=knn)).run()
    cfg = port_config(evaluator="fast", power_model=pf, cycles_model=pk)
    port = Campaign(workloads(dse), cfg).run()
    assert port.complete
    for key in ref.frontiers:
        assert same_frontier_set(ref.frontiers[key], port.frontiers[key]), key
        assert (port.frontiers[key].feasible_count
                == ref.frontiers[key].feasible_count)
        np.testing.assert_array_equal(port.frontiers[key].energy_j,
                                      ref.frontiers[key].energy_j)
        np.testing.assert_array_equal(port.frontiers[key].latency_s,
                                      ref.frontiers[key].latency_s)
    with pytest.raises(ValueError, match="power_model"):
        port_config(evaluator="fast")
    with pytest.raises(ValueError, match="float64"):
        port_config(evaluator="fast", power_model=pf, cycles_model=pk,
                    dtype="float32")
    # resume: refused without the models, the fresh frontier with them
    ckpt = str(tmp_path / "fast.ckpt.json")
    Campaign(workloads(dse), cfg).run(checkpoint_path=ckpt, max_tiles=5)
    with pytest.raises(ValueError, match="power_model"):
        Campaign.from_checkpoint(ckpt, device="cpu")
    resumed = Campaign.from_checkpoint(ckpt, device="cpu", power_model=pf,
                                       cycles_model=pk)
    assert resumed.next_tile == 5
    final = resumed.run()
    for key in port.frontiers:
        assert frontiers_identical(final.frontiers[key], port.frontiers[key])
