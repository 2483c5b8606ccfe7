"""The port's selection serving layer (``repro_torch.serving``,
``repro_torch.select``, ``repro_torch.launch.serve``) against the
reference's (``repro.serving``) on the CPU.

The set-up is the reference test's (``tests/test_selection.py``): a small
space (two chips, 16 and 64 chips, five DVFS points), three cached
workload families and novel census perturbations, constraint 50 kW.  Every
engine of the port runs with ``device="cpu"``, where the fused ``"cuda"``
tier takes the kernels' plain versions.

Tolerances: family keys, index files, lookups, nearest distances,
``index_exact`` choices and predictor-path answers bitwise (the same
float64 numpy arithmetic on the same JSON numbers); ``mini_campaign``
answers of the port's float64 tiers against the reference's ``"numpy"``
tier: the identical candidate set and hypervolume rel diff <= 1e-12 (the
values differ in the last bits: the port cubes with ``x*x*x``, the
reference with ``pow``); the port's float32 fused tier against the
reference's ``"jit"``: hypervolume rel diff <= 1e-5.  Within the port,
batched == sequential and engine == standalone ``Campaign`` bitwise.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.dse_campaign as ref_camp
from repro.core import costmodel as ref_costmodel
from repro.core import dse as ref_dse
from repro.launch import serve as ref_serve
from repro.serving import engine as ref_engine
from repro.serving import frontier_index as ref_index
from repro_torch import select
from repro_torch.core import costmodel, dse
from repro_torch.dse_campaign import (Campaign, CampaignConfig, SliceVariant,
                                      SpaceSpec, StreamingFrontier,
                                      TileEvaluator, canonical_frontier,
                                      default_campaign_space,
                                      frontiers_identical, hypervolume_2d,
                                      store)
from repro_torch.dse_campaign.runner import workload_to_dict
from repro_torch.launch.serve import build_index, select_queries
from repro_torch.serving.engine import CircuitBreaker, SelectionEngine
from repro_torch.serving.frontier_index import (INDEX_SCHEMA_VERSION,
                                                FrontierIndex, family_key)
from repro_torch.telemetry import Telemetry, metric_value

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}


def wl(mod=dse, arch="qwen3_14b", shape="train_4k", scale=1.0, chips=256,
       gb=0.5):
    return mod.Workload(arch, shape, {k: v * scale for k, v in BASE.items()},
                        chips, gb)


CACHED = [dict(), dict(arch="stablelm_1_6b", scale=0.3, chips=64, gb=0.2),
          dict(arch="mamba2_130m", scale=0.05, chips=16, gb=0.05)]
NOVEL = dict(scale=1.07)
NOVEL3 = [dict(scale=1.07), dict(arch="stablelm_1_6b", scale=0.41, chips=64,
                                 gb=0.2),
          dict(arch="mamba2_130m", scale=0.06, chips=16, gb=0.05)]
NEAR = dict(scale=1.0 + 1e-12)          # within lookup's rtol of CACHED[0]
CONS = dict(max_power_w=50_000)
TIGHT = dict(max_power_w=20_000)


def small_spec(space_cls=SpaceSpec, variant_cls=SliceVariant, **kw):
    kw.setdefault("chips", ("tpu-v5e", "tpu-v4"))
    kw.setdefault("chip_counts", (16, 64))
    kw.setdefault("freq_points", 5)
    kw.setdefault("variants", (variant_cls(),))
    kw.setdefault("chunk_size", 64)
    return space_cls(**kw)


def ref_config(evaluator="numpy", **kw):
    return ref_camp.CampaignConfig(
        space=small_spec(ref_camp.SpaceSpec, ref_camp.SliceVariant),
        evaluator=evaluator, constraint=ref_dse.Constraint(**CONS), **kw)


def port_config(evaluator="cuda", dtype=torch.float64, **kw):
    return CampaignConfig(space=small_spec(), evaluator=evaluator,
                          dtype=dtype, device="cpu",
                          constraint=dse.Constraint(**CONS), **kw)


class StubModel:
    """Deterministic ``.predict(X)`` stand-in for a fitted predictor (the
    reference test's)."""

    def __init__(self, scale):
        self.scale = scale

    def predict(self, X):
        X = np.asarray(X, np.float64)
        return self.scale * (1.0 + np.abs(X).sum(axis=1)
                             / (1.0 + np.abs(X).max() * X.shape[1]))


STUBS = dict(power_model=StubModel(40.0), cycles_model=StubModel(1e9))


class FakeClock:
    """Time moves only when the test calls ``advance``."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@pytest.fixture(scope="module")
def offline():
    """The reference's ``"numpy"`` campaign and its index, the port's
    ``"torch"`` float64 campaign and its index, over the same space."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rcamp = ref_camp.Campaign([wl(ref_dse, **c) for c in CACHED],
                                  ref_config())
        rres = rcamp.run()
    pcamp = Campaign([wl(**c) for c in CACHED], port_config("torch"))
    pres = pcamp.run()
    assert rres.complete and pres.complete
    return {"rcamp": rcamp, "rres": rres,
            "rindex": ref_index.FrontierIndex.from_campaign(rcamp),
            "pcamp": pcamp, "pres": pres,
            "pindex": FrontierIndex.from_campaign(pcamp)}


def tuples(cands):
    return [dataclasses.astuple(c) for c in cands]


def same_candidate_set(a, b) -> bool:
    """``a`` may be a reference frontier, ``b`` a port one."""
    ca, _, _, ia = (ref_camp.canonical_frontier(a)
                    if isinstance(a, ref_dse.ParetoFrontier)
                    else canonical_frontier(a))
    cb, _, _, ib = canonical_frontier(b)
    return tuples(ca) == tuples(cb) and np.array_equal(ia, ib)


def hv_rel(a, b) -> float:
    ref_e = 1.1 * max(np.max(a.energy_j), np.max(b.energy_j))
    ref_l = 1.1 * max(np.max(a.latency_s), np.max(b.latency_s))
    ha = hypervolume_2d(a.energy_j, a.latency_s, ref_e, ref_l)
    hb = hypervolume_2d(b.energy_j, b.latency_s, ref_e, ref_l)
    return abs(ha - hb) / ha


def assert_entries_equal(ref_entries, port_entries):
    assert len(ref_entries) == len(port_entries)
    for r, p in zip(ref_entries, port_entries):
        assert (r.arch, r.shape) == (p.arch, p.shape)
        assert r.family.tobytes() == p.family.tobytes()
        assert tuples(r.candidates) == tuples(p.candidates)
        for f in ("energy_j", "latency_s", "indices"):
            assert getattr(r, f).tobytes() == getattr(p, f).tobytes()
        assert r.feasible_count == p.feasible_count
        assert dataclasses.astuple(r.workload) == \
            dataclasses.astuple(p.workload)


def assert_choices_equal(ref_answer, port_answer):
    assert len(ref_answer.choices) == len(port_answer.choices) > 0
    for r, p in zip(ref_answer.choices, port_answer.choices):
        assert dataclasses.astuple(r.candidate) == \
            dataclasses.astuple(p.candidate)
        assert (r.energy_j, r.latency_s, r.index, r.exact) == \
            (p.energy_j, p.latency_s, p.index, p.exact)


# --- FrontierIndex --------------------------------------------------------------


@pytest.mark.parametrize("query", CACHED + NOVEL3 + [dict(gb=0.0)])
def test_family_key_is_the_references_bitwise(query):
    got = family_key(wl(**query))
    want = ref_index.family_key(wl(ref_dse, **query))
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()


def test_reference_index_loads_in_the_port(tmp_path, offline):
    path = offline["rindex"].save(str(tmp_path / "ref_index.json"))
    loaded = FrontierIndex.load(path)
    assert (loaded.evaluator, loaded.dtype) == ("torch", "float64")
    assert loaded.space_dict == offline["rindex"].space_dict
    assert loaded.constraint_dict == offline["rindex"].constraint_dict
    assert loaded.sim_dict == offline["rindex"].sim_dict
    assert_entries_equal(offline["rindex"].entries, loaded.entries)
    assert SpaceSpec.from_dict(loaded.space_dict) == small_spec()


def test_port_index_loads_in_the_reference(tmp_path, offline):
    path = offline["pindex"].save(str(tmp_path / "port_index.json"))
    with open(path) as f:
        payload = json.load(f)
    ref_keys = set(offline["rindex"].to_dict())
    assert set(payload) == ref_keys | {"dtype"}
    assert (payload["evaluator"], payload["dtype"]) == ("torch", "float64")
    loaded = ref_index.FrontierIndex.load(path)
    assert_entries_equal(loaded.entries, offline["pindex"].entries)
    # and back: the port's own file round-trips with its tier
    again = FrontierIndex.load(path)
    assert (again.evaluator, again.dtype) == ("torch", "float64")
    assert_entries_equal(offline["pindex"].entries, again.entries)


@pytest.mark.parametrize("query", CACHED + NOVEL3 + [NEAR])
def test_lookup_and_nearest_agree_across_packages(query, offline):
    """Both packages' lookups over the same (reference-built) index return
    the same entry, and ``nearest`` a bitwise-equal distance."""
    rindex = offline["rindex"]
    pindex = FrontierIndex.from_dict(rindex.to_dict())
    rq, pq = wl(ref_dse, **query), wl(**query)
    r, p = rindex.lookup(rq), pindex.lookup(pq)
    assert (r is None) == (p is None)
    if r is not None:
        assert (r.arch, r.shape) == (p.arch, p.shape)
    (rn, rd), (pn, pd) = rindex.nearest(rq), pindex.nearest(pq)
    assert (rn.arch, rn.shape) == (pn.arch, pn.shape)
    assert np.float64(rd).tobytes() == np.float64(pd).tobytes()
    assert (r is not None) == (query in CACHED or query == NEAR)
    assert (rd == 0.0) == (query in CACHED)


def test_port_index_frontiers_match_the_reference_index(offline):
    """A port ``"torch"`` float64 index holds the reference ``"numpy"``
    index's candidate sets, hypervolume within 1e-12."""
    for r, p in zip(offline["rindex"].entries, offline["pindex"].entries):
        assert same_candidate_set(r.frontier(), p.frontier())
        assert r.feasible_count == p.feasible_count
        assert hv_rel(r.frontier(), p.frontier()) <= 1e-12


def test_empty_index_lookup():
    index = FrontierIndex([], small_spec().to_dict(), CONS,
                          dataclasses.asdict(costmodel.SimConfig()), "torch")
    assert len(index) == 0 and index.lookup(wl()) is None
    assert index.nearest(wl()) == (None, float("inf"))


@pytest.mark.parametrize("field,value,match", [
    ("index_schema_version", INDEX_SCHEMA_VERSION + 1, "schema version"),
    ("sim_model_version", costmodel.SIM_MODEL_VERSION - 1,
     "cost-model version")])
def test_version_refusals_word_for_word(tmp_path, offline, field, value,
                                        match):
    assert INDEX_SCHEMA_VERSION == ref_index.INDEX_SCHEMA_VERSION
    assert costmodel.SIM_MODEL_VERSION == ref_costmodel.SIM_MODEL_VERSION
    bad = dict(offline["pindex"].to_dict(), **{field: value})
    with pytest.raises(ValueError, match=match) as got:
        FrontierIndex.from_dict(bad)
    with pytest.raises(ValueError, match=match) as want:
        ref_index.FrontierIndex.from_dict(bad)
    assert str(got.value) == str(want.value)


def test_unknown_evaluator_refused(offline):
    bad = dict(offline["rindex"].to_dict(), evaluator="warp")
    with pytest.raises(ValueError, match="warp"):
        FrontierIndex.from_dict(bad)


def test_incomplete_campaign_refused():
    partial = Campaign([wl(**c) for c in CACHED], port_config())
    partial.run(max_tiles=1)
    with pytest.raises(ValueError, match="incomplete"):
        FrontierIndex.from_campaign(partial)


def test_index_from_checkpoint_inherits_version_gate(tmp_path, offline):
    """The repaired refusal of ``Campaign.from_state``: the reference's
    words, ending in the FrontierIndex clause."""
    camp, res = offline["pcamp"], offline["pres"]
    ckpt = str(tmp_path / "ckpt.json")
    store.save_checkpoint(camp.state_dict(), ckpt)
    index = FrontierIndex.from_checkpoint(ckpt, device="cpu")
    for c in CACHED:
        w = wl(**c)
        assert frontiers_identical(index.lookup(w).frontier(),
                                   res.frontiers[(w.arch, w.shape)])
    state = camp.state_dict()
    state["sim_model_version"] = costmodel.SIM_MODEL_VERSION - 1
    (tmp_path / "old.json").write_text(json.dumps(state))
    with pytest.raises(ValueError, match="rebuild any FrontierIndex") as got:
        FrontierIndex.from_checkpoint(str(tmp_path / "old.json"),
                                      device="cpu")
    rstate = offline["rcamp"].state_dict()
    rstate["sim_model_version"] = costmodel.SIM_MODEL_VERSION - 1
    with pytest.raises(ValueError) as want:
        ref_camp.Campaign.from_state(rstate, source=str(tmp_path / "old.json"))
    assert str(got.value) == str(want.value)


# --- SelectionEngine: the config it derives ---------------------------------------


@pytest.mark.parametrize("evaluator,dtype,want", [
    ("cuda", "float64", torch.float64), ("cuda", "float32", torch.float32),
    ("pallas", "float64", torch.float64), ("jit", "float32", torch.float32),
    ("numpy", "float64", torch.float32), ("torch", "float64", torch.float32),
    ("fast", "float64", torch.float32)])
def test_config_from_index_maps_every_evaluator(offline, evaluator, dtype,
                                                want):
    p = offline["pindex"]
    index = FrontierIndex(p.entries, p.space_dict, p.constraint_dict,
                          p.sim_dict, evaluator, dtype)
    cfg = SelectionEngine._config_from_index(index, device="cpu")
    assert (cfg.evaluator, cfg.dtype, cfg.device.type) == ("cuda", want,
                                                           "cpu")
    assert cfg.space == small_spec()
    assert cfg.constraint == dse.Constraint(**CONS)
    assert cfg.sim == costmodel.SimConfig()


def test_explicit_config_carries_its_own_device(offline):
    cfg = port_config()
    engine = SelectionEngine(offline["pindex"], cfg)
    assert engine.config is cfg and engine.config.device.type == "cpu"
    with pytest.raises(TypeError, match="CampaignConfig"):
        SelectionEngine(offline["pindex"], {"evaluator": "cuda"})


def test_engine_on_the_card_raises_without_one(tmp_path, offline):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SelectionEngine(offline["pindex"])
    ckpt = str(tmp_path / "ckpt.json")
    store.save_checkpoint(offline["pcamp"].state_dict(), ckpt)
    with pytest.raises(RuntimeError, match="cuda"):
        FrontierIndex.from_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="cuda"):
        build_index(ckpt, str(tmp_path / "index.json"))


# --- the three answer paths against the reference ---------------------------------


def test_index_exact_answers_are_the_references_bitwise(tmp_path, offline):
    """On the same reference-built index, through a save/load round trip,
    the port's choices are the reference engine's: candidate, energy,
    latency and index."""
    rindex = offline["rindex"]
    pindex = FrontierIndex.load(rindex.save(str(tmp_path / "index.json")))
    ref = ref_engine.SelectionEngine(rindex)
    eng = SelectionEngine(pindex, device="cpu")
    for c in CACHED:
        want, got = ref.select(wl(ref_dse, **c)), eng.select(wl(**c))
        assert want.provenance == got.provenance == "index_exact"
        assert_choices_equal(want, got)
        assert same_candidate_set(want.frontier(), got.frontier())
        assert same_candidate_set(
            offline["rres"].frontiers[(want.workload.arch,
                                       want.workload.shape)], got.frontier())
        assert got.feasible_count == want.feasible_count
    assert eng.fused_launches == 0 and eng.stats["index_exact"] == 3


@pytest.mark.parametrize("query", [NOVEL, NOVEL3[1]])
def test_mini_campaign_float64_matches_reference_numpy(offline, query):
    ref = ref_engine.SelectionEngine(offline["rindex"], ref_config("numpy"))
    eng = SelectionEngine(offline["pindex"], port_config("cuda"))
    want, got = ref.select(wl(ref_dse, **query)), eng.select(wl(**query))
    assert want.provenance == got.provenance == "mini_campaign"
    assert same_candidate_set(want.frontier(), got.frontier())
    assert got.feasible_count == want.feasible_count
    assert hv_rel(want.frontier(), got.frontier()) <= 1e-12
    assert np.array_equal(got.verified_gidx, want.verified_gidx)
    assert eng.fused_launches == 1
    # the engine's answer is a standalone campaign's, bitwise
    w = wl(**query)
    standalone = Campaign([w], eng.config).run()
    assert frontiers_identical(got.frontier(),
                               standalone.frontiers[(w.arch, w.shape)])


def test_mini_campaign_float32_matches_reference_jit(offline):
    """The default engines of both packages on a reference ``"numpy"``
    index: the reference's ``"jit"``, the port's ``"cuda"`` float32."""
    ref = ref_engine.SelectionEngine(offline["rindex"])
    eng = SelectionEngine(FrontierIndex.from_dict(offline["rindex"].to_dict()),
                          device="cpu")
    assert (ref.config.evaluator, eng.config.evaluator,
            eng.config.dtype) == ("jit", "cuda", torch.float32)
    for q in NOVEL3:
        want, got = ref.select(wl(ref_dse, **q)), eng.select(wl(**q))
        assert want.provenance == got.provenance == "mini_campaign"
        assert hv_rel(want.frontier(), got.frontier()) <= 1e-5
        assert got.feasible_count == want.feasible_count


def test_constraint_override_forces_exact_path(offline):
    eng = SelectionEngine(offline["pindex"], port_config())
    ref = ref_engine.SelectionEngine(offline["rindex"], ref_config())
    got = eng.select(wl(**CACHED[0]), constraint=dse.Constraint(**TIGHT))
    want = ref.select(wl(ref_dse, **CACHED[0]),
                      constraint=ref_dse.Constraint(**TIGHT))
    assert got.provenance == want.provenance == "mini_campaign"
    assert same_candidate_set(want.frontier(), got.frontier())
    w = wl(**CACHED[0])
    standalone = Campaign([w], eng.config.replace(
        constraint=dse.Constraint(**TIGHT))).run()
    assert frontiers_identical(got.frontier(),
                               standalone.frontiers[(w.arch, w.shape)])


def test_full_default_space_is_one_tile_equal_to_the_campaign():
    """The chip's shape on the CPU: a novel query over the 125,440-candidate
    default space is ONE fused tile (W=1, N=125,440) and equals the
    31-tile standalone campaign bitwise."""
    space = default_campaign_space()
    cfg = CampaignConfig(space=space, evaluator="cuda", device="cpu",
                         constraint=dse.Constraint(max_power_w=40_000))
    index = FrontierIndex([], space.to_dict(),
                          dataclasses.asdict(cfg.constraint),
                          dataclasses.asdict(cfg.sim), "cuda")
    tel = Telemetry()
    eng = SelectionEngine(index, cfg, telemetry=tel)
    w = wl(scale=0.2)
    got = eng.select(w)
    assert got.provenance == "mini_campaign" and eng.fused_launches == 1
    assert got.verified_gidx.size == len(space) == 125_440
    assert [r.attrs["n"] for r in tel.tracer.records
            if r.name == "launch"] == [125_440]
    standalone = Campaign([w], cfg).run()
    assert frontiers_identical(got.frontier(),
                               standalone.frontiers[(w.arch, w.shape)])


def test_batched_queries_one_launch_and_equal_to_sequential(offline):
    batched = SelectionEngine(offline["pindex"], port_config())
    for q in NOVEL3:
        batched.submit(wl(**q))
    batched.submit(wl(**CACHED[0]))        # index hit rides along for free
    answers = batched.flush()
    assert batched.fused_launches == 1
    assert [a.provenance for a in answers] == ["mini_campaign"] * 3 + [
        "index_exact"]
    sequential = SelectionEngine(offline["pindex"], port_config())
    for q, got in zip(NOVEL3, answers):
        solo = sequential.select(wl(**q))
        assert frontiers_identical(got.frontier(), solo.frontier())
        assert got.choices == solo.choices
    assert sequential.fused_launches == 3  # one launch per lone query


# --- predictor paths, with the reference's stub models ------------------------


def test_predictor_only_answers_equal_the_references(offline):
    ref = ref_engine.SelectionEngine(offline["rindex"], ref_config(**STUBS))
    eng = SelectionEngine(offline["pindex"], port_config(**STUBS))
    want = ref.select(wl(ref_dse, **NOVEL), deadline_s=0.0)
    got = eng.select(wl(**NOVEL), deadline_s=0.0)
    assert want.provenance == got.provenance == "predictor_only"
    assert got.degraded_reason == want.degraded_reason == "deadline"
    assert_choices_equal(want, got)
    assert all(not c.exact for c in got.choices)
    for f in ("frontier_energy_j", "frontier_latency_s", "frontier_indices"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
    assert tuples(got.frontier_candidates) == tuples(want.frontier_candidates)
    assert eng.fused_launches == 0 and eng.stats["degraded"] == 1
    # same query, no deadline: the exact path answers
    assert eng.select(wl(**NOVEL)).provenance == "mini_campaign"


def test_pruned_slice_equals_the_references_and_its_direct_evaluation(
        offline):
    ref = ref_engine.SelectionEngine(offline["rindex"], ref_config(**STUBS),
                                     verify_top=16)
    eng = SelectionEngine(offline["pindex"], port_config(**STUBS),
                          verify_top=16)
    want, got = ref.select(wl(ref_dse, **NOVEL)), eng.select(wl(**NOVEL))
    assert got.provenance == want.provenance == "mini_campaign"
    gidx = got.verified_gidx
    assert np.array_equal(gidx, want.verified_gidx)
    assert 0 < gidx.size < len(eng.space)
    assert same_candidate_set(want.frontier(), got.frontier())
    # the served frontier == a direct exact evaluation of that slice
    w = wl(**NOVEL)
    ev = TileEvaluator([w], eng.config)
    batch = dse.CandidateBatch.from_candidates(eng.space.candidates_at(gidx))
    tr = ev.reduce_tile(batch, 0)
    fr = StreamingFrontier()
    loc = tr.surv_gidx[0]
    fr.merge_reduced(eng.space.candidates_at(gidx[loc]), tr.surv_energy[0],
                     tr.surv_latency[0], loc, span=(0, int(gidx.size)),
                     n_feasible=tr.n_feasible[0],
                     ref_energy_j=tr.ref_energy_j[0],
                     ref_latency_s=tr.ref_latency_s[0])
    direct = fr.as_pareto_frontier(w)
    direct = dse.ParetoFrontier(
        workload=w, candidates=direct.candidates, energy_j=direct.energy_j,
        latency_s=direct.latency_s, indices=gidx[direct.indices],
        feasible_count=direct.feasible_count)
    assert frontiers_identical(got.frontier(), direct)


def test_deadline_without_models_does_not_degrade(offline):
    eng = SelectionEngine(offline["pindex"], port_config())
    answer = eng.select(wl(**NOVEL), deadline_s=0.0)
    assert answer.provenance == "mini_campaign"
    assert answer.degraded_reason is None and eng.stats["degraded"] == 0
    assert set(eng.stats) >= set(select.PROVENANCES)


# --- circuit breaker ---------------------------------------------------------


def test_circuit_breaker_trips_cools_probes_and_closes():
    clock = FakeClock()
    seen = []
    br = CircuitBreaker(fail_threshold=2, cooldown_s=10.0, clock=clock,
                        on_transition=lambda a, b: seen.append((a, b)))
    assert br.allow() and br.state == "closed"
    br.record_failure()
    assert br.state == "closed"  # below threshold
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock.advance(9.9)
    assert not br.allow()  # still cooling
    clock.advance(0.2)
    assert br.allow() and br.state == "half_open"  # one probe admitted
    br.record_failure()  # probe failed: re-open for a full cooldown
    assert br.state == "open" and not br.allow()
    clock.advance(10.1)
    assert br.allow() and br.state == "half_open"
    br.record_success()
    assert br.state == "closed" and br.allow()
    assert seen == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


def test_circuit_breaker_success_resets_failure_streak():
    br = CircuitBreaker(fail_threshold=3, clock=FakeClock())
    br.record_failure()
    br.record_failure()
    br.record_success()  # streak broken
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open"


@pytest.mark.parametrize("kw", [dict(fail_threshold=0),
                                dict(cooldown_s=-1.0)])
def test_circuit_breaker_validation(kw):
    with pytest.raises(ValueError):
        CircuitBreaker(**kw)


def _failing(engine):
    def boom(*args, **kwargs):
        raise RuntimeError("sweep failed")
    engine._mini_campaign = boom
    return engine


def test_failed_mini_campaign_degrades_with_models_and_opens_breaker(
        offline):
    tel = Telemetry(clock=FakeClock())
    eng = _failing(SelectionEngine(offline["pindex"], port_config(**STUBS),
                                   telemetry=tel, breaker_threshold=2))
    first = eng.select(wl(**NOVEL))
    assert first.provenance == "predictor_only"
    assert first.degraded_reason == "mini_campaign_error"
    assert eng.breaker.state == "closed"
    eng.select(wl(**NOVEL))
    assert eng.breaker.state == "open" and eng.stats["breaker_opens"] == 1
    third = eng.select(wl(**NOVEL))         # breaker open: no sweep tried
    assert third.degraded_reason == "circuit_open"
    snap = tel.snapshot()
    assert metric_value(snap, "selection_minicampaign_failures_total") == 2
    assert eng.stats["degraded"] == 3 and eng.fused_launches == 0


def test_failed_mini_campaign_raises_without_models(offline):
    eng = _failing(SelectionEngine(offline["pindex"], port_config()))
    with pytest.raises(RuntimeError, match="sweep failed"):
        eng.select(wl(**NOVEL))
    assert eng.telemetry.counter(
        "selection_minicampaign_failures_total").value == 1


# --- the facade and the launch CLI ------------------------------------------------


def test_select_facade_exports_the_references_names():
    from repro import select as ref_select
    assert select.__all__ == ref_select.__all__
    for name in select.__all__:
        assert getattr(select, name) is not None


def test_serve_cli_build_index_and_select(tmp_path, offline, capsys):
    camp = Campaign([wl(**c) for c in CACHED], port_config())
    camp.run()
    ckpt = str(tmp_path / "ckpt.json")
    store.save_checkpoint(camp.state_dict(), ckpt)
    idx_path = build_index(ckpt, str(tmp_path / "index.json"), device="cpu")
    answers = select_queries(idx_path, device="cpu")   # self-check
    assert [a.provenance for a in answers] == ["index_exact"] * len(CACHED)
    queries = [{"workload": workload_to_dict(wl(**CACHED[0]))},
               {"workload": workload_to_dict(wl(**NOVEL)),
                "deadline_s": 60.0}]
    qpath = tmp_path / "queries.json"
    qpath.write_text(json.dumps(queries))
    answers = select_queries(idx_path, str(qpath), device="cpu")
    assert [a.provenance for a in answers] == ["index_exact",
                                               "mini_campaign"]
    assert "fused launches: 1" in capsys.readouterr().out
    # the reference's CLI reads the port's index file
    ref_answers = ref_serve.select_queries(idx_path)
    assert [a.provenance for a in ref_answers] == \
        ["index_exact"] * len(CACHED)
