"""Port parity: the distributed campaign fabric of ``repro_torch`` against
the reference ``repro.dse_campaign.fabric``, on the CPU.

Gates: the lease ledger and the coordinator under the same scripted
operations hand out the same leases and end with the same done intervals,
parked tiles and stats as the reference's; ``LocalFabric`` at 1, 2, 3 and 5
workers, under seeded interleavings and kill / duplicate / hang / poison
faults, ends on the reference ``"numpy"`` frontier candidate set (values
within 1e-12 relative: the port cubes as ``x*x*x`` where the reference
calls ``pow``) with the reference's fault stats, and is BITWISE the port's
own single-process ``Campaign.run``; so are the fused ``"cuda"`` tier (its
kernels' plain versions here) with and without survivor overflow, fabric
checkpoint resume, a reference fabric checkpoint finished in the port, and
real ``spawn`` workers with an injected death and a duplicate delivery."""

import dataclasses
import os
import time
import warnings

import numpy as np
import pytest
import torch

import repro.dse_campaign as ref_camp
from repro.core import dse as ref_dse
from repro.dse_campaign import fabric as ref_fabric
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.core import costmodel, dse
from repro_torch.dse_campaign import (Campaign, CampaignConfig,
                                      FabricCoordinator, FakeClock,
                                      FaultInjection, LeaseBoard, LocalFabric,
                                      MultiprocessFabric, SliceVariant,
                                      SpaceSpec, canonical_frontier,
                                      campaign_config, evaluator_from_config,
                                      frontiers_identical, run_distributed,
                                      store, tile_span)
from repro_torch.dse_campaign import fabric
from repro_torch.dse_campaign.fabric import (_expand_intervals,
                                             _tile_intervals, worker_launches)
from repro_torch.dse_campaign.space import tile_span as space_tile_span
from repro_torch.runtime.fault_tolerance import RetryPolicy

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
CONS = dict(max_power_w=50_000)


def workloads(mod):
    return [mod.Workload("qwen3_14b", "train_4k", BASE, 256, 0.5),
            mod.Workload("stablelm_1_6b", "serve_2k",
                         {k: v * 0.3 for k, v in BASE.items()}, 64, 0.2)]


def small_spec(space_cls=SpaceSpec, variant_cls=SliceVariant, **kw):
    kw.setdefault("chips", ("tpu-v5e", "tpu-v4", "tpu-edge"))
    kw.setdefault("chip_counts", (16, 64))
    kw.setdefault("freq_points", 7)
    kw.setdefault("variants", (variant_cls(), variant_cls("bin85", 0.85)))
    kw.setdefault("chunk_size", 32)
    return space_cls(**kw)


def port_config(evaluator="torch", **kw):
    return CampaignConfig(space=small_spec(), evaluator=evaluator,
                          device="cpu", constraint=dse.Constraint(**CONS),
                          **kw)


def campaign(evaluator="torch", **kw):
    return Campaign(workloads(dse), port_config(evaluator, **kw))


def ref_campaign(evaluator="numpy"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ref_camp.Campaign(workloads(ref_dse), ref_camp.CampaignConfig(
            space=small_spec(ref_camp.SpaceSpec, ref_camp.SliceVariant),
            evaluator=evaluator, constraint=ref_dse.Constraint(**CONS)))


def assert_bitwise(a, b):
    assert set(a) == set(b)
    for key in a:
        assert frontiers_identical(a[key], b[key]), key


def assert_reference_set(ref_fronts, port_fronts):
    """Same canonical candidate tuples and global indices as the
    reference's frontiers; values within 1e-12 relative."""
    assert set(ref_fronts) == set(port_fronts)
    for key in ref_fronts:
        ca, ea, la, ia = ref_camp.canonical_frontier(ref_fronts[key])
        cb, eb, lb, ib = canonical_frontier(port_fronts[key])
        assert ([dataclasses.astuple(c) for c in ca]
                == [dataclasses.astuple(c) for c in cb]), key
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(eb, ea, rtol=1e-12)
        np.testing.assert_allclose(lb, la, rtol=1e-12)


FAULT_STATS = ("deliveries", "duplicates", "reissued_tiles", "lost_workers",
               "worker_crashes", "worker_clean_exits", "poison_tiles",
               "poison_retried")


def fault_stats(coord):
    return {k: coord.stats[k] for k in FAULT_STATS}


@pytest.fixture(scope="module")
def single():
    """The port's single-process frontier every fabric run reproduces
    bitwise, per evaluator tier."""
    return {ev: campaign(ev).run() for ev in ("torch", "cuda")}


@pytest.fixture(scope="module")
def ref_single():
    """The reference's exact ``"numpy"`` frontier."""
    return ref_campaign().run()


# --- LeaseBoard: the same ledger under the same operations --------------------

BOARD_SCRIPTS = {
    "issue_complete_revoke": (6, [], [
        ("next_tile", "a"), ("next_tile", "b"), ("complete", 0),
        ("next_tile", "a"), ("revoke_worker", "b"), ("next_tile", "c"),
        ("complete", 1), ("complete", 1), ("next_tile", "a"),
        ("next_tile", "b"), ("next_tile", "b"), ("next_tile", "b")]),
    "preseeded_done_and_holes": (6, [0, 1, 3], [
        ("next_tile", "a"), ("complete", 2), ("next_tile", "a"),
        ("revoke_worker", "a"), ("complete", 4), ("next_tile", "b"),
        ("next_tile", "b")]),
    "park_unpark": (4, [], [
        ("next_tile", "a"), ("park", 0), ("park", 0), ("next_tile", "a"),
        ("complete", 1), ("next_tile", "b"), ("complete", 2),
        ("next_tile", "b"), ("complete", 3), ("unpark", 0),
        ("next_tile", "c"), ("complete", 0), ("unpark", 0)]),
    "priority": (6, [5], [
        ("set_priority", [4, 1]), ("next_tile", 0), ("next_tile", 1),
        ("revoke_worker", 0), ("next_tile", 2), ("next_tile", 2),
        ("next_tile", 2), ("next_tile", 2), ("next_tile", 2)]),
}


def board_view(b):
    return (b.done_tiles, sorted((t, l.worker, l.issued_at)
                                 for t, l in b.leases.items()),
            b.parked_tiles, b.n_pending, b.n_done, b.all_done,
            b.all_settled, b.contiguous_done_prefix())


@pytest.mark.parametrize("name", sorted(BOARD_SCRIPTS))
def test_lease_board_matches_reference(name):
    n, done, script = BOARD_SCRIPTS[name]
    ref, port = ref_fabric.LeaseBoard(n, done=done), LeaseBoard(n, done=done)
    for op, arg in script:
        assert getattr(port, op)(arg) == getattr(ref, op)(arg), (op, arg)
        assert board_view(port) == board_view(ref), (op, arg)


def test_lease_board_validation_and_intervals_match_reference():
    for cls in (ref_fabric.LeaseBoard, LeaseBoard):
        with pytest.raises(ValueError):
            cls(0)
        with pytest.raises(ValueError):
            cls(4).set_priority([1, 1])
        with pytest.raises(IndexError):
            cls(2).complete(2)
        with pytest.raises(IndexError):
            cls(2).park(9)
    for tiles in ([], [0], [0, 1, 2, 5, 7, 8], [3, 1, 2, 9]):
        assert _tile_intervals(tiles) == ref_fabric._tile_intervals(tiles)
        assert _expand_intervals(_tile_intervals(tiles)) == sorted(tiles)


def test_tile_span_is_the_space_one():
    spec = small_spec()
    assert tile_span is space_tile_span is fabric.tile_span
    ref_spec = small_spec(ref_camp.SpaceSpec, ref_camp.SliceVariant)
    for t in range(spec.n_tiles()):
        assert tile_span(spec, t) == ref_fabric.tile_span(ref_spec, t)
    with pytest.raises(IndexError):
        tile_span(spec, spec.n_tiles())


# --- the coordinator under the same scripted operations ----------------------


def test_coordinator_matches_reference_under_scripted_operations():
    """Leases, expiry, deliveries (duplicates included), crash and clean
    loss, poison quarantine: the same returns, the same stats and the same
    ``"fabric"`` checkpoint key in both packages."""
    coords = []
    for mod, camp in ((ref_fabric, ref_campaign()), (fabric, campaign())):
        clock = mod.FakeClock()
        coords.append((mod, clock, mod.FabricCoordinator(
            camp, lease_timeout_s=10.0, clock=clock, poison_threshold=2)))
    space = small_spec()

    def both(fn):
        outs = [fn(mod, clock, c) for mod, clock, c in coords]
        assert outs[0] == outs[1]
        return outs[0]

    def deliver(worker, tile):
        def go(mod, clock, c):
            lo, hi = tile_span(space, tile)
            eng = c.campaign.engine
            tr = eng.reduce_tile(space.slice(lo, hi) if mod is ref_fabric
                                 else c.campaign.space.slice(lo, hi), lo)
            return c.deliver(worker, tile, tr, busy_s=1.0)
        return both(go)

    for w in ("a", "b", "c", "d"):
        both(lambda m, k, c: c.register_worker(w))
    assert both(lambda m, k, c: c.lease("a")) == 0
    assert both(lambda m, k, c: c.lease("b")) == 1
    assert deliver("a", 0) is True
    assert deliver("a", 0) is False          # duplicate: folded, no stats
    assert both(lambda m, k, c: c.lease("a")) == 2
    both(lambda m, k, c: k.advance(11.0))
    both(lambda m, k, c: c.lease("c"))        # c beats; a and b fall silent
    assert both(lambda m, k, c: c.expire()) == {"a": [2], "b": [1]}
    assert both(lambda m, k, c: c.lease("d")) == 1
    both(lambda m, k, c: c.worker_lost("d", crashed=True))
    # tile 1 has now killed b and d: the second distinct death parks it
    assert both(lambda m, k, c: c.board.parked_tiles) == [1]
    both(lambda m, k, c: c.register_worker("e"))
    assert both(lambda m, k, c: c.lease("e")) == 2
    both(lambda m, k, c: c.worker_lost("e", crashed=True))
    assert both(lambda m, k, c: c.board.parked_tiles) == [1, 2]
    assert both(lambda m, k, c: c.lease("c")) == 4      # c still holds 3
    assert both(lambda m, k, c: c.worker_lost("c", crashed=False)) == [3, 4]
    assert deliver("late", 2) is True    # a parked tile delivered late
    stats = both(lambda m, k, c: {key: v for key, v in c.stats.items()
                                  if key != "recovery"})
    assert stats["worker_crashes"] == ["a", "b", "d", "e"]
    assert stats["worker_clean_exits"] == ["c"]
    assert stats["duplicates"] == 1 and stats["deliveries"] == 3
    assert both(lambda m, k, c: c.state_dict()["fabric"]) == {
        "done": [[0, 1], [2, 3]], "leases": [], "parked": [1]}
    assert both(lambda m, k, c: c.campaign.next_tile) == 1
    both(lambda m, k, c: c.retry_parked())
    assert both(lambda m, k, c: (c.board.done_tiles, c.stats["poison_retried"],
                                 c.campaign.next_tile)) == ([0, 1, 2], [1], 3)
    snap = coords[1][2].telemetry.snapshot()
    from repro_torch.telemetry import metric_value
    assert metric_value(snap, "fabric_worker_crashed") == 4
    assert metric_value(snap, "fabric_worker_done") == 1
    assert metric_value(snap, "fabric_lease_expiries_total") == 2
    assert metric_value(snap, "fabric_poison_tiles_total") == 2


def test_coordinator_validation():
    with pytest.raises(ValueError, match="poison_threshold"):
        FabricCoordinator(campaign(), poison_threshold=0)
    with pytest.raises(ValueError):
        LocalFabric(campaign(), n_workers=0)
    with pytest.raises(ValueError, match="FakeClock"):
        LocalFabric(campaign(), clock=time.monotonic,
                    fault=FaultInjection(hang_worker=0))
    with pytest.raises(ValueError, match="FakeClock"):
        LocalFabric(campaign(), clock=time.monotonic,
                    fault=FaultInjection(poison_tile=0))
    with pytest.raises(ValueError, match="LocalFabric"):
        MultiprocessFabric(campaign(), fault=FaultInjection(hang_worker=0))
    with pytest.raises(ValueError):
        MultiprocessFabric(campaign(), n_workers=0)


# --- the worker config ---------------------------------------------------------


@pytest.mark.parametrize("evaluator,dtype", [("torch", "float64"),
                                             ("cuda", "float64"),
                                             ("cuda", "float32")])
def test_campaign_config_ships_names_and_rebuilds(evaluator, dtype):
    camp = campaign(evaluator, dtype=dtype, max_survivors=5)
    cfg = campaign_config(camp)
    assert (cfg["evaluator"], cfg["dtype"], cfg["device"]) == (
        evaluator, dtype, "cpu")
    assert "pipeline" not in cfg
    assert cfg["sim_model_version"] == costmodel.SIM_MODEL_VERSION
    ref_cfg = ref_fabric.campaign_config(ref_campaign())
    assert set(cfg) == set(ref_cfg) - {"pipeline"} | {"dtype", "device"}
    for key in ("space", "workloads", "constraint", "sim"):
        assert cfg[key] == ref_cfg[key]
    ev = evaluator_from_config(cfg)
    assert (ev.evaluator, ev.config.dtype_name, ev.device.type,
            ev.max_survivors) == (evaluator, dtype, "cpu", 5)
    assert ev.workload_keys == camp.engine.workload_keys
    lo, hi = tile_span(camp.space, 1)
    batch = camp.space.slice(lo, hi, with_candidates=not ev.fused)
    a, b = camp.engine.reduce_tile(batch, lo), ev.reduce_tile(batch, lo)
    for wi in range(a.n_workloads):
        np.testing.assert_array_equal(a.surv_gidx[wi], b.surv_gidx[wi])
        np.testing.assert_array_equal(a.surv_energy[wi], b.surv_energy[wi])
        np.testing.assert_array_equal(a.surv_latency[wi], b.surv_latency[wi])
    assert (a.n_feasible, a.ref_energy_j) == (b.n_feasible, b.ref_energy_j)


def test_campaign_config_refusals():
    class Fitted:
        def predict(self, X):  # pragma: no cover - never called
            return np.zeros(len(X))

    with pytest.raises(ValueError, match="fast"):
        campaign_config(campaign("fast", power_model=Fitted(),
                                 cycles_model=Fitted()))
    cfg = campaign_config(campaign())
    cfg["sim_model_version"] = costmodel.SIM_MODEL_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        evaluator_from_config(cfg)


def test_worker_config_asking_for_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = dict(campaign_config(campaign("cuda")), device="cuda:0")
    with pytest.raises(RuntimeError, match="is_available"):
        evaluator_from_config(cfg)


# --- LocalFabric: interleavings and faults ------------------------------------


@pytest.mark.parametrize("evaluator", ["torch", "cuda"])
@pytest.mark.parametrize("n_workers,seed", [(1, 0), (2, 0), (3, 1), (5, 2)])
def test_local_fabric_any_workers_any_interleaving(n_workers, seed, evaluator,
                                                   single, ref_single):
    ref = ref_fabric.LocalFabric(ref_campaign(), n_workers=n_workers,
                                 seed=seed)
    a = ref.run()
    fab = LocalFabric(campaign(evaluator), n_workers=n_workers, seed=seed)
    b = fab.run()
    assert b.complete and b.tiles_done == a.tiles_done == b.n_tiles
    assert_bitwise(single[evaluator].frontiers, b.frontiers)
    assert_reference_set(ref_single.frontiers, b.frontiers)
    assert_reference_set(a.frontiers, b.frontiers)
    assert fault_stats(fab.coord) == fault_stats(ref.coord)
    assert [s.tile for s in b.tile_stats] == [s.tile for s in a.tile_stats]
    assert b.candidates_evaluated == len(small_spec()) * 2


FAULTS = {
    "kill_duplicate": dict(n_workers=3, seed=1, fault=FaultInjection(
        kill_worker=1, kill_after_tiles=1, duplicate=True)),
    "hang": dict(n_workers=2, seed=3, lease_timeout_s=5.0,
                 fault=FaultInjection(hang_worker=0)),
    "poison": dict(n_workers=3, poison_threshold=2,
                   fault=FaultInjection(poison_tile=2)),
    "kill_first_worker": dict(n_workers=2, seed=1, fault=FaultInjection(
        kill_worker=0, kill_after_tiles=2)),
}


@pytest.mark.parametrize("evaluator", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_local_fabric_faults_match_reference(name, evaluator, single,
                                             ref_single):
    kw = dict(FAULTS[name])
    ref = ref_fabric.LocalFabric(
        ref_campaign(), **kw,
        retry=ref_ft.RetryPolicy(base_s=1.0, max_s=4.0))
    a = ref.run()
    fab = LocalFabric(campaign(evaluator), **kw,
                      retry=RetryPolicy(base_s=1.0, max_s=4.0))
    b = fab.run()
    assert b.complete
    assert fault_stats(fab.coord) == fault_stats(ref.coord)
    assert_bitwise(single[evaluator].frontiers, b.frontiers)
    assert_reference_set(ref_single.frontiers, b.frontiers)
    assert_reference_set(a.frontiers, b.frontiers)
    assert b.candidates_evaluated == len(small_spec()) * 2
    fired = {"kill_duplicate": ("lost_workers", [1]),
             "hang": ("lost_workers", [0]), "poison": ("poison_retried", [2]),
             "kill_first_worker": ("lost_workers", [0])}[name]
    assert fab.coord.stats[fired[0]] == fired[1]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("max_survivors", [2048, 1])
def test_local_fabric_fused_tier_bitwise(dtype, max_survivors, ref_single):
    """The fused tier (its kernels' plain versions here) distributes
    bitwise, including when every tile overflows ``max_survivors`` and
    ships the host-reduced exact skyline instead."""
    kw = dict(dtype=dtype, max_survivors=max_survivors)
    one = campaign("cuda", **kw).run()
    res = LocalFabric(campaign("cuda", **kw), n_workers=3, seed=5,
                      fault=FaultInjection(kill_worker=2, kill_after_tiles=1,
                                           duplicate=True)).run()
    assert res.complete
    assert_bitwise(one.frontiers, res.frontiers)
    if dtype == "float64":
        assert_reference_set(ref_single.frontiers, res.frontiers)


def test_tile_reduction_owns_its_arrays():
    """A fused ``TileReduction`` shares no memory with the ``SweepReduced``
    it was cut from (views of the engine's reused result buffer, valid only
    until its next tile): a queue's feeder thread pickles after ``put``
    returns, so a shipped view would carry the next tile's numbers."""
    eng = campaign("cuda").engine
    seen = []
    orig = eng.sweep_reduced

    def spy(batch):
        red = orig(batch)
        seen.append(red)
        return red

    eng.sweep_reduced = spy
    space = eng.space
    out = []
    for t in (1, 2):
        lo, hi = tile_span(space, t)
        out.append(eng.reduce_tile(space.slice(lo, hi, with_candidates=False),
                                   lo))
    first = [np.array(a, copy=True) for a in out[0].surv_energy]
    for tr, red in zip(out, seen):
        held = [red.surv_idx, red.surv_energy, red.surv_latency,
                red.n_survivors, red.n_feasible, red.ref_energy,
                red.ref_latency]
        for arr in (*tr.surv_gidx, *tr.surv_energy, *tr.surv_latency):
            assert not any(np.shares_memory(arr, h) for h in held)
    for a, b in zip(first, out[0].surv_energy):
        np.testing.assert_array_equal(a, b)


# --- distributed checkpoints ---------------------------------------------------


@pytest.mark.parametrize("evaluator", ["torch", "cuda"])
def test_fabric_checkpoint_resumes_on_another_worker_count(tmp_path, evaluator,
                                                           single):
    ckpt = str(tmp_path / "fabric.ckpt.json")
    partial = LocalFabric(campaign(evaluator), n_workers=3, seed=2).run(
        max_completions=3, checkpoint_path=ckpt)
    assert not partial.complete
    state = store.load_checkpoint(ckpt)
    assert state["version"] == 1 and state["evaluator"] == evaluator
    done = _expand_intervals(state["fabric"]["done"])
    assert len(done) == 3
    prefix = 0
    while prefix in done:
        prefix += 1
    assert state["next_tile"] == prefix
    coord = FabricCoordinator.from_checkpoint(ckpt, lease_timeout_s=1e9,
                                              clock=FakeClock(), device="cpu")
    assert coord.board.done_tiles == done
    assert coord.stats["recovery"]["tiles_done_at_restart"] == 3
    before = coord.campaign.engine._c_candidates.value
    res = LocalFabric(coord, n_workers=2, seed=9).run()
    assert res.complete
    assert_bitwise(single[evaluator].frontiers, res.frontiers)
    assert res.candidates_evaluated == len(small_spec()) * 2
    # the done tiles were not evaluated again
    n_left = sum(hi - lo for lo, hi in (tile_span(small_spec(), t) for t in
                                        range(small_spec().n_tiles())
                                        if t not in done))
    assert coord.campaign.engine._c_candidates.value - before == n_left * 2


def test_plain_campaign_resumes_fabric_checkpoint(tmp_path, single):
    ckpt = str(tmp_path / "fabric.ckpt.json")
    LocalFabric(campaign(), n_workers=3, seed=4).run(max_completions=4,
                                                     checkpoint_path=ckpt)
    resumed = Campaign.from_checkpoint(ckpt, device="cpu")
    res = resumed.run()
    assert res.complete
    assert_bitwise(single["torch"].frontiers, res.frontiers)


@pytest.mark.parametrize("port_eval", ["torch", "cuda"])
def test_reference_fabric_checkpoint_finishes_in_port(tmp_path, port_eval,
                                                      ref_single, single):
    """A half-finished reference fabric run (its checkpoint: the campaign
    state plus ``"fabric"``) finishes in the port on the reference's
    frontier; the tiles it had done are not evaluated again."""
    ckpt = str(tmp_path / "ref_fabric.json")
    ref = ref_fabric.LocalFabric(ref_campaign(), n_workers=3, seed=2)
    ref.run(max_completions=3, checkpoint_path=ckpt)
    state = store.load_checkpoint(ckpt)
    assert state["evaluator"] == "numpy" and "fabric" in state
    done = _expand_intervals(state["fabric"]["done"])
    if port_eval == "cuda":
        # the reference's fused float64 tier stands for the port's "cuda"
        state = dict(state, evaluator="pallas")
    coord = FabricCoordinator.from_reference(state, source=ckpt,
                                             clock=FakeClock(), device="cpu")
    assert coord.campaign.evaluator == port_eval
    assert coord.board.done_tiles == done
    res = LocalFabric(coord, n_workers=2, seed=1).run()
    assert res.complete
    assert_reference_set(ref_single.frontiers, res.frontiers)
    n_left = sum(tile_span(small_spec(), t)[1] - tile_span(small_spec(), t)[0]
                 for t in range(small_spec().n_tiles()) if t not in done)
    assert coord.campaign.engine._c_candidates.value == n_left * 2
    assert res.candidates_evaluated == len(small_spec()) * 2


# --- MultiprocessFabric: real spawn workers ------------------------------------


def test_multiprocess_fabric_death_duplicate_identity(tmp_path, single):
    """Real ``spawn`` workers on the fused tier: worker 1 crashes mid-tile,
    the first payload is delivered twice, checkpoints are written — the
    frontier is still the single-process one bitwise."""
    ckpt = str(tmp_path / "mp.ckpt.json")
    fab = MultiprocessFabric(
        campaign("cuda"), n_workers=2, checkpoint_every=2,
        fault=FaultInjection(kill_worker=1, kill_after_tiles=1,
                             duplicate=True))
    res = fab.run(checkpoint_path=ckpt)
    assert res.complete
    assert fab.stats["lost_workers"] == [1]
    assert fab.stats["worker_crashes"] == [1]
    assert fab.stats["duplicates"] == 1
    assert fab.stats["reissued_tiles"] >= 1
    assert fab.stats["worker_clean_exits"] == [0]
    assert_bitwise(single["cuda"].frontiers, res.frontiers)
    assert res.candidates_evaluated == len(small_spec()) * 2
    state = store.load_checkpoint(ckpt)
    assert _expand_intervals(state["fabric"]["done"]) == list(
        range(small_spec().n_tiles()))
    # the surviving worker's terminal snapshot; on the CPU no kernel runs
    assert list(fab.stats["worker_metrics"]) == [0]
    assert set(worker_launches(fab.stats["worker_metrics"]).values()) == {0}
    assert fab.stats["spawn_to_ready_s"] > 0
    assert fab.stats["window_s"] > 0


def test_worker_error_raises_in_the_coordinator(monkeypatch):
    """A worker that cannot build its evaluator (here: asked for the card on
    a host without one) ships ``"error"``, which raises in the coordinator
    — no hang, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    orig = fabric.campaign_config
    monkeypatch.setattr(fabric, "campaign_config",
                        lambda c: dict(orig(c), device="cuda:0"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fabric worker 0 failed"):
        MultiprocessFabric(campaign("cuda"), n_workers=1).run()
    assert time.monotonic() - t0 < 60


def test_whole_fleet_death_raises_instead_of_hanging():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stalled"):
        MultiprocessFabric(campaign(), n_workers=1,
                           fault=FaultInjection(kill_worker=0,
                                                kill_after_tiles=1)).run()
    assert time.monotonic() - t0 < 60


def test_run_distributed_takes_the_fabric_options_from_the_config(tmp_path,
                                                                   single):
    ckpt = str(tmp_path / "rd.json")
    cfg = port_config(n_workers=1, lease_timeout_s=60.0, checkpoint_path=ckpt)
    with pytest.raises(ValueError):
        port_config(n_workers=0)
    with pytest.raises(TypeError):
        run_distributed(Campaign(workloads(dse), cfg), cfg)
    with pytest.raises(TypeError):
        run_distributed(workloads(dse), None)
    res, stats = run_distributed(workloads(dse), cfg)
    assert stats["n_workers"] == 1 and res.complete
    assert_bitwise(single["torch"].frontiers, res.frontiers)
    assert os.path.exists(ckpt)
