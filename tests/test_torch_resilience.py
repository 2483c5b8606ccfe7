"""Port parity: the resilience layer of ``repro_torch`` against the
reference's, on the CPU.

Gates: ``RetryPolicy`` schedules and ``ChaosPolicy.random`` draws are
bitwise the reference's for the same seeds; the heartbeat, straggler and
retry helpers answer the same sequences alike; ``ChaosRunner`` replays the
same policy to the same report (every count, every fired event, every
recovery's generations) and to frontiers on the reference ``"numpy"``
candidate set that are BITWISE the port's fault-free single-process run;
any byte of a checkpoint flipped or truncated, the resume still equals the
fresh run bitwise; a coordinator restarts from a damaged checkpoint with
the reference's recovery report; and a real ``spawn`` worker killed
mid-tile is counted as a crash, its respawned successor as a clean exit."""

import dataclasses
import os
import time
import warnings

import numpy as np
import pytest
import torch

import repro.dse_campaign as ref_camp
from repro.core import dse as ref_dse
from repro.dse_campaign import chaos as ref_chaos
from repro.dse_campaign import fabric as ref_fabric
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.core import dse
from repro_torch.dse_campaign import (CHAOS_KINDS, Campaign, CampaignConfig,
                                      ChaosEvent, ChaosPolicy, ChaosRunner,
                                      FabricCoordinator, FakeClock,
                                      FaultInjection, LocalFabric,
                                      SliceVariant, SpaceSpec,
                                      canonical_frontier, frontiers_identical,
                                      run_distributed)
from repro_torch.dse_campaign.chaos import _corrupt_file, _truncate_file
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 PreemptionHandler,
                                                 RetryPolicy,
                                                 StragglerDetector,
                                                 recoverable_step)
from repro_torch.telemetry import metric_value

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


def ref_config():
    return ref_camp.CampaignConfig(
        space=small_spec(ref_camp.SpaceSpec, ref_camp.SliceVariant),
        evaluator="numpy", constraint=ref_dse.Constraint(**CONS))


def campaign(evaluator="torch", **kw):
    return Campaign(workloads(dse), port_config(evaluator, **kw))


def assert_bitwise(a, b):
    assert set(a) == set(b)
    for key in a:
        assert frontiers_identical(a[key], b[key]), key


def assert_reference_set(ref_fronts, port_fronts):
    assert set(ref_fronts) == set(port_fronts)
    for key in ref_fronts:
        ca, ea, _, ia = ref_camp.canonical_frontier(ref_fronts[key])
        cb, eb, _, ib = canonical_frontier(port_fronts[key])
        assert ([dataclasses.astuple(c) for c in ca]
                == [dataclasses.astuple(c) for c in cb]), key
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(eb, ea, rtol=1e-12)


@pytest.fixture(scope="module")
def fresh():
    """The port's fault-free single-process frontiers, per tier."""
    return {ev: campaign(ev).run() for ev in ("torch", "cuda")}


@pytest.fixture(scope="module")
def ref_fresh():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ref_camp.Campaign(workloads(ref_dse), ref_config()).run()


# --- RetryPolicy: the reference's schedule, bit for bit -----------------------

RETRY_FIELDS = [dict(), dict(seed=7), dict(seed=8, jitter_frac=0.5),
                dict(base_s=0.1, multiplier=2.0, max_s=1.0, jitter_frac=0.2,
                     max_attempts=8, seed=3),
                dict(base_s=1.0, multiplier=1.0, max_s=1.0, jitter_frac=0.5),
                dict(base_s=0.5, multiplier=2.0, max_s=4.0, jitter_frac=0.0),
                dict(base_s=1.0, max_s=4.0, seed=11, max_attempts=9)]


@pytest.mark.parametrize("fields", RETRY_FIELDS,
                         ids=lambda f: ",".join(f"{k}={v}"
                                                for k, v in f.items()) or "0")
def test_retry_schedule_is_the_reference(fields):
    a, b = ref_ft.RetryPolicy(**fields), RetryPolicy(**fields)
    assert b.schedule() == a.schedule()
    assert [b.backoff_s(i) for i in range(12)] == \
        [a.backoff_s(i) for i in range(12)]
    assert dataclasses.asdict(b) == dataclasses.asdict(a)


def test_retry_policy_validation_and_call_match_reference():
    for bad in (dict(base_s=0.0), dict(multiplier=0.5),
                dict(max_s=0.01, base_s=0.05), dict(jitter_frac=1.0),
                dict(max_attempts=0)):
        for cls in (ref_ft.RetryPolicy, RetryPolicy):
            with pytest.raises(ValueError):
                cls(**bad)
    fields = dict(base_s=0.5, multiplier=2.0, max_s=4.0, jitter_frac=0.1,
                  max_attempts=3, seed=5)
    for cls in (ref_ft.RetryPolicy, RetryPolicy):
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert cls(**fields).call(flaky, sleep=sleeps.append,
                                  retry_on=(OSError,)) == "ok"
        assert sleeps == list(ref_ft.RetryPolicy(**fields).schedule()[:2])
        with pytest.raises(ValueError):
            cls(**fields).call(lambda: (_ for _ in ()).throw(ValueError()),
                               sleep=sleeps.append, retry_on=(OSError,))


# --- heartbeat, straggler, preemption, recoverable step -----------------------


def test_heartbeat_monitor_matches_reference():
    mons = []
    for cls, clock in ((ref_ft.HeartbeatMonitor, ref_fabric.FakeClock()),
                       (HeartbeatMonitor, FakeClock())):
        mons.append((cls(["h0"], timeout_s=10.0, clock=clock), clock))
    script = [("register", "w0"), ("advance", 6.0), ("register", "w1"),
              ("advance", 5.0), ("beat", "w0"), ("advance", 4.0),
              ("forget", "w0"), ("advance", 100.0), ("register", "w2")]
    for op, arg in script:
        outs = []
        for mon, clock in mons:
            if op == "advance":
                clock.advance(arg)
            else:
                getattr(mon, op)(arg)
            outs.append((mon.dead_hosts(), mon.healthy(),
                         dict(mon.last_seen)))
        assert outs[0] == outs[1], (op, arg)


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    times = list(rng.gamma(4.0, 0.01, 200)) + [1.0, 0.04, 2.0]
    a, b = ref_ft.StragglerDetector(window=30, k=4.0), \
        StragglerDetector(window=30, k=4.0)
    assert [b.observe(t) for t in times] == [a.observe(t) for t in times]
    assert b.summary() == a.summary() and b.flagged >= 2
    assert StragglerDetector().summary() == {"median_s": 0.0, "flagged": 0}


def test_preemption_handler_flags_without_installing():
    h = PreemptionHandler(install=False)
    assert not h.requested
    h._handler(15, None)
    assert h.requested


def test_recoverable_step_retries_on_the_same_device():
    assert torch.OutOfMemoryError in ft.torch_transient_errors()
    seen, calls = [], []

    def step(state, batch):
        calls.append(state.device)
        if len(calls) < 3:
            raise torch.OutOfMemoryError("transient")
        return state + batch

    x = torch.ones(3)
    out = recoverable_step(step, x, 2.0, max_retries=2,
                           on_failure=lambda a, e: seen.append(a))
    assert torch.equal(out, torch.full((3,), 3.0))
    assert seen == [1, 2] and set(calls) == {x.device}
    calls.clear()
    with pytest.raises(torch.OutOfMemoryError):
        recoverable_step(step, x, 2.0, max_retries=1)
    with pytest.raises(TypeError):        # a programming error: no retry
        recoverable_step(lambda s, b: s + "x", 1, None)
    # releasing the caching allocator never creates a CUDA context
    was = torch.cuda.is_initialized()
    ft.torch_clear_caches()
    assert torch.cuda.is_initialized() == was


# --- chaos policy ---------------------------------------------------------------


@pytest.mark.parametrize("seed,n_events,horizon", [(0, 6, 31), (3, 4, 7),
                                                   (11, 5, 7), (42, 9, 250),
                                                   (7, 1, 1)])
def test_chaos_policy_random_is_the_reference(seed, n_events, horizon):
    a = ref_chaos.ChaosPolicy.random(seed, n_events, horizon)
    b = ChaosPolicy.random(seed, n_events, horizon)
    assert b.to_dict() == a.to_dict()
    assert ChaosPolicy.from_dict(b.to_dict()) == b
    kinds = ("kill_worker", "slow_worker")
    assert ChaosPolicy.random(seed, n_events, horizon, kinds).to_dict() == \
        ref_chaos.ChaosPolicy.random(seed, n_events, horizon, kinds).to_dict()


def test_chaos_policy_validation_matches_reference():
    assert CHAOS_KINDS == ref_chaos.CHAOS_KINDS
    pol = ChaosPolicy(events=[ChaosEvent(2, "kill_worker", 1),
                              ChaosEvent(3, "corrupt_checkpoint", 17)],
                      poison_tile=4, seed=9)
    assert isinstance(pol.events, tuple)
    assert ChaosPolicy.from_dict(pol.to_dict()) == pol
    for mod in (ref_chaos, None):
        cls = mod.ChaosEvent if mod else ChaosEvent
        with pytest.raises(ValueError):
            cls(1, "set_on_fire")
        with pytest.raises(ValueError):
            cls(-1, "kill_worker")
    with pytest.raises(ValueError):
        ChaosRunner(workloads(dse), port_config(), pol, n_workers=0)


@pytest.mark.parametrize("mode,arg", [("flip", 0), ("flip", 31),
                                      ("flip", 10_007), ("truncate", 1),
                                      ("truncate", 40), ("truncate", 9_999)])
def test_corrupt_and_truncate_file_match_reference(tmp_path, mode, arg):
    data = bytes(range(256)) * 7
    for name, mod in (("ref", ref_chaos), ("port", None)):
        p = tmp_path / name
        p.write_bytes(data)
        fn = (_corrupt_file if mode == "flip" else _truncate_file) \
            if mod is None else (mod._corrupt_file if mode == "flip"
                                 else mod._truncate_file)
        assert fn(str(p), arg) is True
    assert (tmp_path / "ref").read_bytes() == (tmp_path / "port").read_bytes()
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    assert _corrupt_file(str(empty), 3) is False
    assert _truncate_file(str(empty), 3) is False
    assert _corrupt_file(str(tmp_path / "missing"), 3) is False


# --- ChaosRunner: the reference's report, the single-process frontier ---------

POLICIES = {
    "kill_restart_corrupt": dict(events=(
        ChaosEvent(1, "kill_worker"), ChaosEvent(3, "corrupt_checkpoint", 31),
        ChaosEvent(3, "restart_coordinator"))),
    "slow_duplicate_truncate": dict(events=(
        ChaosEvent(1, "slow_worker", 1), ChaosEvent(2, "duplicate_delivery"),
        ChaosEvent(4, "truncate_checkpoint", 40),
        ChaosEvent(4, "restart_coordinator"))),
    "poison": dict(events=(ChaosEvent(2, "kill_worker", 2),), poison_tile=3),
    "random_11": "random:11:5:7",
    "random_0": "random:0:6:7",
    "random_5": "random:5:8:7",
}


def make_policies(name):
    spec = POLICIES[name]
    if isinstance(spec, str):
        _, seed, n, horizon = spec.split(":")
        return (ref_chaos.ChaosPolicy.random(int(seed), int(n), int(horizon)),
                ChaosPolicy.random(int(seed), int(n), int(horizon)))
    ref_events = tuple(ref_chaos.ChaosEvent(e.at_completion, e.kind, e.arg)
                       for e in spec["events"])
    kw = {k: v for k, v in spec.items() if k != "events"}
    return (ref_chaos.ChaosPolicy(events=ref_events, **kw),
            ChaosPolicy(events=spec["events"], **kw))


def normalized(report, root):
    """The report with this run's directory cut out of every path."""
    def norm(v):
        if isinstance(v, str):
            return v.replace(str(root), "<dir>")
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, list):
            return [norm(x) for x in v]
        return v
    return norm(report)


@pytest.mark.parametrize("evaluator", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_chaos_runner_matches_reference(tmp_path, name, evaluator, fresh,
                                        ref_fresh):
    ref_pol, pol = make_policies(name)
    assert pol.to_dict() == ref_pol.to_dict()
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a, ra = ref_chaos.ChaosRunner(workloads(ref_dse), ref_config(),
                                      ref_pol, n_workers=3).run(
            str(tmp_path / "ref" / "chaos.json"))
    b, rb = ChaosRunner(workloads(dse), port_config(evaluator), pol,
                        n_workers=3).run(str(tmp_path / "port" / "chaos.json"))
    assert normalized(rb, tmp_path / "port") == normalized(ra,
                                                           tmp_path / "ref")
    assert b.complete
    assert_bitwise(fresh[evaluator].frontiers, b.frontiers)
    assert_reference_set(ref_fresh.frontiers, b.frontiers)
    assert_reference_set(a.frontiers, b.frontiers)


def test_chaos_run_is_deterministic_and_shows_the_recovery(tmp_path, fresh):
    policy = ChaosPolicy(events=(ChaosEvent(1, "kill_worker"),
                                 ChaosEvent(3, "corrupt_checkpoint", 31),
                                 ChaosEvent(3, "restart_coordinator")))
    reports = []
    for i in range(2):
        result, report = ChaosRunner(workloads(dse), port_config("cuda"),
                                     policy, n_workers=3).run(
            str(tmp_path / "det.json"))
        assert_bitwise(fresh["cuda"].frontiers, result.frontiers)
        reports.append(report)
        for p in os.listdir(tmp_path):
            os.unlink(tmp_path / p)
    assert reports[0] == reports[1]
    r = reports[0]
    assert (r["kills"], r["restarts"], r["corruptions"], r["respawns"]) == \
        (1, 1, 1, 1)
    assert len(r["quarantined_files"]) == 1
    assert r["recoveries"][0]["tiles_done_at_restart"] >= 1


# --- corrupt-any-byte resume == fresh ----------------------------------------


@pytest.mark.parametrize("evaluator", ["torch", "cuda"])
@pytest.mark.parametrize("mode", ["flip", "truncate"])
@pytest.mark.parametrize("offset", [0, 1, 17, 101, 997, 10007])
def test_corrupt_any_byte_resume_equals_fresh(tmp_path, fresh, offset, mode,
                                              evaluator):
    ckpt = str(tmp_path / f"ckpt_{mode}_{offset}.json")
    campaign(evaluator).run(checkpoint_path=ckpt, max_tiles=3)
    if mode == "flip":
        assert _corrupt_file(ckpt, offset)
    else:
        assert _truncate_file(ckpt, offset)
    resumed = Campaign.from_checkpoint(ckpt, device="cpu")
    final = resumed.run(checkpoint_path=ckpt)
    assert final.complete
    assert_bitwise(final.frontiers, fresh[evaluator].frontiers)


# --- coordinator crash recovery -----------------------------------------------


def test_coordinator_recovery_report_matches_reference(tmp_path, fresh):
    """Three completions checkpointed, the canonical file damaged, the
    coordinator restarted: the same recovery report (quarantine, fallback
    generation, journal) as the reference's, then the same frontier."""
    reports = {}
    for name, mod, camp in (
            ("ref", ref_fabric, None), ("port", None, campaign())):
        d = tmp_path / name
        d.mkdir()
        ckpt = str(d / "fab.json")
        if mod is None:
            coord = FabricCoordinator(camp, lease_timeout_s=10.0,
                                      clock=FakeClock())
            LocalFabric(coord, n_workers=2).run(max_completions=3,
                                                checkpoint_path=ckpt)
            _corrupt_file(ckpt, 23)
            coord2 = FabricCoordinator.from_checkpoint(
                ckpt, lease_timeout_s=10.0, clock=FakeClock(), device="cpu")
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rcamp = ref_camp.Campaign(workloads(ref_dse), ref_config())
            coord = mod.FabricCoordinator(rcamp, lease_timeout_s=10.0,
                                          clock=mod.FakeClock())
            mod.LocalFabric(coord, n_workers=2).run(max_completions=3,
                                                    checkpoint_path=ckpt)
            ref_chaos._corrupt_file(ckpt, 23)
            coord2 = mod.FabricCoordinator.from_checkpoint(
                ckpt, lease_timeout_s=10.0, clock=mod.FakeClock())
        reports[name] = normalized(coord2.stats["recovery"], d)
        if mod is None:
            snap = coord2.campaign.telemetry.metrics.snapshot()
            assert metric_value(snap, "fabric_coordinator_recoveries_total") \
                == 1
            assert metric_value(snap,
                                "fabric_checkpoints_quarantined_total") == 1
            final = LocalFabric(coord2, n_workers=2).run(checkpoint_path=ckpt)
            assert_bitwise(final.frontiers, fresh["torch"].frontiers)
    assert reports["port"] == reports["ref"]
    rec = reports["port"]
    assert rec["tiles_done_at_restart"] == 3
    assert rec["journal_generation"] == rec["fallback_generation"] == 4


def test_coordinator_recovery_restores_parked_tiles(tmp_path):
    ckpt = str(tmp_path / "parked.json")
    coord = FabricCoordinator(campaign(), clock=FakeClock(),
                              poison_threshold=1)
    coord.register_worker("w")
    tile = coord.lease("w")
    coord.worker_lost("w", crashed=True)
    assert coord.board.parked_tiles == [tile]
    coord.checkpoint(ckpt)
    coord2 = FabricCoordinator.from_checkpoint(ckpt, clock=FakeClock(),
                                               device="cpu")
    assert coord2.board.parked_tiles == [tile]
    assert coord2.stats["poison_tiles"] == [tile]


# --- real processes: crash against clean exit ---------------------------------


def test_multiprocess_crash_vs_clean_exit_counters(tmp_path, fresh):
    """The ONLY worker dies by ``os._exit`` mid-tile, so the run completes
    only through a RetryPolicy-paced respawn; the kill counts as a crash,
    the respawned worker's shutdown as a clean exit."""
    camp = Campaign(workloads(dse), port_config(
        "cuda", n_workers=1, lease_timeout_s=60.0,
        checkpoint_path=str(tmp_path / "mp.json")))
    t0 = time.monotonic()
    result, stats = run_distributed(
        camp, fault=FaultInjection(kill_worker=0, kill_after_tiles=1),
        retry=RetryPolicy(base_s=0.05, max_s=0.2), max_respawns=2)
    assert time.monotonic() - t0 < 60
    assert_bitwise(result.frontiers, fresh["cuda"].frontiers)
    assert stats["worker_crashes"] == [0]
    assert stats["worker_clean_exits"] == [1]
    assert list(stats["worker_metrics"]) == [1]
    snap = camp.telemetry.metrics.snapshot()
    assert metric_value(snap, "fabric_worker_crashed") == 1
    assert metric_value(snap, "fabric_worker_done") == 1
    assert metric_value(snap, "fabric_worker_respawns_total") == 1
