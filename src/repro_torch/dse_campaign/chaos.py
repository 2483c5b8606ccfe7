"""Chaos harness for the campaign fabric: scripted failures, one invariant.

Counterpart of ``repro.dse_campaign.chaos``.  ``ChaosPolicy`` is a
declarative, seeded schedule of faults — worker kills, coordinator
restarts, checkpoint bit-flips/truncations, slow workers, duplicate
deliveries, plus an optional poison tile — and ``ChaosRunner`` replays it
against a simulated fleet under a ``FakeClock``: every run is
bit-reproducible from ``(workloads, config, policy)`` alone, no wall clock,
no scheduler nondeterminism.  The fleet shares the campaign's own
``TileEvaluator``, so on ``evaluator="cuda"`` every tile it evaluates is a
fused kernel launch on the config's device.

The runner is deliberately the HARSHEST client of the resilience layer:

  * a coordinator restart throws the live ``FabricCoordinator`` away and
    rebuilds it with ``FabricCoordinator.from_checkpoint`` — everything not
    yet checkpointed is re-evaluated, outstanding leases re-pend;
  * checkpoint corruption flips/truncates real bytes on disk, so the next
    restart exercises the store's CRC verify -> quarantine -> generation
    fallback path (``repro_torch.dse_campaign.store``);
  * killed workers respawn after a ``RetryPolicy`` backoff on the virtual
    clock; a poison tile kills every worker that touches it until the
    coordinator's quarantine parks it;
  * slow workers hold their lease past expiry and deliver late — the fold
    must be a no-op.

THE invariant: whatever the policy does, the final frontiers are
bitwise-identical to the fault-free single-process ``Campaign.run`` on the
same config.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dse_campaign.config import CampaignConfig
from repro_torch.dse_campaign.fabric import (FabricCoordinator, FakeClock,
                                             tile_span)
from repro_torch.dse_campaign.runner import Campaign, CampaignResult
from repro_torch.runtime.fault_tolerance import RetryPolicy
from repro_torch.telemetry import NullTelemetry

# event kinds a ChaosPolicy may schedule
CHAOS_KINDS = ("kill_worker", "restart_coordinator", "corrupt_checkpoint",
               "truncate_checkpoint", "slow_worker", "duplicate_delivery")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: fired when the run reaches ``at_completion``
    delivered tile completions.  ``arg`` parameterizes the kind: victim
    selector for kills/slowdowns (index into the alive fleet), byte offset
    for ``corrupt_checkpoint``, kept-byte count for ``truncate_checkpoint``,
    unused otherwise."""

    at_completion: int
    kind: str
    arg: int = 0

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; expected "
                             f"one of {CHAOS_KINDS}")
        if self.at_completion < 0:
            raise ValueError("at_completion must be >= 0")


@dataclasses.dataclass(frozen=True)
class ChaosPolicy:
    """A declarative, seeded fault schedule.

    ``events`` fire in order as the completion counter passes their
    ``at_completion``; ``poison_tile`` (if set) additionally kills every
    worker that receives that tile; ``seed`` drives the interleaving rng
    AND any randomized event details, so a policy fully determines a run.
    """

    events: Tuple[ChaosEvent, ...] = ()
    poison_tile: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    @classmethod
    def random(cls, seed: int, n_events: int, horizon: int,
               kinds: Sequence[str] = CHAOS_KINDS) -> "ChaosPolicy":
        """A seeded random schedule: ``n_events`` faults drawn from
        ``kinds``, spread over completions ``[1, horizon]`` — the same
        draws as the reference's for the same arguments."""
        rng = np.random.default_rng(seed)
        events = tuple(sorted(
            (ChaosEvent(at_completion=int(rng.integers(1, max(horizon, 2))),
                        kind=str(rng.choice(list(kinds))),
                        arg=int(rng.integers(0, 1 << 16)))
             for _ in range(n_events)),
            key=lambda e: (e.at_completion, e.kind, e.arg)))
        return cls(events=events, seed=seed)

    def to_dict(self) -> Dict:
        return {"events": [dataclasses.asdict(e) for e in self.events],
                "poison_tile": self.poison_tile, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Dict) -> "ChaosPolicy":
        return cls(events=tuple(ChaosEvent(**e) for e in d["events"]),
                   poison_tile=d.get("poison_tile"), seed=d.get("seed", 0))


def _corrupt_file(path: str, offset: int) -> bool:
    """Flip one byte of ``path`` at ``offset`` (mod size)."""
    try:
        with open(path, "r+b") as f:
            raw = f.read()
            if not raw:
                return False
            pos = offset % len(raw)
            f.seek(pos)
            f.write(bytes([raw[pos] ^ 0xFF]))
    except OSError:
        return False
    return True


def _truncate_file(path: str, keep: int) -> bool:
    """Cut ``path`` down to ``keep`` bytes (mod size)."""
    try:
        size = os.path.getsize(path)
        if size == 0:
            return False
        with open(path, "r+b") as f:
            f.truncate(keep % size)
    except OSError:
        return False
    return True


class ChaosRunner:
    """Replay a ``ChaosPolicy`` against a simulated fabric fleet.

    Structure follows ``LocalFabric`` (seeded interleaving, shared
    evaluator, virtual clock advancing 1.0 per iteration) plus the full
    resilience surface: checkpoint every completion, coordinator restarts
    via ``from_checkpoint`` (on the config's device and survivor capacity,
    which a checkpoint does not store), worker respawns on a
    ``RetryPolicy`` backoff, slow workers that deliver after lease expiry,
    and on-disk checkpoint corruption.  ``run`` returns
    ``(CampaignResult, report)`` where the report aggregates fault/recovery
    telemetry across every coordinator incarnation.
    """

    def __init__(self, workloads, config: CampaignConfig,
                 policy: ChaosPolicy, n_workers: int = 3,
                 lease_timeout_s: float = 8.0, poison_threshold: int = 2,
                 retry: Optional[RetryPolicy] = None,
                 slow_for_s: Optional[float] = None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.workloads = list(workloads)
        self.config = config
        self.policy = policy
        self.n_workers = int(n_workers)
        self.lease_timeout_s = float(lease_timeout_s)
        self.poison_threshold = int(poison_threshold)
        self.retry = retry or RetryPolicy(base_s=1.0, max_s=4.0,
                                          seed=policy.seed)
        # how long a slow_worker stays asleep: past the lease timeout, so
        # expiry + late delivery is actually exercised
        self.slow_for_s = (float(slow_for_s) if slow_for_s is not None
                           else 2.0 * self.lease_timeout_s + 1.0)

    def run(self, checkpoint_path: str) -> Tuple[CampaignResult, Dict]:
        clock = FakeClock()
        tel = NullTelemetry(clock=clock)
        campaign = Campaign(self.workloads, self.config, telemetry=tel)
        coord = FabricCoordinator(campaign,
                                  lease_timeout_s=self.lease_timeout_s,
                                  clock=clock,
                                  poison_threshold=self.poison_threshold)
        engine = campaign.engine
        space = campaign.space
        rng = np.random.default_rng(self.policy.seed)
        n_tiles = space.n_tiles()

        alive: List[int] = list(range(self.n_workers))
        for w in alive:
            coord.register_worker(w)
        holding: Dict[int, int] = {}
        asleep: Dict[int, float] = {}           # worker -> wake time
        respawns: List[Tuple[float, int]] = []  # (due time, new worker id)
        next_wid = self.n_workers
        n_respawned = 0
        # stable sort: events at the same completion fire in authored order
        pending_events = sorted(self.policy.events,
                                key=lambda e: e.at_completion)
        duplicate_next = 0
        n_completions = 0
        report = {
            "events_fired": [],
            "kills": 0, "restarts": 0, "corruptions": 0, "truncations": 0,
            "slowdowns": 0, "duplicates_injected": 0, "respawns": 0,
            "quarantined_files": [], "recoveries": [],
            "poison_tiles": [], "poison_retried": [],
            "reissued_tiles": 0, "worker_crashes": 0, "clean_exits": 0,
            "deliveries": 0, "duplicates_folded": 0,
            "recovery_virtual_s": 0.0,
        }

        # stats survive coordinator restarts only through this fold
        def fold_stats(c: FabricCoordinator):
            report["reissued_tiles"] += c.stats["reissued_tiles"]
            report["worker_crashes"] += len(c.stats["worker_crashes"])
            report["clean_exits"] += len(c.stats["worker_clean_exits"])
            report["deliveries"] += c.stats["deliveries"]
            report["duplicates_folded"] += c.stats["duplicates"]
            report["poison_tiles"] = sorted(
                set(report["poison_tiles"]) | set(c.stats["poison_tiles"]))
            report["poison_retried"] = sorted(
                set(report["poison_retried"])
                | set(c.stats["poison_retried"]))

        def crash_worker(w: int):
            nonlocal next_wid, n_respawned
            if w in alive:
                alive.remove(w)
            holding.pop(w, None)
            asleep.pop(w, None)
            coord.worker_lost(w, crashed=True)
            respawns.append((clock() + self.retry.backoff_s(n_respawned),
                             next_wid))
            n_respawned += 1
            next_wid += 1

        def fire(event: ChaosEvent):
            nonlocal duplicate_next
            report["events_fired"].append(
                {"t": clock(), "completion": n_completions,
                 "kind": event.kind, "arg": event.arg})
            if event.kind == "kill_worker":
                if alive:
                    report["kills"] += 1
                    crash_worker(alive[event.arg % len(alive)])
            elif event.kind == "slow_worker":
                candidates = [w for w in alive if w in holding
                              and w not in asleep]
                if candidates:
                    report["slowdowns"] += 1
                    asleep[candidates[event.arg % len(candidates)]] = (
                        clock() + self.slow_for_s)
            elif event.kind == "duplicate_delivery":
                duplicate_next += 1
                report["duplicates_injected"] += 1
            elif event.kind == "corrupt_checkpoint":
                if _corrupt_file(checkpoint_path, event.arg):
                    report["corruptions"] += 1
            elif event.kind == "truncate_checkpoint":
                if _truncate_file(checkpoint_path, max(event.arg, 1)):
                    report["truncations"] += 1
            elif event.kind == "restart_coordinator":
                restart()

        def restart():
            # the coordinator dies WITHOUT a goodbye checkpoint — recovery
            # starts from whatever the store last made durable
            nonlocal coord
            report["restarts"] += 1
            t_down = clock()
            fold_stats(coord)
            coord = FabricCoordinator.from_checkpoint(
                checkpoint_path, lease_timeout_s=self.lease_timeout_s,
                clock=clock, poison_threshold=self.poison_threshold,
                telemetry=tel, device=self.config.device,
                max_survivors=self.config.max_survivors)
            rec = coord.stats["recovery"]
            report["recoveries"].append(rec)
            report["quarantined_files"].extend(rec["quarantined"])
            # in-flight work is gone: workers re-register with the new
            # coordinator and start from fresh leases
            holding.clear()
            asleep.clear()
            for w in alive:
                coord.register_worker(w)
            report["recovery_virtual_s"] += clock() - t_down

        def deliver(w: int, tile: int):
            nonlocal duplicate_next, n_completions
            lo, hi = tile_span(space, tile)
            t0 = clock()
            batch = space.slice(lo, hi, with_candidates=not engine.fused)
            reduction = engine.reduce_tile(batch, lo)
            coord.deliver(w, tile, reduction, busy_s=clock() - t0)
            if duplicate_next > 0:
                duplicate_next -= 1
                coord.deliver(w, tile, reduction, busy_s=0.0)
            n_completions += 1
            coord.checkpoint(checkpoint_path)

        def issue_leases():
            for w in alive:
                if w not in holding and w not in asleep:
                    tile = coord.lease(w)
                    if tile is not None:
                        holding[w] = tile

        issue_leases()
        t_start = clock()
        max_iters = 1000 * n_tiles + 10000
        iters = 0
        while not coord.all_done:
            if coord.board.all_settled and not respawns and not holding:
                break  # only parked poison tiles remain
            iters += 1
            if iters > max_iters:
                raise RuntimeError(
                    f"chaos run did not converge in {max_iters} iterations "
                    f"({coord.board.n_done}/{n_tiles} tiles done)")
            while (pending_events
                   and pending_events[0].at_completion <= n_completions):
                fire(pending_events.pop(0))
            active = [w for w in holding
                      if w in alive and w not in asleep]
            if active:
                w = active[int(rng.integers(len(active)))]
                tile = holding.pop(w)
                if tile == self.policy.poison_tile:
                    # touching the poison tile kills the worker; repeated
                    # crash attribution parks the tile at the threshold
                    crash_worker(w)
                else:
                    deliver(w, tile)
            clock.advance(1.0)
            for w, tiles in coord.expire().items():
                # a slow worker keeps its held tile: it will deliver LATE,
                # after the lease re-pended — the fold must be a no-op
                if w not in asleep:
                    holding.pop(w, None)
            for w, wake_at in list(asleep.items()):
                if clock() >= wake_at:
                    del asleep[w]
                    tile = holding.pop(w, None)
                    coord.register_worker(w)
                    if tile is not None and not coord.board.all_done:
                        deliver(w, tile)  # late delivery of the stale lease
            for due, nw in [r for r in respawns if clock() >= r[0]]:
                respawns.remove((due, nw))
                report["respawns"] += 1
                coord.register_worker(nw)
                alive.append(nw)
            issue_leases()
            if not coord.all_done and not alive and not respawns:
                raise RuntimeError(
                    f"chaos fleet extinct with {coord.board.n_pending} "
                    "tiles pending")
        if coord.board.parked_tiles:
            coord.retry_parked()
        coord.checkpoint(checkpoint_path)
        result = coord.result(clock() - t_start)
        fold_stats(coord)
        report["n_completions"] = n_completions
        report["virtual_s"] = clock() - t_start
        report["n_tiles"] = n_tiles
        return result, report
