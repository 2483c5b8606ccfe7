"""Distributed campaign fabric: many workers, one frontier.

Counterpart of ``repro.dse_campaign.fabric``.  A campaign's unit of work is
the tile index, and ``StreamingFrontier`` merges are idempotent and
commutative by global candidate index — so distribution is a ledger
problem, not a numerics problem.  This module supplies the ledger:

  * ``LeaseBoard`` — tile ownership: pending tiles are leased to workers,
    completed tiles are retired, and a lost worker's leases return to the
    pending pool for re-issue.
  * ``FabricCoordinator`` — owns the ``Campaign`` state (frontiers, tile
    stats, checkpoints); folds every delivered ``TileReduction`` via
    ``Campaign.merge_reduction`` and drives the board plus a
    ``HeartbeatMonitor`` (``repro_torch.runtime.fault_tolerance``) for
    lease-timeout expiry.  Pure bookkeeping — it never evaluates a tile
    except a quarantined one at the end — and clock-injectable, so every
    failure path is deterministic in tests.
  * ``LocalFabric`` — N simulated workers in one process with seeded
    interleaving and scripted fault injection (kill / hang / duplicate /
    poison): the exhaustive-identity test harness.
  * ``MultiprocessFabric`` — real ``spawn`` worker processes running
    ``TileEvaluator`` loops on the config's device (each worker creates its
    own CUDA context; N workers share one card), shipping
    ``TileReduction`` payloads (O(survivors), cheap to pickle) over queues.

Delivery is at-least-once by design: the coordinator folds EVERY payload it
receives, and span idempotence in ``StreamingFrontier.merge_reduced`` makes
re-folds exact no-ops — a re-issued tile that was secretly completed, or a
duplicated delivery, cannot perturb the frontier.  ``LeaseBoard.complete``
is first-write-wins for the stats ledger only.

THE invariant: for any worker count, any interleaving, any injected worker
death or duplicated payload, the distributed frontier is bitwise-identical
to the single-process ``Campaign.run`` frontier on the same (space,
workloads, constraint, sim, evaluator, dtype).

Worker processes use the ``spawn`` start method unconditionally: a process
that has initialised CUDA cannot ``fork`` a child that uses it, and spawn
children re-import ``repro_torch`` cleanly from the parent's ``sys.path``.
What crosses to a worker is plain data (``campaign_config``): the device
and dtype travel by name and the config is rebuilt in the child, so a
worker asked for ``cuda`` on a host without a card raises like every other
entry point — and its ``"error"`` message raises in the coordinator.
"""

from __future__ import annotations

import dataclasses
import heapq
import multiprocessing as mp
import os
import queue as queue_mod
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import costmodel, dse
from repro_torch.dse_campaign import store
from repro_torch.dse_campaign.config import AdaptiveConfig, CampaignConfig
from repro_torch.dse_campaign.runner import (Campaign, CampaignResult,
                                             TileEvaluator, TileReduction,
                                             TileStat, state_from_reference,
                                             workload_from_dict,
                                             workload_to_dict)
from repro_torch.dse_campaign.space import SpaceSpec, tile_span
from repro_torch.kernels import dse_sweep as k1
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, RetryPolicy
from repro_torch.telemetry import metric_value

WorkerId = Union[int, str]

__all__ = ["FabricCoordinator", "FakeClock", "FaultInjection", "Lease",
           "LeaseBoard", "LocalFabric", "MultiprocessFabric",
           "campaign_config", "evaluator_from_config", "run_distributed",
           "tile_span", "worker_launches"]


class FakeClock:
    """Deterministic stand-in for ``time.monotonic``: time moves only when
    the test calls ``advance``.  Injected into ``FabricCoordinator`` /
    ``HeartbeatMonitor`` so lease expiry fires at an exact, repeatable
    instant instead of depending on scheduler timing."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        """Move time forward ``dt`` seconds (time never moves on its own)."""
        self.t += float(dt)


# ---------------------------------------------------------------------------
# worker config: the picklable description of "what to evaluate"
# ---------------------------------------------------------------------------

def campaign_config(campaign: Union[Campaign, TileEvaluator]) -> Dict:
    """The JSON/pickle-safe evaluator config shipped to fabric workers.

    Stamps ``costmodel.SIM_MODEL_VERSION`` so a mixed-version fleet is
    refused at worker startup instead of silently splicing incomparable
    scores into one frontier.  The device and dtype ship by name
    (``str(device)``, ``config.dtype_name``).  ``evaluator="fast"`` is
    refused: fitted predictor models are not shipped to workers, so the
    fast path stays single-process.
    """
    eng = campaign.engine if isinstance(campaign, Campaign) else campaign
    if eng.evaluator == "fast":
        raise ValueError(
            "evaluator='fast' cannot run on the fabric: fitted predictor "
            "models are not shipped to workers — use 'torch' or 'cuda'")
    return {
        "sim_model_version": costmodel.SIM_MODEL_VERSION,
        "space": eng.space.to_dict(),
        "workloads": [workload_to_dict(wl) for wl in eng.workloads],
        "constraint": dataclasses.asdict(eng.constraint),
        "sim": dataclasses.asdict(eng.sim),
        "evaluator": eng.evaluator,
        "dtype": eng.config.dtype_name,
        "device": str(eng.device),
        "max_survivors": eng.max_survivors,
        # adaptive campaigns need workers to attach the seeded training
        # subsample to every reduction; exact campaigns ship None
        "adaptive": eng.adaptive.to_dict() if eng.adaptive else None,
    }


def evaluator_from_config(cfg: Dict, telemetry=None) -> TileEvaluator:
    """Rebuild a worker-side ``TileEvaluator`` from ``campaign_config``.

    Refuses a config whose ``sim_model_version`` differs from this
    process's ``costmodel.SIM_MODEL_VERSION``.  The device is resolved here,
    in the worker: ``"cuda:0"`` on a host without a card raises.
    ``telemetry`` is the worker's own observability bundle (a telemetry
    object never crosses the process boundary; only its ``snapshot()``
    dict ships back).
    """
    version = cfg.get("sim_model_version")
    if version != costmodel.SIM_MODEL_VERSION:
        raise ValueError(
            f"fabric config carries cost-model version {version!r} but this "
            f"worker is built against {costmodel.SIM_MODEL_VERSION}; a "
            "mixed-version fleet would fold incomparable scores into one "
            "frontier")
    return TileEvaluator(
        [workload_from_dict(w) for w in cfg["workloads"]],
        CampaignConfig(
            space=SpaceSpec.from_dict(cfg["space"]),
            constraint=dse.Constraint(**cfg["constraint"]),
            evaluator=cfg["evaluator"],
            sim=costmodel.SimConfig(**cfg["sim"]),
            dtype=cfg["dtype"],
            device=cfg["device"],
            max_survivors=cfg["max_survivors"],
            adaptive=(AdaptiveConfig.from_dict(cfg["adaptive"])
                      if cfg.get("adaptive") else None)),
        telemetry=telemetry)


# ---------------------------------------------------------------------------
# lease ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lease:
    """One outstanding tile lease: ``worker`` owes the coordinator tile
    ``tile``, issued at coordinator-clock time ``issued_at``."""

    tile: int
    worker: WorkerId
    issued_at: float


class LeaseBoard:
    """Tile-ownership ledger for one campaign: every tile is exactly one of
    *pending* (needs a worker), *leased* (a worker owes its reduction),
    *parked* (poison-quarantined) or *done* (folded and retired).

    Invariants:

    * ``next_tile`` issues pending tiles smallest-first and never issues a
      done tile, so the board converges even when a revoked tile is
      completed by its original (presumed-dead) worker before re-issue;
    * ``complete`` is first-write-wins: the first delivery of a tile
      retires it, later duplicates report ``False`` (the caller still folds
      them — frontier idempotence, not the board, is the dedup authority);
    * ``revoke_worker`` returns a lost worker's leases to the pending pool;
      nothing is ever lost, so ``all_done`` eventually holds as long as one
      worker survives.

    ``set_priority`` overrides the default smallest-index issue order with
    an explicit ranking — the adaptive campaign's hook for leasing tiles in
    acquisition order while keeping every other board invariant.
    """

    def __init__(self, n_tiles: int, done: Sequence[int] = ()):
        if n_tiles < 1:
            raise ValueError("n_tiles must be >= 1")
        self.n_tiles = int(n_tiles)
        self._done = {int(t) for t in done if 0 <= int(t) < n_tiles}
        self._rank: Dict[int, int] = {}
        self._pending = [(t, t) for t in
                         sorted(set(range(self.n_tiles)) - self._done)]
        heapq.heapify(self._pending)
        self._leases: Dict[int, Lease] = {}
        self._parked: set = set()
        self._prefix = 0

    def _rank_of(self, tile: int) -> int:
        """Issue rank of ``tile``: its ``set_priority`` position when
        ranked, else after every ranked tile, in index order."""
        if not self._rank:
            return tile
        return self._rank.get(tile, len(self._rank) + tile)

    def set_priority(self, order: Sequence[int]) -> None:
        """Lease tiles in ``order`` (first element first) ahead of any tile
        not listed; unlisted tiles keep their relative index order after
        the listed ones.  Re-heapifies the pending pool; done/leased tiles
        are unaffected."""
        self._rank = {int(t): i for i, t in enumerate(order)}
        if len(self._rank) != len(order):
            raise ValueError("set_priority order contains duplicate tiles")
        pending = {t for _, t in self._pending
                   if t not in self._done and t not in self._leases}
        self._pending = [(self._rank_of(t), t) for t in pending]
        heapq.heapify(self._pending)

    def next_tile(self, worker: WorkerId, now: float = 0.0) -> Optional[int]:
        """Lease the lowest-rank pending tile to ``worker`` (``None`` when
        no tile is pending — outstanding leases may still re-pend later)."""
        while self._pending:
            _, tile = heapq.heappop(self._pending)
            if (tile in self._done or tile in self._leases
                    or tile in self._parked):
                continue
            self._leases[tile] = Lease(tile, worker, now)
            return tile
        return None

    def complete(self, tile: int) -> bool:
        """Retire ``tile``; ``True`` only for the first completion.  A late
        delivery of a parked tile also completes it — a delivered reduction
        is proof the tile evaluated after all."""
        if not 0 <= tile < self.n_tiles:
            raise IndexError(f"tile {tile} outside [0, {self.n_tiles})")
        if tile in self._done:
            return False
        self._done.add(tile)
        self._leases.pop(tile, None)
        self._parked.discard(tile)
        return True

    def park(self, tile: int) -> bool:
        """Quarantine ``tile``: no longer issued by ``next_tile`` until
        ``unpark``.  Its lease (if any) is dropped.  Returns ``False`` for
        an already-done or already-parked tile."""
        if not 0 <= tile < self.n_tiles:
            raise IndexError(f"tile {tile} outside [0, {self.n_tiles})")
        if tile in self._done or tile in self._parked:
            return False
        self._leases.pop(tile, None)
        self._parked.add(tile)
        return True

    def unpark(self, tile: int) -> bool:
        """Return a parked tile to the pending pool (retry path)."""
        if tile not in self._parked:
            return False
        self._parked.discard(tile)
        heapq.heappush(self._pending, (self._rank_of(tile), tile))
        return True

    def revoke_worker(self, worker: WorkerId) -> List[int]:
        """Return all of ``worker``'s outstanding leases to the pending
        pool (the lost-worker path); returns the re-pended tiles."""
        tiles = sorted(t for t, l in self._leases.items() if l.worker == worker)
        for t in tiles:
            del self._leases[t]
            heapq.heappush(self._pending, (self._rank_of(t), t))
        return tiles

    @property
    def all_done(self) -> bool:
        """True once every tile has completed (leases outstanding or not)."""
        return len(self._done) == self.n_tiles

    @property
    def all_settled(self) -> bool:
        """True once every tile is either done or parked — the fabric loop's
        exit condition when poison tiles are quarantined."""
        return len(self._done) + len(self._parked) == self.n_tiles

    @property
    def parked_tiles(self) -> List[int]:
        """Sorted poison-quarantined tile indices."""
        return sorted(self._parked)

    @property
    def n_done(self) -> int:
        """Completed tile count."""
        return len(self._done)

    @property
    def done_tiles(self) -> List[int]:
        """Sorted completed tile indices."""
        return sorted(self._done)

    @property
    def leases(self) -> Dict[int, Lease]:
        """Snapshot copy of outstanding leases, keyed by tile."""
        return dict(self._leases)

    @property
    def n_pending(self) -> int:
        """Tiles neither done, leased nor parked."""
        return len([t for _, t in self._pending
                    if t not in self._done and t not in self._leases
                    and t not in self._parked])

    def contiguous_done_prefix(self) -> int:
        """First tile index NOT in the done set — the ``next_tile`` a plain
        single-process ``Campaign.from_checkpoint`` resume starts at."""
        while self._prefix in self._done:
            self._prefix += 1
        return self._prefix


def _tile_intervals(tiles: Sequence[int]) -> List[List[int]]:
    """Sorted tile indices -> half-open [lo, hi) interval list (compact
    checkpoint encoding of the done set)."""
    out: List[List[int]] = []
    for t in sorted(tiles):
        if out and t == out[-1][1]:
            out[-1][1] = t + 1
        else:
            out.append([t, t + 1])
    return out


def _expand_intervals(intervals: Sequence[Sequence[int]]) -> List[int]:
    """Inverse of ``_tile_intervals``."""
    return [t for lo, hi in intervals for t in range(lo, hi)]


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------

class FabricCoordinator:
    """The single owner of campaign state in a distributed run.

    Wraps a ``Campaign`` (whose frontiers/tile-stats/checkpoint it reuses
    unchanged) with a ``LeaseBoard`` and a ``HeartbeatMonitor``.  Workers
    interact through three verbs:

      * ``lease(worker)`` — claim the next pending tile (also a heartbeat);
      * ``deliver(worker, tile, reduction)`` — ship a ``TileReduction``;
        ALWAYS folded (at-least-once delivery — duplicates are exact
        no-ops), first delivery retires the tile and records its
        ``TileStat``;
      * ``worker_lost(worker)`` / ``expire()`` — revoke a dead worker's
        leases back to pending.

    Checkpoints keep the single-process schema (version 1) and add a
    ``"fabric"`` key (done-tile intervals, outstanding leases, parked
    tiles); ``next_tile`` is the contiguous done prefix, so a plain
    ``Campaign.from_checkpoint`` resume of a fabric checkpoint is correct.
    """

    def __init__(self, campaign: Campaign, lease_timeout_s: float = 300.0,
                 clock=time.monotonic, done_tiles: Sequence[int] = (),
                 poison_threshold: int = 3,
                 parked_tiles: Sequence[int] = ()):
        self.campaign = campaign
        prefix_done = range(campaign.next_tile)
        self.board = LeaseBoard(campaign.space.n_tiles(),
                                done=[*prefix_done, *done_tiles])
        self.monitor = HeartbeatMonitor([], timeout_s=lease_timeout_s,
                                        clock=clock)
        if poison_threshold < 1:
            raise ValueError("poison_threshold must be >= 1")
        self.poison_threshold = int(poison_threshold)
        # tile -> distinct workers that died while holding it; at
        # poison_threshold the tile is quarantined instead of re-issued
        self._tile_crashes: Dict[int, set] = {}
        self.stats = {"deliveries": 0, "duplicates": 0, "reissued_tiles": 0,
                      "lost_workers": [], "worker_crashes": [],
                      "worker_clean_exits": [], "poison_tiles": [],
                      "poison_retried": [], "recovery": None}
        # the coordinator shares the campaign's telemetry: one trace holds
        # the lease/deliver spans AND the evaluation spans
        self.telemetry = campaign.telemetry
        self._c_deliveries = self.telemetry.counter("fabric_deliveries_total")
        self._c_duplicates = self.telemetry.counter("fabric_duplicates_total")
        self._c_reissued = self.telemetry.counter(
            "fabric_reissued_tiles_total")
        self._c_lost = self.telemetry.counter("fabric_lost_workers_total")
        self._c_expiries = self.telemetry.counter(
            "fabric_lease_expiries_total")
        self._c_crashed = self.telemetry.counter("fabric_worker_crashed")
        self._c_clean = self.telemetry.counter("fabric_worker_done")
        self._c_poison = self.telemetry.counter("fabric_poison_tiles_total")
        for t in parked_tiles:
            if self.board.park(int(t)):
                self.stats["poison_tiles"].append(int(t))

    @classmethod
    def _resume(cls, campaign: Campaign, fabric_state: Dict,
                **coord_kwargs) -> Tuple["FabricCoordinator", List[int]]:
        """A coordinator over ``campaign`` with the done and parked tiles of
        a checkpoint's ``"fabric"`` key; leases recorded at checkpoint time
        are released (counted as ``reissued_tiles``) and returned."""
        coord = cls(campaign,
                    done_tiles=_expand_intervals(fabric_state.get("done", [])),
                    parked_tiles=fabric_state.get("parked", []),
                    **coord_kwargs)
        released = [t for t, _ in fabric_state.get("leases", [])]
        coord.stats["reissued_tiles"] += len(released)
        coord._c_reissued.inc(len(released))
        return coord, released

    @classmethod
    def from_checkpoint(cls, path: str, lease_timeout_s: float = 300.0,
                        clock=time.monotonic, poison_threshold: int = 3,
                        **campaign_kwargs) -> "FabricCoordinator":
        """Resume a distributed campaign from a (fabric or single-process)
        checkpoint of this package; out-of-prefix tiles recorded under the
        ``"fabric"`` key are marked done so they are not re-issued.  Leases
        recorded at checkpoint time are NOT restored — a coordinator
        restart implicitly revokes them, and the tiles simply re-pend
        (counted as ``reissued_tiles``).  Parked poison tiles stay parked.
        ``campaign_kwargs`` go to ``Campaign.from_state`` (``device=``,
        which a checkpoint does not store, ``telemetry=``, ...).

        The load path is the recovering one: a corrupt checkpoint is
        quarantined to ``*.corrupt`` and the newest valid generation is used
        instead; the write-ahead journal is cross-checked, and the full
        recovery report lands in ``stats["recovery"]``.
        """
        state, report = store.load_checkpoint_recovering(path)
        version = state.get("version")
        if version != 1:
            raise ValueError(f"unsupported campaign checkpoint version "
                             f"{version!r} in {path}")
        campaign = Campaign.from_state(state, source=path, **campaign_kwargs)
        coord, released = cls._resume(
            campaign, state.get("fabric") or {},
            lease_timeout_s=lease_timeout_s, clock=clock,
            poison_threshold=poison_threshold)
        records, torn = store.CheckpointJournal(path).records()
        coord.stats["recovery"] = {
            "path": report["path"],
            "quarantined": report["quarantined"],
            "fallback_generation": report["fallback_generation"],
            "journal_generation": (int(records[-1]["generation"])
                                   if records else None),
            "journal_torn_lines": torn,
            "released_leases": released,
            "tiles_done_at_restart": coord.board.n_done,
        }
        coord.telemetry.counter("fabric_coordinator_recoveries_total").inc()
        if report["quarantined"]:
            coord.telemetry.counter(
                "fabric_checkpoints_quarantined_total").inc(
                    len(report["quarantined"]))
        return coord

    @classmethod
    def from_reference(cls, state: Dict, chip_table: Optional[Dict] = None,
                       source: str = "<reference state>",
                       lease_timeout_s: float = 300.0, clock=time.monotonic,
                       poison_threshold: int = 3,
                       **campaign_kwargs) -> "FabricCoordinator":
        """Carry a distributed campaign of the reference package across:
        ``state`` is a reference ``FabricCoordinator.state_dict()`` (what a
        reference fabric checkpoint holds: the campaign state plus
        ``"fabric": {"done", "leases", "parked"}``).  The campaign goes
        through ``runner.state_from_reference`` (evaluator names mapped by
        ``REFERENCE_EVALUATORS``, the same refusals); the done tiles are not
        re-evaluated, recorded leases re-pend as on any restart.
        ``campaign_kwargs`` override config fields (``device=``)."""
        campaign = state_from_reference(state, chip_table=chip_table,
                                        source=source, **campaign_kwargs)
        coord, released = cls._resume(
            campaign, state.get("fabric") or {},
            lease_timeout_s=lease_timeout_s, clock=clock,
            poison_threshold=poison_threshold)
        coord.stats["recovery"] = {"path": source, "released_leases": released,
                                   "tiles_done_at_restart": coord.board.n_done}
        return coord

    # -- the three worker verbs --------------------------------------------

    def register_worker(self, worker: WorkerId) -> None:
        """Admit ``worker`` to heartbeat monitoring."""
        self.monitor.register(worker)

    def lease(self, worker: WorkerId) -> Optional[int]:
        """Claim the next pending tile for ``worker`` (beats its heart)."""
        with self.telemetry.span("lease", worker=worker):
            self.monitor.beat(worker)
            return self.board.next_tile(worker, now=self.monitor.clock())

    def deliver(self, worker: WorkerId, tile: int, reduction: TileReduction,
                busy_s: float = 0.0) -> bool:
        """Fold one delivered ``TileReduction``; returns ``True`` iff this
        was the tile's FIRST delivery (stats recorded), ``False`` for a
        duplicate (still folded — provably a no-op)."""
        with self.telemetry.span("deliver", worker=worker, tile=tile):
            if worker in self.monitor.last_seen:
                self.monitor.beat(worker)
            with self.telemetry.span("merge", tile=tile):
                self.campaign.merge_reduction(reduction, tile)
            self.stats["deliveries"] += 1
            self._c_deliveries.inc()
            self.telemetry.gauge("fabric_worker_busy_s",
                                 worker=worker).add(busy_s)
            newly_done = self.board.complete(tile)
            if newly_done:
                self.campaign.tile_stats.append(TileStat(
                    tile=tile,
                    candidates=(reduction.hi - reduction.lo)
                    * len(self.campaign.workloads),
                    wall_s=busy_s))
                self.campaign.next_tile = self.board.contiguous_done_prefix()
            else:
                self.stats["duplicates"] += 1
                self._c_duplicates.inc()
            return newly_done

    def worker_lost(self, worker: WorkerId,
                    crashed: bool = True) -> List[int]:
        """Declare ``worker`` dead: its leases re-pend for re-issue and it
        leaves heartbeat monitoring.  Late deliveries from it still fold.

        ``crashed=True`` (death by nonzero exit, chaos kill, or lease
        expiry) attributes the death to every tile the worker held: a tile
        that kills ``poison_threshold`` DISTINCT workers is quarantined
        (parked) instead of re-issued.  ``crashed=False`` is a clean
        protocol exit; it re-pends leases without attribution and increments
        ``fabric_worker_done`` instead of ``fabric_worker_crashed``.
        """
        held = [t for t, l in self.board.leases.items() if l.worker == worker]
        tiles = self.board.revoke_worker(worker)
        self.monitor.forget(worker)
        self.stats["reissued_tiles"] += len(tiles)
        self.stats["lost_workers"].append(worker)
        self._c_reissued.inc(len(tiles))
        self._c_lost.inc()
        if crashed:
            self.stats["worker_crashes"].append(worker)
            self._c_crashed.inc()
            for t in held:
                culprits = self._tile_crashes.setdefault(t, set())
                culprits.add(worker)
                if len(culprits) >= self.poison_threshold:
                    self.quarantine_tile(t)
        else:
            self.stats["worker_clean_exits"].append(worker)
            self._c_clean.inc()
        return tiles

    def quarantine_tile(self, tile: int) -> bool:
        """Park a poison tile: no re-issue to the fleet; it is retried once
        single-process at campaign end (``retry_parked``)."""
        if not self.board.park(tile):
            return False
        self.stats["poison_tiles"].append(tile)
        self._c_poison.inc()
        return True

    def retry_parked(self) -> List[int]:
        """Evaluate every parked tile once, single-process, in the
        coordinator — a poison quarantine ends as either a completed tile or
        a loud failure in THIS process.  Returns the tiles retried."""
        engine = self.campaign.engine
        space = self.campaign.space
        clock = self.telemetry.clock
        retried = []
        for tile in list(self.board.parked_tiles):
            lo, hi = tile_span(space, tile)
            t0 = clock()
            with self.telemetry.span("poison_retry", tile=tile):
                batch = space.slice(lo, hi, with_candidates=not engine.fused)
                reduction = engine.reduce_tile(batch, lo)
            self.board.unpark(tile)
            self.deliver("__poison_retry__", tile, reduction,
                         busy_s=clock() - t0)
            self.stats["poison_retried"].append(tile)
            retried.append(tile)
        return retried

    def expire(self) -> Dict[WorkerId, List[int]]:
        """Lease-timeout sweep: every worker silent for longer than
        ``timeout_s`` on the injected clock WHILE holding a lease is
        declared lost.  Idle workers owe the coordinator nothing, so silence
        alone never expels them."""
        leased = {lease.worker for lease in self.board.leases.values()}
        expired = {w: self.worker_lost(w)
                   for w in self.monitor.dead_hosts() if w in leased}
        if expired:
            self._c_expiries.inc(len(expired))
        return expired

    # -- state --------------------------------------------------------------

    @property
    def all_done(self) -> bool:
        """True once the lease board has every tile completed."""
        return self.board.all_done

    def state_dict(self) -> Dict:
        """Campaign schema version 1 plus a ``"fabric"`` key (done-tile
        intervals + outstanding leases + parked poison tiles)."""
        state = self.campaign.state_dict()
        state["fabric"] = {
            "done": _tile_intervals(self.board.done_tiles),
            "leases": [[l.tile, l.worker] for l in
                       sorted(self.board.leases.values(),
                              key=lambda l: l.tile)],
            "parked": self.board.parked_tiles,
        }
        return state

    def checkpoint(self, path: str) -> str:
        """Atomically persist ``state_dict`` to ``path``."""
        with self.telemetry.span("checkpoint_write",
                                 n_done=self.board.n_done):
            return store.save_checkpoint(self.state_dict(), path)

    def result(self, wall_s: float) -> CampaignResult:
        """The campaign result with the board's (possibly non-contiguous)
        completed-tile count."""
        return self.campaign._result(wall_s, tiles_done=self.board.n_done)


# ---------------------------------------------------------------------------
# fault injection (tests + the smoke script's gates)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """Scripted failures for identity testing.

    ``kill_worker`` crashes that worker mid-tile after it has completed
    ``kill_after_tiles`` tiles (evaluation started, reduction never ships);
    ``duplicate`` redelivers the first completed payload a second time;
    ``hang_worker`` (``LocalFabric`` + ``FakeClock`` only) takes its lease
    and never finishes, so only lease-timeout expiry can recover the tile;
    ``poison_tile`` kills EVERY worker that receives that tile — the
    coordinator's poison quarantine is the only way such a run completes.
    """

    kill_worker: Optional[int] = None
    kill_after_tiles: int = 1
    duplicate: bool = False
    hang_worker: Optional[int] = None
    poison_tile: Optional[int] = None


# ---------------------------------------------------------------------------
# in-process deterministic fabric (the identity-test harness)
# ---------------------------------------------------------------------------

class LocalFabric:
    """N simulated workers in one process, interleaved by a seeded RNG.

    All workers share the campaign's own ``TileEvaluator`` (evaluation is a
    pure function of config + span, so sharing changes nothing); what
    varies across seeds is WHICH worker completes next — the delivery order
    the coordinator observes.  Faults from ``FaultInjection`` are replayed
    exactly.  With a ``FakeClock`` the virtual clock advances 1.0 per loop
    iteration, making hang-expiry deterministic.
    """

    def __init__(self, campaign_or_coord: Union[Campaign, FabricCoordinator],
                 n_workers: int = 2, seed: int = 0,
                 lease_timeout_s: float = 1e9, clock=None,
                 fault: Optional[FaultInjection] = None,
                 poison_threshold: int = 3,
                 retry: Optional[RetryPolicy] = None):
        if isinstance(campaign_or_coord, FabricCoordinator):
            self.coord = campaign_or_coord
        else:
            self.coord = FabricCoordinator(
                campaign_or_coord, lease_timeout_s=lease_timeout_s,
                clock=clock if clock is not None else FakeClock(),
                poison_threshold=poison_threshold)
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = int(n_workers)
        self.seed = int(seed)
        self.fault = fault or FaultInjection()
        self.retry = retry or RetryPolicy()
        if (self.fault.hang_worker is not None
                and not hasattr(self.coord.monitor.clock, "advance")):
            raise ValueError("hang_worker injection needs a FakeClock — a "
                             "real clock would spin until wall-clock expiry")
        if (self.fault.poison_tile is not None
                and not hasattr(self.coord.monitor.clock, "advance")):
            raise ValueError("poison_tile injection needs a FakeClock — "
                             "respawn backoff is paced on the virtual clock")

    def run(self, max_completions: Optional[int] = None,
            checkpoint_path: Optional[str] = None) -> CampaignResult:
        """Drive the fabric to completion (or ``max_completions`` tile
        completions, the distributed-interrupt point for resume tests)."""
        coord, fault = self.coord, self.fault
        campaign = coord.campaign
        engine = campaign.engine
        space = campaign.space
        tel = campaign.telemetry
        clock = tel.clock
        rng = np.random.default_rng(self.seed)
        t_start = clock()

        alive = list(range(self.n_workers))
        for w in alive:
            coord.register_worker(w)
        holding: Dict[int, int] = {}
        completed = {w: 0 for w in alive}
        kill_pending = fault.kill_worker is not None
        duplicate_pending = fault.duplicate
        n_completions = 0
        mclock = coord.monitor.clock  # the virtual clock (FakeClock in tests)
        respawns: List[Tuple[float, int]] = []  # (due time, new worker id)
        next_wid = self.n_workers
        n_respawned = 0

        def issue_leases():
            for w in alive:
                if w not in holding:
                    tile = coord.lease(w)
                    if tile is not None:
                        holding[w] = tile

        issue_leases()
        while not coord.all_done:
            if max_completions is not None and n_completions >= max_completions:
                break
            if coord.board.all_settled and not respawns:
                break  # only parked poison tiles remain: retried below
            active = [w for w in holding if w != fault.hang_worker]
            if active:
                w = active[int(rng.integers(len(active)))]
                tile = holding.pop(w)
                if tile == fault.poison_tile:
                    # poison: whoever touches the tile dies mid-evaluation;
                    # a replacement spawns after the RetryPolicy backoff on
                    # the virtual clock (attribution eventually parks it)
                    alive.remove(w)
                    coord.worker_lost(w, crashed=True)
                    respawns.append(
                        (mclock() + self.retry.backoff_s(n_respawned),
                         next_wid))
                    n_respawned += 1
                    next_wid += 1
                elif (kill_pending and w == fault.kill_worker
                        and completed[w] >= fault.kill_after_tiles):
                    # dies mid-tile: evaluation started, nothing delivered
                    kill_pending = False
                    alive.remove(w)
                    coord.worker_lost(w)
                else:
                    lo, hi = tile_span(space, tile)
                    t0 = clock()
                    with tel.span("tile_eval", tile=tile, worker=w):
                        with tel.span("tile_slice", tile=tile):
                            batch = space.slice(
                                lo, hi, with_candidates=not engine.fused)
                        tr = engine.reduce_tile(batch, lo)
                    busy = clock() - t0
                    coord.deliver(w, tile, tr, busy_s=busy)
                    if duplicate_pending:
                        duplicate_pending = False
                        coord.deliver(w, tile, tr, busy_s=0.0)
                    completed[w] += 1
                    n_completions += 1
                    if checkpoint_path:
                        coord.checkpoint(checkpoint_path)
            if hasattr(coord.monitor.clock, "advance"):
                coord.monitor.clock.advance(1.0)
            for w in coord.expire():
                if w in alive:
                    alive.remove(w)
                holding.pop(w, None)
            for due, nw in [r for r in respawns if mclock() >= r[0]]:
                respawns.remove((due, nw))
                coord.register_worker(nw)
                alive.append(nw)
                completed[nw] = 0
            issue_leases()
            if not coord.all_done and not alive and not respawns:
                raise RuntimeError(
                    f"fabric stalled: all workers lost with "
                    f"{coord.board.n_pending} tiles pending")
        if coord.board.parked_tiles and max_completions is None:
            coord.retry_parked()
        if checkpoint_path:
            coord.checkpoint(checkpoint_path)
        return coord.result(clock() - t_start)


# ---------------------------------------------------------------------------
# multiprocess fabric (real workers, spawn)
# ---------------------------------------------------------------------------

def _worker_main(worker_id: int, cfg: Dict, worker_cfg: Dict,
                 task_q, result_q) -> None:
    """Fabric worker loop (runs in a ``spawn`` child).

    Protocol (all messages are 5-tuples ``(kind, wid, tile, payload,
    busy_s)``): emits ``("ready", ...)`` once warm, then for each leased
    tile received on ``task_q`` evaluates it and emits ``("result", wid,
    tile, TileReduction, busy_s)``; ``None`` on ``task_q`` is shutdown,
    answered with a terminal ``("metrics", wid, None, snapshot, 0.0)``
    carrying the worker's own telemetry snapshot: ``worker_busy_s_total``,
    ``worker_tiles_total``, the evaluator's counters, and
    ``kernel_launches_total{kernel=...}`` — this process's kernel launches
    (``kernels.dse_sweep.LAUNCHES``) since it started, warm-up included.
    ``busy_s`` is ``time.process_time`` of the tile: on the card that
    includes the CPU the host spends spinning in the synchronise.

    The fused evaluator warms up on tile 0's shape before signalling ready:
    that first launch creates this process's CUDA context and loads the
    kernel library, so per-tile busy excludes one-time costs.  Every
    ``TileReduction`` shipped holds arrays of its own (``reduce_tile``
    copies out of the engine's reused result buffer), so the queue's feeder
    thread, which pickles after ``put`` returns, cannot ship a later tile's
    numbers.
    """
    try:
        launches0 = k1.launch_counts()
        evaluator = evaluator_from_config(cfg)
        tel = evaluator.telemetry
        c_busy = tel.counter("worker_busy_s_total")
        c_tiles = tel.counter("worker_tiles_total")
        space = evaluator.space
        if evaluator.fused:
            lo, hi = tile_span(space, 0)
            evaluator.reduce_tile(space.slice(lo, hi, with_candidates=False),
                                  lo)
        result_q.put(("ready", worker_id, None, None, 0.0))
        die_on_nth = (worker_cfg or {}).get("die_on_nth_tile")
        die_on_tile = (worker_cfg or {}).get("die_on_tile")
        n_received = 0
        while True:
            tile = task_q.get()
            if tile is None:
                for name, n in k1.launch_counts().items():
                    if n > launches0[name]:
                        tel.counter("kernel_launches_total",
                                    kernel=name).inc(n - launches0[name])
                result_q.put(("metrics", worker_id, None, tel.snapshot(),
                              0.0))
                return
            n_received += 1
            t0 = time.process_time()
            lo, hi = tile_span(space, tile)
            with tel.span("tile_eval", tile=tile, worker=worker_id):
                with tel.span("tile_slice", tile=tile):
                    batch = space.slice(lo, hi,
                                        with_candidates=not evaluator.fused)
                if die_on_nth is not None and n_received >= die_on_nth:
                    # Flush and retire the queue's feeder thread before
                    # dying: ``os._exit`` while the feeder holds the shared
                    # ``result_q`` write lock would wedge every surviving
                    # worker's puts — the fabric stalls.
                    result_q.close()
                    result_q.join_thread()
                    os._exit(40)  # injected crash mid-tile: no result ships
                if die_on_tile is not None and tile == die_on_tile:
                    result_q.close()      # poison tile: every worker that
                    result_q.join_thread()  # receives it dies the same way
                    os._exit(41)
                reduction = evaluator.reduce_tile(batch, lo)
            busy = time.process_time() - t0
            c_busy.inc(busy)
            c_tiles.inc()
            result_q.put(("result", worker_id, tile, reduction, busy))
    except BaseException as exc:  # surface config/eval errors, then die
        result_q.put(("error", worker_id, None, repr(exc), 0.0))
        result_q.close()          # guarantee the error ships and the shared
        result_q.join_thread()    # write lock is released before exiting
        os._exit(1)


def _stop_workers(procs: Dict[int, "mp.Process"], task_qs: Dict[int, object],
                  result_q, retry: RetryPolicy) -> Dict[int, Dict]:
    """Shut a fleet down: ask every live worker to stop, read the terminal
    metrics snapshots while the workers exit (a worker whose queue feeder
    still holds data cannot exit before it is read), then join, terminating
    a worker that does not exit in ``retry.join_timeout_s``.  Returns the
    snapshots by worker (a crashed worker ships none)."""
    metrics: Dict[int, Dict] = {}

    def read(timeout: float) -> bool:
        try:
            kind, w, _, payload, _ = result_q.get(timeout=timeout)
        except queue_mod.Empty:
            return False
        if kind == "metrics":
            metrics[w] = payload
        return True

    for w, p in procs.items():
        if p.is_alive():
            try:
                task_qs[w].put(None)
            except (OSError, ValueError):
                pass
    deadline = time.monotonic() + retry.join_timeout_s
    while (any(p.is_alive() for p in procs.values())
           and time.monotonic() < deadline):
        read(retry.poll_s)
    for p in procs.values():
        p.join(timeout=retry.join_timeout_s)
        if p.is_alive():
            p.terminate()
            p.join(timeout=retry.join_timeout_s)
    while read(retry.drain_timeout_s):
        pass
    return metrics


def worker_launches(worker_metrics: Dict[WorkerId, Dict]) -> Dict[str, int]:
    """Kernel launches summed over the workers' terminal snapshots (keyed
    like ``kernels.dse_sweep.LAUNCHES``; a crashed worker ships none)."""
    out = {name: 0 for name in k1.LAUNCHES}
    for snap in worker_metrics.values():
        for name in out:
            out[name] += int(metric_value(snap, "kernel_launches_total",
                                          default=0, kernel=name))
    return out


class MultiprocessFabric:
    """Coordinator + N real ``spawn`` worker processes on one machine.

    The coordinator thread never evaluates: it leases tiles, folds
    delivered ``TileReduction`` payloads, detects death two ways — process
    exit (``Process.is_alive``, immediate) and lease timeout
    (``HeartbeatMonitor``, catches hangs) — and re-issues revoked tiles to
    surviving workers.  ``run`` returns the standard ``CampaignResult``;
    ``self.stats`` additionally carries the per-worker busy-CPU ledger
    (``worker_busy_s``), the seconds from the first spawn until every
    worker was ready or lost (``spawn_to_ready_s``: imports, CUDA context,
    kernel load, warm-up), the measurement window (``window_s``, from
    all-workers-ready to the last fold, the fleet's shutdown excluded), the
    shutdown itself (``shutdown_s``: stop messages, terminal snapshots,
    process exits and joins) and each worker's terminal metrics snapshot
    (``worker_metrics``).
    """

    def __init__(self, campaign: Campaign, n_workers: int = 2,
                 lease_timeout_s: float = 300.0,
                 fault: Optional[FaultInjection] = None,
                 checkpoint_every: int = 8,
                 retry: Optional[RetryPolicy] = None,
                 max_respawns: int = 0, poison_threshold: int = 3):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.campaign = campaign
        self.n_workers = int(n_workers)
        self.lease_timeout_s = float(lease_timeout_s)
        self.fault = fault or FaultInjection()
        if self.fault.hang_worker is not None:
            raise ValueError("hang_worker is a LocalFabric-only injection; "
                             "multiprocess hangs are recovered by the lease "
                             "timeout in real time")
        self.checkpoint_every = max(int(checkpoint_every), 1)
        # one RetryPolicy carries every time constant of the run: respawn
        # backoff schedule plus the transport poll/join/drain timeouts
        self.retry = retry or RetryPolicy()
        self.max_respawns = int(max_respawns)
        self.poison_threshold = int(poison_threshold)
        self.stats: Dict = {}

    def run(self, checkpoint_path: Optional[str] = None) -> CampaignResult:
        """Run the campaign to completion across the worker fleet.

        Leases are issued only after every worker is ready (or declared
        lost), so tile distribution is fair regardless of per-worker warm-up
        time.  Lost workers' tiles re-issue to survivors.  Raises if the
        whole fleet dies, or if a worker reports an error.  The returned
        frontier is bitwise-identical to the single-process run.
        """
        cfg = campaign_config(self.campaign)
        clock = self.campaign.telemetry.clock
        # the coordinator's lease clock IS the telemetry clock: one injected
        # time source for the whole run
        coord = FabricCoordinator(self.campaign,
                                  lease_timeout_s=self.lease_timeout_s,
                                  clock=clock,
                                  poison_threshold=self.poison_threshold)
        ctx = mp.get_context("spawn")  # a CUDA parent cannot fork
        result_q = ctx.Queue()
        procs: Dict[int, mp.Process] = {}
        task_qs: Dict[int, object] = {}
        busy_s: Dict[int, float] = {}
        worker_metrics: Dict[int, Dict] = {}
        idle: List[int] = []
        ready: set = set()
        lost: set = set()
        duplicate_pending = self.fault.duplicate
        window_t0: Optional[float] = None
        # worker respawn: (due time on the injected clock, new worker id)
        pending_respawns: List[Tuple[float, int]] = []
        n_respawned = 0
        next_wid = self.n_workers

        def spawn_worker(w: int):
            worker_cfg = {}
            if self.fault.kill_worker == w:
                worker_cfg["die_on_nth_tile"] = self.fault.kill_after_tiles + 1
            if self.fault.poison_tile is not None:
                worker_cfg["die_on_tile"] = self.fault.poison_tile
            task_qs[w] = ctx.Queue()
            p = ctx.Process(target=_worker_main,
                            args=(w, cfg, worker_cfg, task_qs[w], result_q),
                            daemon=True)
            p.start()
            procs[w] = p
            busy_s[w] = 0.0

        t_spawn = clock()
        for w in range(self.n_workers):
            spawn_worker(w)

        def issue_leases():
            # hold the first lease until every worker is warm (or lost):
            # issuing early would let the first-ready worker drain the board
            # before its peers even finish warming up
            if len(ready | lost) < self.n_workers:
                return
            while idle:
                w = idle[0]
                tile = coord.lease(w)
                if tile is None:
                    return
                idle.pop(0)
                task_qs[w].put(tile)

        def mark_lost(w: int, crashed: bool = True):
            nonlocal window_t0, n_respawned, next_wid
            lost.add(w)
            if w in idle:
                idle.remove(w)
            coord.worker_lost(w, crashed=crashed)
            if window_t0 is None and len(ready | lost) >= self.n_workers:
                window_t0 = clock()  # peer died during warm-up
            if crashed and n_respawned < self.max_respawns:
                pending_respawns.append(
                    (clock() + self.retry.backoff_s(n_respawned), next_wid))
                n_respawned += 1
                next_wid += 1

        try:
            while not coord.all_done:
                if coord.board.all_settled and not pending_respawns:
                    break  # only parked poison tiles remain: retried below
                try:
                    kind, w, tile, payload, t = result_q.get(
                        timeout=self.retry.poll_s)
                except queue_mod.Empty:
                    kind = None
                if kind == "ready":
                    coord.register_worker(w)
                    idle.append(w)
                    ready.add(w)
                    if len(ready | lost) >= self.n_workers:
                        if window_t0 is None:
                            window_t0 = clock()
                        issue_leases()
                elif kind == "metrics":
                    worker_metrics[w] = payload
                elif kind == "result":
                    busy_s[w] += t
                    newly = coord.deliver(w, tile, payload, busy_s=t)
                    if duplicate_pending and newly:
                        duplicate_pending = False
                        coord.deliver(w, tile, payload, busy_s=0.0)
                    if w not in lost:
                        idle.append(w)
                    if (checkpoint_path and newly and
                            coord.board.n_done % self.checkpoint_every == 0):
                        coord.checkpoint(checkpoint_path)
                elif kind == "error":
                    raise RuntimeError(f"fabric worker {w} failed: {payload}")
                for w2, p in procs.items():
                    if w2 not in lost and not p.is_alive():
                        # the exit code tells crash (nonzero: chaos kill,
                        # poison tile, hard fault) from clean protocol exit
                        mark_lost(w2, crashed=(p.exitcode is None
                                               or p.exitcode != 0))
                for w2 in coord.expire():
                    if w2 not in lost:
                        mark_lost(w2)
                for due, nw in [r for r in pending_respawns
                                if clock() >= r[0]]:
                    pending_respawns.remove((due, nw))
                    spawn_worker(nw)
                    self.campaign.telemetry.counter(
                        "fabric_worker_respawns_total").inc()
                issue_leases()
                if (not coord.all_done and not coord.board.all_settled
                        and len(lost) == len(procs) and not pending_respawns):
                    raise RuntimeError(
                        f"fabric stalled: all {len(procs)} workers lost with "
                        f"{coord.board.n_pending} tiles pending")
        finally:
            t_down = clock()
            worker_metrics.update(
                _stop_workers(procs, task_qs, result_q, self.retry))
            # shutdown exit-code audit: workers that were never declared
            # lost mid-run still report how they ended — 0 is a clean
            # protocol exit (fabric_worker_done), anything else (including
            # a terminate() after a wedged join) counts as a crash
            for w, p in procs.items():
                if w in lost or p.exitcode is None:
                    continue
                if p.exitcode == 0:
                    coord.stats["worker_clean_exits"].append(w)
                    coord._c_clean.inc()
                else:
                    coord.stats["worker_crashes"].append(w)
                    coord._c_crashed.inc()
            shutdown_s = clock() - t_down
        if coord.board.parked_tiles:
            # poison tiles: one single-process retry in THIS process — a
            # genuinely broken tile now raises here with a real traceback
            coord.retry_parked()
        window_s = (clock() - window_t0 - shutdown_s
                    if window_t0 is not None else 0.0)
        if checkpoint_path:
            coord.checkpoint(checkpoint_path)
        # prefer the busy total the worker measured itself (shipped in its
        # metrics snapshot) over the coordinator-side per-result sum; the
        # per-result sum stays the fallback for crashed workers
        busy_final = {
            w: metric_value(worker_metrics[w], "worker_busy_s_total",
                            default=busy_s[w])
            if w in worker_metrics else busy_s[w]
            for w in busy_s}
        self.stats = {
            **coord.stats,
            "n_workers": self.n_workers,
            "worker_busy_s": busy_final,
            "max_worker_busy_s": (max(busy_final.values())
                                  if busy_final else 0.0),
            "total_busy_s": sum(busy_final.values()),
            "spawn_to_ready_s": (window_t0 - t_spawn
                                 if window_t0 is not None else None),
            "window_s": window_s,
            "shutdown_s": shutdown_s,
            "worker_metrics": worker_metrics,
        }
        return coord.result(window_s)


def run_distributed(workloads_or_campaign, config: CampaignConfig = None,
                    fault: Optional[FaultInjection] = None,
                    retry: Optional[RetryPolicy] = None,
                    max_respawns: int = 0, poison_threshold: int = 3
                    ) -> Tuple[CampaignResult, Dict]:
    """One-call distributed sweep; returns ``(CampaignResult, fabric stats)``.

    ``run_distributed(workloads, config)``: the ``CampaignConfig`` supplies
    the space, evaluator, device and dtype AND the fabric options
    (``n_workers``, ``lease_timeout_s``, ``checkpoint_path``).  Passing an
    already-built ``Campaign`` also works; its own ``campaign.config``
    drives the fabric.  The result's frontiers are bitwise-identical to
    ``Campaign.run`` single-process on the same config.
    """
    if isinstance(workloads_or_campaign, Campaign):
        if config is not None:
            raise TypeError("run_distributed: pass either a Campaign (which "
                            "carries its config) or (workloads, config), "
                            "not both")
        campaign = workloads_or_campaign
    else:
        if not isinstance(config, CampaignConfig):
            raise TypeError("run_distributed(workloads, config) needs a "
                            "CampaignConfig")
        campaign = Campaign(workloads_or_campaign, config)
    cfg = campaign.config
    fabric = MultiprocessFabric(campaign, n_workers=cfg.n_workers,
                                lease_timeout_s=cfg.lease_timeout_s,
                                fault=fault, retry=retry,
                                max_respawns=max_respawns,
                                poison_threshold=poison_threshold)
    result = fabric.run(checkpoint_path=cfg.checkpoint_path)
    return result, fabric.stats
