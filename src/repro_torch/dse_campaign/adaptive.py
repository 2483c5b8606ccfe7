"""Surrogate-guided adaptive campaigns: learned search, not just faster sweep.

Counterpart of ``repro.dse_campaign.adaptive`` (its single-process part).
``Campaign`` evaluates every candidate of a ``SpaceSpec`` exactly, so cost
grows linearly with space size.  ``AdaptiveCampaign`` spends an evaluation
budget (default 10% of the space) where the frontier actually moves:

  1. **seed** — evaluate an evenly-spaced slice of tiles exactly (the same
     ``TileEvaluator`` path the exact sweep uses: on ``"cuda"`` the fused
     tile kernel, plus one launch of the sweep kernel alone for the tile's
     training rows) and fit per-workload energy/latency random forests
     (``core/predictors.py``) on a seeded subsample of the evaluated rows;
  2. **acquire** — score every *unevaluated* tile with batched forest
     inference on the config's device (``dse.surrogate_features``) and rank
     tiles by expected hypervolume gain: each candidate's LCB-optimistic
     prediction ``exp(mu - explore_weight * sigma)`` is scored with
     ``frontier.hypervolume_gain_2d`` against the current frontier
     staircase and the campaign's pinned acquisition reference point,
     after an analytic feasibility screen (predicted slice power is
     exactly ``energy/latency``, HBM fit is exact arithmetic on the
     feature columns).  Forest spread doubles as the exploration term —
     inside the LCB and as the ranking tie-break (sole signal while no
     predicted point lands inside the reference box);
  3. **evaluate + retrain** — evaluate only the top-ranked tiles exactly,
     fold them into the ``StreamingFrontier`` exactly like the sweep
     would, warm-start-refit the forests (``partial_fit``), and repeat
     until the frontier hypervolume plateaus or the budget is spent.

Only exactly-evaluated points ever merge, so the adaptive frontier is by
construction a subset of the exactly-evaluated candidates — a predicted
value can steer the search but never land on the frontier.  With
``budget_fraction >= 1`` the loop degenerates to the exact sweep (same
``reduce_tile`` + ``merge_reduced`` fold over every tile in index order),
bitwise.

Determinism is the load-bearing property:

* training rows are a pure function of config x tile span (seeded
  subsample attached to each ``TileReduction``), and each round's rows are
  concatenated in sorted-tile order before the single ``partial_fit`` call
  per model;
* the acquisition reference point is pinned per workload as the maximum
  feasible (energy, latency) over a whole round's reductions, and is
  explicitly serialized in checkpoints so a resumed campaign computes the
  same acquisition scores as an uninterrupted one;
* forests are rebuilt slot-seeded (``default_rng((seed, call, slot))``) on
  the host, and their statistics (``predict_log_stats``) are numpy's bits
  on any device — so the card and the host rank, select and stop alike,
  and replaying the recorded rounds reproduces the surrogate state
  bitwise, which is exactly how ``from_checkpoint`` restores it.

The distributed path (``run_adaptive_distributed``) keeps one coordinator
(selection, fitting, folding) and farms tile evaluation to a persistent
pool of fabric worker processes (``fabric._worker_main``: each its own
CUDA context on the config's device); each round's tiles are leased in
acquisition order through a ``LeaseBoard`` priority ranking.  Worker loss
re-pends the tile; duplicate deliveries are no-ops — the result is
bitwise-identical to the single-process adaptive run.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as queue_mod
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dse
from repro_torch.core.predictors import RandomForestRegressor
from repro_torch.dse_campaign import store
from repro_torch.dse_campaign.config import AdaptiveConfig, CampaignConfig
from repro_torch.dse_campaign.fabric import (FaultInjection, LeaseBoard,
                                             _stop_workers, _worker_main,
                                             campaign_config)
from repro_torch.dse_campaign.frontier import (hypervolume_2d,
                                               hypervolume_gain_2d)
from repro_torch.dse_campaign.runner import (Campaign, CampaignResult,
                                             TileReduction, TileStat,
                                             WorkloadKey)
from repro_torch.dse_campaign.space import tile_span
from repro_torch.runtime.fault_tolerance import RetryPolicy
from repro_torch.telemetry import coerce_telemetry

# feature-column positions the analytic feasibility screen reads
_F_N_CHIPS = dse.SURROGATE_FEATURES.index("n_chips")
_F_HBM_BYTES = dse.SURROGATE_FEATURES.index("hbm_bytes")

# one (tile, reduction, busy_s) delivery of an evaluated tile
RoundDelivery = Tuple[int, TileReduction, float]


@dataclasses.dataclass
class AdaptiveResult:
    """Outcome of an adaptive campaign.

    ``result`` is the standard ``CampaignResult`` view (frontiers,
    trajectories, tile stats) over the tiles that were actually evaluated;
    the adaptive fields say how the budget was spent: ``rounds`` (tile
    indices per round, acquisition order), ``hv_history`` (total frontier
    hypervolume against the pinned acquisition refs after each round),
    ``stopped_on`` (``"plateau"`` / ``"budget"`` / ``"exhausted"``, or
    ``"max_rounds"`` when interrupted), and ``fraction_evaluated`` — the
    headline gate quantity: unique candidates evaluated over space size.
    """

    result: CampaignResult
    rounds: List[List[int]]
    hv_history: List[float]
    stopped_on: str
    tiles_evaluated: int
    n_tiles: int
    candidates_evaluated: int       # unique candidates (tile spans, no dups)
    space_size: int

    @property
    def frontiers(self):
        return self.result.frontiers

    @property
    def fraction_evaluated(self) -> float:
        """Unique candidates evaluated / space size (the <=10% gate)."""
        return self.candidates_evaluated / max(self.space_size, 1)


class AdaptiveCampaign:
    """Active-learning campaign over one ``CampaignConfig`` (which must
    carry an ``AdaptiveConfig`` in ``config.adaptive``).

    Owns an internal ``Campaign`` for everything the exact sweep already
    does right — frontiers, reduction folding, checkpoint schema — and
    adds the surrogate state (per-workload energy/latency forests), the
    acquisition loop and the adaptive checkpoint extension (an
    ``"adaptive"`` key the plain campaign schema ignores).

    The public surface mirrors ``Campaign``: construct, ``run()``
    (optionally ``max_rounds`` as an interruption point), or
    ``from_checkpoint`` to resume — a resumed run selects, evaluates and
    stops exactly like the uninterrupted one.
    """

    def __init__(self, workloads: Sequence[dse.Workload],
                 config: CampaignConfig, telemetry=None,
                 _campaign: Optional[Campaign] = None):
        if config.adaptive is None:
            raise ValueError(
                "AdaptiveCampaign needs config.adaptive (an AdaptiveConfig); "
                "for an exact sweep use Campaign")
        self.telemetry = coerce_telemetry(telemetry)
        self._campaign = _campaign if _campaign is not None else Campaign(
            workloads, config, telemetry=self.telemetry)
        if _campaign is not None:
            self.telemetry = self._campaign.telemetry
        self.engine = self._campaign.engine
        self.acfg: AdaptiveConfig = config.adaptive
        self.space = self.engine.space
        # surrogate state: two forests per workload, created unfitted
        self.models: Dict[WorkloadKey, Dict[str, RandomForestRegressor]] = {
            key: {"energy": self._make_forest(), "latency": self._make_forest()}
            for key in self.engine.workload_keys}
        self.rounds: List[List[int]] = []
        self.acq_refs: Dict[WorkloadKey, Optional[Tuple[float, float]]] = {
            key: None for key in self.engine.workload_keys}
        self.hv_history: List[float] = []
        self.plateau = 0
        self.stopped_on: Optional[str] = None
        self._done: set = set()
        tel = self.telemetry
        self._c_rounds = tel.counter("adaptive_rounds_total")
        self._c_evaluated = tel.counter("adaptive_tiles_evaluated_total")
        self._c_skipped = tel.counter("adaptive_tiles_skipped_total")
        self._c_refits = tel.counter("adaptive_refits_total")

    # -- views --------------------------------------------------------------

    @property
    def config(self) -> CampaignConfig:
        return self._campaign.config

    @property
    def workloads(self) -> List[dse.Workload]:
        return self._campaign.workloads

    @property
    def frontiers(self):
        return self._campaign.frontiers

    def _make_forest(self) -> RandomForestRegressor:
        a = self.acfg
        return RandomForestRegressor(
            n_trees=a.n_trees, max_depth=a.max_depth, min_leaf=a.min_leaf,
            refresh_trees=a.refresh_trees, log_target=True,
            device=self.config.device)

    def _model_seed(self, wi: int, target: str) -> int:
        """Stable per-(workload, target) bootstrap seed — distinct models
        must not share tree draws."""
        return self.acfg.seed * 1_000_003 + wi * 2 + (target == "latency")

    # -- tile evaluation ----------------------------------------------------

    def _evaluate_round(self, tiles: List[int]) -> List[RoundDelivery]:
        """Evaluate ``tiles`` in the given (acquisition) order on the
        campaign's own ``TileEvaluator`` — the round hook: the distributed
        runner assigns its worker pool's ``evaluate_round`` here."""
        clock = self.telemetry.clock
        out: List[RoundDelivery] = []
        for t in tiles:
            lo, hi = tile_span(self.space, t)
            t0 = clock()
            with self.telemetry.span("tile_eval", tile=t):
                batch = self.space.slice(
                    lo, hi, with_candidates=not self.engine.fused)
                tr = self.engine.reduce_tile(batch, lo)
            out.append((t, tr, clock() - t0))
        return out

    # -- folding + training -------------------------------------------------

    def _fold_round(self, tiles: List[int],
                    deliveries: List[RoundDelivery],
                    fit: bool = True) -> None:
        """Merge a completed round into the campaign state: frontiers, tile
        stats, the done set, acquisition refs and the surrogates.  Runs at
        the round barrier, after which every derived quantity (frontier
        set, refs, forests) is independent of delivery order."""
        w = len(self.workloads)
        reductions: Dict[int, TileReduction] = {}
        for tile, tr, busy in deliveries:
            first = tile not in reductions
            reductions[tile] = tr
            self._campaign.merge_reduction(tr, tile)       # dup = exact no-op
            if first:
                self._campaign.tile_stats.append(TileStat(
                    tile=tile, candidates=(tr.hi - tr.lo) * w, wall_s=busy))
        self._done.update(reductions)
        self._c_evaluated.inc(len(reductions))
        self._campaign.next_tile = self._contiguous_prefix()
        self.rounds.append([int(t) for t in tiles])
        self._pin_refs(reductions)
        if fit:
            with self.telemetry.span("refit", rows=sum(
                    r.sample_lidx.size for r in reductions.values())):
                self._fit_round(reductions)
        self._track_hypervolume()
        self._c_rounds.inc()

    def _contiguous_prefix(self) -> int:
        p = 0
        while p in self._done:
            p += 1
        return p

    def _pin_refs(self, reductions: Dict[int, TileReduction]) -> None:
        """Pin each workload's acquisition reference point at the first
        round that saw feasible points: the maximum feasible
        (energy, latency) across the WHOLE round — a barrier maximum, so
        the refs cannot depend on merge/delivery order."""
        for wi, key in enumerate(self.engine.workload_keys):
            if self.acq_refs[key] is not None:
                continue
            es = [tr.ref_energy_j[wi] for tr in reductions.values()
                  if tr.ref_energy_j[wi] is not None]
            ls = [tr.ref_latency_s[wi] for tr in reductions.values()
                  if tr.ref_latency_s[wi] is not None]
            if es:
                self.acq_refs[key] = (float(max(es)), float(max(ls)))

    def _fit_round(self, reductions: Dict[int, TileReduction]) -> None:
        """ONE ``partial_fit`` per model on the round's training rows,
        concatenated in sorted-tile order — the canonical order that makes
        the forests a pure function of WHICH tiles ran, never of how their
        results arrived."""
        tiles = sorted(reductions)
        x_parts: List[np.ndarray] = []
        for t in tiles:
            tr = reductions[t]
            lo, hi = tile_span(self.space, t)
            feats = dse.surrogate_features(
                self.space.slice(lo, hi, with_candidates=False))
            x_parts.append(feats[tr.sample_lidx])
        X = np.concatenate(x_parts)
        for wi, key in enumerate(self.engine.workload_keys):
            y_e = np.concatenate(
                [reductions[t].sample_energy[wi] for t in tiles])
            y_l = np.concatenate(
                [reductions[t].sample_latency[wi] for t in tiles])
            self.models[key]["energy"].partial_fit(
                X, y_e, seed=self._model_seed(wi, "energy"))
            self.models[key]["latency"].partial_fit(
                X, y_l, seed=self._model_seed(wi, "latency"))
            self._c_refits.inc(2)

    def _track_hypervolume(self) -> None:
        """Total frontier hypervolume against the pinned acquisition refs
        (0 until a ref pins); drives the plateau stop."""
        hv = 0.0
        for key, refs in self.acq_refs.items():
            if refs is None:
                continue
            fr = self.frontiers[key]
            hv += hypervolume_2d(fr.energy_j, fr.latency_s, *refs)
        if self.hv_history:
            prev = self.hv_history[-1]
            rel = ((hv - prev) / abs(prev)) if prev > 0 else (
                1.0 if hv > 0 else 0.0)
            self.plateau = self.plateau + 1 if rel < self.acfg.plateau_tol \
                else 0
        self.hv_history.append(hv)

    # -- acquisition --------------------------------------------------------

    def _rank_pending(self, pending: List[int]) -> List[int]:
        """Pending tiles ranked best-first by expected hypervolume gain
        (max over the tile's candidates, summed across workload frontiers),
        tie-broken by mean forest spread (exploration) then tile index.
        The feature matrix crosses to the forests' device once a round."""
        sizes = []
        x_parts = []
        for t in pending:
            lo, hi = tile_span(self.space, t)
            feats = dse.surrogate_features(
                self.space.slice(lo, hi, with_candidates=False))
            x_parts.append(feats)
            sizes.append(hi - lo)
        X = np.concatenate(x_parts)
        X_dev = torch.from_numpy(X).to(self.config.device)
        n = X.shape[0]
        beta = self.acfg.explore_weight
        cons = self.engine.constraint
        gain = np.zeros(n, np.float64)
        spread = np.zeros(n, np.float64)
        for wi, key in enumerate(self.engine.workload_keys):
            wl = self.workloads[wi]
            e_mu, e_sd = self.models[key]["energy"].predict_log_stats(X_dev)
            l_mu, l_sd = self.models[key]["latency"].predict_log_stats(X_dev)
            spread += e_sd + l_sd
            refs = self.acq_refs[key]
            if refs is None:
                continue
            # analytic feasibility screen on LCB-lenient predictions:
            # slice power is exactly energy/latency, HBM fit is exact
            # arithmetic on the feature columns
            feas = np.ones(n, bool)
            if cons.max_power_w is not None:
                feas &= ((e_mu - beta * e_sd) - (l_mu + beta * l_sd)
                         <= np.log(cons.max_power_w))
            if cons.max_latency_s is not None:
                feas &= l_mu - beta * l_sd <= np.log(cons.max_latency_s)
            if cons.min_hbm_fit:
                state_pd = (wl.state_gb_per_device * wl.base_chips
                            / X[:, _F_N_CHIPS].astype(np.float64))
                feas &= (state_pd * 1e9
                         <= X[:, _F_HBM_BYTES].astype(np.float64) * 0.9)
            fr = self.frontiers[key]
            g = hypervolume_gain_2d(
                np.exp(e_mu - beta * e_sd), np.exp(l_mu - beta * l_sd),
                fr.energy_j, fr.latency_s, refs[0], refs[1])
            g[~feas] = 0.0
            gain += g
        offsets = np.cumsum([0] + sizes)[:-1]
        tile_gain = np.maximum.reduceat(gain, offsets)
        tile_spread = np.add.reduceat(spread, offsets) / np.asarray(
            sizes, np.float64)
        # best-first: gain desc, spread desc, then tile index asc —
        # a total, deterministic order
        order = np.lexsort((np.asarray(pending), -tile_spread, -tile_gain))
        return [pending[i] for i in order]

    def _select_round(self, ranked: List[int], budget_cands: int,
                      spent: int, k_round: int) -> List[int]:
        """Top-ranked tiles that fit the remaining candidate budget, at most
        ``k_round`` of them."""
        sel: List[int] = []
        for t in ranked:
            if len(sel) >= k_round:
                break
            lo, hi = tile_span(self.space, t)
            if spent + (hi - lo) > budget_cands:
                continue
            sel.append(t)
            spent += hi - lo
        return sel

    # -- the loop -----------------------------------------------------------

    def _spent_candidates(self) -> int:
        return sum(tile_span(self.space, t)[1] - tile_span(self.space, t)[0]
                   for t in self._done)

    def _seed_tiles(self, n_tiles: int, budget_cands: int) -> List[int]:
        """Evenly spaced seed tiles (every region of the space represented),
        truncated to the budget."""
        k = max(2, int(round(self.acfg.seed_fraction * n_tiles)))
        k = min(k, n_tiles)
        tiles = np.unique(np.linspace(0, n_tiles - 1, k).round()
                          .astype(int)).tolist()
        sel, spent = [], 0
        for t in tiles:
            lo, hi = tile_span(self.space, t)
            if spent + (hi - lo) > budget_cands:
                break
            sel.append(int(t))
            spent += hi - lo
        return sel

    def run(self, checkpoint_path: Optional[str] = None,
            max_rounds: Optional[int] = None) -> AdaptiveResult:
        """Run (or continue) the adaptive loop; ``max_rounds`` bounds THIS
        call — the interruption point resume tests exercise.  With a
        ``checkpoint_path`` (default ``config.checkpoint_path``) the full
        state persists after every round."""
        if checkpoint_path is None:
            checkpoint_path = self.config.checkpoint_path
        tel = self.telemetry
        clock = tel.clock
        t_start = clock()
        n_tiles = self.space.n_tiles()
        space_size = len(self.space)
        acfg = self.acfg

        if acfg.budget_fraction >= 1.0:
            return self._run_exact(checkpoint_path, t_start)

        budget_cands = int(np.floor(acfg.budget_fraction * space_size))
        k_round = max(1, int(round(acfg.round_fraction * n_tiles)))
        rounds_this_call = 0
        was_stopped = self.stopped_on is not None

        def out_of_rounds() -> bool:
            return max_rounds is not None and rounds_this_call >= max_rounds

        # seed round (skipped on a resumed campaign that already has one)
        if not self.rounds and not out_of_rounds():
            seed = self._seed_tiles(n_tiles, budget_cands)
            if not seed:
                raise ValueError(
                    f"budget_fraction={acfg.budget_fraction} cannot afford "
                    f"a single seed tile of chunk {self.space.chunk_size}")
            with tel.span("round", kind="seed", tiles=len(seed)):
                self._fold_round(seed, self._evaluate_round(seed))
            rounds_this_call += 1
            if checkpoint_path:
                self.checkpoint(checkpoint_path)

        while self.stopped_on is None and not out_of_rounds():
            pending = [t for t in range(n_tiles) if t not in self._done]
            if not pending:
                self.stopped_on = "exhausted"
                break
            if self.plateau >= acfg.plateau_rounds:
                self.stopped_on = "plateau"
                break
            spent = self._spent_candidates()
            with tel.span("round", kind="acquire", pending=len(pending)):
                with tel.span("acquisition", pending=len(pending)):
                    ranked = self._rank_pending(pending)
                    sel = self._select_round(ranked, budget_cands, spent,
                                             k_round)
                if not sel:
                    self.stopped_on = "budget"
                    break
                self._fold_round(sel, self._evaluate_round(sel))
            rounds_this_call += 1
            if checkpoint_path:
                self.checkpoint(checkpoint_path)
        if self.stopped_on is None and out_of_rounds():
            stopped = "max_rounds"       # interrupted, not finished
        else:
            stopped = self.stopped_on or "exhausted"
            if self.stopped_on is not None and not was_stopped:
                # counted once, when THIS call reaches the stop
                self._c_skipped.inc(n_tiles - len(self._done))
        if checkpoint_path:
            self.checkpoint(checkpoint_path)
        return self._result(stopped, clock() - t_start)

    def _run_exact(self, checkpoint_path: Optional[str],
                   t_start: float) -> AdaptiveResult:
        """budget >= 100%: the degenerate exact sweep — every tile in index
        order through the same reduce/merge fold, bitwise-identical to
        ``Campaign.run`` on the same config."""
        tiles = [t for t in range(self.space.n_tiles())
                 if t not in self._done]
        with self.telemetry.span("round", kind="exact", tiles=len(tiles)):
            # full coverage: the surrogates have nothing left to steer, so
            # skip the (pointless) whole-space forest fit
            self._fold_round(tiles, self._evaluate_round(tiles), fit=False)
        self.stopped_on = "budget"
        if checkpoint_path:
            self.checkpoint(checkpoint_path)
        return self._result("budget", self.telemetry.clock() - t_start)

    def _result(self, stopped: str, wall_s: float) -> AdaptiveResult:
        return AdaptiveResult(
            result=self._campaign._result(wall_s, tiles_done=len(self._done)),
            rounds=[list(r) for r in self.rounds],
            hv_history=list(self.hv_history),
            stopped_on=stopped,
            tiles_evaluated=len(self._done),
            n_tiles=self.space.n_tiles(),
            candidates_evaluated=self._spent_candidates(),
            space_size=len(self.space))

    # -- persistence --------------------------------------------------------

    def state_dict(self) -> Dict:
        """Campaign schema version 1 plus an ``"adaptive"`` key: the
        adaptive config, per-round tile lists, the EXPLICIT acquisition
        reference points, the hypervolume history and the plateau/stop
        state — everything a resume needs to compute the same acquisition
        scores as an uninterrupted run (the forests are reconstructed by
        replaying the recorded rounds, not persisted)."""
        state = self._campaign.state_dict()
        state["adaptive"] = {
            "config": self.acfg.to_dict(),
            "rounds": [list(map(int, r)) for r in self.rounds],
            "acq_refs": {f"{a}|{s}": list(v) if v is not None else None
                         for (a, s), v in self.acq_refs.items()},
            "hv_history": [float(h) for h in self.hv_history],
            "plateau": int(self.plateau),
            "stopped_on": self.stopped_on,
        }
        return state

    def checkpoint(self, path: str) -> str:
        with self.telemetry.span("checkpoint_write", rounds=len(self.rounds)):
            return store.save_checkpoint(self.state_dict(), path)

    @classmethod
    def from_checkpoint(cls, path: str, telemetry=None,
                        **kwargs) -> "AdaptiveCampaign":
        """Resume an adaptive campaign: frontiers and accounting load
        through ``Campaign.from_checkpoint`` (same schema/version gates),
        the acquisition refs and round ledger come from the ``"adaptive"``
        key, and the forests are rebuilt bitwise by replaying each recorded
        round — re-evaluating its tiles for training rows only (a pure
        function of config x span; costs at most the spent budget, which
        the adaptive loop bounds at ~10% of a sweep).  ``kwargs`` override
        config fields (``device=``, which a checkpoint does not store)."""
        state = store.load_checkpoint(path)
        ad = state.get("adaptive")
        if not ad:
            raise ValueError(
                f"checkpoint {path} has no 'adaptive' state — resume it "
                "with Campaign.from_checkpoint instead")
        acfg = AdaptiveConfig.from_dict(ad["config"])
        camp = Campaign.from_checkpoint(path, adaptive=acfg,
                                        telemetry=telemetry, **kwargs)
        obj = cls(camp.workloads, camp.config, telemetry=camp.telemetry,
                  _campaign=camp)
        obj.rounds = [list(map(int, r)) for r in ad["rounds"]]
        for key_str, v in ad["acq_refs"].items():
            arch, shape = key_str.split("|", 1)
            obj.acq_refs[(arch, shape)] = tuple(v) if v is not None else None
        obj.hv_history = [float(h) for h in ad["hv_history"]]
        obj.plateau = int(ad["plateau"])
        obj.stopped_on = ad["stopped_on"]
        obj._done = {t for r in obj.rounds for t in r}
        with obj.telemetry.span("adaptive_replay", rounds=len(obj.rounds)):
            for rtiles in obj.rounds:
                reductions = {}
                for t in sorted(set(rtiles)):
                    lo, hi = tile_span(obj.space, t)
                    batch = obj.space.slice(
                        lo, hi, with_candidates=not obj.engine.fused)
                    reductions[t] = obj.engine.reduce_tile(batch, lo)
                obj._fit_round(reductions)
        return obj


# ---------------------------------------------------------------------------
# distributed adaptive: one coordinator, a persistent fabric worker pool
# ---------------------------------------------------------------------------

class _WorkerPool:
    """Persistent pool of fabric worker processes for the adaptive loop.

    Reuses ``fabric._worker_main`` (same protocol, same warm-up, same
    crash semantics) but keeps the processes alive ACROSS rounds — each
    worker creates its CUDA context and loads the kernels once, not once
    per round.  Each ``evaluate_round`` drives a per-round ``LeaseBoard``
    restricted to the selected tiles, leased in acquisition order via
    ``set_priority``; worker death re-pends its tile to a survivor.
    ``close`` collects each surviving worker's terminal metrics snapshot
    into ``stats["worker_metrics"]`` (its kernel launches among them: an
    adaptive ``"cuda"`` tile launches the fused kernel and the sweep kernel
    alone, in the worker that evaluated it).
    """

    def __init__(self, engine, n_workers: int,
                 fault: Optional[FaultInjection] = None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        fault = fault or FaultInjection()
        if fault.hang_worker is not None:
            raise ValueError("hang_worker is a LocalFabric-only injection")
        cfg = campaign_config(engine)
        self.n_tiles = engine.space.n_tiles()
        ctx = mp.get_context("spawn")  # a CUDA parent cannot fork
        self.result_q = ctx.Queue()
        self.task_qs: Dict[int, object] = {}
        self.procs: Dict[int, mp.Process] = {}
        self.lost: set = set()
        self.duplicate_pending = fault.duplicate
        self.stats = {"deliveries": 0, "duplicates": 0, "reissued_tiles": 0,
                      "lost_workers": [], "n_workers": int(n_workers),
                      "worker_metrics": {}}
        for w in range(n_workers):
            worker_cfg = {}
            if fault.kill_worker == w:
                worker_cfg["die_on_nth_tile"] = fault.kill_after_tiles + 1
            self.task_qs[w] = ctx.Queue()
            p = ctx.Process(target=_worker_main,
                            args=(w, cfg, worker_cfg, self.task_qs[w],
                                  self.result_q), daemon=True)
            p.start()
            self.procs[w] = p
        # ready barrier: leases are only issued once the fleet is warm
        self.idle: List[int] = []
        ready: set = set()
        try:
            while len(ready | self.lost) < n_workers:
                try:
                    kind, w, _, payload, _ = self.result_q.get(timeout=0.1)
                except queue_mod.Empty:
                    kind = None
                if kind == "ready":
                    ready.add(w)
                    self.idle.append(w)
                elif kind == "error":
                    raise RuntimeError(f"adaptive worker {w} failed: "
                                       f"{payload}")
                self._reap()
            if not self.idle:
                raise RuntimeError("adaptive worker pool: all workers died "
                                   "during warm-up")
        except BaseException:
            self.close()
            raise

    def _reap(self) -> None:
        for w, p in self.procs.items():
            if w not in self.lost and not p.is_alive():
                self.lost.add(w)
                self.stats["lost_workers"].append(w)
                if w in self.idle:
                    self.idle.remove(w)

    def evaluate_round(self, tiles: List[int]) -> List[RoundDelivery]:
        """Evaluate ``tiles`` across the pool; returns every delivery
        (duplicates included — folding dedups).  Raises if the whole fleet
        dies with tiles outstanding, or if a worker reports an error."""
        board = LeaseBoard(
            self.n_tiles,
            done=[t for t in range(self.n_tiles) if t not in set(tiles)])
        board.set_priority(tiles)
        holding: Dict[int, int] = {}
        out: List[RoundDelivery] = []
        while not board.all_done:
            while self.idle:
                w = self.idle[0]
                tile = board.next_tile(w)
                if tile is None:
                    break
                self.idle.pop(0)
                holding[w] = tile
                self.task_qs[w].put(tile)
            try:
                kind, w, tile, payload, busy = self.result_q.get(timeout=0.05)
            except queue_mod.Empty:
                kind = None
            if kind == "result":
                out.append((tile, payload, busy))
                board.complete(tile)
                holding.pop(w, None)
                self.stats["deliveries"] += 1
                if w not in self.lost:
                    self.idle.append(w)
                if self.duplicate_pending:
                    self.duplicate_pending = False
                    out.append((tile, payload, 0.0))
                    self.stats["duplicates"] += 1
            elif kind == "error":
                raise RuntimeError(f"adaptive worker {w} failed: {payload}")
            self._reap()
            for w in list(holding):
                if w in self.lost:
                    holding.pop(w)
                    re_pended = board.revoke_worker(w)
                    self.stats["reissued_tiles"] += len(re_pended)
            if not board.all_done and len(self.lost) == len(self.procs):
                raise RuntimeError(
                    "adaptive pool stalled: all workers lost with "
                    f"{board.n_pending} tiles pending")
        return out

    def close(self) -> None:
        """Shut the pool down (``fabric._stop_workers``), keeping each
        surviving worker's terminal metrics snapshot."""
        self.stats["worker_metrics"].update(_stop_workers(
            self.procs, self.task_qs, self.result_q, RetryPolicy()))


def run_adaptive_distributed(workloads: Sequence[dse.Workload],
                             config: CampaignConfig,
                             fault: Optional[FaultInjection] = None,
                             telemetry=None
                             ) -> Tuple[AdaptiveResult, Dict]:
    """One-call distributed adaptive campaign; returns
    ``(AdaptiveResult, pool stats)``.

    The coordinator (this process) keeps every decision — acquisition,
    surrogate fitting, frontier folding, plateau stop — and only tile
    evaluation fans out to ``config.n_workers`` fabric worker processes on
    ``config.device``.  Because training rows, acquisition refs and
    frontier folds are all order-canonicalized at round barriers, the
    result is bitwise-identical to the single-process
    ``AdaptiveCampaign.run`` on the same config — under injected worker
    crashes and duplicate deliveries too.
    """
    adaptive = AdaptiveCampaign(workloads, config, telemetry=telemetry)
    pool = _WorkerPool(adaptive.engine, config.n_workers, fault=fault)
    try:
        adaptive._evaluate_round = pool.evaluate_round
        result = adaptive.run(checkpoint_path=config.checkpoint_path)
    finally:
        pool.close()
    return result, dict(pool.stats)
