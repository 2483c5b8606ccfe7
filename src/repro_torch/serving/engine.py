"""Serving engines: token generation and accelerator selection (the
reference's ``serving/engine.py``).

Two independent engines live here:

* ``ServingEngine`` — KV-cache manager + continuous batcher for token
  serving.  Slot-based continuous batching with static shapes: the decode
  step always runs the full [slots, 1] batch; free slots carry pad token 0.
  A request's prompt is fed token by token through that same decode step,
  and finished requests free their slot immediately for the next queued
  request.  The semantics are the reference's, step for step (the parity
  tests hold the tokens equal): every decode advances the cache's ONE
  shared position for all slots, and an admitted request inherits its
  slot's old cache rows.  The port's decode raises on a full cache where
  the reference's clamps, so ``max_len`` must cover the engine's total
  decode steps, not one request's.

* ``SelectionEngine`` — the accelerator-selection query engine over a
  ``FrontierIndex``: ``select(workload, constraint) -> ranked candidates``.
  Known workload families are answered straight from the index (provenance
  ``index_exact`` — identical to the offline campaign pick by
  construction).  Novel workloads fall back to a mini-campaign: all novel
  queries of a flush ride ONE fused multi-workload sweep launch (the fused
  K1 of ``kernels/dse_sweep.py`` takes one row per workload, so batching
  queries is free), optionally predictor-pruned to a top slice that is
  then verified exactly (provenance ``mini_campaign``).  A query whose
  deadline the exact path cannot meet degrades to predictor-ranked answers
  without any sweep (provenance ``predictor_only``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import costmodel as _costmodel
from repro_torch.core import dse as _dse
from repro_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from repro_torch.dse_campaign.config import (REFERENCE_EVALUATORS,
                                             CampaignConfig)
from repro_torch.dse_campaign.frontier import StreamingFrontier
from repro_torch.dse_campaign.runner import TileEvaluator
from repro_torch.dse_campaign.space import SpaceSpec
from repro_torch.models.api import Model
from repro_torch.serving.frontier_index import FrontierIndex, IndexEntry
from repro_torch.telemetry import coerce_telemetry


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [prompt_len] int32
    max_new_tokens: int = 32
    arrived_s: float = 0.0
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None


class ServingEngine:
    """Static-shape continuous batching over ``slots`` concurrent sequences.

    ``load(module)`` takes the network ``model.init`` built (the reference's
    ``params``) on ``device`` and allocates the [slots, max_len] cache
    there.  Each step calls ``model.decode(module, batch, cache)`` directly
    and reads the float32 logits back to the host for a numpy ``argmax``
    (ties go to the first index, as in the reference).
    """

    def __init__(self, model: Model, slots: int = 4, max_len: int = 512,
                 greedy: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 device: DeviceLike = DEFAULT_DEVICE):
        if model.decode is None:
            raise ValueError(f"{model.cfg.name}: family has no decode step")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.device = resolve_device(device)
        self._clock = clock
        self.params = None
        self.cache = None
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_len = np.zeros(slots, np.int32)
        self.queue: List[Request] = []

    def load(self, params: torch.nn.Module):
        dev = next(params.parameters()).device
        if dev != self.device:
            raise ValueError(f"the module lies on {dev}, the engine serves "
                             f"on {self.device}")
        self.params = params
        self.cache = self.model.init_cache(self.slots, self.max_len,
                                           device=self.device)

    # --- admission ---------------------------------------------------------------

    def submit(self, req: Request):
        req.arrived_s = self._clock()
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_slot(s, req)

    def _prefill_slot(self, slot: int, req: Request):
        """Sequential per-slot prefill: decode the prompt token-by-token
        into this slot's cache region (static shape; prompt lengths vary per
        request).  The last prompt token's logits yield the first generated
        token immediately."""
        self.slot_req[slot] = req
        self.slot_len[slot] = 0
        for t in req.prompt[:-1]:
            self._step_single_token(slot, int(t))
        logits = self._step_single_token(slot, int(req.prompt[-1]))
        req.tokens_out.append(int(np.argmax(logits)))
        req.first_token_s = self._clock()
        if len(req.tokens_out) >= req.max_new_tokens:
            req.done = True
            req.finished_s = self._clock()
            self.slot_req[slot] = None

    def _decode(self, toks: np.ndarray) -> torch.Tensor:
        logits, self.cache = self.model.decode(
            self.params, {"tokens": torch.from_numpy(toks)}, self.cache)
        return logits

    def _step_single_token(self, slot: int, token: int) -> np.ndarray:
        toks = np.zeros((self.slots, 1), np.int32)
        toks[slot, 0] = token
        logits = self._decode(toks)
        self.slot_len[slot] += 1
        return logits[slot, -1].cpu().numpy()

    # --- decode loop --------------------------------------------------------------

    def step(self) -> int:
        """One engine iteration: admit, decode one token for every live slot."""
        self._admit()
        live = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not live:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for s in live:
            req = self.slot_req[s]
            toks[s, 0] = req.tokens_out[-1]      # never empty after prefill
        logits = self._decode(toks)[:, -1].cpu().numpy()
        for s in live:
            req = self.slot_req[s]
            nxt = int(np.argmax(logits[s]))
            req.tokens_out.append(nxt)
            self.slot_len[s] += 1
            if (len(req.tokens_out) >= req.max_new_tokens
                    or self.slot_len[s] >= self.max_len - 1):
                req.done = True
                req.finished_s = self._clock()
                self.slot_req[s] = None
        return len(live)

    def run_until_drained(self, max_iters: int = 10_000) -> Dict:
        t0 = self._clock()
        decoded = 0
        for _ in range(max_iters):
            n = self.step()
            decoded += n
            if n == 0 and not self.queue:
                break
        dt = self._clock() - t0
        return {"decoded_tokens": decoded, "wall_s": dt,
                "tok_per_s": decoded / dt if dt > 0 else 0.0}


# ---------------------------------------------------------------------------
# accelerator selection
# ---------------------------------------------------------------------------

# answer provenance, stamped on every SelectionAnswer:
#   index_exact    — served from the FrontierIndex; identical to the offline
#                    campaign pick by construction
#   mini_campaign  — novel workload, answered by a fused exact sweep (all
#                    concurrent novel queries share ONE launch)
#   predictor_only — deadline degradation: predictor-ranked, no exact sweep
PROVENANCES = ("index_exact", "mini_campaign", "predictor_only")


@dataclasses.dataclass
class SelectionQuery:
    """One pending selection request.

    ``constraint=None`` means "the index's constraint" (the only constraint
    index entries were computed under); an explicit different constraint
    forces the mini-campaign path even for known families.  ``deadline_s``
    is a budget from submission time: if the exact path cannot meet it
    (and predictors are configured), the answer degrades to
    ``predictor_only``.
    """

    workload: _dse.Workload
    constraint: Optional[_dse.Constraint] = None
    deadline_s: Optional[float] = None
    qid: int = -1
    submitted_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class RankedChoice:
    """One ranked accelerator recommendation.  ``index`` is the candidate's
    global position in the serving space; ``exact`` is False only for
    predictor-scored (unverified) choices."""

    candidate: _dse.Candidate
    energy_j: float
    latency_s: float
    index: int
    exact: bool = True


@dataclasses.dataclass
class SelectionAnswer:
    """The engine's answer to one query: the top-k ranked choices plus the
    full frontier it ranked from (for parity checks and richer clients).

    ``verified_gidx`` is the global-index slice the fallback sweep verified
    exactly (``None`` for index hits and predictor-only answers) — a
    standalone mini-campaign on the same slice reproduces ``frontier()``
    bitwise.

    ``degraded_reason`` stamps WHY a ``predictor_only`` answer degraded:
    ``"deadline"`` (budget triage), ``"circuit_open"`` (the mini-campaign
    circuit breaker is cooling down) or ``"mini_campaign_error"`` (the exact
    sweep raised and the engine fell back).  ``None`` on exact answers.
    """

    qid: int
    workload: _dse.Workload
    provenance: str
    choices: List[RankedChoice]
    feasible_count: int
    wall_s: float
    frontier_candidates: Tuple[_dse.Candidate, ...]
    frontier_energy_j: np.ndarray
    frontier_latency_s: np.ndarray
    frontier_indices: np.ndarray
    verified_gidx: Optional[np.ndarray] = None
    degraded_reason: Optional[str] = None

    def frontier(self) -> _dse.ParetoFrontier:
        """The answer's frontier in ``dse.ParetoFrontier`` form (exact for
        ``index_exact`` / ``mini_campaign``; predicted for
        ``predictor_only``)."""
        return _dse.ParetoFrontier(
            workload=self.workload,
            candidates=tuple(self.frontier_candidates),
            energy_j=np.asarray(self.frontier_energy_j, np.float64),
            latency_s=np.asarray(self.frontier_latency_s, np.float64),
            indices=np.asarray(self.frontier_indices, np.int64),
            feasible_count=int(self.feasible_count))


class CircuitBreaker:
    """Mini-campaign circuit breaker: closed → open → half-open.

    ``record_failure`` counts consecutive exact-path failures (exceptions
    or deadline overruns); at ``fail_threshold`` the breaker OPENS and
    ``allow()`` refuses the exact path until ``cooldown_s`` has elapsed on
    the injected clock.  The first ``allow()`` after cooldown transitions to
    HALF-OPEN and admits one probe: success closes the breaker, failure
    re-opens it for another full cooldown.  All transitions are reported
    through ``on_transition`` (the engine counts them in telemetry); the
    breaker itself never sleeps and never reads a wall clock directly, so
    tests drive it entirely through an injected clock.
    """

    def __init__(self, fail_threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic, on_transition=None):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.on_transition = on_transition
        self.state = "closed"
        self.failures = 0
        self.opened_at: Optional[float] = None

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        old, self.state = self.state, state
        if self.on_transition is not None:
            self.on_transition(old, state)

    def allow(self) -> bool:
        """Whether the exact path may run now (may flip open → half-open)."""
        if self.state == "open":
            if self.clock() - self.opened_at >= self.cooldown_s:
                self._transition("half_open")
                return True
            return False
        return True

    def record_success(self) -> None:
        self.failures = 0
        if self.state != "closed":
            self._transition("closed")

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.fail_threshold:
            self.opened_at = self.clock()
            self._transition("open")


class SelectionEngine:
    """Accelerator-selection query engine over a ``FrontierIndex``.

    Constructed like every other campaign entry point — from a
    ``CampaignConfig``, which carries its own device.  ``config=None``
    derives one from the index itself on ``device`` (same space,
    constraint and ``SimConfig`` the offline campaign used; the evaluator is
    coerced to the fused ``"cuda"`` tier, since the fallback path's
    one-launch batching property only exists on the fused sweep — see
    ``_config_from_index`` for the dtype).  The ``power_model`` /
    ``cycles_model`` config fields enable the predictor paths (top-slice
    pruning and deadline degradation); without them every novel query is
    answered by a full exact sweep and deadlines are advisory.

    Request layer: ``submit()`` queues queries, ``flush()`` answers the
    whole batch — the batching window is the caller's submit..flush span
    (``select()`` is the submit+flush one-liner).  All novel queries of a
    flush that share a constraint ride ONE fused multi-workload sweep
    launch; ``fused_launches`` counts launches across the engine's lifetime
    so the claim is measured, not assumed.  Per-row results of the fused
    sweep are lane-local, so batched answers are bitwise identical to
    sequential ones.

    Observability: pass ``telemetry=`` to share a metrics registry / tracer
    with the caller (per-path ``selection_latency_s`` histograms,
    ``selection_queries_total`` counters, the ``selection_deadline_ema_s``
    gauge and the ``index_lookup`` / ``mini_campaign`` / ``predictor_only``
    spans, with the evaluator's ``pad`` / ``launch`` / ``compact`` nested
    under ``mini_campaign``, land there); the default is a private
    ``NullTelemetry`` — counters still count, tracing is free.  The EMA the
    deadline triage BRANCHES on stays a plain attribute; the gauge only
    mirrors it (instrumented values never feed computation).
    """

    def __init__(self, index: FrontierIndex, config: CampaignConfig = None,
                 top_k: int = 5, match_rtol: float = 1e-9,
                 verify_top: int = 256, telemetry=None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 device: DeviceLike = DEFAULT_DEVICE):
        if config is None:
            config = self._config_from_index(index, device)
        elif not isinstance(config, CampaignConfig):
            raise TypeError("SelectionEngine: config must be a "
                            "CampaignConfig (or None to derive one from "
                            "the index)")
        self.index = index
        self.config = config
        self.space = config.resolved_space
        self.top_k = int(top_k)
        self.match_rtol = float(match_rtol)
        self.verify_top = int(verify_top)
        self.index_constraint = _dse.Constraint(**index.constraint_dict)
        self.pending: List[SelectionQuery] = []
        self.telemetry = coerce_telemetry(telemetry)
        self._clock = self.telemetry.clock
        self._c_fused = self.telemetry.counter("selection_fused_launches_total")
        self._g_ema = self.telemetry.gauge("selection_deadline_ema_s")
        self.stats: Dict[str, int] = {p: 0 for p in PROVENANCES}
        self.stats["queries"] = 0
        self.stats["degraded"] = 0
        self.stats["breaker_opens"] = 0
        self._next_qid = 0
        self._exact_ema_s: Optional[float] = None
        self._full_batch: Optional[_dse.CandidateBatch] = None
        self._g_breaker = self.telemetry.gauge("selection_breaker_open")
        self._g_breaker.set(0.0)
        self.breaker = CircuitBreaker(
            fail_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s, clock=self._clock,
            on_transition=self._on_breaker_transition)

    def _on_breaker_transition(self, old: str, new: str) -> None:
        self.telemetry.counter("selection_breaker_transitions_total",
                               to=new).inc()
        self._g_breaker.set(1.0 if new == "open" else 0.0)
        if new == "open":
            self.stats["breaker_opens"] += 1

    @property
    def fused_launches(self) -> int:
        """Fused fallback-sweep launches over the engine's lifetime — a view
        over the ``selection_fused_launches_total`` telemetry counter."""
        return int(self._c_fused.value)

    @staticmethod
    def _config_from_index(index: FrontierIndex,
                           device: DeviceLike = DEFAULT_DEVICE
                           ) -> CampaignConfig:
        """The fused ``"cuda"`` tier on ``device``: an index built on it
        keeps its dtype, one named after the reference's fused tiers takes
        theirs (``"pallas"`` float64, ``"jit"`` float32), and every other
        tier (``"torch"``, ``"numpy"``, ``"fast"``) becomes float32 — as the
        reference turns every non-fused tier into its ``"jit"``."""
        if index.evaluator == "cuda":
            dtype = index.dtype
        else:
            tier, dtype = REFERENCE_EVALUATORS.get(index.evaluator,
                                                   (None, None))
            if tier != "cuda":
                dtype = "float32"
        return CampaignConfig(
            space=SpaceSpec.from_dict(index.space_dict),
            evaluator="cuda", dtype=dtype, device=device,
            constraint=_dse.Constraint(**index.constraint_dict),
            sim=_costmodel.SimConfig(**index.sim_dict))

    @property
    def _has_models(self) -> bool:
        return (self.config.power_model is not None
                and self.config.cycles_model is not None)

    # -- request layer ------------------------------------------------------

    def submit(self, workload: _dse.Workload,
               constraint: Optional[_dse.Constraint] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a query for the next ``flush``; returns its qid."""
        qid = self._next_qid
        self._next_qid += 1
        self.pending.append(SelectionQuery(
            workload=workload, constraint=constraint, deadline_s=deadline_s,
            qid=qid, submitted_s=self._clock()))
        return qid

    def select(self, workload: _dse.Workload,
               constraint: Optional[_dse.Constraint] = None,
               deadline_s: Optional[float] = None) -> SelectionAnswer:
        """Answer one query now (a batching window of one)."""
        self.submit(workload, constraint, deadline_s)
        return self.flush()[-1]

    def flush(self) -> List[SelectionAnswer]:
        """Answer every pending query, in submission order.

        Index-eligible queries (known family, index constraint) are served
        from the index; the rest are triaged by deadline and the survivors
        grouped by constraint — each group is ONE fused sweep launch.  A
        group whose sweep raises degrades to ``predictor_only`` answers
        when predictors are configured (counted in
        ``selection_minicampaign_failures_total``); without them the error
        propagates.
        """
        queries, self.pending = self.pending, []
        tel = self.telemetry
        answers: Dict[int, SelectionAnswer] = {}
        novel: List[SelectionQuery] = []
        for q in queries:
            t0 = self._clock()
            with tel.span("index_lookup", qid=q.qid):
                entry = (self.index.lookup(q.workload, self.match_rtol)
                         if self._index_eligible(q) else None)
            if entry is not None:
                answers[q.qid] = self._answer_from_entry(
                    q, entry, self._clock() - t0)
            else:
                novel.append(q)
        exact: List[SelectionQuery] = []
        for q in novel:
            if self._must_degrade(q):
                with tel.span("predictor_only", qid=q.qid):
                    answers[q.qid] = self._answer_predictor_only(
                        q, reason="deadline")
            elif self._has_models and not self.breaker.allow():
                # breaker open: the exact path has been failing; serve
                # predictor-ranked answers until the cooldown probe closes it
                with tel.span("predictor_only", qid=q.qid):
                    answers[q.qid] = self._answer_predictor_only(
                        q, reason="circuit_open")
            else:
                exact.append(q)
        groups: Dict[Tuple, List[SelectionQuery]] = {}
        for q in exact:
            groups.setdefault(
                dataclasses.astuple(self._query_constraint(q)),
                []).append(q)
        for group in groups.values():
            t0 = self._clock()
            try:
                with tel.span("mini_campaign", n_queries=len(group)):
                    fronts, gidx = self._mini_campaign(
                        [q.workload for q in group],
                        self._query_constraint(group[0]))
            except Exception:
                self.breaker.record_failure()
                tel.counter("selection_minicampaign_failures_total").inc()
                if not self._has_models:
                    raise      # no degraded answer is possible: surface it
                for q in group:
                    with tel.span("predictor_only", qid=q.qid):
                        answers[q.qid] = self._answer_predictor_only(
                            q, reason="mini_campaign_error")
                continue
            dt = self._clock() - t0
            if self._has_models:
                # a sweep that blew through a caller's deadline counts as a
                # breaker failure even though it produced exact answers —
                # repeated overruns should trip to predictor-only, not keep
                # serving late exact answers
                blown = [q for q in group if q.deadline_s is not None
                         and self._clock() - q.submitted_s > q.deadline_s]
                if blown:
                    self.breaker.record_failure()
                    tel.counter(
                        "selection_minicampaign_timeouts_total").inc()
                else:
                    self.breaker.record_success()
            self._exact_ema_s = (dt if self._exact_ema_s is None
                                 else 0.5 * (self._exact_ema_s + dt))
            self._g_ema.set(self._exact_ema_s)
            for q, front in zip(group, fronts):
                answers[q.qid] = self._answer_from_frontier(
                    q, front, "mini_campaign", dt / len(group),
                    verified_gidx=gidx)
        for q in queries:
            ans = answers[q.qid]
            self.stats["queries"] += 1
            self.stats[ans.provenance] += 1
            tel.counter("selection_queries_total", path=ans.provenance).inc()
            tel.histogram("selection_latency_s",
                          path=ans.provenance).observe(ans.wall_s)
        return [answers[q.qid] for q in queries]

    # -- the three answer paths ---------------------------------------------

    def _index_eligible(self, q: SelectionQuery) -> bool:
        return q.constraint is None or q.constraint == self.index_constraint

    def _query_constraint(self, q: SelectionQuery) -> _dse.Constraint:
        return (q.constraint if q.constraint is not None
                else self.index_constraint)

    def _must_degrade(self, q: SelectionQuery) -> bool:
        """Whether ``q``'s deadline forces the predictor-only answer.

        Degradation needs predictors; without them the exact sweep is the
        only possible answer and the deadline is advisory.  The exact
        path's cost estimate is an EMA of past group sweeps — before any
        sweep has run, only an already-expired deadline degrades.
        """
        if not self._has_models or q.deadline_s is None:
            return False
        remaining = q.deadline_s - (self._clock() - q.submitted_s)
        if remaining <= 0:
            return True
        return self._exact_ema_s is not None and remaining < self._exact_ema_s

    def _ranked(self, candidates: Sequence[_dse.Candidate], energy_j,
                latency_s, indices, exact: bool) -> List[RankedChoice]:
        """Top-k by (energy, latency, index) ascending — the one ranking
        rule all three provenances share."""
        e = np.asarray(energy_j, np.float64)
        l = np.asarray(latency_s, np.float64)
        i = np.asarray(indices, np.int64)
        order = np.lexsort((i, l, e))[:self.top_k]
        return [RankedChoice(candidate=candidates[j], energy_j=float(e[j]),
                             latency_s=float(l[j]), index=int(i[j]),
                             exact=exact) for j in order]

    def _answer_from_entry(self, q: SelectionQuery, entry: IndexEntry,
                           wall_s: float) -> SelectionAnswer:
        return SelectionAnswer(
            qid=q.qid, workload=q.workload, provenance="index_exact",
            choices=self._ranked(entry.candidates, entry.energy_j,
                                 entry.latency_s, entry.indices, exact=True),
            feasible_count=entry.feasible_count, wall_s=wall_s,
            frontier_candidates=tuple(entry.candidates),
            frontier_energy_j=entry.energy_j.copy(),
            frontier_latency_s=entry.latency_s.copy(),
            frontier_indices=entry.indices.copy())

    def _answer_from_frontier(self, q: SelectionQuery,
                              front: _dse.ParetoFrontier, provenance: str,
                              wall_s: float,
                              verified_gidx: Optional[np.ndarray] = None,
                              exact: bool = True) -> SelectionAnswer:
        return SelectionAnswer(
            qid=q.qid, workload=q.workload, provenance=provenance,
            choices=self._ranked(front.candidates, front.energy_j,
                                 front.latency_s, front.indices, exact=exact),
            feasible_count=int(front.feasible_count), wall_s=wall_s,
            frontier_candidates=tuple(front.candidates),
            frontier_energy_j=np.asarray(front.energy_j, np.float64),
            frontier_latency_s=np.asarray(front.latency_s, np.float64),
            frontier_indices=np.asarray(front.indices, np.int64),
            verified_gidx=verified_gidx)

    # -- predictor paths ----------------------------------------------------

    def _full_space_batch(self) -> _dse.CandidateBatch:
        """The whole serving space as one materialized batch (cached) —
        what the predictor paths score over."""
        if self._full_batch is None:
            self._full_batch = self.space.slice(0, len(self.space),
                                                with_candidates=True)
        return self._full_batch

    def _predict(self, wl: _dse.Workload, constraint: _dse.Constraint):
        """Predictor scores over the full space for one workload.

        Predictors score static (arch config x candidate) features, so a
        workload's census perturbations do not move its predictions — fine
        for ranking a top slice, which is why the slice is always verified
        exactly before being served as ``mini_campaign``.
        """
        cfg = get_config(wl.arch)
        shape = SHAPES[wl.shape.split(":", 1)[0]]
        energy, latency, feasible, _, _ = _dse.predict_space(
            cfg, shape, self.config.power_model, self.config.cycles_model,
            self._full_space_batch(), constraint)
        return energy, latency, feasible

    def _answer_predictor_only(self, q: SelectionQuery,
                               reason: str = "deadline") -> SelectionAnswer:
        t0 = self._clock()
        constraint = self._query_constraint(q)
        energy, latency, feasible = self._predict(q.workload, constraint)
        mask = _dse.pareto_mask(energy, latency, feasible)
        loc = np.flatnonzero(mask)
        batch = self._full_space_batch()
        front = _dse.ParetoFrontier(
            workload=q.workload,
            candidates=tuple(batch.candidates[i] for i in loc),
            energy_j=np.asarray(energy, np.float64)[loc],
            latency_s=np.asarray(latency, np.float64)[loc],
            indices=loc.astype(np.int64),
            feasible_count=int(np.asarray(feasible, bool).sum()))
        answer = self._answer_from_frontier(
            q, front, "predictor_only", self._clock() - t0,
            exact=False)
        answer.degraded_reason = reason
        self.stats["degraded"] += 1
        self.telemetry.counter("selection_degraded_total",
                               reason=reason).inc()
        return answer

    def _candidate_slice(self, workloads: Sequence[_dse.Workload],
                         constraint: _dse.Constraint) -> np.ndarray:
        """Global indices the fallback sweep verifies exactly: the whole
        space without predictors, else the union over workloads of each
        predictor's top slice (predicted-feasible best-energy and
        best-latency ``verify_top`` plus the predicted Pareto members)."""
        n = len(self.space)
        if not self._has_models or self.verify_top >= n:
            return np.arange(n, dtype=np.int64)
        union: List[np.ndarray] = []
        for wl in workloads:
            energy, latency, feasible = self._predict(wl, constraint)
            feas = np.flatnonzero(np.asarray(feasible, bool))
            if not feas.size:
                continue
            by_e = feas[np.argsort(energy[feas], kind="stable")]
            by_l = feas[np.argsort(latency[feas], kind="stable")]
            union.append(by_e[:self.verify_top])
            union.append(by_l[:self.verify_top])
            union.append(np.flatnonzero(
                _dse.pareto_mask(energy, latency, feasible)))
        if not union:
            return np.arange(n, dtype=np.int64)   # conservative fallback
        return np.unique(np.concatenate(union)).astype(np.int64)

    # -- the exact fallback sweep -------------------------------------------

    def _mini_campaign(self, workloads: Sequence[_dse.Workload],
                       constraint: _dse.Constraint
                       ) -> Tuple[List[_dse.ParetoFrontier], np.ndarray]:
        """Exact frontiers for ``workloads`` on the verified slice — ONE
        fused multi-workload launch for the whole group.

        The verified slice goes to the evaluator as ONE tile (padded to
        the space's chunk size if it is shorter), so the full default space
        is one fused launch of W = len(workloads) rows x N = 125,440 lanes;
        a row whose screen overflows ``max_survivors`` reads its full rows
        through K1 alone, still one counted sweep.  A new ``TileEvaluator``
        per group: the reduction's arrays are copies, never views into a
        result buffer a later sweep rewrites.

        Workload keys are tagged per query position (the fused sweep reads
        only the census columns, and predictor shape resolution strips the
        tag like pod tags), so concurrent queries on the same (arch, shape)
        with different censuses cannot collide.  Frontier indices are
        remapped to global space indices; on the full-space slice the
        result is bitwise identical to ``Campaign.run`` on the same config
        (tile-boundary invariance), which is what the parity tests pin.
        """
        tagged = [dse_workload_tagged(wl, i) for i, wl in enumerate(workloads)]
        cfg = self.config.replace(constraint=constraint)
        # the evaluator shares this engine's telemetry (pad/launch/compact
        # spans nest under the mini_campaign span); its lifetime counter is
        # shared too, so the launch count for THIS sweep is a delta
        ev = TileEvaluator(tagged, cfg, telemetry=self.telemetry)
        launches_before = ev._c_fused.value
        gidx = self._candidate_slice(workloads, constraint)
        if gidx.size == len(self.space):
            batch = self._full_space_batch()
        else:
            batch = _dse.CandidateBatch.from_candidates(
                self.space.candidates_at(gidx))
        tr = ev.reduce_tile(batch, 0)
        self._c_fused.inc(ev._c_fused.value - launches_before)
        fronts: List[_dse.ParetoFrontier] = []
        for wi, wl in enumerate(workloads):
            loc = tr.surv_gidx[wi]                 # local slice positions
            fr = StreamingFrontier()
            fr.merge_reduced(
                self.space.candidates_at(gidx[loc]), tr.surv_energy[wi],
                tr.surv_latency[wi], loc, span=(0, int(gidx.size)),
                n_feasible=tr.n_feasible[wi],
                ref_energy_j=tr.ref_energy_j[wi],
                ref_latency_s=tr.ref_latency_s[wi], tile=0)
            front = fr.as_pareto_frontier(wl)
            fronts.append(_dse.ParetoFrontier(
                workload=wl, candidates=front.candidates,
                energy_j=front.energy_j, latency_s=front.latency_s,
                indices=gidx[front.indices],
                feasible_count=front.feasible_count))
        return fronts, gidx


def dse_workload_tagged(wl: _dse.Workload, i: int) -> _dse.Workload:
    """``wl`` with its shape tagged by query position — unique (arch, shape)
    keys inside one fused group sweep (the same mechanism as pod tags)."""
    return _dse.Workload(arch=wl.arch, shape=f"{wl.shape}:q{i}",
                         base_analysis=dict(wl.base_analysis),
                         base_chips=wl.base_chips,
                         state_gb_per_device=wl.state_gb_per_device)
