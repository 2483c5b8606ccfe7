"""Fault-tolerance runtime: heartbeats, straggler detection, preemption.

Counterpart of ``repro.runtime.fault_tolerance``.  Mechanisms (all
host-side and unit-testable):

  * HeartbeatMonitor — per-host liveness registry with timeout-based failure
    flags over an injected clock.
  * StragglerDetector — rolling per-step wall-times; a step slower than
    median + k*MAD marks the step straggling.
  * PreemptionHandler — SIGTERM/SIGINT -> checkpoint-now-then-exit flag.
  * recoverable_step — retries a step through the transient errors torch
    raises on the card (``torch_transient_errors``) after releasing the
    CUDA caching allocator's blocks (``torch_clear_caches``), the restart
    half of checkpoint/restart.  A retry runs again on the SAME device:
    nothing here moves work to the CPU.
  * RetryPolicy — the one retry/backoff schedule shared by every layer that
    retries (fabric worker respawn, lease-expiry sweeps, chaos recovery):
    bounded exponential backoff with deterministic jitter, all timing off an
    injected clock/sleep so tests and chaos runs never wall-sleep.  Its
    schedule is the reference's bit for bit for the same fields.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import signal
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``backoff_s(attempt)`` = ``min(base_s * multiplier**attempt, max_s)``
    scaled by a jitter factor drawn uniformly from ``[1 - jitter_frac,
    1 + jitter_frac]``.  The jitter rng is seeded from ``(seed, attempt)``
    (integer mix, no process-salted hashing), so the same policy produces
    the same schedule in every process and every run.

    The transport timeouts of ``MultiprocessFabric`` live here too
    (``poll_s`` result-queue poll, ``join_timeout_s`` worker shutdown,
    ``drain_timeout_s`` result drain), so one policy object describes every
    time constant a fabric run uses.
    """

    base_s: float = 0.05
    multiplier: float = 2.0
    max_s: float = 2.0
    jitter_frac: float = 0.1
    max_attempts: int = 5
    seed: int = 0
    poll_s: float = 0.05
    join_timeout_s: float = 5.0
    drain_timeout_s: float = 0.2

    def __post_init__(self):
        if self.base_s <= 0:
            raise ValueError("base_s must be > 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if self.max_s < self.base_s:
            raise ValueError("max_s must be >= base_s")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("jitter_frac must be in [0, 1)")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based), jittered, bounded by
        ``max_s * (1 + jitter_frac)``."""
        raw = min(self.base_s * self.multiplier ** attempt, self.max_s)
        rng = random.Random(self.seed * 1_000_003 + attempt)
        return raw * (1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0))

    def schedule(self) -> Tuple[float, ...]:
        """The full backoff schedule, one entry per allowed retry."""
        return tuple(self.backoff_s(a) for a in range(self.max_attempts))

    def call(self, fn: Callable, *, sleep: Callable[[float], None] = time.sleep,
             retry_on: Tuple[type, ...] = (Exception,)):
        """Run ``fn()`` with up to ``max_attempts`` tries; ``sleep`` is
        injected (a FakeClock advance in tests, ``time.sleep`` in
        production)."""
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on:
                if attempt == self.max_attempts - 1:
                    raise
                sleep(self.backoff_s(attempt))


class HeartbeatMonitor:
    """Per-host liveness registry with timeout-based failure detection.

    A host is *dead* when strictly more than ``timeout_s`` has elapsed on
    ``clock`` since its last ``beat`` (or since registration).  The clock is
    injectable, so expiry is deterministic under a fake clock.  Membership
    is dynamic: ``register`` admits a host mid-flight and ``forget`` retires
    one.
    """

    def __init__(self, hosts: List[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen: Dict[str, float] = {h: clock() for h in hosts}

    def register(self, host: str):
        """Admit ``host``, marking it alive as of now (idempotent refresh)."""
        self.last_seen[host] = self.clock()

    def forget(self, host: str):
        """Retire ``host`` from monitoring (no-op if unknown)."""
        self.last_seen.pop(host, None)

    def beat(self, host: str):
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_hosts()


class StragglerDetector:
    """Median + k*MAD outlier rule over a rolling window of step times."""

    def __init__(self, window: int = 50, k: float = 5.0, min_samples: int = 8):
        self.times = collections.deque(maxlen=window)
        self.k = k
        self.min_samples = min_samples
        self.flagged = 0

    def observe(self, step_time_s: float) -> bool:
        is_straggler = False
        if len(self.times) >= self.min_samples:
            med = statistics.median(self.times)
            mad = statistics.median(abs(t - med) for t in self.times) or 1e-6
            if step_time_s > med + self.k * mad:
                is_straggler = True
                self.flagged += 1
        self.times.append(step_time_s)
        return is_straggler

    def summary(self) -> Dict:
        if not self.times:
            return {"median_s": 0.0, "flagged": self.flagged}
        return {"median_s": statistics.median(self.times), "flagged": self.flagged}


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful checkpoint-then-exit."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
                signal.signal(signal.SIGINT, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True


def recoverable_step(step_fn: Callable, state, batch, max_retries: int = 2,
                     on_failure: Optional[Callable] = None):
    """Run ``step_fn(state, batch)``, retrying through transient runtime
    failures.

    On each failure: call ``on_failure(attempt, exc)`` (the hook that
    restores from checkpoint at real scale), release the CUDA caching
    allocator's blocks, and run the step again on the same device.
    Programming errors (TypeError, etc.) are NOT retried.
    """
    attempt = 0
    while True:
        try:
            return step_fn(state, batch)
        except (RuntimeError, *torch_transient_errors()) as e:  # noqa: B030
            attempt += 1
            if attempt > max_retries:
                raise
            if on_failure is not None:
                on_failure(attempt, e)
            torch_clear_caches()


def torch_transient_errors() -> Tuple[type, ...]:
    """The error types torch raises on the card for a failure that a retry
    may get past: an allocation the caching allocator could not satisfy
    (``torch.OutOfMemoryError``) and an error the CUDA runtime reported
    (``torch.AcceleratorError``, where this torch has it)."""
    errors = [torch.OutOfMemoryError]
    if hasattr(torch, "AcceleratorError"):
        errors.append(torch.AcceleratorError)
    return tuple(errors)


def torch_clear_caches() -> None:
    """Return the CUDA caching allocator's unused blocks to the driver —
    only where this process has initialised CUDA (never creates a context
    on a host that has not touched the card)."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
