"""Campaign telemetry: one injectable observability object for the stack.

``Telemetry`` bundles the two observability pieces every layer shares:

* a ``MetricsRegistry`` (labeled Counter/Gauge/Histogram series,
  ``snapshot()`` -> JSON) — see ``repro_torch.telemetry.metrics``;
* a ``SpanTracer`` (nested timing spans, bounded ring buffer, Chrome
  ``trace_event`` export for Perfetto) — see ``repro_torch.telemetry.trace``;

plus the injected monotonic ``clock`` both read, which is also the clock
the instrumented call sites (``Campaign.run`` tile walls) use instead of
raw ``time.perf_counter()`` — inject a fake clock and every telemetry
timestamp in the system becomes deterministic.

``NullTelemetry`` is the default everywhere and the disabled-path
contract: **metrics still count** (they are O(1) scalar writes, and
back-compat surfaces like ``TileEvaluator.fused_launches`` read them) but
**tracing is free** — ``span()`` returns a process-wide no-op singleton,
nothing is buffered.

The one rule that keeps observability safe: no instrumented value may feed
computation.  Metrics and spans are readings; the frontier identity gates
(streamed == one-shot, instrumented == uninstrumented) stay bitwise with
telemetry on, off, or null.  Spans wrap host code only: a span around a
kernel launch times the enqueue (and any wait for the device the call does),
never the device itself.

Usage::

    from repro_torch.telemetry import Telemetry

    tel = Telemetry()
    campaign = Campaign(workloads, config, telemetry=tel)
    campaign.run()
    tel.snapshot()                        # metrics -> JSON dict
    tel.export_trace("trace.json")        # open in Perfetto
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, metric_value)
from repro_torch.telemetry.trace import (NULL_SPAN, NULL_TRACER, NullTracer,
                                   SpanRecord, SpanTracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullTelemetry",
    "SpanRecord", "SpanTracer", "Telemetry", "coerce_telemetry",
    "metric_value",
]


class Telemetry:
    """The injectable observability bundle: metrics + tracer + clock."""

    tracing = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 wall_clock: Callable[[], float] = time.time,
                 trace_capacity: int = 65536):
        self.clock = clock
        self.metrics = MetricsRegistry(clock=clock)
        self.tracer = SpanTracer(clock=clock, wall_clock=wall_clock,
                                 capacity=trace_capacity)

    # -- tracing -------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing one named span (see ``SpanTracer.span``)."""
        return self.tracer.span(name, **attrs)

    def chrome_trace(self, process_name: str = "repro-torch-campaign") -> Dict:
        return self.tracer.chrome_trace(process_name)

    def export_trace(self, path: str,
                     process_name: str = "repro-torch-campaign") -> str:
        return self.tracer.export(path, process_name)

    # -- metrics -------------------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, max_samples: int = 8192,
                  **labels) -> Histogram:
        return self.metrics.histogram(name, max_samples=max_samples, **labels)

    def snapshot(self) -> Dict:
        return self.metrics.snapshot()


class NullTelemetry(Telemetry):
    """The default: real (cheap) metrics, no tracing.

    Every component that is not handed a ``Telemetry`` constructs its OWN
    ``NullTelemetry`` — registries are per-owner, so two engines' counters
    never alias (``engine.fused_launches`` stays an engine-local reading).
    ``span()`` short-circuits to the shared no-op singleton.
    """

    tracing = False

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.metrics = MetricsRegistry(clock=clock)
        self.tracer = NULL_TRACER

    def span(self, name: str = "", **attrs):
        return NULL_SPAN


def coerce_telemetry(telemetry: Optional[Telemetry]) -> Telemetry:
    """``None`` -> a fresh per-owner ``NullTelemetry`` (the default path)."""
    return telemetry if telemetry is not None else NullTelemetry()
