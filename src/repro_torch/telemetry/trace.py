"""Span tracer: nested timing spans with a Chrome ``trace_event`` exporter.

``SpanTracer.span("tile_eval", tile=7)`` is a context manager that records
one ``SpanRecord`` — name, span/parent ids, nesting depth, thread id,
monotonic start/end from the injected clock, a wall-clock anchor, and the
keyword attributes.  Records land in a bounded ring buffer (a deque), so a
week-long campaign traces its most recent window instead of growing without
bound.

Two hard rules the instrumented call sites follow:

* spans wrap HOST code only — a span may surround a kernel launch, but
  then it times the enqueue and whatever wait for the device the wrapped
  call does, never the device work itself (CUDA events are the tool for
  that);
* a span is a *reading*: nothing downstream may branch on span contents
  (the frontier identity gates stay bitwise with tracing on or off).

``chrome_trace()`` renders the buffer as Chrome ``trace_event`` JSON
(complete ``"X"`` events + ``"M"`` metadata), so a sweep's trace opens
directly in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

# process-wide span id sequence: ids stay unique when several tracers run
# in one process (campaign + coordinator + tests), which the trace-report
# nesting check relies on after traces are merged
_SPAN_IDS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span (perf timestamps are the tracer clock's).

    Materialized lazily by ``SpanTracer.records`` — the hot path appends a
    plain tuple to the ring; ``wall_t0`` is derived from the tracer's wall
    anchor (``wall_epoch + (t0 - epoch)``), never a per-span syscall.
    """

    name: str
    sid: int
    parent: int            # enclosing span's sid on this thread, -1 if root
    depth: int             # nesting depth on this thread (0 = root)
    thread_id: int
    t0: float              # injected-clock start
    t1: float              # injected-clock end
    wall_t0: float         # wall-clock anchor of t0
    attrs: Dict

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _Span:
    """The live context manager; lands in the ring as a tuple on exit.

    The exit path is the instrumented sweep's per-tile cost, so it stays
    allocation-light: one tuple append onto a deque (GIL-atomic, no lock)
    and two injected-clock reads."""

    __slots__ = ("tracer", "name", "attrs", "sid", "parent", "depth", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: Dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        tracer = self.tracer
        stack = tracer._stack()
        self.sid = next(_SPAN_IDS)
        self.parent = stack[-1].sid if stack else -1
        self.depth = len(stack)
        stack.append(self)
        self.t0 = tracer.clock()            # last: exclude setup from dur
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tracer = self.tracer
        t1 = tracer.clock()
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tracer._buf.append((self.name, self.sid, self.parent, self.depth,
                            threading.get_ident(), self.t0, t1, self.attrs))
        return False


class SpanTracer:
    """Thread-aware span recorder over an injected clock.

    Nesting is tracked per thread (a prefetcher-thread span is a root on
    its own thread, not a child of whatever the main thread is doing);
    the ring buffer is shared — deque appends are GIL-atomic, so no lock
    sits on the span exit path — and one export sees every thread's spans.
    ``capacity`` bounds retained spans: eviction drops the OLDEST records,
    keeping the most recent window.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 wall_clock: Callable[[], float] = time.time,
                 capacity: int = 65536):
        self.clock = clock
        self.wall_clock = wall_clock
        self.capacity = int(capacity)
        self.epoch = clock()                # ts origin for chrome export
        self.wall_epoch = wall_clock()      # wall anchor of the epoch
        self._buf = collections.deque(maxlen=self.capacity)
        self._local = threading.local()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs) -> _Span:
        """A context manager timing one named span (attrs are free-form
        JSON-safe scalars: tile index, worker id, evaluator tier...)."""
        return _Span(self, name, attrs)

    @property
    def records(self) -> List[SpanRecord]:
        """Snapshot copy of the retained spans as ``SpanRecord``s, oldest
        first (``list(deque)`` is atomic under the GIL while writers
        append)."""
        epoch, wall_epoch = self.epoch, self.wall_epoch
        return [SpanRecord(name, sid, parent, depth, tid, t0, t1,
                           wall_epoch + (t0 - epoch), attrs)
                for name, sid, parent, depth, tid, t0, t1, attrs
                in list(self._buf)]

    def clear(self) -> None:
        self._buf.clear()

    # -- Chrome trace_event export ------------------------------------------

    def chrome_trace(self, process_name: str = "repro-torch-campaign") -> Dict:
        """The buffer as Chrome ``trace_event`` JSON (the object form).

        Complete events (``"ph": "X"``) carry microsecond ``ts`` relative
        to the tracer's epoch and ``dur``; span/parent ids, depth and the
        user attrs ride in ``args``.  Open the written file in Perfetto or
        ``chrome://tracing`` as-is.
        """
        pid = os.getpid()
        records = self.records
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        for r in sorted(records, key=lambda r: (r.t0, r.sid)):
            events.append({
                "name": r.name, "cat": "repro", "ph": "X", "pid": pid,
                "tid": r.thread_id,
                "ts": (r.t0 - self.epoch) * 1e6,
                "dur": r.dur * 1e6,
                "args": {**r.attrs, "sid": r.sid, "parent": r.parent,
                         "depth": r.depth},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"epoch_wall_s": None if not records
                              else records[0].wall_t0}}

    def export(self, path: str, process_name: str = "repro-torch-campaign") -> str:
        """Write ``chrome_trace()`` to ``path``; returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(process_name), f, indent=1)
        return path


class _NullSpan:
    """The shared do-nothing span — one instance for the whole process, so
    the disabled tracing path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracer that records nothing (the ``NullTelemetry`` default).  Its
    ``span()`` returns the process-wide ``NULL_SPAN`` singleton; the only
    per-call cost left is the caller's argument evaluation."""

    capacity = 0
    records: List[SpanRecord] = []

    def span(self, name: str = "", **attrs) -> _NullSpan:
        return NULL_SPAN

    def clear(self) -> None:
        pass

    def chrome_trace(self, process_name: str = "repro-torch-campaign") -> Dict:
        return {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}


NULL_TRACER = NullTracer()
