"""Metrics registry: labeled Counter / Gauge / Histogram series.

The registry is the campaign stack's one source of runtime counters — the
evaluator's ``fused_launches``, candidate and survivor totals, tile and
checkpoint counts all live here as named, labeled series instead of ad-hoc
instance attributes.  Design
rules, in the order they matter:

* **instrumented values never feed computation** — a metric is a reading,
  not an input; the frontier identity gates stay bitwise whether or not
  anything reads the registry;
* **the clock is injected** — every series stamps ``updated_at`` from the
  registry's ``clock`` (default ``time.perf_counter``), so a fake clock
  makes readings fully deterministic in tests;
* **snapshots are plain JSON** — ``MetricsRegistry.snapshot()`` returns a
  dict that drops straight into the ``BENCH_*.json`` artifacts (and must
  pickle cheaply);
* **hot-path cost is one dict hit** — ``counter()/gauge()/histogram()``
  return the (cached) series object; instrumented code holds the series and
  calls ``inc``/``set``/``observe``, which are O(1) scalar ops.

Histogram quantiles follow ``numpy.percentile``'s default linear
interpolation exactly (the test oracle); samples live in a bounded ring so
a long campaign cannot grow memory, while ``count``/``sum`` keep the exact
totals across evictions.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

LabelItems = Tuple[Tuple[str, str], ...]


def _label_items(labels: Dict[str, object]) -> LabelItems:
    """Normalized, hashable label set (values stringified, keys sorted)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing numeric series (int or float increments)."""

    __slots__ = ("name", "labels", "_clock", "_value", "updated_at")

    def __init__(self, name: str, labels: LabelItems, clock):
        self.name = name
        self.labels = labels
        self._clock = clock
        self._value = 0.0
        self.updated_at: Optional[float] = None

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._value += n
        self.updated_at = self._clock()

    @property
    def value(self) -> float:
        return self._value

    def as_dict(self) -> Dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self._value, "updated_at": self.updated_at}


class Gauge:
    """Last-written value series (``None`` until first ``set``/``add``)."""

    __slots__ = ("name", "labels", "_clock", "_value", "updated_at")

    def __init__(self, name: str, labels: LabelItems, clock):
        self.name = name
        self.labels = labels
        self._clock = clock
        self._value: Optional[float] = None
        self.updated_at: Optional[float] = None

    def set(self, v: float) -> None:
        self._value = float(v)
        self.updated_at = self._clock()

    def add(self, dv: float) -> None:
        """Accumulate onto the gauge (starting from 0.0 when unset) — the
        per-worker busy-time gauges are running totals, not last-values."""
        self._value = (self._value or 0.0) + float(dv)
        self.updated_at = self._clock()

    @property
    def value(self) -> Optional[float]:
        return self._value

    def as_dict(self) -> Dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self._value, "updated_at": self.updated_at}


class Histogram:
    """Sample distribution with exact totals and windowed quantiles.

    ``count``/``sum``/``min``/``max`` are exact over every observation;
    quantiles are computed over the most recent ``max_samples`` (bounded
    ring — a mega-campaign cannot grow the registry without bound) with
    ``numpy.percentile``'s default linear interpolation.
    """

    __slots__ = ("name", "labels", "_clock", "_samples", "count", "sum",
                 "min", "max", "updated_at")

    def __init__(self, name: str, labels: LabelItems, clock,
                 max_samples: int = 8192):
        self.name = name
        self.labels = labels
        self._clock = clock
        self._samples = collections.deque(maxlen=int(max_samples))
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.updated_at: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self._samples.append(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.updated_at = self._clock()

    def quantile(self, q: float) -> Optional[float]:
        """Linear-interpolated quantile of the retained window, matching
        ``numpy.percentile(samples, q * 100)`` exactly; ``None`` when no
        sample has been observed."""
        if not self._samples:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s = sorted(self._samples)
        pos = q * (len(s) - 1)
        lo = int(pos)
        frac = pos - lo
        if frac == 0.0:
            return s[lo]
        return s[lo] + (s[lo + 1] - s[lo]) * frac

    @property
    def samples(self) -> List[float]:
        """The retained window (oldest first) — for tests and exports."""
        return list(self._samples)

    def as_dict(self) -> Dict:
        return {"name": self.name, "labels": dict(self.labels),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99), "updated_at": self.updated_at}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Process-local registry of labeled metric series.

    One registry per telemetry owner (campaign, evaluator): series with the
    same name must share one kind, and ``snapshot()`` renders every series
    deterministically sorted so two snapshots of identical activity are
    equal.  Thread-safe: the campaign prefetcher and the consuming thread
    may both touch it.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._series: Dict[Tuple[str, str, LabelItems], object] = {}
        self._kinds: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: Dict, **kw):
        items = _label_items(labels)
        key = (kind, name, items)
        series = self._series.get(key)
        if series is not None:
            return series
        with self._lock:
            series = self._series.get(key)
            if series is not None:
                return series
            prior = self._kinds.get(name)
            if prior is not None and prior != kind:
                raise ValueError(f"metric {name!r} already registered as a "
                                 f"{prior}, cannot re-register as a {kind}")
            self._kinds[name] = kind
            series = _KINDS[kind](name, items, self.clock, **kw)
            self._series[key] = series
            return series

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, max_samples: int = 8192,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, max_samples=max_samples)

    def snapshot(self) -> Dict:
        """All series as one JSON-ready dict, deterministically ordered."""
        out = {"clock_s": self.clock(),
               "counters": [], "gauges": [], "histograms": []}
        with self._lock:
            items = sorted(self._series.items())
        for (kind, _, _), series in items:
            out[kind + "s"].append(series.as_dict())
        return out


def metric_value(snapshot: Dict, name: str, kind: str = "counters",
                 default=None, **labels):
    """Read one series' value back out of a ``snapshot()`` dict, so
    consumers never hand-parse the schema."""
    want = dict(_label_items(labels))
    for row in snapshot.get(kind, ()):
        if row["name"] == name and row.get("labels", {}) == want:
            return row.get("value", row)
    return default
