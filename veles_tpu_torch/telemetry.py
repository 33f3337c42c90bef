"""The in-memory telemetry core: counters, gauges, histograms and the
event ring (the port's copy).

Counterpart of ``veles_tpu/telemetry.py``, its in-memory half only:

- **Counter**: a monotonic number (``counter("fleet.requests").inc()``);
  float increments accumulate seconds or bytes.
- **Gauge**: a last-write-wins level.
- **Histogram**: fixed log-spaced buckets (32 per decade over
  [1e-7, 1e7)), quantiles computed from the bucket counts with
  geometric interpolation inside the bucket, clamped to the exact
  observed min and max.  No sample is kept.  The bucket layout
  (:meth:`Histogram._index`) is the reference's, so the two compute the
  same quantiles from the same samples.  :meth:`Histogram.
  snapshot_buckets` / :meth:`Histogram.delta_quantile` give the
  windowed quantile the fleet's hedge threshold and the batcher's
  adaptive wait read.
- :func:`event` appends a state transition to an in-memory ring that
  :func:`recent_events` reads.

One process-wide :class:`Registry`; :func:`snapshot` is what a hive
answers ``op=stats`` with (``counters``, ``gauges``, ``histograms``),
and :func:`merge_snapshot` folds another process's in.

Left out here: the journal file and ``$VELES_METRICS_DIR`` persistence
(``configure``, ``flush``), ``span``, trace lineage and
``adopt_child_snapshot``.  A lock is a plain ``threading.Lock``.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: histogram bucket layout: log-spaced, 32 per decade over
#: [10^LOG_LO, 10^LOG_HI); bucket 0 is the underflow bin (x < lo,
#: including zero and negatives), the last is overflow
LOG_LO = -7
LOG_HI = 7
PER_DECADE = 32
NBUCKETS = (LOG_HI - LOG_LO) * PER_DECADE
_STEP = 10.0 ** (1.0 / PER_DECADE)

class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def _reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Last-write-wins level; ``value`` is None until first set."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v

    def _reset(self) -> None:
        self.value = None


class Histogram:
    """Fixed log-spaced buckets; quantiles from the bucket counts.

    ``record`` increments one bucket and the exact count, sum, min and
    max.  ``quantile(q)`` walks the cumulative counts to the target rank
    and interpolates geometrically inside that bucket, clamped to the
    observed [min, max]: deterministic, O(buckets), and mergeable across
    processes by adding buckets."""

    __slots__ = ("name", "count", "sum", "min", "max", "buckets",
                 "exemplars", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: List[int] = [0] * (NBUCKETS + 2)
        #: bucket index -> the last exemplar id that landed there
        self.exemplars: Dict[int, str] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _index(x: float) -> int:
        if x < 10.0 ** LOG_LO:
            return 0
        if x >= 10.0 ** LOG_HI:
            return NBUCKETS + 1
        i = int((math.log10(x) - LOG_LO) * PER_DECADE)
        return 1 + min(NBUCKETS - 1, max(0, i))

    def record(self, x: float, exemplar: Optional[str] = None) -> None:
        x = float(x)
        with self._lock:
            self.count += 1
            self.sum += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            i = self._index(x)
            self.buckets[i] += 1
            if exemplar is not None:
                self.exemplars[i] = exemplar

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (q in [0, 1]) from the bucket counts."""
        if self.count == 0:
            return None
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            if cum + c >= target:
                if i == 0:
                    return self.min
                if i == NBUCKETS + 1:
                    return self.max
                e0 = 10.0 ** (LOG_LO + (i - 1) / PER_DECADE)
                frac = (target - cum) / c
                v = e0 * (_STEP ** frac)
                return min(max(v, self.min), self.max)
            cum += c
        return self.max

    def snapshot_buckets(self) -> Any:
        """An opaque (bucket counts, count) base for
        :meth:`delta_quantile`: take one at each window edge."""
        with self._lock:
            return list(self.buckets), self.count

    def delta_quantile(self, base: Any, q: float,
                       min_count: int = 1) -> Optional[float]:
        """The q-quantile of only the samples recorded since ``base`` (a
        :meth:`snapshot_buckets` result).  None when fewer than
        ``min_count`` samples landed in the window."""
        base_buckets, base_count = base
        with self._lock:
            delta = [b - p for b, p in zip(self.buckets, base_buckets)]
            n = self.count - base_count
        if n < max(1, min_count):
            return None
        target = max(1, math.ceil(q * n))
        cum = 0
        for i, c in enumerate(delta):
            if c <= 0:
                continue
            if cum + c >= target:
                if i == 0:
                    return 10.0 ** LOG_LO
                if i == NBUCKETS + 1:
                    return 10.0 ** LOG_HI
                e0 = 10.0 ** (LOG_LO + (i - 1) / PER_DECADE)
                frac = (target - cum) / c
                return e0 * (_STEP ** frac)
            cum += c
        return None

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            d: Dict[str, Any] = {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": {str(i): c
                            for i, c in enumerate(self.buckets) if c},
            }
            if self.exemplars:
                d["exemplars"] = {str(i): t
                                  for i, t in self.exemplars.items()}
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            d[key] = self.quantile(q)
        return d

    def merge_dict(self, d: Dict[str, Any]) -> None:
        """Bucket-wise merge of a :meth:`to_dict` (its quantile keys are
        ignored: they are recomputed from the buckets)."""
        with self._lock:
            self.count += int(d.get("count", 0))
            self.sum += float(d.get("sum", 0.0))
            if d.get("min") is not None:
                self.min = min(self.min, float(d["min"]))
            if d.get("max") is not None:
                self.max = max(self.max, float(d["max"]))
            for i, c in (d.get("buckets") or {}).items():
                self.buckets[int(i)] += int(c)
            for i, t in (d.get("exemplars") or {}).items():
                self.exemplars.setdefault(int(i), str(t))

    def _reset(self) -> None:
        with self._lock:
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf
            self.buckets = [0] * (NBUCKETS + 2)
            self.exemplars = {}


class Registry:
    """A namespace of metrics; the module-level one is the process's."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            with self._lock:
                c = self.counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            with self._lock:
                g = self.gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.setdefault(name, Histogram(name))
        return h

    def snapshot(self) -> Dict[str, Any]:
        """The registry as one JSON-ready dict (cumulative totals)."""
        return {
            "counters": {n: c.value for n, c in
                         sorted(self.counters.items()) if c.value},
            "gauges": {n: g.value for n, g in
                       sorted(self.gauges.items())
                       if g.value is not None},
            "histograms": {n: h.to_dict() for n, h in
                           sorted(self.histograms.items()) if h.count},
        }

    def merge_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fold another process's snapshot in: counters and buckets add;
        a gauge is filled only where this registry has no value."""
        for n, v in (snap.get("counters") or {}).items():
            self.counter(n).inc(v)
        for n, v in (snap.get("gauges") or {}).items():
            if self.gauge(n).value is None:
                self.gauge(n).value = v
        for n, d in (snap.get("histograms") or {}).items():
            self.histogram(n).merge_dict(d)

    def reset(self) -> None:
        """Zero every metric in place: references held elsewhere stay
        wired to the registry."""
        for c in self.counters.values():
            c._reset()
        for g in self.gauges.values():
            g._reset()
        for h in self.histograms.values():
            h._reset()


#: the process registry
_registry = Registry()

#: in-memory ring of recent events
_recent: "deque[Dict[str, Any]]" = deque(maxlen=4096)


def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


def event(name: str, **fields: Any) -> None:
    """Keep one state-transition event in the in-memory ring, stamped
    with the wall clock (``ts``) and the monotonic one (``mono``)."""
    rec: Dict[str, Any] = {"ts": round(time.time(), 3),
                           "mono": round(time.monotonic(), 6),
                           "event": name}
    rec.update(fields)
    _recent.append(rec)


def recent_events(name: Optional[str] = None) -> List[Dict[str, Any]]:
    evs = list(_recent)
    if name is not None:
        evs = [e for e in evs if e.get("event") == name]
    return evs


def snapshot() -> Dict[str, Any]:
    snap = _registry.snapshot()
    snap["pid"] = os.getpid()
    snap["ts"] = round(time.time(), 3)
    return snap


def merge_snapshot(snap: Dict[str, Any]) -> None:
    _registry.merge_snapshot(snap)


def reset() -> None:
    """Zero every metric in place and clear the event ring."""
    _registry.reset()
    _recent.clear()
