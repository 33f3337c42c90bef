"""The telemetry core: counters, gauges, histograms, spans, the event
ring and the run journal (the port's copy).

Counterpart of ``veles_tpu/telemetry.py``:

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
- **Spans** (``with span("ga.cohort_train"):``) nest through a
  thread-local stack (:func:`span_stack`) and feed the histogram of the
  same name; ``journal=True`` also appends an event.  A span reads the
  host's clock only: it never waits for the device.
- :func:`event` appends a state transition to an in-memory ring that
  :func:`recent_events` reads, and to the journal.

One process-wide :class:`Registry`; :func:`snapshot` is what a hive
answers ``op=stats`` with (``counters``, ``gauges``, ``histograms``),
and :func:`merge_snapshot` folds another process's in.

**Persistence**, in the reference's formats, so the port's reader
(:mod:`veles_tpu_torch.obs`, ``python -m veles_tpu_torch.tools.obs_report``)
and the reference's read a port's dir:
when ``$VELES_METRICS_DIR`` is set, or :func:`configure` ran (which
exports the variable, so every child process inherits it), each process
appends its events to ``journal-<pid>.jsonl`` (flushed per line, except
the per-request ``trace.*`` family, whose records wait in memory and are
encoded and written by the next notable event or flush, off the
request's path) and
writes its cumulative snapshot to ``metrics-<pid>.json`` with a
tempfile and ``os.replace``, so a reader never sees a torn file.  A
snapshot is written by :func:`flush` (explicit, and at exit), and by the
throttled :func:`maybe_flush` (at most every :data:`FLUSH_EVERY`
seconds, on a thread of its own, never on the emitting one).
:func:`adopt_child_snapshot` folds a dead child's snapshot into this
registry and renames its file ``*.merged``.  :func:`set_enabled`
(False) reduces every call to one module-attribute load and a falsy
check.  Telemetry never takes down a run: a file error drops the sink
and the counting goes on in memory.

Every lock here comes from the lock-order witness's factories
(``veles_tpu_torch/analysis/witness.py``) under the reference's names
(``telemetry.counter``, ``.histogram``, ``.registry``, ``.journal``),
and :func:`flush` writes the witness's snapshot and its ``lockstep.*``
gauges beside the metrics snapshot.  :func:`set_trace_provider` is the
seam through which ``veles_tpu_torch/trace.py`` stamps the current trace
onto every event.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from veles_tpu_torch import knobs
from veles_tpu_torch.analysis import witness

ENV_DIR = knobs.METRICS_DIR

#: histogram bucket layout: log-spaced, 32 per decade over
#: [10^LOG_LO, 10^LOG_HI); bucket 0 is the underflow bin (x < lo,
#: including zero and negatives), the last is overflow
LOG_LO = -7
LOG_HI = 7
PER_DECADE = 32
NBUCKETS = (LOG_HI - LOG_LO) * PER_DECADE
_STEP = 10.0 ** (1.0 / PER_DECADE)

#: the kill switch: when False every record, inc and event is one
#: attribute load and a falsy check
_enabled = True


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0
        self._lock = witness.lock("telemetry.counter")

    def inc(self, n: float = 1) -> None:
        if not _enabled:
            return
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
        if not _enabled:
            return
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
        self._lock = witness.lock("telemetry.histogram")

    @staticmethod
    def _index(x: float) -> int:
        if x < 10.0 ** LOG_LO:
            return 0
        if x >= 10.0 ** LOG_HI:
            return NBUCKETS + 1
        i = int((math.log10(x) - LOG_LO) * PER_DECADE)
        return 1 + min(NBUCKETS - 1, max(0, i))

    def record(self, x: float, exemplar: Optional[str] = None) -> None:
        if not _enabled:
            return
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
        return self.quantiles((q,))[0]

    def quantiles(self, qs, nonzero=None) -> List[Optional[float]]:
        """The quantiles ``qs`` (ascending, each in [0, 1]) in one walk
        of the buckets: what :meth:`quantile` gives for each.
        ``nonzero``, the [(index, count)] of the non-empty buckets, spares
        the scan for it."""
        if self.count == 0:
            return [None] * len(qs)
        if nonzero is None:
            nonzero = [(i, c) for i, c in enumerate(self.buckets) if c]
        targets = [max(1, math.ceil(q * self.count)) for q in qs]
        out: List[Optional[float]] = []
        k, cum = 0, 0
        for i, c in nonzero:
            while cum + c >= targets[k]:
                if i == 0:
                    out.append(self.min)
                elif i == NBUCKETS + 1:
                    out.append(self.max)
                else:
                    e0 = 10.0 ** (LOG_LO + (i - 1) / PER_DECADE)
                    v = e0 * (_STEP ** ((targets[k] - cum) / c))
                    out.append(min(max(v, self.min), self.max))
                k += 1
                if k == len(targets):
                    return out
            cum += c
        return out + [self.max] * (len(targets) - k)

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
            nonzero = [(i, c) for i, c in enumerate(self.buckets) if c]
            d: Dict[str, Any] = {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": {str(i): c for i, c in nonzero},
            }
            if self.exemplars:
                d["exemplars"] = {str(i): t
                                  for i, t in self.exemplars.items()}
        d["p50"], d["p90"], d["p99"] = self.quantiles((0.5, 0.9, 0.99),
                                                      nonzero)
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
        self._lock = witness.lock("telemetry.registry")
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

#: in-memory ring of recent events (read even with no metrics dir)
_recent: "deque[Dict[str, Any]]" = deque(maxlen=4096)

_dir: Optional[str] = knobs.get(ENV_DIR) or None
_journal_file = None
_journal_lock = witness.lock("telemetry.journal")
_last_flush = 0.0
#: seconds between the throttled snapshot writes
FLUSH_EVERY = 5.0

_tls = threading.local()


def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


def metrics_dir() -> Optional[str]:
    return _dir


def _close_journal() -> None:
    global _journal_file
    with _journal_lock:
        _write_pending()
        if _journal_file is not None:
            try:
                _journal_file.close()
            except OSError:
                pass
            _journal_file = None


#: bumped by :func:`configure` and :func:`reset`: a flush that began
#: under an older generation writes nothing (see :func:`flush`)
_generation = 0


def configure(metrics_dir: Optional[str]) -> None:
    """Point persistence at ``metrics_dir`` (None tears it down), and
    export ``$VELES_METRICS_DIR`` so child processes inherit it."""
    global _dir, _generation
    _generation += 1
    _close_journal()
    _dir = metrics_dir or None
    if _dir:
        os.makedirs(_dir, exist_ok=True)
        os.environ[ENV_DIR] = _dir
    else:
        os.environ.pop(ENV_DIR, None)


#: per-request ``trace.*`` records not yet in the journal: appended by the
#: emitting thread (a deque's append needs no lock), encoded and written
#: by the next notable event, :func:`flush` (the throttled one runs on its
#: own thread) or the first emitter past :data:`TRACE_PENDING_MAX`.  The
#: writer offers the GIL back every :data:`TRACE_WRITE_CHUNK` lines, so
#: one chunk's encoding holds the serving threads up for a fraction of a
#: millisecond (``tools/trace_cost.py`` times a line's: ``journal_line``)
_trace_pending: deque = deque()
TRACE_PENDING_MAX, TRACE_WRITE_CHUNK = 4096, 32


def _open_journal():
    """The journal file (opened on first use); None without one.  The
    caller holds ``_journal_lock``."""
    global _journal_file
    if _journal_file is None:
        try:
            os.makedirs(_dir, exist_ok=True)
            _journal_file = open(
                os.path.join(_dir, f"journal-{os.getpid()}.jsonl"), "a",
                buffering=1 << 16)
        except OSError:
            return None
    return _journal_file


def _write_lines(recs) -> None:
    """Append ``recs`` to the journal.  The caller holds
    ``_journal_lock``."""
    global _journal_file
    f = _open_journal()
    if f is None:
        return
    try:
        f.write("".join(json.dumps(r) + "\n" for r in recs))
    except (OSError, ValueError):
        # a full or vanished disk: drop the sink, keep the ring
        try:
            f.close()
        except OSError:
            pass
        _journal_file = None


def _write_pending() -> None:
    """Write the waiting ``trace.*`` records, oldest first,
    :data:`TRACE_WRITE_CHUNK` at a time with the GIL offered to the
    serving threads between chunks.  The caller holds ``_journal_lock``."""
    while True:
        recs = []
        while len(recs) < TRACE_WRITE_CHUNK:
            try:
                recs.append(_trace_pending.popleft())
            except IndexError:
                break
        if recs and _dir:
            _write_lines(recs)
        if len(recs) < TRACE_WRITE_CHUNK:
            return
        time.sleep(0)


def _journal(rec: Dict[str, Any], traced: bool) -> None:
    global _journal_file
    if not _dir:
        return
    if traced:
        # the per-request family is encoded and written off the request's
        # path: a JSON line on the emitting thread is paid inside every
        # traced request's latency
        _trace_pending.append(rec)
        if len(_trace_pending) <= TRACE_PENDING_MAX:
            return
    with _journal_lock:
        # a notable event reaches the disk at once (a drill polls live
        # journals), every earlier line before it
        _write_pending()
        if traced:
            return
        _write_lines([rec])
        if _journal_file is not None:
            try:
                _journal_file.flush()
            except (OSError, ValueError):
                try:
                    _journal_file.close()
                except OSError:
                    pass
                _journal_file = None


#: a zero-argument callable returning (trace_id, span_id) while a
#: sampled trace context is parked on this thread, else None
_trace_provider: Optional[Any] = None


def set_trace_provider(fn: Optional[Any]) -> None:
    global _trace_provider
    _trace_provider = fn


def event(name: str, **fields: Any) -> None:
    """Record one state-transition event in the ring and the journal,
    stamped with the wall clock (``ts``) and the monotonic one
    (``mono``: ``veles_tpu/obs.py`` interleaves processes by it), and
    with ``trace``/``span`` where a trace provider names them (the
    caller's own fields win)."""
    if not _enabled:
        return
    rec: Dict[str, Any] = {"ts": round(time.time(), 3),
                           "mono": round(time.monotonic(), 6),
                           "event": name}
    rec.update(fields)
    # every ``trace.*`` event names its own trace and span
    if _trace_provider is not None and not ("trace" in fields
                                            and "span" in fields):
        try:
            t = _trace_provider()
        except Exception:  # noqa: BLE001 — tracing never breaks the
            t = None       # journal
        if t is not None:
            rec.setdefault("trace", t[0])
            rec.setdefault("span", t[1])
    _recent.append(rec)
    _journal(rec, name.startswith("trace."))
    _maybe_flush()


def recent_events(name: Optional[str] = None) -> List[Dict[str, Any]]:
    evs = list(_recent)
    if name is not None:
        evs = [e for e in evs if e.get("event") == name]
    return evs


@contextlib.contextmanager
def span(name: str, journal: bool = False, **fields: Any):
    """Time a block (host clock) into ``histogram(name)``.  Spans nest
    through a thread-local stack; ``journal=True`` also emits an event
    at exit with the seconds, the parent span and the caller's
    fields."""
    if not _enabled:
        yield name
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield name
    finally:
        dt = time.perf_counter() - t0
        if stack and stack[-1] == name:
            stack.pop()
        histogram(name).record(dt)
        if journal:
            event(name, seconds=round(dt, 6), parent=parent,
                  depth=len(stack), **fields)


def span_stack() -> List[str]:
    """The current thread's open spans, outermost first."""
    return list(getattr(_tls, "stack", []) or [])


def snapshot() -> Dict[str, Any]:
    snap = _registry.snapshot()
    snap["pid"] = os.getpid()
    snap["ts"] = round(time.time(), 3)
    return snap


def merge_snapshot(snap: Dict[str, Any]) -> None:
    _registry.merge_snapshot(snap)


def flush() -> Optional[str]:
    """Write this process's cumulative snapshot to ``metrics-<pid>.json``
    (a tempfile, then ``os.replace``), push the journal's buffer to the
    disk and write the lock witness's snapshot beside them.  None, and
    nothing written, without a metrics dir; never raises on a file
    error.  A flush that :func:`configure` or :func:`reset` overtook
    writes nothing: the throttled flush runs on a thread of its own, and
    its snapshot, taken after a reset, would replace the last one
    written into the old dir with the reset registry's."""
    global _last_flush
    d, gen = _dir, _generation
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"metrics-{os.getpid()}.json")
        fd, tmp = tempfile.mkstemp(
            dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
        try:
            # one string, then one write: json.dump's chunked writes cost
            # several times more, on a thread that shares the GIL with
            # the serving path
            text = json.dumps(snapshot())
            with os.fdopen(fd, "w") as f:
                if gen != _generation:
                    raise OSError("telemetry reconfigured during the "
                                  "flush")
                f.write(text)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        with _journal_lock:
            _write_pending()
            if _journal_file is not None:
                _journal_file.flush()
        witness.write_snapshot(d)
        _last_flush = time.monotonic()
        return path
    except OSError:
        return None


#: the throttled flush's thread (one a process, started at its first
#: flush) and its wake-up
_flusher: Optional[threading.Thread] = None
_flush_wake = threading.Event()


def _flush_loop() -> None:
    while True:
        _flush_wake.wait()
        _flush_wake.clear()
        try:
            flush()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _maybe_flush() -> None:
    # the snapshot write (1-3 ms) runs on a thread of its own: paid on
    # the emitting thread it would land in a serving request's latency.
    # The thread lives on: starting one a flush would make the emitting
    # thread wait for it to run, inside whichever request emitted
    global _last_flush, _flusher
    if _dir and time.monotonic() - _last_flush > FLUSH_EVERY:
        _last_flush = time.monotonic()   # even on failure: no storms
        if _flusher is None or not _flusher.is_alive():
            _flusher = threading.Thread(target=_flush_loop, daemon=True,
                                        name="telemetry-flush")
            _flusher.start()
        _flush_wake.set()


def maybe_flush() -> None:
    """The throttled flush (at most once per :data:`FLUSH_EVERY`
    seconds) a long-lived process calls from its heartbeat loop: a
    SIGKILLed one leaves a snapshot at most a heartbeat and
    :data:`FLUSH_EVERY` old."""
    _maybe_flush()


def adopt_child_snapshot(pid: int) -> bool:
    """Merge a child process's ``metrics-<pid>.json`` into this registry
    and rename it ``*.merged``, so a reader of the dir does not count it
    twice.  True when a file was merged."""
    d = _dir
    if not d:
        return False
    path = os.path.join(d, f"metrics-{pid}.json")
    if not os.path.isfile(path):
        return False
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return False
    merge_snapshot(snap)
    try:
        os.replace(path, path + ".merged")
    except OSError:
        pass
    return True


def reset() -> None:
    """Zero every metric in place, clear the event ring, drop the
    journal handle and re-read ``$VELES_METRICS_DIR`` (the tests' clean
    slate); references held elsewhere stay wired."""
    global _dir, _last_flush, _generation
    _generation += 1
    _registry.reset()
    _recent.clear()
    _close_journal()
    _dir = knobs.get(ENV_DIR) or None
    _last_flush = 0.0
    if getattr(_tls, "stack", None):
        _tls.stack = []


atexit.register(flush)
