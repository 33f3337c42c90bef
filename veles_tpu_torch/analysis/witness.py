"""The lock-order witness (the port's copy of
``veles_tpu/analysis/witness.py``).

The port's veleslint (``veles_tpu_torch/analysis/flow.py``) derives the
lock acquisition graph from the port's AST and keeps it as
``veles_tpu_torch/analysis/lock_order.json``, the reviewed statement of
the port's locking law, whose nodes are exactly :data:`LOCK_NAMES`.
This module watches the real locks at run time: when
``$VELES_LOCK_WITNESS`` is set, every instrumented acquire records
``(already-held lock, acquired lock)`` pairs into a process-wide table,
and a tier-1 test (``tests/test_torch_lockstep.py``) and the card's
fleet phase assert every observed edge is declared in that law.

Instrumentation is by construction: the thread-spawning modules make
their locks through the factories here (``witness.lock("batcher.queue")``
instead of a bare ``threading.Lock()``), which also gives every lock the
canonical name the reference's law uses.  Off (the default), a factory
returns the bare ``threading`` primitive, so the serving path pays
nothing.  On: one thread-local list append per acquire and a dict upsert
under a private leaf lock.

The table is published as the ``lockstep.*`` gauges and written next to
the telemetry snapshot: ``telemetry.flush()`` calls
:func:`write_snapshot`, which drops an atomic ``lockwitness-<pid>.json``
into the metrics dir, so a witnessed fleet leaves one observation file
per process for the test to union.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from veles_tpu_torch import knobs

ENV_VAR = knobs.LOCK_WITNESS

#: every name the port gives a lock through the factories below: the
#: reference's (``veles_tpu/analysis/lock_order.json``) and three of the
#: port's own, whose locks the reference does not have
#: (``tests/test_torch_lockstep.py`` pins this set to the factory calls
#: in the source, and the lock-order rule to the port's law)
LOCK_NAMES = frozenset({
    "autoscale.state", "batcher.queue", "client.results", "client.wire",
    "fleet.replica", "hive.emit", "online.buffer", "online.learner",
    "online.tap", "pool.prep", "residency.arbiter", "residency.state",
    "router.emit", "router.state", "sentinel.health",
    "telemetry.counter", "telemetry.histogram", "telemetry.journal",
    "telemetry.registry", "trace.flightrec", "trace.mint",
    "traffic.results", "web_status.state", "worker.emit",
    # the port's own
    "fused.count", "hive.stats", "lrn_cuda.build",
})

_tls = threading.local()

#: observed (holder, acquired) -> count.  The witness's own lock is a
#: bare primitive and a leaf by construction (nothing is acquired under
#: it), so it never takes part in an order violation and is not itself
#: witnessed
_table_lock = threading.Lock()
_edges: Dict[Tuple[str, str], int] = {}
_acquire_count = 0


def enabled(environ: Optional[Dict[str, str]] = None) -> bool:
    """Is the witness armed?  Read when a lock is made: an armed process
    instruments every lock it makes from then on; a disarmed one pays
    nothing."""
    return bool(knobs.get(ENV_VAR, environ))


def _held() -> List[str]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _suppressed() -> bool:
    return bool(getattr(_tls, "busy", False))


def _after_acquire(name: str) -> None:
    """Record the (held -> acquired) edges and push the name.  This runs
    while the acquired lock is held, so it must never call telemetry
    (whose own locks are witnessed: a gauge registration here would take
    the very lock being recorded and deadlock); the gauges are published
    from :func:`publish_metrics` on the flush path instead."""
    global _acquire_count
    if _suppressed():
        return
    held = _held()
    with _table_lock:
        _acquire_count += 1
        for holder in held:
            if holder == name:
                continue   # a re-entrant RLock: not an order edge
            key = (holder, name)
            _edges[key] = _edges.get(key, 0) + 1
    held.append(name)


def _after_release(name: str) -> None:
    if _suppressed():
        return
    held = _held()
    # remove the last occurrence: nested reacquisition unwinds LIFO
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


def publish_metrics() -> None:
    """Set the ``lockstep.edges_observed`` and ``lockstep.acquires``
    gauges.  Called by :func:`write_snapshot`, next to the telemetry
    flush, where the calling thread holds no witnessed lock; skipped
    (and recording suppressed) otherwise, because the gauge registration
    takes telemetry's witnessed registry lock."""
    if _suppressed() or _held():
        return
    _tls.busy = True
    try:
        from veles_tpu_torch import events, telemetry
        with _table_lock:
            n_edges = len(_edges)
            n_acq = _acquire_count
        telemetry.gauge(events.GAUGE_LOCKSTEP_EDGES).set(n_edges)
        telemetry.gauge(events.GAUGE_LOCKSTEP_ACQUIRES).set(n_acq)
    except Exception:  # noqa: BLE001 — the witness never takes down the
        pass           # run it observes
    finally:
        _tls.busy = False


class _WitnessLock:
    """Recording proxy over a ``threading.Lock`` or ``RLock``."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner) -> None:
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _after_acquire(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _after_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _WitnessCondition:
    """Recording proxy over a ``threading.Condition``.  ``wait`` releases
    the underlying lock for its duration, so the held list drops the
    name across the wait and records it again on wake-up."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = threading.Condition()

    def acquire(self, *args):
        ok = self._inner.acquire(*args)
        if ok:
            _after_acquire(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _after_release(self.name)

    def __enter__(self) -> "_WitnessCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        _after_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            _after_acquire(self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _after_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _after_acquire(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# -- the factories the instrumented modules call ------------------------

def lock(name: str):
    """A named mutex: the bare ``threading.Lock()`` when the witness is
    off, a recording proxy when armed.  ``name`` is the lock's canonical
    identity, shared with the reference's ``lock_order.json``."""
    if not enabled():
        return threading.Lock()
    return _WitnessLock(name, threading.Lock())


def rlock(name: str):
    if not enabled():
        return threading.RLock()
    return _WitnessLock(name, threading.RLock())


def condition(name: str):
    if not enabled():
        return threading.Condition()
    return _WitnessCondition(name)


# -- reading and flushing the table --------------------------------------

def observed_edges() -> List[Tuple[str, str]]:
    """Every (holder, acquired) pair seen so far, sorted."""
    with _table_lock:
        return sorted(_edges)


def acquire_count() -> int:
    with _table_lock:
        return _acquire_count


def reset() -> None:
    """Clear the table (test isolation)."""
    global _acquire_count
    with _table_lock:
        _edges.clear()
        _acquire_count = 0


def write_snapshot(directory: Optional[str] = None) -> Optional[str]:
    """Write this process's table atomically as
    ``lockwitness-<pid>.json`` into ``directory`` (default: the
    telemetry metrics dir).  ``telemetry.flush()`` calls it, so a
    witnessed subprocess leaves its edges behind.  None when there is
    nowhere to write or nothing was observed."""
    publish_metrics()
    if directory is None:
        directory = knobs.get(knobs.METRICS_DIR) or None
    if not directory:
        return None
    with _table_lock:
        if not _edges and not _acquire_count:
            return None
        payload = {
            "pid": os.getpid(),
            "acquires": _acquire_count,
            "edges": [{"from": h, "to": a, "count": c}
                      for (h, a), c in sorted(_edges.items())],
        }
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"lockwitness-{os.getpid()}.json")
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".lockwitness.",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path
    except OSError:
        return None


def read_snapshots(directory: str) -> List[Tuple[str, str]]:
    """The union of the observed edges across every
    ``lockwitness-*.json`` under ``directory`` (recursive: fleet
    replicas write into per-replica child dirs)."""
    out = set()
    for dirpath, _dirnames, filenames in os.walk(directory):
        for fn in filenames:
            if not (fn.startswith("lockwitness-") and fn.endswith(".json")):
                continue
            try:
                with open(os.path.join(dirpath, fn),
                          encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            for e in data.get("edges", []):
                out.add((e["from"], e["to"]))
    return sorted(out)
