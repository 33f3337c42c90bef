"""Fleet-wide causal tracing and the flight recorder (the port's copy of
``veles_tpu/trace.py``).

Telemetry (``veles_tpu_torch/telemetry.py``) answers "how fast" per
process; this module answers "what happened to this request" after the
fleet router fans it across replicas, the sentinel hedges it, the
batcher coalesces it and the online tap feeds it into a replay buffer.
Two pieces:

- **TraceContext**: ``(trace_id, span_id, parent_id, sampled)``, minted
  once at the router's admission edge (:func:`mint`, head-based
  sampling at ``$VELES_TRACE_SAMPLE`` by error diffusion, so the
  sampled fraction is exact) and carried on every wire hop in the
  ``trace``/``span``/``parent``/``sampled`` JSONL fields (registered in
  ``serve/protocol.py``).  Each hop derives its own span with
  :meth:`TraceContext.child`; :func:`use` parks the context on the
  thread, so every journaled telemetry event inside the block carries
  ``trace``/``span`` (telemetry's trace-provider seam), and
  ``veles_tpu_torch/obs.py`` assembles the ``journal-*.jsonl`` files of
  all processes by trace id.

- **The flight recorder**: a fixed-size in-memory ring of recent spans
  and events (:func:`record`: no I/O, always armed), dumped to
  ``flightrec-<pid>-<n>-<reason>.json`` in the metrics dir
  (:func:`dump`, tempfile + ``os.replace``) on a SIGTERM drain, an
  injected SIGKILL (``faults.py``), a sentinel ejection and a promotion
  gate's verdict, so each ships with the trace tail that explains it.

Tracing never takes down serving: an unsampled context costs one
attribute check per hop, :func:`record` is a deque append, and
:func:`dump` swallows file errors.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from veles_tpu_torch import events, knobs, telemetry
from veles_tpu_torch.analysis import witness

#: the wire fields that carry a trace context; each is registered in
#: ``veles_tpu_torch/serve/protocol.py``
K_TRACE = "trace"
K_SPAN = "span"
K_PARENT = "parent"
K_SAMPLED = "sampled"
WIRE_FIELDS = ("trace", "span", "parent", "sampled")


#: the ids' generator: seeded once a process from the OS, and again in a
#: forked child, which must draw its own.  A system call an id (an
#: ``os.urandom``, or an ``os.getpid`` to notice a fork) lets another
#: thread take the GIL in the middle of a traced request's hop
_gen: Optional[random.Random] = None


def _reseed() -> None:
    global _gen
    _gen = random.Random(int.from_bytes(os.urandom(16), "big"))


os.register_at_fork(after_in_child=_reseed)


def _hex(nbytes: int) -> str:
    if _gen is None:
        _reseed()
    return f"{_gen.getrandbits(8 * nbytes):0{2 * nbytes}x}"


def new_span_id() -> str:
    """A fresh 8-hex span id for an event that links several traces
    instead of belonging to one (the batcher's coalesced dispatch)."""
    return _hex(4)


class TraceContext:
    """One causal hop: the trace (the whole request tree), this hop's
    span, the span that caused it, and the head-sampling bit."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id or _hex(4)
        self.parent_id = parent_id
        self.sampled = bool(sampled)

    def child(self) -> "TraceContext":
        """A new span under this one (same trace, same sampling)."""
        return TraceContext(self.trace_id, _hex(4), self.span_id,
                            self.sampled)

    def fields(self) -> Dict[str, Any]:
        """Journal-ready ``trace``/``span``/``parent`` fields."""
        d: Dict[str, Any] = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id:
            d["parent"] = self.parent_id
        return d

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_id} sampled={self.sampled})")


# -- minting (the router's admission edge) -------------------------------

_mint_lock = witness.lock("trace.mint")
_acc = 0.0


def mint(environ: Optional[Dict[str, str]] = None) -> TraceContext:
    """A root context.  Head-based sampling by error diffusion (``acc +=
    rate``; sampled when ``acc >= 1``, the tap's rule): the sampled
    fraction of any request stream is exactly ``$VELES_TRACE_SAMPLE``,
    so rate 0 and rate 1 compare on identical traffic."""
    global _acc
    rate = max(0.0, min(1.0, float(knobs.get(knobs.TRACE_SAMPLE,
                                             environ))))
    with _mint_lock:
        _acc += rate
        sampled = _acc >= 1.0
        if sampled:
            _acc -= 1.0
    return TraceContext(_hex(8), _hex(4), None, sampled)


# -- the thread-local current context ------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context parked on this thread (None outside :func:`use`)."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    """Park ``ctx`` on this thread for the block: journaled telemetry
    events inside carry its trace and span, and :func:`record` stamps
    ring entries with it.  The previous context comes back after."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


# -- wire propagation ----------------------------------------------------

def to_wire(msg: Dict[str, Any],
            ctx: Optional[TraceContext]) -> Dict[str, Any]:
    """Stamp ``ctx`` onto an outgoing wire message in place.  Only a
    sampled context rides the wire: rate 0 adds no bytes to a hop."""
    if ctx is not None and ctx.sampled:
        msg[K_TRACE] = ctx.trace_id
        msg[K_SPAN] = ctx.span_id
        if ctx.parent_id:
            msg[K_PARENT] = ctx.parent_id
        msg[K_SAMPLED] = 1
    return msg


def from_wire(job: Dict[str, Any]) -> Optional[TraceContext]:
    """The sender's context read off an incoming message (None when the
    hop carried none).  The receiver's own work runs under
    ``use(from_wire(job).child())`` so its spans parent correctly."""
    tid = job.get(K_TRACE)
    if not tid:
        return None
    return TraceContext(str(tid), str(job.get(K_SPAN) or _hex(4)),
                        job.get(K_PARENT), bool(job.get(K_SAMPLED, 1)))


# -- the flight recorder -------------------------------------------------

_rec_lock = witness.lock("trace.flightrec")
_ring: "deque[Dict[str, Any]]" = deque(
    maxlen=max(16, int(knobs.get(knobs.FLIGHTREC_CAP))))
_dump_seq = 0


def record(name: str, ctx: Optional[TraceContext] = None,
           **fields: Any) -> None:
    """Append one entry to the always-armed ring.  No I/O: the hot path
    (each request leg, each dispatch) may call it freely; the entry
    leaves memory only on :func:`dump`."""
    rec: Dict[str, Any] = {"ts": round(time.time(), 3),
                           "mono": round(time.monotonic(), 6),
                           "ev": name}
    c = ctx if ctx is not None else current()
    if c is not None:
        rec["trace"] = c.trace_id
        rec["span"] = c.span_id
    rec.update(fields)
    with _rec_lock:
        _ring.append(rec)


def ring_entries() -> Tuple[Dict[str, Any], ...]:
    """The ring's entries, oldest first."""
    with _rec_lock:
        return tuple(_ring)


def dump(reason: str,
         metrics_dir: Optional[str] = None) -> Optional[str]:
    """Write the ring and the telemetry event ring's tail to
    ``flightrec-<pid>-<n>-<reason>.json`` (tempfile + ``os.replace``: a
    reader never sees a torn dump).  The path, or None when no metrics
    dir is configured or the write failed: a dump never takes a dying
    process down harder."""
    global _dump_seq
    d = metrics_dir or telemetry.metrics_dir()
    if not d:
        return None
    reason = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(reason)) or "dump"
    with _rec_lock:
        _dump_seq += 1
        seq = _dump_seq
        ring = list(_ring)
    payload = {"pid": os.getpid(), "reason": reason,
               "ts": round(time.time(), 3),
               "mono": round(time.monotonic(), 6),
               "ring": ring,
               "journal_tail": telemetry.recent_events()[-256:]}
    path = os.path.join(d, f"flightrec-{os.getpid()}-{seq}-{reason}.json")
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    except (OSError, ValueError, TypeError):
        return None
    telemetry.event(events.EV_FLIGHTREC_DUMP, reason=reason,
                    entries=len(ring), path=os.path.basename(path))
    return path


# -- the telemetry provider seam -----------------------------------------

def _provider() -> Optional[Tuple[str, str]]:
    c = current()
    if c is None or not c.sampled:
        return None
    return c.trace_id, c.span_id


telemetry.set_trace_provider(_provider)
