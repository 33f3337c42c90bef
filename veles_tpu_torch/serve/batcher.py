"""The dynamic micro-batching loop.

Counterpart of ``veles_tpu/serve/batcher.py`` with the same semantics:
one request is one or more sample rows; one DISPATCH is one fixed-shape
zero-padded chunk of ``max_batch`` rows.  Concurrent :meth:`submit`
calls append to a queue and a flush thread dispatches as soon as
``max_batch`` rows have coalesced or the oldest request has waited
``max_wait_s``.  Whole requests coalesce; only a request larger than
``max_batch`` on its own is split across consecutive dispatches, and
its Future resolves when the last slice lands.  A request still fully
queued past its ``deadline_ms`` (absolute unix-epoch ms) is dropped
with :class:`DeadlineExpired` instead of dispatched.  A failed dispatch
fails exactly the requests it carried.

:attr:`last_activity` is the monotonic time of the last submit or
resolve: with an empty queue, ``now - last_activity`` is the serving
idle gap the online scavenger (``online/trainer.py``) trains in.

The wait is adaptive by default (``$VELES_SERVE_ADAPTIVE_WAIT``), as in
the reference: the batcher keeps the inter-arrival gaps in a local
windowed histogram and, once it has an estimate, compares the quiet time
since the last submit against a pace bar (2x the windowed median gap,
clamped into [max_wait_s/20, max_wait_s]).  Arrivals that keep pace
while the batch is predicted to fill stretch the window up to
``$VELES_SERVE_WAIT_STRETCH`` x ``max_wait_s``; quiet past the bar
collapses a stretched window back to the static deadline.  No window
flushes before the static deadline would have, and the cold start (no
estimate yet) is exactly the static behaviour.

Telemetry, under the reference's names (``veles_tpu_torch/events.py``):
``serve.batches``, ``serve.rows`` and ``serve.batch_slots`` counters,
``serve.batch_rows``, ``serve.wait_seconds`` and
``serve.request_seconds`` histograms, the ``serve.queue_depth`` gauge;
the engine records ``serve.dispatch_seconds``.  The fault point
``hive.slow_dispatch`` (``label`` = the model) stalls a dispatch.  The
loop also keeps plain counters (:attr:`dispatches`, :attr:`rows`,
:attr:`max_rows`).

Tracing (``veles_tpu_torch/trace.py``): a request submitted with a
sampled ``ctx`` journals ``trace.serve`` when it resolves, its queue wait
(``wait_s``), its dispatch (``dispatch_s``, read around the dispatch
call, which returns host arrays) and its total (``total_s``), and its
trace id rides the wait and request histograms as their exemplar.  Each
dispatch that carried a traced request journals ``trace.batch`` with one
link per request it carried, once its answers are out, and records
``serve.batch`` in the flight recorder's ring.  The queue's condition is
the witness's ``batcher.queue``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, faults, knobs, telemetry, trace
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.ops import batching


class DeadlineExpired(RuntimeError):
    """A queued request's ``deadline_ms`` passed before its dispatch."""


class _Pending:
    """One submitted request: its rows, result slices, and Future."""

    __slots__ = ("rows", "future", "t0", "results", "taken", "popped",
                 "deadline_ms", "ctx", "wait_s")

    def __init__(self, rows: np.ndarray,
                 deadline_ms: Optional[float] = None,
                 ctx: Optional[trace.TraceContext] = None) -> None:
        self.rows = rows
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        self.deadline_ms = deadline_ms
        #: the request's sampled span (None when untraced)
        self.ctx = ctx
        #: seconds queued before its first dispatch (trace.serve)
        self.wait_s: Optional[float] = None
        self.results: List[np.ndarray] = []
        #: rows already handed to a dispatch
        self.taken = 0
        #: fully taken off the queue (counts toward _inflight)
        self.popped = False


class MicroBatcher:
    """Coalesce concurrent row requests into fixed-shape dispatches.

    ``dispatch(xb) -> np.ndarray`` receives the padded
    ``(max_batch, *sample_shape)`` array and returns per-row outputs at
    the same leading shape."""

    def __init__(self, dispatch: Callable[[np.ndarray], np.ndarray],
                 max_batch: int, max_wait_s: float,
                 label: str = "serve",
                 sample_shape: Optional[Tuple[int, ...]] = None) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0.0, float(max_wait_s))
        self.label = label
        self._cond = witness.condition("batcher.queue")
        self._queue: "deque[_Pending]" = deque()
        #: per-sample shape; pinned by the first request when unset
        self._sample_shape = tuple(sample_shape) if sample_shape \
            else None
        #: adaptive-wait state (mutated under _cond): a local
        #: inter-arrival-gap histogram and the cached windowed estimate
        self._adaptive = bool(knobs.get(knobs.SERVE_ADAPTIVE_WAIT)) \
            and self.max_wait_s > 0.0
        self._stretch = max(1.0, float(
            knobs.get(knobs.SERVE_WAIT_STRETCH)))
        self._gap_hist = telemetry.Histogram(
            f"batcher.{label}.gap") if self._adaptive else None
        self._last_arrival: Optional[float] = None
        self._gap_base = None
        self._gap_cache: Tuple[Optional[float], float] = (None, 0.0)
        self._queued_rows = 0
        self._inflight = 0          # requests taken but not resolved
        #: monotonic time of the last submit or resolve
        self.last_activity = time.monotonic()
        self._closed = False
        #: counters (written by the flush thread only)
        self.dispatches = 0
        self.rows = 0
        self.max_rows = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"batcher-{label}")
        self._thread.start()

    # -- producer side -------------------------------------------------

    def submit(self, rows: Any, deadline_ms: Optional[float] = None,
               ctx: Optional[trace.TraceContext] = None) -> Future:
        """Enqueue one request; returns a Future of its per-row outputs
        in request order.  Thread-safe; never blocks on the device.
        ``ctx`` (a sampled span) makes the request's coalescing visible:
        its ``trace.serve`` event splits wait and dispatch, and the
        dispatch that carried it links its span (``trace.batch``)."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 0 or len(rows) == 0:
            raise ValueError("a request needs at least one sample row")
        p = _Pending(rows, float(deadline_ms)
                     if deadline_ms is not None else None,
                     ctx=ctx if ctx is not None and ctx.sampled else None)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"batcher {self.label!r} is closed")
            # requests coalesce by concatenation: a mismatched sample
            # shape bounces here instead of poisoning a whole batch
            shape = tuple(rows.shape[1:])
            if self._sample_shape is None:
                self._sample_shape = shape
            elif shape != self._sample_shape:
                raise ValueError(
                    f"request rows have sample shape {shape}, but "
                    f"{self.label!r} serves {self._sample_shape}")
            self._queue.append(p)
            self._queued_rows += len(rows)
            if self._gap_hist is not None:
                now = time.perf_counter()
                if self._last_arrival is not None:
                    self._gap_hist.record(now - self._last_arrival)
                self._last_arrival = now
            self.last_activity = time.monotonic()
            telemetry.gauge(events.GAUGE_SERVE_QUEUE_DEPTH).set(
                self._queued_rows)
            self._cond.notify_all()
        return p.future

    @property
    def pending_rows(self) -> int:
        """Queued rows + in-flight requests (plain int reads)."""
        return self._queued_rows + self._inflight

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and every taken request has
        resolved.  False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
        return True

    def close(self) -> None:
        """Refuse new submissions, drain what was accepted, and stop
        the flush thread."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self.drain()
        self._thread.join(timeout=5.0)

    # -- flush loop ----------------------------------------------------

    def _gap_estimate(self, now: float) -> Optional[float]:
        """Median inter-arrival gap of the recent window, in seconds: a
        cached value recomputed at most every 0.25 s from the bucket
        deltas since the last recompute, the cumulative median while the
        window is sparse, None until 8 gaps were seen.  Under _cond."""
        est, recompute_at = self._gap_cache
        if now < recompute_at:
            return est
        h = self._gap_hist
        base, self._gap_base = self._gap_base, h.snapshot_buckets()
        gap = h.delta_quantile(base, 0.5, min_count=8) \
            if base is not None else None
        if gap is None and h.count >= 8:
            gap = h.quantile(0.5)
        self._gap_cache = (gap, now + 0.25)
        return gap

    def _wait_left(self, now: float, oldest: float) -> float:
        """Seconds the flush thread may still wait before dispatching
        the oldest queued request; <= 0 flushes now.  Static:
        ``max_wait_s`` minus the age.  Adaptive, on top of that: the
        window stretches to ``stretch x max_wait_s`` only while the
        observed cadence predicts the batch fills inside it and arrivals
        keep pace; a stretched window whose flow stops (quiet past the
        pace bar) collapses to the static deadline, or flushes now when
        already past it."""
        limit = self.max_wait_s
        if self._gap_hist is not None:
            gap = self._gap_estimate(now)
            if gap is not None and self._last_arrival is not None:
                need = self.max_batch - self._queued_rows
                fills = 0 < need and \
                    (now - oldest) + gap * need <= \
                    self._stretch * self.max_wait_s
                if fills:
                    stall = now - self._last_arrival
                    pace = min(max(2.0 * gap, 0.05 * self.max_wait_s),
                               self.max_wait_s)
                    if stall >= pace:
                        if now - oldest >= self.max_wait_s:
                            telemetry.counter(
                                events.CTR_SERVE_WAIT_COLLAPSED).inc()
                            return 0.0
                    else:
                        # wake no later than the pace bar trips, so a
                        # held window re-checks the stall without a
                        # submit to notify it
                        limit = self._stretch * self.max_wait_s
                        return min(limit - (now - oldest), pace - stall)
        return limit - (now - oldest)

    def _expire(self) -> List[_Pending]:
        """Under the lock: pop every fully queued request past its
        deadline."""
        now_ms = time.time() * 1000.0
        expired = [p for p in self._queue
                   if p.taken == 0 and p.deadline_ms is not None
                   and now_ms > p.deadline_ms]
        for p in expired:
            self._queue.remove(p)
            self._queued_rows -= len(p.rows)
        if expired:
            telemetry.gauge(events.GAUGE_SERVE_QUEUE_DEPTH).set(
                self._queued_rows)
        return expired

    def _take_batch(self) -> Optional[List[Tuple[_Pending, int, int]]]:
        """Wait for a flushable batch; returns [(request, start_row,
        n_rows)] covering up to ``max_batch`` rows, or None when closed
        and empty."""
        while True:
            with self._cond:
                while True:
                    expired = self._expire()
                    if expired:
                        break
                    if self._queue:
                        if self._queued_rows >= self.max_batch:
                            break
                        now = time.perf_counter()
                        oldest = self._queue[0].t0
                        wait_left = self._wait_left(now, oldest)
                        if wait_left <= 0:
                            waited = now - oldest
                            if waited > self.max_wait_s:
                                telemetry.counter(
                                    events.CTR_SERVE_WAIT_STRETCHED).inc()
                            telemetry.gauge(
                                events.GAUGE_SERVE_EFFECTIVE_WAIT_MS).set(
                                round(waited * 1000.0, 3))
                            break
                        self._cond.wait(min(wait_left, 0.05))
                    elif self._closed:
                        return None
                    else:
                        self._cond.wait(0.05)
                if not expired:
                    take: List[Tuple[_Pending, int, int]] = []
                    room = self.max_batch
                    while room > 0 and self._queue:
                        p = self._queue[0]
                        rem = len(p.rows) - p.taken
                        if rem > room and take:
                            break
                        n = min(room, rem)
                        take.append((p, p.taken, n))
                        p.taken += n
                        room -= n
                        self._queued_rows -= n
                        if p.taken >= len(p.rows):
                            self._queue.popleft()
                            p.popped = True
                            self._inflight += 1
                    telemetry.gauge(events.GAUGE_SERVE_QUEUE_DEPTH).set(
                        self._queued_rows)
                    return take
            # outside the lock: done-callbacks must not run under it
            telemetry.counter(events.CTR_SERVE_DEADLINE_DROPPED).inc(
                len(expired))
            now_ms = time.time() * 1000.0
            for p in expired:
                if not p.future.done():
                    p.future.set_exception(DeadlineExpired(
                        f"request expired {now_ms - p.deadline_ms:.0f}ms "
                        f"past its deadline before dispatch"))

    def _loop(self) -> None:
        while True:
            take = self._take_batch()
            if take is None:
                return
            rows = np.concatenate([p.rows[s:s + n] for p, s, n in take])
            xb = batching.pad_rows(rows, self.max_batch)
            t_wait = time.perf_counter()
            for p, s, n in take:
                if s == 0:
                    p.wait_s = t_wait - p.t0
                    telemetry.histogram(
                        events.HIST_SERVE_WAIT_SECONDS).record(
                        p.wait_s,
                        exemplar=p.ctx.trace_id if p.ctx else None)
            f = faults.fire("hive.slow_dispatch", label=self.label)
            if f:
                # the gray-failure drill: the dispatch stalls while the
                # process stays alive and heartbeating
                time.sleep(float(f.get("seconds", 0.25)))
            try:
                out = self.dispatch(xb)
            except Exception as e:  # noqa: BLE001 — a failed dispatch
                # fails exactly the requests it carried; the loop lives
                telemetry.counter(
                    events.CTR_SERVE_REQUEST_ERRORS).inc(len(take))
                self._resolve(take, None, err=e)
                continue
            dispatch_s = time.perf_counter() - t_wait
            self.dispatches += 1
            self.rows += len(rows)
            self.max_rows = max(self.max_rows, len(rows))
            telemetry.counter(events.CTR_SERVE_BATCHES).inc()
            telemetry.counter(events.CTR_SERVE_ROWS).inc(len(rows))
            telemetry.counter(events.CTR_SERVE_BATCH_SLOTS).inc(
                self.max_batch)
            telemetry.histogram(events.HIST_SERVE_BATCH_ROWS).record(
                len(rows))
            self._resolve(take, np.asarray(out), dispatch_s=dispatch_s)
            links = [{"trace": p.ctx.trace_id, "span": p.ctx.span_id}
                     for p, s, n in take if p.ctx is not None and s == 0]
            if links:
                # one dispatch span links the request spans it carried:
                # coalescing is a fan-in, not a parent and child.  The
                # reference journals it before the answers and skips a
                # dispatch that coalesced one request; here every traced
                # request is linked to its dispatch, after the answers
                # went out, so the line costs no request its latency
                telemetry.event(events.EV_TRACE_BATCH,
                                span=trace.new_span_id(),
                                label=self.label, rows=len(rows),
                                dispatch_s=round(dispatch_s, 6),
                                links=links)
                trace.record("serve.batch", label=self.label,
                             rows=len(rows),
                             dispatch_s=round(dispatch_s, 6))

    def _resolve(self, take, out, err=None,
                 dispatch_s: Optional[float] = None) -> None:
        off = 0
        done: List[_Pending] = []
        for p, s, n in take:
            if err is None:
                p.results.append(out[off:off + n])
            off += n
            if err is not None:
                if not p.future.done():
                    p.future.set_exception(err)
                done.append(p)
            elif s + n >= len(p.rows):   # request fully covered
                if not p.future.done():  # a prior slice may have erred
                    p.future.set_result(np.concatenate(p.results)
                                        if len(p.results) > 1
                                        else p.results[0])
                done.append(p)
        now = time.perf_counter()
        self.last_activity = time.monotonic()
        for p in done:
            if p.ctx is not None:
                # the request's serve-side span: queue wait against
                # dispatch, the two halves the critical path attributes
                telemetry.event(
                    events.EV_TRACE_SERVE,
                    trace=p.ctx.trace_id, span=p.ctx.span_id,
                    parent=p.ctx.parent_id, label=self.label,
                    rows=int(len(p.rows)),
                    wait_s=round(p.wait_s, 6)
                    if p.wait_s is not None else None,
                    dispatch_s=round(dispatch_s, 6)
                    if dispatch_s is not None else None,
                    total_s=round(now - p.t0, 6),
                    error=type(err).__name__ if err is not None
                    else None)
        with self._cond:
            for p in done:
                telemetry.histogram(
                    events.HIST_SERVE_REQUEST_SECONDS).record(
                    now - p.t0,
                    exemplar=p.ctx.trace_id if p.ctx else None)
                if p.popped:
                    self._inflight -= 1
                elif self._queue and self._queue[0] is p:
                    # an erred oversized request still at the head:
                    # retire it so its tail never dispatches
                    self._queued_rows -= len(p.rows) - p.taken
                    self._queue.popleft()
                    p.popped = True
            self._cond.notify_all()
