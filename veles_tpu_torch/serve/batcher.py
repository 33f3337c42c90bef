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

Left out here: the reference's adaptive wait window
(``$VELES_SERVE_ADAPTIVE_WAIT``; this loop keeps the static deadline,
which is the adaptive one's floor) and its telemetry, fault, trace and
lock-witness hooks.  The loop keeps plain counters instead
(:attr:`dispatches`, :attr:`rows`, :attr:`max_rows`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from veles_tpu_torch.ops import batching


class DeadlineExpired(RuntimeError):
    """A queued request's ``deadline_ms`` passed before its dispatch."""


class _Pending:
    """One submitted request: its rows, result slices, and Future."""

    __slots__ = ("rows", "future", "t0", "results", "taken", "popped",
                 "deadline_ms")

    def __init__(self, rows: np.ndarray,
                 deadline_ms: Optional[float] = None) -> None:
        self.rows = rows
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        self.deadline_ms = deadline_ms
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
        self._cond = threading.Condition()
        self._queue: "deque[_Pending]" = deque()
        #: per-sample shape; pinned by the first request when unset
        self._sample_shape = tuple(sample_shape) if sample_shape \
            else None
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

    def submit(self, rows: Any, deadline_ms: Optional[float] = None
               ) -> Future:
        """Enqueue one request; returns a Future of its per-row outputs
        in request order.  Thread-safe; never blocks on the device."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 0 or len(rows) == 0:
            raise ValueError("a request needs at least one sample row")
        p = _Pending(rows, float(deadline_ms)
                     if deadline_ms is not None else None)
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
            self.last_activity = time.monotonic()
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
                        waited = time.perf_counter() - self._queue[0].t0
                        if waited >= self.max_wait_s:
                            break
                        self._cond.wait(min(self.max_wait_s - waited,
                                            0.05))
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
                    return take
            # outside the lock: done-callbacks must not run under it
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
            try:
                out = self.dispatch(xb)
            except Exception as e:  # noqa: BLE001 — a failed dispatch
                # fails exactly the requests it carried; the loop lives
                self._resolve(take, None, err=e)
                continue
            self.dispatches += 1
            self.rows += len(rows)
            self.max_rows = max(self.max_rows, len(rows))
            self._resolve(take, np.asarray(out))

    def _resolve(self, take, out, err=None) -> None:
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
        self.last_activity = time.monotonic()
        with self._cond:
            for p in done:
                if p.popped:
                    self._inflight -= 1
                elif self._queue and self._queue[0] is p:
                    # an erred oversized request still at the head:
                    # retire it so its tail never dispatches
                    self._queued_rows -= len(p.rows) - p.taken
                    self._queue.popleft()
                    p.popped = True
            self._cond.notify_all()
