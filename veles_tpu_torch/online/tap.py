"""The traffic tap: live request rows -> the replay buffer (the port's
counterpart of ``veles_tpu/online/tap.py``).

Sits on the hive's admission path, after the engine accepted the
request, so rejected or misshapen rows never enter a buffer, and
mirrors a DETERMINISTIC fraction of requests: an error-diffusion
accumulator (``acc += frac``; tap when ``acc >= 1``) rather than a coin
flip, so the tapped subsequence of any request stream is exactly
reproducible.

Labels: a request may carry its ground truth inline (the ``label`` wire
field: one int per row, or one for the whole request) or deliver it
late as a ``{"label_of": <wire id>, "label": [...]}`` line.  Tapped but
unlabeled rows wait in a bounded FIFO map keyed by wire id
(:data:`PENDING_CAP`); a label for an id that was never tapped, or was
already evicted, counts as an orphan and drops.

Telemetry: ``online.tapped_rows``, ``online.labeled_rows`` and
``online.label_orphans`` (a hive's ``op=stats`` ``online`` entry).  Fault
point ``online.poison_batch`` (``model``, ``slot``: ``train`` or
``holdout``) replaces a labeled batch's labels with deterministic
garbage, the poisoned stream the promotion gate must never promote.

Lineage: the trace id of each tapped request whose context was sampled
enters its model's bounded tail (:data:`LINEAGE_CAP`);
:meth:`TrafficTap.lineage_sample` returns it, and the promotion gate
journals it with a promotion or a rollback, so a served promotion traces
back to the live requests that trained it.  The lock is the witness's
``online.tap``; telemetry and the buffer are called outside it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, faults, telemetry, trace
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.online.buffer import ReplayBuffer

#: tapped-but-unlabeled requests held before the oldest is evicted
PENDING_CAP = 256

#: trace ids kept per model: the promotion gate's lineage sample (a
#: bounded tail, not the whole training history)
LINEAGE_CAP = 32


class TrafficTap:
    """Per-hive tap over every learning model's admitted traffic."""

    def __init__(self, frac: float) -> None:
        self.frac = max(0.0, min(1.0, float(frac)))
        self._lock = witness.lock("online.tap")
        #: per-model error-diffusion accumulator
        self._acc: Dict[str, float] = {}
        #: wire id -> (model, rows) awaiting a late label
        self._pending: Dict[Any, Tuple[str, np.ndarray]] = {}
        #: model name -> ReplayBuffer (armed by the learner)
        self.buffers: Dict[str, ReplayBuffer] = {}
        #: model name -> recent trace ids of its tapped traffic
        self._lineage: Dict[str, "deque[str]"] = {}

    def arm(self, model: str, buffer: ReplayBuffer) -> None:
        with self._lock:
            self.buffers[model] = buffer
            self._acc.setdefault(model, 0.0)

    # -- the admission-path hook ---------------------------------------

    def tap(self, model: str, jid: Any, rows: np.ndarray,
            label: Any = None,
            ctx: Optional[trace.TraceContext] = None) -> None:
        """One admitted request.  Samples deterministically; labeled
        rows go straight to the buffer, unlabeled ones wait for a
        ``label_of`` join.  A sampled ``ctx`` (the request's span) puts
        its trace id in the model's lineage tail."""
        with self._lock:
            buf = self.buffers.get(model)
            if buf is None or self.frac <= 0.0:
                return
            acc = self._acc.get(model, 0.0) + self.frac
            take = acc >= 1.0
            if take:
                acc -= 1.0
            self._acc[model] = acc
            if take and ctx is not None and ctx.sampled:
                self._lineage.setdefault(
                    model, deque(maxlen=LINEAGE_CAP)).append(ctx.trace_id)
        if not take:
            return
        rows = np.asarray(rows, np.float32)
        telemetry.counter(events.CTR_ONLINE_TAPPED_ROWS).inc(len(rows))
        if label is not None:
            self._admit(model, buf, rows, label)
            return
        with self._lock:
            while len(self._pending) >= PENDING_CAP:
                # FIFO eviction: dicts keep insertion order
                self._pending.pop(next(iter(self._pending)))
            self._pending[jid] = (model, rows)

    def label_for(self, jid: Any, label: Any) -> bool:
        """A late ``label_of`` line: join by wire id.  False (and an
        orphan count) when the id was never tapped or was evicted."""
        with self._lock:
            hit = self._pending.pop(jid, None)
            buf = self.buffers.get(hit[0]) if hit is not None else None
        if hit is None:
            telemetry.counter(events.CTR_ONLINE_LABEL_ORPHANS).inc()
            return False
        if buf is None:
            return False
        self._admit(hit[0], buf, hit[1], label)
        return True

    def _admit(self, model: str, buf: ReplayBuffer, rows: np.ndarray,
               label: Any) -> None:
        labels = np.asarray(label, np.int32).reshape(-1)
        # the slot this batch lands in (the buffer's holdout rule)
        slot = "holdout" if buf.holdout_every > 0 and \
            (buf._seen + 1) % buf.holdout_every == 0 else "train"
        if faults.fire("online.poison_batch", model=model, slot=slot):
            # deterministic garbage labels: the same seed corrupts the
            # same way, run to run
            labels = faults.rng("online.poison_batch").integers(
                0, max(2, int(labels.max()) + 1),
                size=len(labels) if len(labels) > 1 else len(rows),
                dtype=np.int32)
        buf.add(rows, labels)
        telemetry.counter(events.CTR_ONLINE_LABELED_ROWS).inc(len(rows))

    # -- introspection -------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def lineage_sample(self, model: str) -> List[str]:
        """Recent trace ids of ``model``'s tapped traffic, oldest first
        (empty when tracing is off): what a promotion or a rollback
        journals."""
        with self._lock:
            return list(self._lineage.get(model, ()))
