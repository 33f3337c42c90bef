"""Workflow: a container of linked Units with a run loop (the port's copy
of ``veles_tpu/workflow.py``).

- A ``Workflow`` holds the unit graph between its ``StartPoint`` and
  its ``EndPoint``.
- ``initialize()`` initializes the units in dependency order, and
  retries a unit whose linked inputs are not allocated yet.
- ``run()`` fires units until the end point fires.  A decision's
  ``complete`` gate steers the loop-back edge against the exit edge.
  The scheduler is synchronous and deterministic: a FIFO of ready
  units.  A ``Repeater`` joins the loop-back edge with the initial one
  (OR semantics, where other units AND their predecessors).
- A per-unit timing table is logged at the end.
- It carries the distribution hooks (``distributable.py``), no-ops as
  the reference's.

This is the graph API for workflow files written against units.  The
port's own models keep their plain loop (``ops/standard_workflow.py``).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Optional

from veles_tpu_torch.distributable import Distributable
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Container, Unit


class StartPoint(Unit):
    pass


class EndPoint(Unit):
    def run(self) -> None:
        if self.workflow is not None:
            self.workflow.stopped.set(True)


class Workflow(Container, Distributable):
    """Container + scheduler for a unit graph."""

    def __init__(self, workflow: Optional[Unit] = None,
                 name: Optional[str] = None, **kwargs: Any) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.start_point = StartPoint(self, name="start_point")
        self.end_point = EndPoint(self, name="end_point")
        self.stopped = Bool(False)
        #: a graceful stop asked from a signal handler or another thread
        #: (:meth:`request_stop`): the run loop honors it at the next
        #: iteration boundary (a unit flagged ``iteration_boundary``, the
        #: Repeater), where every unit has finished the iteration.  A
        #: plain bool: its assignment is atomic under the GIL
        self.stop_requested = False
        self.device = None
        self._max_firings = kwargs.get("max_firings", 10_000_000)
        #: seconds spent inside run(), device work the units waited on
        #: included
        self.wall_time = 0.0

    # -- lifecycle -----------------------------------------------------

    def initialize(self, device: Any = None, **kwargs: Any) -> None:
        """Initialize every unit in control-dependency order.  A unit
        whose ``initialize`` raises ``AttributeError`` (a linked input
        not allocated yet) is retried after the others; a whole pass
        without progress raises."""
        self.device = device
        order = self._dependency_order()
        pending = [u for u in order if u is not self]
        while pending:
            errors = {}
            still = []
            for u in pending:
                try:
                    u.initialize(device=device, **kwargs)
                    u._initialized = True
                except AttributeError as e:
                    errors[u] = e
                    still.append(u)
            if len(still) == len(pending):
                u, e = next(iter(errors.items()))
                raise RuntimeError(
                    f"initialization deadlock: {len(still)} units cannot "
                    f"initialize; first: {u} -> {e}") from e
            pending = still
        self._initialized = True

    def _dependency_order(self) -> list:
        """Breadth-first over control edges from the start point (a back
        edge reaches a unit already seen), then every unit not reached."""
        seen = []
        seen_set = set()
        queue = collections.deque([self.start_point])
        while queue:
            u = queue.popleft()
            if u in seen_set:
                continue
            seen.append(u)
            seen_set.add(u)
            for succ in sorted(u.links_to, key=lambda x: x.name):
                if succ not in seen_set:
                    queue.append(succ)
        for u in self.units:
            if u not in seen_set:
                seen.append(u)
                seen_set.add(u)
        return seen

    # -- run loop ------------------------------------------------------

    def run(self) -> None:
        """Fire the start point and drive the graph until stopped."""
        if not self._initialized:
            raise RuntimeError("workflow.run() before initialize()")
        t_start = time.perf_counter()
        self.stopped.set(False)
        # a stop asked before this run (or carried by a snapshot) must
        # not stop it before its first firing
        self.stop_requested = False
        queue: collections.deque = collections.deque([self.start_point])
        firings = 0
        while queue and not bool(self.stopped):
            unit = queue.popleft()
            if self.stop_requested and \
                    getattr(unit, "iteration_boundary", False):
                break
            if bool(unit.gate_block):
                continue
            unit._reset_trigger_state()
            unit.fire()
            firings += 1
            if firings > self._max_firings:
                raise RuntimeError("workflow exceeded max firings "
                                   "(runaway loop?)")
            if bool(self.stopped):
                break
            for succ in sorted(unit.links_to, key=lambda x: x.name):
                succ.links_from[unit] = True
                if succ.ready and not bool(succ.gate_block):
                    queue.append(succ)
        self.wall_time += time.perf_counter() - t_start
        self.on_workflow_finished()

    def stop(self) -> None:
        self.stopped.set(True)
        for u in self.units:
            u.stop()

    def request_stop(self) -> None:
        """Stop the run loop at the next iteration boundary.  Unlike
        :meth:`stop` it calls no unit's clean-up hook and leaves the
        graph resumable."""
        self.stop_requested = True

    def on_workflow_finished(self) -> None:
        self.report_timings()

    def report_timings(self) -> None:
        """Log each unit's firings and wall time."""
        rows = [(u.name, u.run_count, u.run_time)
                for u in self.units if u.run_count]
        if not rows:
            return
        total = sum(r[2] for r in rows) or 1e-12
        self.info("unit timing report:")
        for name, count, t in sorted(rows, key=lambda r: -r[2]):
            self.info("  %-28s %8d runs  %9.3fs  %5.1f%%",
                      name, count, t, 100.0 * t / total)

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        # never carry a stale stop request into a resumed run
        self.stop_requested = False


class Repeater(Unit):
    """Joins the loop-back edge with the initial edge, so the loop's
    first unit is triggered by the start point or by the end of an
    iteration: it fires when ANY predecessor fired (OR semantics)."""

    #: the Repeater opens each iteration, so the instant before it fires
    #: is the graceful-stop boundary (Workflow.run honors it here)
    iteration_boundary = True

    @property
    def ready(self) -> bool:
        if not self.links_from:
            return True
        return any(self.links_from.values())
