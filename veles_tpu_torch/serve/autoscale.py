"""The elastic fleet: the scale controller and the degradation ladder.

Counterpart of ``veles_tpu/serve/autoscale.py``, with the same rules.
The router already measures what an autoscaler needs: each replica's
queue depth and dispatch cadence behind ``estimated_total_ms()``, the
estimate admission control sheds on.  Three pieces:

- :class:`ScaleController`: a pure hysteresis controller (no threads,
  no clock; the caller passes ``now``): scale up when the best
  candidate's estimated completion stays above
  ``$VELES_FLEET_SCALE_UP_MS`` for ``..._UP_SUSTAIN`` seconds, down when
  it stays below ``..._DOWN_MS`` for ``..._DOWN_SUSTAIN`` seconds, never
  below ``..._MIN`` or above ``..._MAX`` replicas, at most one action
  per ``..._COOLDOWN`` seconds.
- :class:`DegradationLadder`: when demand outruns the ceiling, three
  rungs engaged strictly in order and released in reverse: suspend the
  online learner, disable hedging, shed the long-tail models.
- :class:`FleetAutoscaler`: the thread that wires both to a live
  :class:`~veles_tpu_torch.serve.router.FleetRouter`: polls the pressure
  every ``$VELES_FLEET_SCALE_INTERVAL`` seconds, spawns with
  ``add_replica()``, retires with ``retire_replica()``, walks the
  ladder at the bounds, and records every action with its cause in
  :attr:`FleetAutoscaler.journal` and the in-memory telemetry events.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from veles_tpu_torch import events, knobs, telemetry
from veles_tpu_torch.analysis import witness

log = logging.getLogger("veles.serve.autoscale")

#: controller verdicts (the autoscaler maps them onto router calls)
ACT_UP = "up"              # spawn a replica
ACT_DOWN = "down"          # retire a replica
ACT_SATURATED = "saturated"  # pressure at the max bound: engage a rung
ACT_RELAX = "relax"        # idle with rungs engaged: release a rung


class ScaleController:
    """Hysteresis + cooldown + bounds over a scalar pressure signal.

    ``observe(pressure_ms, n_replicas, now)`` returns one of
    :data:`ACT_UP` / :data:`ACT_DOWN` / :data:`ACT_SATURATED` /
    :data:`ACT_RELAX` / ``None``.  The caller owns the clock and the
    consequences; the controller owns WHEN — sustained-signal windows
    reset whenever the signal leaves the band, any verdict starts the
    cooldown, and the bounds turn up-at-max into ``saturated`` and
    down-at-min into ``relax`` (the ladder's levers) instead of
    silently clamping to ``None``.
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 up_ms: float = 200.0, down_ms: float = 25.0,
                 up_sustain_s: float = 1.0, down_sustain_s: float = 3.0,
                 cooldown_s: float = 5.0) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if down_ms >= up_ms:
            raise ValueError(
                "hysteresis band inverted: down_ms must be < up_ms")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_ms = up_ms
        self.down_ms = down_ms
        self.up_sustain_s = up_sustain_s
        self.down_sustain_s = down_sustain_s
        self.cooldown_s = cooldown_s
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_at: Optional[float] = None

    def _in_cooldown(self, now: float) -> bool:
        return (self._last_action_at is not None
                and now - self._last_action_at < self.cooldown_s)

    def _acted(self, now: float) -> None:
        self._last_action_at = now
        self._above_since = None
        self._below_since = None

    def observe(self, pressure_ms: float, n_replicas: int,
                now: float) -> Optional[str]:
        if pressure_ms >= self.up_ms:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since >= self.up_sustain_s
                    and not self._in_cooldown(now)):
                self._acted(now)
                return (ACT_UP if n_replicas < self.max_replicas
                        else ACT_SATURATED)
            return None
        if pressure_ms <= self.down_ms:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if (now - self._below_since >= self.down_sustain_s
                    and not self._in_cooldown(now)):
                self._acted(now)
                return (ACT_DOWN if n_replicas > self.min_replicas
                        else ACT_RELAX)
            return None
        # inside the hysteresis band: both windows reset — a signal
        # that wanders in and out never accumulates sustain
        self._above_since = None
        self._below_since = None
        return None

    @classmethod
    def from_knobs(cls, environ=None) -> "ScaleController":
        g = lambda k: knobs.get(k, environ=environ)  # noqa: E731
        return cls(min_replicas=g(knobs.FLEET_SCALE_MIN),
                   max_replicas=g(knobs.FLEET_SCALE_MAX),
                   up_ms=g(knobs.FLEET_SCALE_UP_MS),
                   down_ms=g(knobs.FLEET_SCALE_DOWN_MS),
                   up_sustain_s=g(knobs.FLEET_SCALE_UP_SUSTAIN),
                   down_sustain_s=g(knobs.FLEET_SCALE_DOWN_SUSTAIN),
                   cooldown_s=g(knobs.FLEET_SCALE_COOLDOWN))


#: the ladder's rungs, in ENGAGE order; release is strictly reversed.
#: Ordered by cost-of-degradation: the learner only consumes idle
#: gaps that no longer exist; hedging spends duplicate capacity to
#: shave tail latency the fleet can no longer afford; shedding the
#: long tail is the first rung a user can SEE — and the hot prefix
#: is the last thing standing.
RUNGS = ("learner", "hedge", "shed_tail")


class DegradationLadder:
    """Strict-LIFO rung state.  ``engage()`` returns the next rung to
    pull (None when exhausted); ``release()`` returns the most recent
    rung to restore (None when fully recovered).  The ladder holds no
    levers itself — callers map rung names onto subsystem switches —
    so the ordering invariant is testable without a fleet."""

    def __init__(self) -> None:
        self.engaged: List[str] = []

    @property
    def depth(self) -> int:
        return len(self.engaged)

    def engage(self) -> Optional[str]:
        if len(self.engaged) >= len(RUNGS):
            return None
        rung = RUNGS[len(self.engaged)]
        self.engaged.append(rung)
        return rung

    def release(self) -> Optional[str]:
        if not self.engaged:
            return None
        return self.engaged.pop()


class FleetAutoscaler:
    """The daemon thread that makes the fleet track the load curve."""

    def __init__(self, router, controller: Optional[ScaleController] = None,
                 interval_s: Optional[float] = None) -> None:
        self.router = router
        self.controller = controller or ScaleController.from_knobs()
        self.ladder = DegradationLadder()
        self.interval_s = (knobs.get(knobs.FLEET_SCALE_INTERVAL)
                           if interval_s is None else interval_s)
        self._lock = witness.lock("autoscale.state")
        #: every action taken, for the accountability check:
        #: {"t", "action", "rung"|"replica", "pressure_ms", "n"}
        self.journal: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-autoscaler")

    def start(self) -> "FleetAutoscaler":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    # -- signals -------------------------------------------------------

    def pressure_ms(self) -> float:
        """The BEST candidate's estimated completion — the admission
        estimate: if even the least-loaded eligible replica is slow,
        more capacity helps; one hot replica among idle peers does
        not call for a spawn (that is Sentinel's problem)."""
        vals = [r.estimated_total_ms()
                for r in list(self.router.replicas)
                if r.healthy and not r.retiring
                and self.router.sentinel.eligible(r)]
        if not vals:
            # no routable replica at all: maximal pressure (the fleet
            # monitor is respawning; the controller's sustain window
            # still gates the reaction)
            return float("inf")
        return min(vals)

    def n_live(self) -> int:
        return sum(1 for r in list(self.router.replicas)
                   if not r.retiring)

    # -- the loop ------------------------------------------------------

    def _journal(self, action: str, pressure: float,
                 **extra: Any) -> None:
        rec = {"t": time.time(), "action": action,
               "pressure_ms": pressure, "n": self.n_live()}
        rec.update(extra)
        with self._lock:
            self.journal.append(rec)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — scaling must not die
                log.exception("autoscaler tick failed")

    def _tick(self) -> None:
        pressure = self.pressure_ms()
        n = self.n_live()
        telemetry.gauge(events.GAUGE_FLEET_SCALE_PRESSURE_MS).set(
            0.0 if pressure == float("inf") else pressure)
        telemetry.gauge(events.GAUGE_FLEET_REPLICAS_TOTAL).set(n)
        telemetry.gauge(events.GAUGE_FLEET_DEGRADE_RUNGS).set(
            self.ladder.depth)
        act = self.controller.observe(pressure, n, time.monotonic())
        if act is None:
            return
        p = 0.0 if pressure == float("inf") else round(pressure, 3)
        if act == ACT_UP:
            # any engaged rungs STAY engaged across a scale-up: they
            # release only once pressure actually relieves
            log.info("scale-up: pressure %.1fms >= %.1fms at n=%d",
                      p, self.controller.up_ms, n)
            r = self.router.add_replica(cause="pressure",
                                        pressure_ms=p)
            self._journal(ACT_UP, p, replica=r.idx if r else None)
        elif act == ACT_SATURATED:
            rung = self.ladder.engage()
            if rung is None:
                return  # fully degraded; nothing left to pull
            log.info("degrade ENGAGE %s: pressure %.1fms at the "
                      "max bound n=%d", rung, p, n)
            self.router.apply_degradation(rung, True, cause="pressure",
                                          pressure_ms=p)
            self._journal("degrade_engage", p, rung=rung)
        elif act == ACT_DOWN:
            if self.ladder.depth:
                # recover service levels BEFORE shrinking: the rungs
                # were the emergency, spare capacity pays them back
                # first — strict reverse engage order
                rung = self.ladder.release()
                log.info("degrade RELEASE %s: pressure %.1fms", rung,
                          p)
                self.router.apply_degradation(rung, False,
                                              cause="recovered",
                                              pressure_ms=p)
                self._journal("degrade_release", p, rung=rung)
                return
            log.info("scale-down: pressure %.1fms <= %.1fms at n=%d",
                      p, self.controller.down_ms, n)
            idx = self.router.retire_replica(cause="idle",
                                             pressure_ms=p)
            self._journal(ACT_DOWN, p, replica=idx)
        elif act == ACT_RELAX:
            rung = self.ladder.release()
            if rung is None:
                return
            log.info("degrade RELEASE %s: pressure %.1fms", rung, p)
            self.router.apply_degradation(rung, False,
                                          cause="recovered",
                                          pressure_ms=p)
            self._journal("degrade_release", p, rung=rung)
