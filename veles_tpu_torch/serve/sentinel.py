"""Gray-failure defense for the serving fleet.

Counterpart of ``veles_tpu/serve/sentinel.py``, with the same rules and
constants.  The fleet (``veles_tpu_torch/serve/fleet.py``) survives a
clean replica death (reader EOF or heartbeat silence); everything short
of death, a replica dispatching at 10x its peers' latency, a wedged
batcher that still heartbeats, a corrupt answer, is a gray failure.  The
router owns one :class:`Sentinel`, which composes three defenses:

- **request deadlines**: every request carries an absolute
  ``deadline_ms`` end to end (router -> hive batcher, which drops
  expired rows before dispatch), so a waiter spends at most
  ``$VELES_FLEET_DEADLINE_MS`` on a wedged replica;
- **hedged requests**: a request older than the adaptive hedge threshold
  (the model's windowed p95 latency, floored by
  ``$VELES_FLEET_HEDGE_MIN_MS``) is sent again to a second replica; the
  first answer wins and the loser is cancelled by wire id.  Hedges are
  capped at ``$VELES_FLEET_HEDGE_BUDGET`` of admitted requests;
- **outlier ejection**: a per-replica health score sums weighted strikes
  (deadline misses, deaths, integrity failures, hedge losses, latency
  outliers against the peers) under exponential decay; a replica at
  ``$VELES_FLEET_EJECT_THRESHOLD`` leaves routing, is probed with
  synthetic requests on a doubling backoff, and comes back after
  ``$VELES_FLEET_PROBE_OK`` clean probes in a row.  Ejection is capped
  at N - 1 replicas.

Every routing decision asks :meth:`Sentinel.eligible`, every outcome
reports through the ``record_*`` methods, and the probe loop runs on the
sentinel's own thread.  An ejection records ``sentinel.eject`` in the
flight recorder's ring and dumps it (``ejection``,
``veles_tpu_torch/trace.py``), so it ships with the recent legs and
hedges that led to it.  The health table's lock is the witness's
``sentinel.health``.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, knobs, telemetry, trace
from veles_tpu_torch.analysis import witness

log = logging.getLogger("veles.serve.sentinel")

STATE_HEALTHY = "healthy"
STATE_EJECTED = "ejected"
STATE_PROBING = "probing"

#: strike weights — one deadline miss or death is a full strike,
#: integrity failures weigh more (wrong answers beat slow answers),
#: hedge losses and latency outliers accumulate more slowly (they are
#: statistical evidence, not hard failures)
WEIGHT_TIMEOUT = 1.0
WEIGHT_DIED = 1.0
WEIGHT_INTEGRITY = 1.5
WEIGHT_HEDGE_LOSS = 0.75
WEIGHT_SLOW = 0.5

#: health-score strikes decay with this time constant: an isolated
#: blip is forgotten in a minute, a persistent gray failure is not
DECAY_TAU_S = 30.0

#: latency z-score vs fleet peers above which a replica earns a slow
#: strike (std floored at 20% of the peer mean so one quiet fleet
#: can't divide by ~zero), rate-limited to one strike per second
Z_THRESHOLD = 3.0
Z_MIN_GAP_MS = 10.0
Z_STRIKE_MIN_INTERVAL_S = 1.0

#: probe request timeout floor and backoff cap
PROBE_TIMEOUT_MIN_S = 1.0
PROBE_BACKOFF_CAP_S = 10.0


class ReplicaHealth:
    """One replica's decaying health score + probe lifecycle state."""

    __slots__ = ("idx", "state", "score", "last_decay", "strikes",
                 "hedge_wins", "hedge_losses", "lat_ema_s",
                 "last_z_strike", "probe_ok_streak", "probe_fails",
                 "next_probe_at", "probe_backoff_s", "ejections",
                 "reinstatements", "probing")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.state = STATE_HEALTHY
        self.score = 0.0
        self.last_decay = time.monotonic()
        #: strike counts by kind (timeout/died/integrity/hedge_loss/
        #: slow) — the operator-facing "why is it out of rotation"
        self.strikes: Dict[str, int] = {}
        self.hedge_wins = 0
        self.hedge_losses = 0
        #: EMA of this replica's observed request latency (seconds)
        self.lat_ema_s: Optional[float] = None
        self.last_z_strike = 0.0
        self.probe_ok_streak = 0
        self.probe_fails = 0
        self.next_probe_at = 0.0
        self.probe_backoff_s = 0.0
        self.ejections = 0
        self.reinstatements = 0
        #: True once the first probe of the CURRENT ejection has been
        #: sent (renders the state as "probing" rather than "ejected")
        self.probing = False

    def decayed_score(self, now: float) -> float:
        dt = now - self.last_decay
        if dt > 0:
            self.score *= math.exp(-dt / DECAY_TAU_S)
            self.last_decay = now
        return self.score

    def public_state(self) -> str:
        if self.state == STATE_EJECTED:
            return STATE_PROBING if self.probing else STATE_EJECTED
        return STATE_HEALTHY


class Sentinel:
    """Per-replica health scoring, hedging governor, ejection+probes.

    ``probe_fn(replica, model, rows) -> (ok, detail)`` is supplied by
    the router: one synthetic canary request aimed straight at the
    replica (bypassing routing), verified end to end — answered inside
    the probe deadline AND integrity-clean.
    """

    def __init__(self, replicas: List[Any],
                 probe_fn: Callable[[Any, str, np.ndarray],
                                    Tuple[bool, str]],
                 hedge_min_ms: Optional[float] = None,
                 hedge_budget: Optional[float] = None,
                 eject_threshold: Optional[float] = None,
                 probe_ok: Optional[int] = None,
                 probe_interval: Optional[float] = None,
                 probe_backoff_cap: float = PROBE_BACKOFF_CAP_S
                 ) -> None:
        self.replicas = replicas
        self.probe_fn = probe_fn
        self.hedge_min_ms = float(hedge_min_ms) \
            if hedge_min_ms is not None \
            else float(knobs.get(knobs.FLEET_HEDGE_MIN_MS))
        self.hedge_budget = float(hedge_budget) \
            if hedge_budget is not None \
            else float(knobs.get(knobs.FLEET_HEDGE_BUDGET))
        self.eject_threshold = float(eject_threshold) \
            if eject_threshold is not None \
            else float(knobs.get(knobs.FLEET_EJECT_THRESHOLD))
        self.probe_ok = int(probe_ok) if probe_ok is not None \
            else int(knobs.get(knobs.FLEET_PROBE_OK))
        self.probe_interval = float(probe_interval) \
            if probe_interval is not None \
            else float(knobs.get(knobs.FLEET_PROBE_INTERVAL))
        self.probe_backoff_cap = float(probe_backoff_cap)
        self._lock = witness.lock("sentinel.health")
        self.health: Dict[int, ReplicaHealth] = {
            r.idx: ReplicaHealth(r.idx) for r in replicas}
        self._requests_seen = 0
        self._hedges_issued = 0
        #: {model: (threshold_ms, recompute_after)} — the p95 scan is
        #: too hot to run per request at fleet QPS
        self._thr_cache: Dict[str, Tuple[float, float]] = {}
        #: {model: histogram snapshot} — the previous recompute's
        #: bucket base, so the p95 is WINDOWED (last ~0.5s), not
        #: cumulative: a cumulative quantile lags a load shift so
        #: badly that most spike requests would cross the threshold
        #: instead of the intended slowest ~5%
        self._thr_base: Dict[str, Any] = {}
        #: last-seen single-row probe template per model (a synthetic
        #: canary must exercise the REAL inference path)
        self._templates: Dict[str, np.ndarray] = {}
        self._closing = False
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True,
            name="fleet-sentinel-probe")
        self._probe_thread.start()

    # -- elastic membership --------------------------------------------

    def _h(self, idx: int) -> ReplicaHealth:
        """The idx's health record, created on first sight — MUST be
        called under ``_lock``.  An elastic fleet adds members after
        the ctor, and a record the scoring paths race to create must
        never KeyError a request thread."""
        h = self.health.get(idx)
        if h is None:
            h = self.health[idx] = ReplicaHealth(idx)
        return h

    def add_replica(self, replica: Any) -> None:
        """A scale-up joined ``self.replicas`` (the shared list the
        router mutates); give it a fresh health record."""
        with self._lock:
            self.health[replica.idx] = ReplicaHealth(replica.idx)

    def remove_replica(self, replica: Any) -> None:
        """A scale-down left the fleet: drop its record so the peer
        latency stats and the ejected count stop seeing a ghost."""
        with self._lock:
            self.health.pop(replica.idx, None)

    # -- routing-side queries ------------------------------------------

    def eligible(self, replica: Any) -> bool:
        """May the router send this replica traffic?  (Process-level
        health is the ReplicaSet's call; this is the gray-failure
        overlay.)"""
        with self._lock:
            return self._h(replica.idx).state == STATE_HEALTHY

    def ejected_count(self) -> int:
        with self._lock:
            return sum(1 for h in self.health.values()
                       if h.state == STATE_EJECTED)

    def hedge_threshold_ms(self, model: str) -> float:
        """When a request of ``model`` is old enough to hedge: the
        model's measured p95 latency, floored by
        ``$VELES_FLEET_HEDGE_MIN_MS`` — the floor keeps a fast model
        from hedging on microscopic jitter.  The p95 is WINDOWED
        (samples since the previous recompute, ~0.5s) so the
        threshold tracks the live distribution — by construction only
        the slowest ~5% of current traffic outlives it; sparse
        traffic (too few windowed samples) falls back to the
        cumulative p95.  Cached for 0.5s per model: the quantile scan
        is too expensive to run on every request at fleet QPS."""
        now = time.monotonic()
        with self._lock:
            cached = self._thr_cache.get(model)
            if cached is not None and now < cached[1]:
                return cached[0]
        h = telemetry.histogram(f"fleet.model.{model}.request_seconds")
        with self._lock:
            base = self._thr_base.get(model)
            self._thr_base[model] = h.snapshot_buckets()
        p95 = h.delta_quantile(base, 0.95, min_count=20) \
            if base is not None else None
        if p95 is None and h.count >= 20:
            p95 = h.quantile(0.95)
        thr = self.hedge_min_ms
        if p95 is not None:
            thr = max(thr, 1000.0 * p95)
        telemetry.gauge(events.GAUGE_FLEET_HEDGE_THRESHOLD_MS).set(
            round(thr, 3))
        with self._lock:
            self._thr_cache[model] = (thr, now + 0.5)
        return thr

    def note_request(self, model: str, rows: Any) -> None:
        """One admitted request: budget accounting + the probe
        template capture (first row only — a probe is one synthetic
        sample, not a replayed batch)."""
        with self._lock:
            self._requests_seen += 1
            if model not in self._templates:
                try:
                    self._templates[model] = np.asarray(
                        rows, np.float32)[:1].copy()
                except (TypeError, ValueError, IndexError):
                    pass

    def allow_hedge(self) -> bool:
        """May one more hedge be issued under the budget?  Consumes
        the budget slot when it says yes."""
        if self.hedge_budget <= 0:
            return False
        with self._lock:
            if self._hedges_issued + 1 > \
                    self.hedge_budget * self._requests_seen + 1:
                return False
            self._hedges_issued += 1
        return True

    def hedge_rate(self) -> float:
        with self._lock:
            return self._hedges_issued / max(1, self._requests_seen)

    # -- outcome reports -----------------------------------------------

    def record_ok(self, replica: Any, model: str,
                  latency_s: float) -> None:
        """A clean answer: refresh the latency EMA and check the
        latency-outlier signal (a replica consistently far above its
        peers earns slow strikes even when nothing ever times out)."""
        del model
        now = time.monotonic()
        strike = False
        with self._lock:
            h = self._h(replica.idx)
            h.decayed_score(now)
            h.lat_ema_s = latency_s if h.lat_ema_s is None \
                else 0.8 * h.lat_ema_s + 0.2 * latency_s
            peers = [p.lat_ema_s for i, p in self.health.items()
                     if i != replica.idx and p.lat_ema_s is not None]
            if peers and h.lat_ema_s is not None \
                    and now - h.last_z_strike \
                    >= Z_STRIKE_MIN_INTERVAL_S:
                mean = sum(peers) / len(peers)
                var = sum((p - mean) ** 2 for p in peers) / len(peers)
                std = max(math.sqrt(var), 0.2 * mean, 1e-6)
                z = (h.lat_ema_s - mean) / std
                if z > Z_THRESHOLD \
                        and (h.lat_ema_s - mean) * 1000.0 \
                        > Z_MIN_GAP_MS:
                    h.last_z_strike = now
                    strike = True
        if strike:
            self._strike(replica, "slow", WEIGHT_SLOW)

    def record_timeout(self, replica: Any) -> None:
        """The replica failed to answer inside the request deadline
        (router-side expiry or the hive's own expired-drop echo)."""
        telemetry.counter(events.CTR_FLEET_DEADLINE_MISSES).inc()
        self._strike(replica, "timeout", WEIGHT_TIMEOUT)

    def record_died(self, replica: Any) -> None:
        """The replica died under a request (``ReplicaDied``)."""
        self._strike(replica, "died", WEIGHT_DIED)

    def record_integrity(self, replica: Any) -> None:
        """The replica's response failed the row-count/crc echo."""
        telemetry.counter(events.CTR_FLEET_INTEGRITY_STRIKES).inc()
        self._strike(replica, "integrity", WEIGHT_INTEGRITY)

    def record_hedge_win(self, winner: Any, loser: Any) -> None:
        """The hedge answered first: credit the winner, strike the
        replica that sat on the request past the hedge threshold —
        repeated hedge losses ARE the slow-replica signal when the
        deadline is too generous to ever expire."""
        telemetry.counter(events.CTR_FLEET_HEDGE_WINS).inc()
        with self._lock:
            self._h(winner.idx).hedge_wins += 1
            self._h(loser.idx).hedge_losses += 1
        telemetry.counter(
            f"fleet.replica.{winner.idx}.hedge_wins").inc()
        self._strike(loser, "hedge_loss", WEIGHT_HEDGE_LOSS)

    # -- scoring / ejection --------------------------------------------

    def _strike(self, replica: Any, kind: str, weight: float) -> None:
        now = time.monotonic()
        eject = False
        with self._lock:
            h = self._h(replica.idx)
            h.strikes[kind] = h.strikes.get(kind, 0) + 1
            strikes = dict(h.strikes)
            score = h.decayed_score(now) + weight
            h.score = score
            if h.state == STATE_HEALTHY \
                    and score >= self.eject_threshold \
                    and self._can_eject_locked(replica):
                h.state = STATE_EJECTED
                h.probing = False
                h.ejections += 1
                h.probe_ok_streak = 0
                h.probe_backoff_s = self.probe_interval
                h.next_probe_at = now + self.probe_interval
                eject = True
        telemetry.gauge(
            f"fleet.replica.{replica.idx}.health_score").set(
            round(score, 3))
        if eject:
            telemetry.counter(events.CTR_FLEET_EJECTIONS).inc()
            telemetry.gauge(events.GAUGE_FLEET_REPLICAS_EJECTED).set(
                self.ejected_count())
            telemetry.event(
                events.EV_FLEET_REPLICA_EJECTED, replica=replica.idx,
                state=STATE_EJECTED, score=round(score, 3),
                strikes=strikes)
            # an ejection is when an operator asks what the fleet was
            # doing: dump the ring (recent legs, hedges, strikes)
            trace.record("sentinel.eject", replica=replica.idx,
                         score=round(score, 3))
            trace.dump("ejection")
            log.warning(
                "replica %d EJECTED from routing (health score %.2f "
                ">= %.2f; strikes %s) — probing on backoff",
                replica.idx, score, self.eject_threshold, strikes)

    def _can_eject_locked(self, replica: Any) -> bool:
        """Ejection is capped at N-1: at least one OTHER replica must
        remain routable (process-healthy and not ejected), else the
        fleet must keep limping on the sick replica rather than
        refusing all traffic."""
        for r in self.replicas:
            if r.idx == replica.idx:
                continue
            if getattr(r, "healthy", False) \
                    and self._h(r.idx).state == STATE_HEALTHY:
                return True
        return False

    # -- probe / reinstate lifecycle -----------------------------------

    def _probe_loop(self) -> None:
        while not self._closing:
            time.sleep(0.05)
            if self._closing:
                return
            now = time.monotonic()
            for r in self.replicas:
                if self._closing:
                    return
                with self._lock:
                    h = self._h(r.idx)
                    due = h.state == STATE_EJECTED \
                        and now >= h.next_probe_at \
                        and getattr(r, "healthy", False)
                if due:
                    self._probe_once(r)

    def _pick_probe(self) -> Optional[Tuple[str, np.ndarray]]:
        with self._lock:
            if not self._templates:
                return None
            model = next(iter(self._templates))
            return model, self._templates[model]

    def _probe_once(self, replica: Any) -> None:
        tpl = self._pick_probe()
        if tpl is None:
            # no traffic observed yet — nothing to probe with; retry
            # on the same schedule
            with self._lock:
                self._h(replica.idx).next_probe_at = \
                    time.monotonic() + self.probe_interval
            return
        model, rows = tpl
        with self._lock:
            self._h(replica.idx).probing = True
        telemetry.counter(events.CTR_FLEET_PROBES).inc()
        try:
            ok, detail = self.probe_fn(replica, model, rows)
        except Exception as e:  # noqa: BLE001 — a probe crash is a
            ok, detail = False, f"{type(e).__name__}: {e}"  # failure
        now = time.monotonic()
        reinstate = False
        with self._lock:
            h = self._h(replica.idx)
            if ok:
                h.probe_ok_streak += 1
                h.probe_backoff_s = self.probe_interval
                if h.probe_ok_streak >= self.probe_ok \
                        and h.state == STATE_EJECTED:
                    h.state = STATE_HEALTHY
                    h.probing = False
                    h.score = 0.0
                    h.last_decay = now
                    h.strikes = {}
                    h.lat_ema_s = None
                    h.reinstatements += 1
                    reinstate = True
            else:
                h.probe_ok_streak = 0
                h.probe_fails += 1
                h.probe_backoff_s = min(
                    self.probe_backoff_cap,
                    max(self.probe_interval, h.probe_backoff_s * 2))
            h.next_probe_at = now + h.probe_backoff_s
            streak = h.probe_ok_streak
        telemetry.counter(events.CTR_FLEET_PROBES_OK if ok
                          else events.CTR_FLEET_PROBES_FAILED).inc()
        telemetry.event(
            events.EV_FLEET_PROBE_RESULT, replica=replica.idx,
            ok=bool(ok), streak=streak, model=model, detail=detail,
            state=STATE_HEALTHY if reinstate else STATE_PROBING)
        if reinstate:
            telemetry.counter(events.CTR_FLEET_REINSTATEMENTS).inc()
            telemetry.gauge(events.GAUGE_FLEET_REPLICAS_EJECTED).set(
                self.ejected_count())
            telemetry.gauge(
                f"fleet.replica.{replica.idx}.health_score").set(0.0)
            telemetry.event(
                events.EV_FLEET_REPLICA_REINSTATED,
                replica=replica.idx, state=STATE_HEALTHY,
                probes_ok=streak)
            log.info("replica %d REINSTATED after %d clean probes",
                      replica.idx, streak)

    # -- introspection / teardown --------------------------------------

    def status(self, replica: Any) -> Dict[str, Any]:
        """The operator's why-is-it-out-of-rotation row."""
        now = time.monotonic()
        with self._lock:
            h = self._h(replica.idx)
            return {
                "state": h.public_state(),
                "health_score": round(h.decayed_score(now), 3),
                "strikes": dict(h.strikes),
                "hedge_wins": h.hedge_wins,
                "hedge_losses": h.hedge_losses,
                "probe_ok_streak": h.probe_ok_streak,
                "probe_fails": h.probe_fails,
                "ejections": h.ejections,
                "reinstatements": h.reinstatements,
                "latency_ema_ms": round(1000.0 * h.lat_ema_s, 3)
                if h.lat_ema_s is not None else None,
            }

    def close(self) -> None:
        self._closing = True
        self._probe_thread.join(timeout=5.0)
