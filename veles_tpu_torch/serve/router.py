"""The fleet router: N hive replicas behind one front end.

``python -m veles_tpu_torch --serve-fleet N NAME=PKG.vpkg [NAME=PKG ...]``

Counterpart of ``veles_tpu/serve/router.py``.  :class:`FleetRouter` owns
N hive replicas (:mod:`veles_tpu_torch.serve.fleet` spawns and
supervises them; on one card each is a process with its own CUDA
context) and fans concurrent requests out across them:

- **placement-aware routing**: a request goes to the least-loaded
  healthy replica holding the model (router-side in-flight count),
  falling back to any healthy replica, which LRU-loads the model;
- **failover**: a replica death fails its in-flight requests with
  ``ReplicaDied`` at once; the router retries each once on a healthy
  peer while the monitor respawns the replica into its warm install dir;
- **admission control**: a bounded per-replica queue and an SLO target
  (``$VELES_FLEET_SLO_P99_MS``): when the estimated completion (queue
  depth x observed dispatch cadence) would blow the target on the
  least-loaded candidate, the request is shed with an explicit
  ``overloaded`` answer;
- **canary**: a model registered as the canary of another receives a
  deterministic fraction of its traffic as asynchronous mirrors, with
  per-model telemetry (``fleet.model.<name>.*``);
- **gray-failure defense** (:mod:`veles_tpu_torch.serve.sentinel`):
  deadlines end to end, budget-capped hedging, the rows_n/crc integrity
  echo, ejection with probes;
- **elastic membership**: :meth:`FleetRouter.add_replica` /
  :meth:`FleetRouter.retire_replica` and the degradation rungs
  (:meth:`FleetRouter.apply_degradation`) the autoscaler
  (:mod:`veles_tpu_torch.serve.autoscale`) drives.

The CLI speaks a hive's JSONL protocol (hello with ``"fleet": N``,
heartbeats, ``{"id", "model", "rows"}`` in, ``{"id", "pred", "probs"}``
out, ``op=fleet``, ``op=stats``, ``shutdown``); SIGTERM drains and exits
14.  A shed answer is ``{"id", "error": "overloaded", "overloaded":
true}``.  The replicas run on the card unless ``-b cpu`` asks for the
CPU.  ``--metrics-dir DIR`` (``FleetRouter(metrics_dir=)``) persists the
router's telemetry in DIR and each replica's in ``DIR/replica-<i>``
(a respawn writes its new pid's files beside the dead one's), the
layout ``veles_tpu/obs.py`` ``fleet_rows`` reads.  ``--mesh`` (the
reference's ``router.py:105``, ``:161-179``, :func:`parse_mesh`): a bare
``N`` gives every replica a ``--mesh N`` hive, ``I=N`` (repeatable) only
replica I, the mixed fleet; each replica's capacity comes from its own
hello (``devices`` x the per-place budget), which the placement reads.

Tracing (``veles_tpu_torch/trace.py``, ``$VELES_TRACE_SAMPLE``): each
request is minted a root context at :meth:`FleetRouter.request` and runs
under it; a sampled one journals ``trace.request`` (outcome, seconds)
and is the exemplar of ``fleet.request_seconds``.  Each leg of a routed
round (the primary, a hedge copy, a failover retry's attempt, a canary
mirror) sends a child span on its wire message, and the three routed
ones journal ``trace.leg`` (replica, verdict, seconds, hedge, winner).
``veles_tpu_torch/obs.py`` assembles the router's and the replicas'
journals into one trace a request.  A hedge is recorded in the flight
recorder's ring, which a SIGTERM drain dumps.  The locks come from the
witness's factories as ``router.state`` and ``router.emit``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import sys
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, knobs, telemetry, trace
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.serve.client import ReplicaDied
from veles_tpu_torch.serve.fleet import PlacementPolicy, Replica, ReplicaSet
from veles_tpu_torch.serve.sentinel import Sentinel

log = logging.getLogger("veles.serve.router")

#: the exit code the supervisor reads as "preempted, resume me"
EXIT_PREEMPTED = 14


class FleetRouter:
    """Own N hive replicas; route, shed, mirror and fail over."""

    def __init__(self, models: Dict[str, str], n_replicas: int,
                 backend: str = "auto",
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 hbm_budget: Optional[int] = None,
                 heartbeat_every: Optional[float] = None,
                 cwd: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 canaries: Optional[Dict[str, Tuple[str, Optional[float]]]]
                 = None,
                 placement: Optional[PlacementPolicy] = None,
                 slo_p99_ms: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 heartbeat_deadline: Optional[float] = None,
                 respawn_backoff: Optional[float] = None,
                 start_timeout: float = 300.0,
                 deadline_ms: Optional[float] = None,
                 hedge_min_ms: Optional[float] = None,
                 hedge_budget: Optional[float] = None,
                 eject_threshold: Optional[float] = None,
                 probe_ok: Optional[int] = None,
                 probe_interval: Optional[float] = None,
                 probe_backoff_cap: Optional[float] = None,
                 env_overrides: Optional[Dict[int, Dict[str, str]]] = None,
                 stderr: Any = None,
                 metrics_dir: Optional[str] = None,
                 mesh: Any = None) -> None:
        if n_replicas < 1:
            raise ValueError(f"a fleet needs >= 1 replica, got "
                             f"{n_replicas}")
        if not models:
            raise ValueError("a fleet needs at least one model")
        self.models = dict(models)
        self.n_replicas = int(n_replicas)
        #: {canary_name: (primary_name, fraction)}
        self.canaries: Dict[str, Tuple[str, float]] = {}
        default_frac = float(knobs.get(knobs.FLEET_CANARY_FRACTION))
        for cname, (primary, frac) in (canaries or {}).items():
            if cname not in self.models:
                raise ValueError(f"canary {cname!r} is not a registered "
                                 f"model")
            if primary not in self.models:
                raise ValueError(f"canary {cname!r} mirrors unknown model "
                                 f"{primary!r}")
            if cname == primary:
                raise ValueError(f"{cname!r} cannot canary itself")
            f = default_frac if frac is None else float(frac)
            if not 0.0 <= f <= 1.0:
                raise ValueError(f"canary fraction must be in [0, 1], got "
                                 f"{f} for {cname!r}")
            self.canaries[cname] = (primary, f)
        self._mirrors_by_primary: Dict[str, List[Tuple[str, float]]] = {}
        for cname, (primary, f) in self.canaries.items():
            self._mirrors_by_primary.setdefault(primary, []).append(
                (cname, f))
        #: admission knobs: plain attributes, retunable on a live fleet
        self.slo_p99_ms = float(slo_p99_ms) if slo_p99_ms is not None \
            else float(knobs.get(knobs.FLEET_SLO_P99_MS))
        self.max_inflight = int(max_inflight) \
            if max_inflight is not None \
            else int(knobs.get(knobs.FLEET_MAX_INFLIGHT))
        #: default per-request deadline budget (ms)
        self.deadline_ms = float(deadline_ms) \
            if deadline_ms is not None \
            else float(knobs.get(knobs.FLEET_DEADLINE_MS))
        if metrics_dir:
            telemetry.configure(metrics_dir)
        self.metrics_dir = metrics_dir

        def _replica_env(i: int) -> Optional[Dict[str, str]]:
            # per-replica overrides: a drill arms ONE replica's
            # VELES_FAULTS without touching its peers
            over = (env_overrides or {}).get(i)
            if not over:
                return env
            merged = dict(env or {})
            merged.update(over)
            return merged

        def _replica_mesh(i: int) -> int:
            # an int meshes every replica, {I: N} only replica I (the
            # mixed one-device / N-place fleet)
            if mesh is None:
                return 0
            if isinstance(mesh, dict):
                return int(mesh.get(i, 0))
            return int(mesh)

        def _make_replica(i: int,
                          install_dir: Optional[str] = None) -> Replica:
            return Replica(i, self.models, backend=backend,
                           max_batch=max_batch, max_wait_ms=max_wait_ms,
                           hbm_budget=hbm_budget,
                           heartbeat_every=heartbeat_every, cwd=cwd,
                           env=_replica_env(i),
                           start_timeout=start_timeout,
                           install_dir=install_dir, stderr=stderr,
                           metrics_dir=metrics_dir, mesh=_replica_mesh(i))

        #: the scale-up path reuses the founding replicas' recipe
        self._make_replica = _make_replica
        self.replicas = [_make_replica(i) for i in range(self.n_replicas)]
        self.fleet = ReplicaSet(
            self.replicas, heartbeat_deadline=heartbeat_deadline,
            respawn_backoff=respawn_backoff)
        hellos = self.fleet.start()
        self.hello_models = hellos[0].get("models", {})

        #: routing affinity, against the capacity each hello advertised
        policy = placement or PlacementPolicy(budget_bytes=hbm_budget)
        self.placement = policy.assign(
            {name: self.hello_models.get(name, {}).get("param_bytes", 0)
             for name in self.models},
            self.n_replicas,
            capacities=[r.capacity_bytes for r in self.replicas])
        self._lock = witness.lock("router.state")
        self._routed = [0] * self.n_replicas
        self._mirror_acc: Dict[str, float] = {}
        self._closed = False
        #: next replica index: indices are never reused
        self._next_idx = self.n_replicas
        #: install dirs of retired replicas, for the next scale-up
        self._warm_dirs: List[str] = []
        #: the replicated hot prefix: a scale-up joins these; the rest is
        #: the sheddable long tail
        self._hot_models = {m for m, placed in self.placement.items()
                            if len(placed) == self.n_replicas}
        #: degradation-ladder levers (``apply_degradation``)
        self.hedging_enabled = True
        self.shed_tail = False
        sentinel_kw = {}
        if probe_backoff_cap is not None:
            sentinel_kw["probe_backoff_cap"] = probe_backoff_cap
        self.sentinel = Sentinel(
            self.replicas, probe_fn=self._probe_replica,
            hedge_min_ms=hedge_min_ms, hedge_budget=hedge_budget,
            eject_threshold=eject_threshold, probe_ok=probe_ok,
            probe_interval=probe_interval, **sentinel_kw)
        telemetry.event(events.EV_FLEET_PLACEMENT, placement=self.placement)
        telemetry.event(
            events.EV_FLEET_READY, replicas=self.n_replicas,
            pids=[h.get("pid") for h in hellos],
            models=sorted(self.models),
            canaries={c: {"of": p, "fraction": f}
                      for c, (p, f) in self.canaries.items()},
            slo_p99_ms=self.slo_p99_ms, max_inflight=self.max_inflight)
        log.info("fleet up: %d replicas (pids %s), %d models, placement "
                 "%s", self.n_replicas, [h.get("pid") for h in hellos],
                 len(self.models), self.placement)

    # -- routing -------------------------------------------------------

    def _pick(self, model: str,
              exclude: Tuple[Replica, ...] = ()) -> Optional[Replica]:
        """The least-loaded healthy, non-ejected replica holding
        ``model``; any eligible replica when none of the placed set is."""
        placed = set(self.placement.get(model, ()))
        healthy = [r for r in self.fleet.healthy()
                   if r not in exclude and not r.retiring
                   and self.sentinel.eligible(r)]
        candidates = [r for r in healthy if r.idx in placed] or healthy
        if not candidates:
            return None
        return min(candidates, key=lambda r: (r.inflight, r.idx))

    def _shed(self, r: Replica) -> Optional[float]:
        """Admission control on the picked (least-loaded) candidate: the
        estimated completion in ms when the request must be shed, None
        when it is admitted."""
        if r.inflight >= self.max_inflight:
            return float(r.estimated_total_ms())
        if self.slo_p99_ms > 0:
            est = r.estimated_total_ms()
            telemetry.gauge(events.GAUGE_FLEET_EST_WAIT_MS).set(
                round(est, 3))
            if est > self.slo_p99_ms:
                return float(est)
        return None

    def request(self, model: str, rows: Any, timeout: float = 60.0,
                deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """One routed round trip: the replica's answer ({"pred",
        "probs"}), an {"error": ...} dict, or the shed answer {"error":
        "overloaded", "overloaded": True}.  Never raises for a replica's
        death, overload or a blown deadline.

        ``deadline_ms`` is the request's absolute unix-epoch deadline;
        None stamps now + min($VELES_FLEET_DEADLINE_MS, timeout)."""
        telemetry.counter(events.CTR_FLEET_REQUESTS).inc()
        telemetry.counter(f"fleet.model.{model}.requests").inc()
        rows = np.asarray(rows, np.float32)
        self.sentinel.note_request(model, rows)
        if deadline_ms is None:
            budget = self.deadline_ms if self.deadline_ms > 0 \
                else 1000.0 * timeout
            if timeout:
                budget = min(budget, 1000.0 * timeout)
            deadline_ms = time.time() * 1000.0 + budget
        # the trace root is minted here, at the admission edge: every leg
        # (hedge copies, failover retries, canary mirrors) derives a
        # child span from it, so one request assembles into one tree
        # across processes however it was routed
        ctx = trace.mint()
        t0 = time.perf_counter()
        with trace.use(ctx):
            resp = self._dispatch(model, rows, float(deadline_ms))
            if resp.get("overloaded"):
                telemetry.counter(events.CTR_FLEET_SHED).inc()
                telemetry.counter(f"fleet.model.{model}.shed").inc()
            elif "error" in resp:
                telemetry.counter(events.CTR_FLEET_REQUEST_ERRORS).inc()
                telemetry.counter(f"fleet.model.{model}.errors").inc()
            else:
                dt = time.perf_counter() - t0
                telemetry.histogram(
                    events.HIST_FLEET_REQUEST_SECONDS).record(
                    dt, exemplar=ctx.trace_id if ctx.sampled else None)
                telemetry.histogram(
                    f"fleet.model.{model}.request_seconds").record(dt)
                self._maybe_mirror(model, rows)
            if ctx.sampled:
                outcome = ("shed" if resp.get("overloaded")
                           else "timeout" if resp.get("timeout")
                           else "error" if "error" in resp else "ok")
                telemetry.event(
                    events.EV_TRACE_REQUEST, trace=ctx.trace_id,
                    span=ctx.span_id, model=model, rows=int(len(rows)),
                    outcome=outcome,
                    seconds=round(time.perf_counter() - t0, 6))
                trace.record("fleet.request", ctx=ctx, model=model,
                             outcome=outcome)
        return resp

    def _dispatch(self, model: str, rows: Any,
                  deadline_ms: float) -> Dict[str, Any]:
        if self.shed_tail and model not in self._hot_models:
            # the ladder's last rung: the long tail is shed explicitly
            return {"error": "overloaded", "overloaded": True,
                    "degraded": True, "model": model}
        r = self._pick(model)
        if r is None:
            return {"error": "no healthy replica", "model": model}
        est = self._shed(r)
        if est is not None:
            return {"error": "overloaded", "overloaded": True,
                    "model": model, "est_ms": round(est, 2)}
        tried: Tuple[Replica, ...] = ()
        cur = r
        resp: Dict[str, Any] = {"error": "unroutable", "model": model}
        for attempt in (0, 1):
            resp, verdict = self._routed_round(model, rows, cur,
                                               deadline_ms, tried)
            if verdict in ("ok", "timeout"):
                # a blown deadline is final: a retry would answer after
                # nobody is waiting
                return resp
            # died or integrity: retry once on a healthy peer
            # (inference is idempotent); admission is not re-run
            tried = tried + (cur,)
            if attempt == 0:
                telemetry.counter(events.CTR_FLEET_RETRIES).inc()
                peer = self._pick(model, exclude=tried)
                if peer is None:
                    return {"error": f"replica failed ({verdict}) and no "
                                     f"healthy peer", "model": model}
                cur = peer
        return resp

    def _routed_round(self, model: str, rows: np.ndarray,
                      primary: Replica, deadline_ms: float,
                      tried: Tuple[Replica, ...]
                      ) -> Tuple[Dict[str, Any], str]:
        """One routed attempt with hedging: submit to ``primary``; once
        the request outlives the adaptive hedge threshold (and the budget
        allows), send a second copy to another replica, take the first
        clean answer and cancel the loser by wire id.  Returns (answer,
        verdict), verdict one of ``ok`` (also a replica-side request
        error: deterministic, not gray), ``timeout``, ``died``,
        ``integrity``.

        Two phases, so the usual case (the answer beats the threshold)
        costs one submit and one blocking wait; the fan-in queue exists
        only for a request that hedges.

        Each leg (the primary attempt, the hedge copy, a failover retry's
        attempt) gets a child span of the request's context, carried on
        its wire message and journaled as ``trace.leg``.  The context is
        read once here, on the admitting thread: the hedge's answers
        arrive on the clients' reader threads, which hold none."""
        n_rows = int(len(rows))
        t_start = time.perf_counter()
        rctx = trace.current()

        def leg_ctx() -> Optional[trace.TraceContext]:
            return rctx.child() \
                if rctx is not None and rctx.sampled else None

        def leg_event(rep: Replica, lctx: Optional[trace.TraceContext],
                      verdict: str, t0_leg: float, hedge: bool = False,
                      winner: bool = False) -> None:
            if lctx is None:
                return
            telemetry.event(
                events.EV_TRACE_LEG, trace=lctx.trace_id,
                span=lctx.span_id, parent=lctx.parent_id,
                replica=rep.idx, verdict=verdict,
                seconds=round(time.perf_counter() - t0_leg, 6),
                hedge=bool(hedge), winner=bool(winner))

        def timeout_resp() -> Tuple[Dict[str, Any], str]:
            return ({"error": "deadline exceeded", "model": model,
                     "timeout": True,
                     "deadline_ms": round(deadline_ms, 1)}, "timeout")

        def evaluate(rep: Replica, msg: Dict[str, Any]) \
                -> Tuple[Dict[str, Any], str]:
            """Judge one answered leg (the caller already released)."""
            if "error" in msg:
                if msg.get("expired"):
                    # the hive's batcher dropped it past its deadline
                    self.sentinel.record_timeout(rep)
                    return timeout_resp()
                return msg, "ok"
            if not self._verify_integrity(msg, n_rows):
                self.sentinel.record_integrity(rep)
                return ({"error": "response failed integrity check",
                         "model": model}, "integrity")
            self.sentinel.record_ok(rep, model,
                                    time.perf_counter() - t_start)
            return msg, "ok"

        def died(rep: Replica) -> Tuple[Dict[str, Any], str]:
            rep.mark_dead()
            self.sentinel.record_died(rep)
            return {"error": "replica died", "model": model}, "died"

        remain_s = (deadline_ms - time.time() * 1000.0) / 1000.0
        if remain_s <= 0:
            return timeout_resp()
        with self._lock:
            self._routed[primary.idx] += 1
        primary.acquire()
        telemetry.gauge(events.GAUGE_FLEET_INFLIGHT).set(
            self.inflight_total())
        pctx = leg_ctx()
        t_leg0 = time.perf_counter()
        try:
            jid = primary.client.submit(model, rows,
                                        deadline_ms=deadline_ms, ctx=pctx)
        except ReplicaDied:
            primary.release()
            leg_event(primary, pctx, "died", t_leg0)
            return died(primary)
        # -- phase 1: a plain wait until the hedge threshold
        hedge_thr_s = self.sentinel.hedge_threshold_ms(model) / 1000.0
        try:
            msg = primary.client.wait_for(
                jid, timeout=max(0.001, min(hedge_thr_s, remain_s)))
            primary.release()
            out = evaluate(primary, msg)
            leg_event(primary, pctx, out[1], t_leg0,
                      winner=out[1] == "ok")
            return out
        except TimeoutError:
            pass   # outlived the hedge threshold
        except ReplicaDied:
            # the wire id is retired all the same: a respawned client
            # can never collide with it
            primary.client.cancel(jid)
            primary.release()
            leg_event(primary, pctx, "died", t_leg0)
            return died(primary)
        remain_s = (deadline_ms - time.time() * 1000.0) / 1000.0
        if remain_s <= 0:
            primary.client.cancel(jid)
            primary.release()
            self.sentinel.record_timeout(primary)
            leg_event(primary, pctx, "timeout", t_leg0)
            return timeout_resp()
        peer: Optional[Replica] = None
        if self.hedging_enabled and self.sentinel.hedge_budget > 0:
            cand = self._pick(model, exclude=tried + (primary,))
            # a hedge duplicates load: it passes the same admission gate
            # a fresh request would
            if cand is not None and self._shed(cand) is None \
                    and self.sentinel.allow_hedge():
                peer = cand
            elif cand is not None:
                telemetry.counter(events.CTR_FLEET_HEDGE_DENIED).inc()
        if peer is None:
            # no hedge: wait the primary out to the deadline
            try:
                msg = primary.client.wait_for(
                    jid, timeout=max(0.001, remain_s))
            except TimeoutError:
                primary.client.cancel(jid)
                primary.release()
                self.sentinel.record_timeout(primary)
                leg_event(primary, pctx, "timeout", t_leg0)
                return timeout_resp()
            except ReplicaDied:
                primary.client.cancel(jid)
                primary.release()
                leg_event(primary, pctx, "died", t_leg0)
                return died(primary)
            primary.release()
            out = evaluate(primary, msg)
            leg_event(primary, pctx, out[1], t_leg0,
                      winner=out[1] == "ok")
            return out
        # -- phase 2: the hedged fan-in (the rare, already slow case)
        telemetry.counter(events.CTR_FLEET_HEDGES).inc()
        trace.record("fleet.hedge", ctx=rctx, model=model,
                     primary=primary.idx, peer=peer.idx)
        results: "queue.SimpleQueue[Tuple[Replica, int, Any, Any]]" = \
            queue.SimpleQueue()
        outstanding: Dict[Tuple[int, int], Replica] = {
            (primary.idx, jid): primary}
        #: each leg's span, submit time and hedge flag, keyed like
        #: ``outstanding``: both legs are journaled, the winner marked
        legmeta: Dict[Tuple[int, int],
                      Tuple[Optional[trace.TraceContext], float, bool]] = {
            (primary.idx, jid): (pctx, t_leg0, False)}
        primary.client.collect_async(
            jid, lambda m, e, rep=primary, j=jid:
            results.put((rep, j, m, e)))
        with self._lock:
            self._routed[peer.idx] += 1
        peer.acquire()
        hctx = leg_ctx()
        t_hleg0 = time.perf_counter()
        try:
            hjid = peer.client.submit(model, rows, deadline_ms=deadline_ms,
                                      ctx=hctx)
        except ReplicaDied:
            peer.release()
            peer.mark_dead()
            self.sentinel.record_died(peer)
            leg_event(peer, hctx, "died", t_hleg0, hedge=True)
        else:
            # registered only after the submit succeeded
            outstanding[(peer.idx, hjid)] = peer
            legmeta[(peer.idx, hjid)] = (hctx, t_hleg0, True)
            peer.client.collect_async(
                hjid, lambda m, e, rep=peer, j=hjid:
                results.put((rep, j, m, e)))

        def drop_outstanding(score_timeout: bool) -> None:
            for key, rep in list(outstanding.items()):
                rep.client.cancel(key[1])
                rep.release()
                if score_timeout:
                    self.sentinel.record_timeout(rep)
                lctx, t0l, hedged = legmeta.get(key, (None, t_start, False))
                leg_event(rep, lctx,
                          "timeout" if score_timeout else "cancelled",
                          t0l, hedge=hedged)
            outstanding.clear()

        fail: Optional[Tuple[Dict[str, Any], str]] = None
        while outstanding:
            remain_s = (deadline_ms - time.time() * 1000.0) / 1000.0
            if remain_s <= 0:
                drop_outstanding(score_timeout=True)
                return timeout_resp()
            try:
                rep, rjid, msg, err = results.get(
                    timeout=max(0.001, remain_s))
            except queue.Empty:
                continue
            if (rep.idx, rjid) not in outstanding:
                continue   # already cancelled
            outstanding.pop((rep.idx, rjid))
            rep.release()
            lctx, t0l, hedged = legmeta.get((rep.idx, rjid),
                                            (None, t_start, False))
            if err is not None:
                leg_event(rep, lctx, "died", t0l, hedge=hedged)
                fail = died(rep)
                continue   # the other leg may still answer
            out = evaluate(rep, msg)
            leg_event(rep, lctx, out[1], t0l, hedge=hedged,
                      winner=out[1] == "ok")
            if out[1] == "ok":
                if rep is peer and "probs" in out[0]:
                    self.sentinel.record_hedge_win(rep, primary)
                drop_outstanding(score_timeout=False)
                return out
            fail = out   # expired or integrity: the other leg may save it
        return fail if fail is not None \
            else ({"error": "replica died", "model": model}, "died")

    @staticmethod
    def _verify_integrity(msg: Dict[str, Any], n_rows: int) -> bool:
        """The integrity echo: the payload carries exactly the requested
        rows and matches the crc32 the hive computed over its clean f32
        payload (f32 round-trips JSON exactly).  An answer without a crc
        passes on its row count."""
        if "probs" not in msg:
            return True
        try:
            probs = np.asarray(msg["probs"], np.float32)
        except (TypeError, ValueError):
            return False
        if probs.ndim < 1 or len(probs) != n_rows:
            return False
        rows_n = msg.get("rows_n")
        if rows_n is not None and int(rows_n) != len(probs):
            return False
        crc = msg.get("crc")
        if crc is not None and zlib.crc32(probs.tobytes()) != int(crc):
            return False
        return True

    def _probe_replica(self, r: Replica, model: str,
                       rows: np.ndarray) -> Tuple[bool, str]:
        """One synthetic request aimed straight at replica ``r`` (it is
        ejected: routing bypassed), the sentinel's reinstatement
        evidence.  Clean = answered inside the probe deadline and
        integrity-checked."""
        timeout_s = max(1.0, 4.0 * self.sentinel.hedge_threshold_ms(model)
                        / 1000.0)
        if not r.healthy or r.client is None:
            return False, "replica process down"
        deadline_ms = time.time() * 1000.0 + 1000.0 * timeout_s
        try:
            jid = r.client.submit(model, rows, deadline_ms=deadline_ms)
        except ReplicaDied as e:
            return False, f"died at submit: {e}"
        try:
            msg = r.client.wait_for(jid, timeout=timeout_s)
        except TimeoutError:
            r.client.cancel(jid)
            return False, f"no answer in {timeout_s:.1f}s"
        except ReplicaDied as e:
            r.client.cancel(jid)
            return False, f"died: {e}"
        if "error" in msg:
            return False, f"error: {msg['error']}"
        if not self._verify_integrity(msg, int(len(rows))):
            return False, "integrity mismatch"
        return True, "clean"

    def _maybe_mirror(self, primary: str, rows: Any) -> None:
        """Mirror a deterministic fraction of ``primary``'s admitted
        traffic to each of its canaries, asynchronously (the caller's
        latency never carries the mirror)."""
        pairs = self._mirrors_by_primary.get(primary)
        if not pairs:
            return
        for cname, frac in pairs:
            with self._lock:
                acc = self._mirror_acc.get(cname, 0.0) + frac
                fire = acc >= 1.0
                self._mirror_acc[cname] = acc - 1.0 if fire else acc
            if not fire:
                continue
            r = self._pick(cname)
            if r is None:
                continue
            telemetry.counter(events.CTR_FLEET_MIRRORED).inc()
            telemetry.counter(f"fleet.model.{cname}.requests").inc()
            telemetry.counter(f"fleet.model.{cname}.mirrored").inc()
            t0 = time.perf_counter()
            # the mirror joins the primary request's trace, so a canary
            # regression ties back to the traffic that hit it
            c = trace.current()
            mctx = c.child() if c is not None and c.sampled else None
            r.acquire()
            try:
                jid = r.client.submit(
                    cname, rows,
                    deadline_ms=time.time() * 1000.0 + self.deadline_ms
                    if self.deadline_ms > 0 else None, ctx=mctx)
            except ReplicaDied:
                r.release()
                r.mark_dead()
                telemetry.counter(f"fleet.model.{cname}.errors").inc()
                continue

            def _collect(msg, err, r=r, cname=cname, t0=t0):
                r.release()
                if err is not None or (msg and "error" in msg):
                    telemetry.counter(f"fleet.model.{cname}.errors").inc()
                else:
                    telemetry.histogram(
                        f"fleet.model.{cname}.request_seconds").record(
                        time.perf_counter() - t0)

            r.client.collect_async(jid, _collect)

    # -- elastic scaling -----------------------------------------------

    def add_replica(self, cause: str = "manual",
                    **info: Any) -> Optional[Replica]:
        """Scale up by one replica: spawn it (into a warm install dir
        from a retired peer when one is pooled), join it to the hot
        placement, hand it to the monitor and the sentinel.  Routing
        never sees it before its hello.  None when the spawn failed."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
            warm = self._warm_dirs.pop() if self._warm_dirs else None
        r = self._make_replica(idx, install_dir=warm)
        try:
            hello = r.spawn()
        except Exception as e:  # noqa: BLE001 — a failed scale-up
            log.error("scale-up replica %d failed to spawn: %s: %s", idx,
                      type(e).__name__, e)
            try:
                r.close(kill=True)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            return None
        with self._lock:
            while len(self._routed) <= idx:
                self._routed.append(0)
            # the new member serves the replicated hot prefix; the
            # partitioned tail keeps its owners
            for m in self._hot_models:
                placed = self.placement.get(m)
                if placed is not None and idx not in placed:
                    placed.append(idx)
        # the health record before routing can see it
        self.sentinel.add_replica(r)
        self.fleet.add(r)
        telemetry.counter(events.CTR_FLEET_SCALE_UPS).inc()
        telemetry.event(events.EV_FLEET_REPLICA_SPAWNED, replica=idx,
                        pid=hello.get("pid"), models=sorted(r.models))
        telemetry.event(events.EV_FLEET_SCALE_UP, replica=idx,
                        pid=hello.get("pid"), cause=cause,
                        warm_dir=warm is not None,
                        n_replicas=len(self.replicas), **info)
        telemetry.event(events.EV_FLEET_PLACEMENT, placement=self.placement)
        log.info("scale-up: replica %d (pid %s, %s install dir), fleet "
                 "now %d", idx, hello.get("pid"),
                 "warm" if warm else "cold", len(self.replicas))
        return r

    def retire_replica(self, cause: str = "manual",
                       drain_timeout: float = 30.0,
                       **info: Any) -> Optional[int]:
        """Scale down by one replica, in the only safe order:

        1. mark it ``retiring``: routing, hedges and mirrors exclude it,
           the monitor stops supervising it;
        2. re-place its exclusive models onto a survivor (every replica
           spawns with the full model set, so it LRU-loads them);
        3. drain its router-side in-flight requests;
        4. only then remove it from supervision and SIGTERM it (the
           hive drains its batcher and exits 14);
        5. pool its install dir for the next scale-up.

        Returns the retired replica's index, or None when no member can
        retire (a lone or all-unhealthy fleet)."""
        with self._lock:
            # the youngest healthy member retires
            cands = [r for r in self.replicas
                     if not r.retiring and r.healthy]
            if len(cands) < 2:
                return None
            victim = max(cands, key=lambda r: r.idx)
            victim.retiring = True
        survivors = [r for r in self.replicas
                     if r is not victim and not r.retiring]
        with self._lock:
            replaced = []
            for m, placed in self.placement.items():
                kept = [i for i in placed if i != victim.idx]
                if not kept:
                    tgt = min((r for r in survivors if r.healthy),
                              key=lambda r: (r.inflight, r.idx),
                              default=survivors[0])
                    kept = [tgt.idx]
                    replaced.append((m, tgt.idx))
                self.placement[m] = kept
        if replaced:
            telemetry.event(events.EV_FLEET_PLACEMENT,
                            placement=self.placement)
            log.info("retire: re-placed exclusive models %s off replica "
                     "%d", replaced, victim.idx)
        deadline = time.monotonic() + drain_timeout
        while victim.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        drained = victim.inflight == 0
        self.fleet.remove(victim)
        self.sentinel.remove_replica(victim)
        rc = None
        if victim.client is not None and victim.alive:
            victim.client.sigterm()
            try:
                rc = victim.client.wait(timeout=30.0)
            except Exception:  # noqa: BLE001 — stuck in its drain
                pass
        victim.close(kill=True)
        with self._lock:
            self._warm_dirs.append(victim.install_dir)
        telemetry.counter(events.CTR_FLEET_SCALE_DOWNS).inc()
        telemetry.counter(events.CTR_FLEET_RETIRED).inc()
        telemetry.event(events.EV_FLEET_REPLICA_RETIRED,
                        replica=victim.idx, rc=rc, drained=drained,
                        replaced=[m for m, _ in replaced])
        telemetry.event(events.EV_FLEET_SCALE_DOWN, replica=victim.idx,
                        cause=cause, rc=rc,
                        n_replicas=len(self.replicas), **info)
        log.info("scale-down: replica %d retired (drained=%s, rc=%s), "
                 "fleet now %d", victim.idx, drained, rc,
                 len(self.replicas))
        return victim.idx

    def apply_degradation(self, rung: str, engage: bool,
                          cause: str = "manual", **info: Any) -> None:
        """Flip one ladder rung: ``learner`` fans learner_suspend /
        learner_resume to every live replica; ``hedge`` gates hedging;
        ``shed_tail`` sheds the non-hot models."""
        if rung == "learner":
            for r in list(self.replicas):
                if not r.healthy or r.client is None or r.retiring:
                    continue
                try:
                    r.client.learner_ctl(engage, timeout=10.0)
                except Exception as e:  # noqa: BLE001 — a replica
                    # mid-respawn misses the rung and comes back with
                    # its learner in the default state
                    log.warning("learner_ctl(%s) failed on replica %d: "
                                "%s", engage, r.idx, e)
        elif rung == "hedge":
            self.hedging_enabled = not engage
        elif rung == "shed_tail":
            self.shed_tail = engage
        else:
            raise ValueError(f"unknown degradation rung {rung!r}")
        telemetry.event(events.EV_FLEET_DEGRADE_ENGAGE if engage
                        else events.EV_FLEET_DEGRADE_RELEASE,
                        rung=rung, cause=cause, **info)

    # -- introspection -------------------------------------------------

    def routed_counts(self) -> List[int]:
        """Requests routed per replica index."""
        with self._lock:
            return list(self._routed)

    def inflight_total(self) -> int:
        return sum(r.inflight for r in list(self.replicas))

    def fleet_status(self) -> Dict[str, Any]:
        """One JSON-ready view of the fleet (the CLI's op=fleet), with
        each replica's sentinel row."""
        routed = self.routed_counts()
        return {
            "replicas": [
                {"replica": r.idx, "pid": r.pid, "healthy": r.healthy,
                 "inflight": r.inflight, "routed": routed[r.idx],
                 "deaths": r.deaths, "devices": r.devices,
                 "device_budget": (r.capacity_bytes // r.devices
                                   if r.capacity_bytes else None),
                 "ema_dispatch_ms": round(1000 * r.ema_dispatch_s, 3)
                 if r.ema_dispatch_s else None,
                 "retiring": r.retiring,
                 "sentinel": self.sentinel.status(r)}
                for r in list(self.replicas)],
            "n_replicas": len(self.replicas),
            "hedging_enabled": self.hedging_enabled,
            "shed_tail": self.shed_tail,
            "warm_dirs": len(self._warm_dirs),
            "placement": self.placement,
            "canaries": {c: {"of": p, "fraction": f}
                         for c, (p, f) in self.canaries.items()},
            "slo_p99_ms": self.slo_p99_ms,
            "max_inflight": self.max_inflight,
            "deadline_ms": self.deadline_ms,
            "hedge_rate": round(self.sentinel.hedge_rate(), 4),
        }

    # -- teardown ------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for every in-flight request to resolve."""
        deadline = time.monotonic() + timeout
        while self.inflight_total() > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)
        return True

    def close(self, kill: bool = False, reason: Optional[str] = None,
              code: int = 0) -> None:
        if self._closed:
            return
        self._closed = True
        self.sentinel.close()
        self.fleet.close(kill=kill)
        telemetry.event(events.EV_FLEET_SHUTDOWN,
                        routed=self.routed_counts(), reason=reason,
                        code=code)
        telemetry.flush()


# -- the CLI front end -----------------------------------------------------

def parse_mesh(specs: List[str]) -> Any:
    """``--mesh`` specs -> the FleetRouter ``mesh`` argument: a bare
    ``N`` meshes every replica with N places; ``I=N`` (repeatable) meshes
    only replica I.  The two forms do not mix (ValueError)."""
    if not specs:
        return None
    per: Dict[int, int] = {}
    uniform: Optional[int] = None
    for s in specs:
        idx, eq, n = s.partition("=")
        if eq:
            per[int(idx)] = int(n)
        else:
            uniform = int(s)
    if per and uniform is not None:
        raise ValueError(
            "mix of bare N and I=N --mesh specs; use one form")
    return per if per else uniform


def parse_canary(spec: str) -> Tuple[str, str, Optional[float]]:
    """``CNAME=PRIMARY[:FRACTION]`` -> (cname, primary, fraction)."""
    cname, _, rest = spec.partition("=")
    primary, _, frac_s = rest.partition(":")
    if not cname or not primary:
        raise ValueError(f"bad --canary spec {spec!r} (want "
                         f"CANARY=PRIMARY[:FRACTION])")
    return cname, primary, float(frac_s) if frac_s else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch --serve-fleet",
        description="Fleet router over N hive replicas (PyTorch/CUDA "
                    "port)")
    p.add_argument("replicas", type=int,
                   help="replica count (each is one --serve-models "
                        "process)")
    p.add_argument("models", nargs="+", metavar="NAME=PKG",
                   help="model name = Forge ensemble package path; the "
                        "declaration order is the placement's hotness "
                        "order")
    p.add_argument("-b", "--backend", default="auto",
                   help="the replicas' backend: auto|cuda (the card; "
                        "fails without one) or cpu")
    p.add_argument("--mesh", action="append", default=[],
                   metavar="N|I=N",
                   help="places per replica: a bare N meshes every "
                        "replica, I=N (repeatable) only replica I; "
                        "placement follows each replica's advertised "
                        "capacity ($VELES_SERVE_MESH)")
    p.add_argument("--canary", action="append", default=[],
                   metavar="CNAME=PRIMARY[:FRACTION]",
                   help="register model CNAME as the canary of PRIMARY, "
                        "mirroring FRACTION of its traffic (default "
                        "$VELES_FLEET_CANARY_FRACTION)")
    p.add_argument("--hot", action="append", default=None,
                   metavar="NAME",
                   help="the placement's hot set (repeatable): hot "
                        "models replicate on every replica")
    p.add_argument("--max-batch", type=int,
                   default=int(knobs.get(knobs.SERVE_MAX_BATCH)))
    p.add_argument("--max-wait-ms", type=float,
                   default=float(knobs.get(knobs.SERVE_MAX_WAIT_MS)))
    p.add_argument("--hbm-budget", type=int, default=0,
                   help="per-replica residency budget in bytes")
    p.add_argument("--slo-p99-ms", type=float,
                   default=float(knobs.get(knobs.FLEET_SLO_P99_MS)),
                   help="admission-control SLO target "
                        "($VELES_FLEET_SLO_P99_MS; 0 disables shedding)")
    p.add_argument("--max-inflight", type=int,
                   default=int(knobs.get(knobs.FLEET_MAX_INFLIGHT)),
                   help="per-replica in-flight bound "
                        "($VELES_FLEET_MAX_INFLIGHT)")
    p.add_argument("--deadline-ms", type=float,
                   default=float(knobs.get(knobs.FLEET_DEADLINE_MS)),
                   help="default per-request deadline budget "
                        "($VELES_FLEET_DEADLINE_MS); a request's own "
                        "deadline_ms overrides it")
    p.add_argument("--heartbeat-every", type=float,
                   default=float(knobs.get(knobs.HEARTBEAT_EVERY)))
    p.add_argument("--metrics-dir", default=None,
                   help="persist the router's telemetry here and each "
                        "replica's in <dir>/replica-<i> (also "
                        "$VELES_METRICS_DIR)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from concurrent.futures import ThreadPoolExecutor

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.INFO, stream=sys.stderr)
    if args.replicas < 1:
        print(f"--serve-fleet: replica count must be >= 1 (got "
              f"{args.replicas})", file=sys.stderr)
        return 2
    specs: Dict[str, str] = {}
    for spec in args.models:
        name, _, path = spec.partition("=")
        if not name or not path:
            print(f"--serve-fleet: bad model spec {spec!r} (want "
                  f"NAME=PACKAGE.vpkg)", file=sys.stderr)
            return 2
        if not os.path.isfile(path):
            print(f"--serve-fleet: no such package {path!r}",
                  file=sys.stderr)
            return 2
        specs[name] = os.path.abspath(path)
    canaries: Dict[str, Tuple[str, Optional[float]]] = {}
    try:
        for cspec in args.canary:
            cname, primary, frac = parse_canary(cspec)
            canaries[cname] = (primary, frac)
        mesh = parse_mesh(args.mesh)
        router = FleetRouter(
            specs, args.replicas, backend=args.backend,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            hbm_budget=args.hbm_budget or None,
            heartbeat_every=args.heartbeat_every, canaries=canaries,
            placement=PlacementPolicy(
                budget_bytes=args.hbm_budget or None,
                hot=set(args.hot) if args.hot else None),
            slo_p99_ms=args.slo_p99_ms, max_inflight=args.max_inflight,
            deadline_ms=args.deadline_ms,
            metrics_dir=args.metrics_dir, mesh=mesh)
    except (ValueError, RuntimeError) as e:
        print(f"--serve-fleet: {e}", file=sys.stderr)
        return 2

    emit_lock = witness.lock("router.emit")

    def emit(obj: Dict[str, Any]) -> None:
        line = json.dumps(obj)
        with emit_lock:
            print(line, flush=True)

    emit({"ready": True, "pid": os.getpid(), "fleet": args.replicas,
          "replica_pids": [r.pid for r in router.replicas],
          "models": router.hello_models, "placement": router.placement,
          "canaries": {c: {"of": p, "fraction": f}
                       for c, (p, f) in router.canaries.items()},
          "slo_p99_ms": router.slo_p99_ms,
          "max_inflight": router.max_inflight})
    telemetry.flush()

    stop = {"signal": None}
    stop_event = threading.Event()

    def _on_term(signum, frame) -> None:
        if stop["signal"] is not None:
            os.write(2, b"fleet: second signal - hard exit\n")
            os._exit(EXIT_PREEMPTED)
        stop["signal"] = signum
        stop_event.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    hb_stop = threading.Event()

    def _hb_loop() -> None:
        n = 0
        while not hb_stop.wait(args.heartbeat_every):
            emit({"hb": n, "pid": os.getpid()})
            telemetry.maybe_flush()
            n += 1

    if args.heartbeat_every > 0:
        threading.Thread(target=_hb_loop, daemon=True,
                         name="fleet-heartbeat").start()

    jobs: "queue.Queue[Optional[str]]" = queue.Queue()

    def _read_stdin() -> None:
        for line in sys.stdin:
            jobs.put(line)
        jobs.put(None)   # EOF

    threading.Thread(target=_read_stdin, daemon=True,
                     name="fleet-stdin").start()

    pool = ThreadPoolExecutor(max_workers=min(64, 8 * args.replicas),
                              thread_name_prefix="fleet-route")

    def handle(line: str) -> bool:
        """One request line; False when the loop should end."""
        line = line.strip()
        if not line:
            return True
        try:
            job = json.loads(line)
        except ValueError:
            emit({"error": f"bad request line: {line[:120]!r}"})
            return True
        op = job.get("op")
        if op == "shutdown":
            return False
        if op == "stats":
            emit({"id": job.get("id"), "stats": telemetry.snapshot()})
            return True
        if op == "fleet":
            emit({"id": job.get("id"), "fleet": router.fleet_status()})
            return True
        jid = job.get("id")
        try:
            model = job["model"]
            rows = np.asarray(job["rows"], np.float32)
        except Exception as e:  # noqa: BLE001 — a bad request answers
            emit({"id": jid, "error": f"{type(e).__name__}: {e}"})
            return True

        def _route(jid=jid, model=model, rows=rows,
                   dl=job.get("deadline_ms")) -> None:
            # a client's deadline_ms rides through unchanged
            resp = dict(router.request(model, rows, deadline_ms=dl))
            resp["id"] = jid
            emit(resp)

        def _route_done(f, jid=jid) -> None:
            err = f.exception()
            if err is not None:
                telemetry.counter(events.CTR_FLEET_REQUEST_ERRORS).inc()
                print(f"fleet: request {jid} route thread died: "
                      f"{type(err).__name__}: {err}", file=sys.stderr)

        pool.submit(_route).add_done_callback(_route_done)
        return True

    while not stop_event.is_set():
        try:
            line = jobs.get(timeout=0.2)
        except queue.Empty:
            continue
        if line is None or not handle(line):   # EOF or shutdown
            break

    # -- drain: accept what is already on the wire, then let every routed
    # request resolve before the replicas go down
    if stop_event.is_set():
        time.sleep(0.3)
    n_late = 0
    while True:
        try:
            line = jobs.get_nowait()
        except queue.Empty:
            break
        if line is not None:
            n_late += 1
            handle(line)
    pool.shutdown(wait=True)
    drained = router.drain()
    telemetry.event(events.EV_FLEET_DRAIN, late_requests=n_late,
                    complete=bool(drained))
    rc = 0
    reason = None
    if stop["signal"] is not None:
        reason = signal.Signals(stop["signal"]).name
        rc = EXIT_PREEMPTED
        # the flight recorder's SIGTERM hook: the router's recent legs
        # and hedges reach the disk before the replicas go down
        trace.dump("sigterm")
    router.close(reason=reason, code=rc)
    hb_stop.set()
    if rc:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
