"""Fleet replica lifecycle: spawn, supervise, respawn; and placement.

Counterpart of ``veles_tpu/serve/fleet.py``.  One **replica** is one
``--serve-models`` hive process owned through
:class:`~veles_tpu_torch.serve.client.HiveClient`; N of them run side by
side (on one card, each with its own CUDA context) and a monitor thread
keeps the set healthy:

- **death detection**: reader EOF or a heartbeat deadline (any stdout
  line is proof of life).  A dead replica's pending waiters fail at once
  with ``ReplicaDied`` (the router retries them on a peer); the monitor
  respawns the replica with exponential backoff into the same install
  dir, so the package unpack is warm.  A replica must survive
  :data:`STABLE_UPTIME_S` past its hello for a death to reset the
  backoff streak;
- **per-dispatch time**: each replica's ``op=stats`` (the
  ``serve.dispatch_seconds`` and ``serve.batch_rows`` histograms, the
  ``serve.batches`` counter) is polled into three EMAs; the dispatch
  cadence is what the router's admission control multiplies by queue
  depth.

:class:`PlacementPolicy` decides which models a replica serves
preferentially: every replica is spawned with the full model set (so
any replica can LRU-load any model), and placement controls routing
affinity: the declaration-order prefix that fits every replica's budget
(or an explicit hot set) is replicated, the long tail goes greedily to
the replica with the most free bytes.

With a fleet ``metrics_dir``, each replica's hive persists its
telemetry in ``<metrics_dir>/replica-<i>``, on every spawn and respawn.
The process runs on the card unless the caller asks for the CPU.  A
replica with ``mesh=N`` (> 1) runs a ``--mesh N`` hive; its ``devices``
and capacity (devices x the per-place budget) come from its own hello.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Set

from veles_tpu_torch import events, knobs, telemetry
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.serve.client import HiveClient

log = logging.getLogger("veles.serve.fleet")

#: a replica must survive this long past its hello for a death to reset
#: the crash streak: a flapping member keeps escalating its backoff
STABLE_UPTIME_S = 10.0


class PlacementPolicy:
    """Model -> preferred replica set, under a per-replica budget.

    Declaration order is the hotness order: models are replicated on all
    replicas while the running total fits every replica's capacity; the
    first model that would overflow ends the replicated prefix and
    starts the partitioned tail (the replica with the most free bytes).
    An explicit ``hot`` set overrides the prefix rule."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 hot: Optional[Set[str]] = None) -> None:
        self.budget_bytes = int(budget_bytes) if budget_bytes \
            else int(knobs.get(knobs.SERVE_HBM_BUDGET))
        self.hot = set(hot) if hot is not None else None

    def assign(self, model_bytes: Dict[str, int], n_replicas: int,
               capacities: Optional[List[Optional[int]]] = None
               ) -> Dict[str, List[int]]:
        """{model: [replica indices]}; the insertion order of
        ``model_bytes`` is the declaration order.  ``capacities`` is the
        per-replica byte capacity each hello advertised; None entries
        fall back to ``budget_bytes``."""
        n = max(1, int(n_replicas))
        caps = [self.budget_bytes] * n
        if capacities:
            for i, c in enumerate(capacities[:n]):
                if c:
                    caps[i] = int(c)
        fill = [0] * n
        placement: Dict[str, List[int]] = {}
        replicating = True
        for name, nbytes in model_bytes.items():
            nbytes = int(nbytes)
            if self.hot is not None:
                is_hot = name in self.hot
            else:
                is_hot = replicating and all(
                    f + nbytes <= c for f, c in zip(fill, caps))
                if not is_hot:
                    replicating = False
            if is_hot:
                placement[name] = list(range(n))
                fill = [f + nbytes for f in fill]
            else:
                r = max(range(n), key=lambda i: (caps[i] - fill[i], -i))
                placement[name] = [r]
                fill[r] += nbytes
        return placement


class Replica:
    """One hive process slot: spawn and respawn, load accounting."""

    def __init__(self, idx: int, models: Dict[str, str],
                 backend: str = "auto",
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 hbm_budget: Optional[int] = None,
                 heartbeat_every: Optional[float] = None,
                 cwd: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 start_timeout: float = 180.0,
                 install_dir: Optional[str] = None,
                 stderr: Any = None,
                 metrics_dir: Optional[str] = None,
                 mesh: int = 0) -> None:
        self.idx = idx
        self.models = dict(models)
        self.backend = backend
        #: places this replica's hive owns (--mesh N); 0 or 1: one device
        self.mesh = int(mesh)
        #: what the replica's own hello advertised (1 until the first
        #: spawn)
        self.devices = 1
        #: capacity the replica's own hello advertised; None until the
        #: first spawn
        self.capacity_bytes: Optional[int] = None
        self.max_batch = max_batch
        #: rows one dispatch drains: the admission estimate's divisor
        self.batch_capacity = int(max_batch) if max_batch \
            else int(knobs.get(knobs.SERVE_MAX_BATCH))
        self.max_wait_ms = max_wait_ms if max_wait_ms is not None \
            else float(knobs.get(knobs.SERVE_MAX_WAIT_MS))
        self.hbm_budget = hbm_budget
        self.heartbeat_every = heartbeat_every
        #: this replica's own dir under the fleet's
        self.metrics_dir = os.path.join(metrics_dir, f"replica-{idx}") \
            if metrics_dir else None
        self.cwd = cwd
        self.env = env
        self.stderr = stderr
        self.start_timeout = start_timeout
        #: reused across respawns (and handed on by a retired replica)
        self.install_dir = install_dir or tempfile.mkdtemp(
            prefix=f"fleet_replica{idx}_")
        self.client: Optional[HiveClient] = None
        self.healthy = False
        #: set by the router's scale-down before the drain: no new work,
        #: and the monitor neither respawns it nor counts its exit
        self.retiring = False
        self.deaths = 0
        #: set by mark_dead on the healthy -> dead transition; the
        #: monitor consumes it once
        self.death_kind: Optional[str] = None
        self._consecutive_deaths = 0
        self._ready_at: Optional[float] = None
        self.next_respawn_at = 0.0
        #: seconds from spawn to hello, of the last spawn
        self.spawn_seconds: Optional[float] = None
        self._lock = witness.lock("fleet.replica")
        #: router-side in-flight requests
        self.inflight = 0
        #: EMAs polled from the replica's stats by the monitor
        self.ema_dispatch_s: Optional[float] = None
        self.ema_batch_rows: Optional[float] = None
        #: observed per-dispatch cycle (batches-counter delta over the
        #: poll interval): the admission estimate's multiplier
        self.ema_cycle_s: Optional[float] = None
        self._dispatch_base = (0, 0.0)
        self._rows_base = (0, 0.0)
        self._batches_base: Optional[tuple] = None

    # -- lifecycle -----------------------------------------------------

    def spawn(self) -> Dict[str, Any]:
        """Start (or restart) the process; returns its hello."""
        t0 = time.monotonic()
        self.client = HiveClient(
            self.models, backend=self.backend,
            max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
            hbm_budget=self.hbm_budget,
            heartbeat_every=self.heartbeat_every,
            install_dir=self.install_dir, env=self.env, cwd=self.cwd,
            stderr=self.stderr, start_timeout=self.start_timeout,
            metrics_dir=self.metrics_dir, mesh=self.mesh)
        hello = self.client.hello or {}
        with self._lock:
            self.spawn_seconds = time.monotonic() - t0
            self.devices = int(hello.get("devices") or 1)
            budget = hello.get("device_budget")
            self.capacity_bytes = int(budget) * self.devices \
                if budget else None
            self.healthy = True
            self.death_kind = None
            # not a streak reset: only surviving STABLE_UPTIME_S clears
            # it (judged at death time)
            self._ready_at = time.monotonic()
            self.inflight = 0
            self._dispatch_base = (0, 0.0)
            self._rows_base = (0, 0.0)
            self._batches_base = None
        return self.client.hello

    def mark_dead(self, kind: str = "eof") -> bool:
        """Flip healthy off; True only on the transition (the first
        noticer wins; the monitor consumes ``death_kind``)."""
        with self._lock:
            if not self.healthy:
                return False
            self.healthy = False
            self.death_kind = kind
            return True

    @property
    def alive(self) -> bool:
        return self.client is not None and not self.client.dead

    @property
    def pid(self) -> Optional[int]:
        return self.client.pid if self.client is not None else None

    # -- load accounting -----------------------------------------------

    def acquire(self) -> None:
        with self._lock:
            self.inflight += 1

    def release(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)

    def update_from_stats(self, st: Dict[str, Any]) -> None:
        """Fold one stats answer into the dispatch-time, batch-fill and
        dispatch-cadence EMAs (deltas against the previous poll)."""
        hists = st.get("histograms") or {}
        now = time.monotonic()

        def delta(name, base):
            h = hists.get(name) or {}
            c, s = int(h.get("count", 0)), float(h.get("sum", 0.0))
            return (c, s), (c - base[0], s - base[1])

        with self._lock:
            self._dispatch_base, (dc, ds) = delta(
                events.HIST_SERVE_DISPATCH_SECONDS, self._dispatch_base)
            if dc > 0:
                mean = ds / dc
                self.ema_dispatch_s = mean if self.ema_dispatch_s is None \
                    else 0.5 * self.ema_dispatch_s + 0.5 * mean
            self._rows_base, (rc, rs) = delta(
                events.HIST_SERVE_BATCH_ROWS, self._rows_base)
            if rc > 0:
                mean = rs / rc
                self.ema_batch_rows = mean if self.ema_batch_rows is None \
                    else 0.5 * self.ema_batch_rows + 0.5 * mean
            batches = int((st.get("counters") or {})
                          .get(events.CTR_SERVE_BATCHES, 0))
            if self._batches_base is not None:
                db = batches - self._batches_base[0]
                dt = now - self._batches_base[1]
                if db > 0 and dt > 0:
                    cycle = dt / db
                    self.ema_cycle_s = cycle if self.ema_cycle_s is None \
                        else 0.5 * self.ema_cycle_s + 0.5 * cycle
            self._batches_base = (batches, now)
        if self.ema_dispatch_s is not None:
            telemetry.gauge(events.GAUGE_FLEET_DISPATCH_EMA_MS).set(
                round(1000.0 * self.ema_dispatch_s, 3))

    def _cycle_s(self) -> float:
        """The observed per-dispatch cycle when the monitor has polled
        one, else the batching window plus a small dispatch (the idle
        floor)."""
        cycle = self.ema_cycle_s
        floor = self.max_wait_ms / 1000.0 + 0.002
        return max(cycle, floor) if cycle is not None else floor

    def estimated_wait_ms(self) -> float:
        """Queue depth x the observed per-dispatch cycle: how long a new
        request would queue behind this replica's in-flight work."""
        with self._lock:
            inflight = self.inflight
        pending_dispatches = inflight / max(1, self.batch_capacity)
        return 1000.0 * pending_dispatches * self._cycle_s()

    def estimated_total_ms(self) -> float:
        """The admission estimate: queued wait + one dispatch cycle."""
        return self.estimated_wait_ms() + 1000.0 * self._cycle_s()

    def close(self, kill: bool = False) -> None:
        self.mark_dead()
        if self.client is not None:
            self.client.close(kill=kill)


class ReplicaSet:
    """Spawn N replicas concurrently and keep the set healthy."""

    def __init__(self, replicas: List[Replica],
                 heartbeat_deadline: Optional[float] = None,
                 respawn_backoff: Optional[float] = None,
                 stats_every: float = 0.5) -> None:
        self.replicas = replicas
        self.heartbeat_deadline = float(heartbeat_deadline) \
            if heartbeat_deadline is not None \
            else float(knobs.get(knobs.FLEET_HEARTBEAT_DEADLINE))
        self.respawn_backoff = float(respawn_backoff) \
            if respawn_backoff is not None \
            else float(knobs.get(knobs.FLEET_RESPAWN_BACKOFF))
        self.stats_every = stats_every
        self._closing = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._last_stats_poll = 0.0

    def start(self) -> List[Dict[str, Any]]:
        """Spawn every replica concurrently; returns their hellos in
        replica order.  Any spawn failure tears the whole set down and
        raises."""
        from concurrent.futures import ThreadPoolExecutor
        try:
            with ThreadPoolExecutor(len(self.replicas)) as tp:
                hellos = list(tp.map(lambda r: r.spawn(), self.replicas))
        except BaseException:
            for r in self.replicas:
                try:
                    r.close(kill=True)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            raise
        for r, hello in zip(self.replicas, hellos):
            telemetry.event(events.EV_FLEET_REPLICA_SPAWNED,
                            replica=r.idx, pid=hello.get("pid"),
                            models=sorted(r.models))
        self._update_health_gauge()
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="fleet-monitor")
        self._monitor_thread.start()
        return hellos

    def healthy(self) -> List[Replica]:
        return [r for r in list(self.replicas) if r.healthy]

    # -- elastic membership --------------------------------------------

    def add(self, r: Replica) -> None:
        """Adopt an already-spawned replica into supervision."""
        self.replicas.append(r)
        self._update_health_gauge()

    def remove(self, r: Replica) -> None:
        """Drop a replica from supervision (before its SIGTERM, so the
        orderly exit is never taken for a death)."""
        if r in self.replicas:
            self.replicas.remove(r)
        self._update_health_gauge()

    def _update_health_gauge(self) -> None:
        telemetry.gauge(events.GAUGE_FLEET_REPLICAS_HEALTHY).set(
            len(self.healthy()))

    # -- monitor -------------------------------------------------------

    def _monitor(self) -> None:
        while not self._closing:
            time.sleep(0.25)
            if self._closing:
                return
            now = time.monotonic()
            poll_stats = now - self._last_stats_poll >= self.stats_every
            if poll_stats:
                self._last_stats_poll = now
            for r in list(self.replicas):
                if self._closing:
                    return
                if r.retiring:
                    continue   # the router's scale-down owns it
                if r.healthy and not r.alive:
                    r.mark_dead("eof")
                    self._on_death(r)
                elif r.healthy and self.heartbeat_deadline > 0 \
                        and r.client is not None \
                        and now - r.client.last_line_ts \
                        > self.heartbeat_deadline:
                    # silent too long: hung; the reader's EOF then fails
                    # its pending waiters
                    r.client.kill()
                    r.mark_dead("heartbeat_deadline")
                    self._on_death(r)
                elif not r.healthy and r.death_kind is not None:
                    # the router's request path noticed first
                    self._on_death(r)
                elif not r.healthy and now >= r.next_respawn_at:
                    self._respawn(r)
                elif r.healthy and poll_stats:
                    try:
                        r.update_from_stats(r.client.stats(timeout=5))
                    except Exception:  # noqa: BLE001 — a stats miss must
                        pass           # never kill supervision

    def _on_death(self, r: Replica) -> None:
        kind = r.death_kind or "eof"
        r.death_kind = None
        r.deaths += 1
        uptime = (time.monotonic() - r._ready_at) \
            if r._ready_at is not None else None
        if uptime is not None and uptime >= STABLE_UPTIME_S:
            r._consecutive_deaths = 0
        r._consecutive_deaths += 1
        backoff = min(30.0, self.respawn_backoff
                      * (2 ** (r._consecutive_deaths - 1)))
        r.next_respawn_at = time.monotonic() + backoff
        telemetry.counter(events.CTR_FLEET_REPLICA_DEATHS).inc()
        telemetry.event(events.EV_FLEET_REPLICA_DIED,
                        replica=r.idx, pid=r.pid, kind=kind,
                        rc=getattr(r.client, "exit_rc", None),
                        backoff=round(backoff, 3))
        self._update_health_gauge()
        log.warning("replica %d (pid %s) died (%s); respawn in %.2fs",
                    r.idx, r.pid, kind, backoff)
        try:
            r.close(kill=True)   # reap the corpse
        except Exception:  # noqa: BLE001 — already dead
            pass

    def _respawn(self, r: Replica) -> None:
        consecutive = r._consecutive_deaths
        try:
            hello = r.spawn()
        except Exception as e:  # noqa: BLE001 — retry with backoff
            r._consecutive_deaths = max(consecutive, 1) + 1
            backoff = min(30.0, self.respawn_backoff
                          * (2 ** (r._consecutive_deaths - 1)))
            r.next_respawn_at = time.monotonic() + backoff
            log.warning("replica %d respawn failed (%s); next try in "
                        "%.2fs", r.idx, e, backoff)
            return
        telemetry.counter(events.CTR_FLEET_REPLICA_RESPAWNS).inc()
        telemetry.event(events.EV_FLEET_REPLICA_RESPAWNED,
                        replica=r.idx, pid=hello.get("pid"),
                        deaths=r.deaths, seconds=r.spawn_seconds)
        self._update_health_gauge()
        log.info("replica %d respawned (pid %s, warm install dir)",
                 r.idx, hello.get("pid"))

    # -- teardown ------------------------------------------------------

    def close(self, kill: bool = False) -> None:
        self._closing = True
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
        from concurrent.futures import ThreadPoolExecutor
        replicas = list(self.replicas)
        with ThreadPoolExecutor(max(1, len(replicas))) as tp:
            list(tp.map(lambda r: r.close(kill=kill), replicas))
        self._update_health_gauge()
