"""The evaluator pool: ONE evaluator process owns the card, and host
threads feed it genomes (the port's counterpart of
``veles_tpu/genetics/pool.py``, the reference's ``tpu-evaluator``
mode).

Topology: exactly one ``genetics/worker.py --serve`` subprocess makes
the device at startup and evaluates every genome of the run on it; the
parent's N "workers" are host threads that prepare the job payloads
(genome -> per-job seed -> wire JSON, plus an optional ``prep`` hook).
They never touch the device.

Failure contract: a genome that kills the evaluator, or runs past its
deadline, is retried once on a fresh evaluator and then scores ``inf``;
the pool restarts the evaluator and the rest of the generation goes on.
The evaluator prints heartbeats, and the pool enforces two deadlines
tighter than the ``timeout`` cap:

- the heartbeat deadline: no line at all for ``heartbeat_deadline``
  seconds means the process is wedged: kill and restart;
- the adaptive per-genome deadline: the in-flight genome running past
  ``max(min_genome_deadline, ema * genome_deadline_factor)`` (capped at
  ``timeout``), the EMA over measured genome durations, means the
  evaluator is alive but stuck.

Restarts back off exponentially with jitter once they come in a row,
and ``max_barren_restarts`` restarts that resolve nothing score the rest
of the generation inf.  ``hangs_detected``, ``restarts``,
``genome_retries`` and ``genomes_lost`` read the process's ``ga.*``
telemetry counters (this pool's share: the count since it was made), as
the reference's do; ``fallbacks`` counts the cohort splits and
per-genome fallbacks its evaluator reported (``genetics/worker.py``),
with ``cohort_stats`` (members, seconds and minibatches of each trained
chunk).  The evaluator flushes its
telemetry snapshot after every job; when it dies or closes, the pool
folds that snapshot into its own registry
(``telemetry.adopt_child_snapshot``), so a GA run leaves one aggregate
view.  Each job carries the generation (``gen``, from
``$VELES_GA_GENERATION``) for fault qualifiers, and a trace root minted
for it (``veles_tpu_torch/trace.py``) on its wire message: the
evaluator runs the job under a child span, so its journaled events carry
the job's trace.  A cohort job carries its first member's.
"""

from __future__ import annotations

import json
import logging
import queue
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, knobs, telemetry, trace
from veles_tpu_torch.analysis import witness

log = logging.getLogger("veles.genetics.pool")

#: the pool's supervision counters, by attribute
_COUNTS = {"hangs_detected": events.CTR_GA_HANGS_DETECTED,
           "restarts": events.CTR_GA_EVALUATOR_RESTARTS,
           "genome_retries": events.CTR_GA_GENOME_RETRIES,
           "genomes_lost": events.CTR_GA_GENOMES_LOST}


class ChipEvaluatorPool:
    """One serve-mode evaluator owns the device; N prep threads feed
    its queue.

    ``worker_cmd`` is the full evaluator argv (``... worker --serve
    workflow.py [config.py ...] -b BACKEND -s SEED``).  ``prep`` is an
    optional host-side staging hook run by the prep threads on each
    genome's values dict before submission (config/data preparation —
    the CPU-parallel share of an evaluation).

    Supervision knobs (all per-instance; the CLI surfaces
    ``--ga-eval-timeout``/``--eval-timeout`` and
    ``--heartbeat-deadline``):

    - ``timeout``: hard per-genome cap, seconds (default 3600) — the
      last-resort deadline when no duration EMA exists yet;
    - ``heartbeat_deadline``: max silence (no stdout line at all)
      before the evaluator is declared hung (default 60; 0 disables);
    - ``genome_deadline_factor`` x the duration EMA = the adaptive
      per-genome deadline (default 4.0), floored at
      ``min_genome_deadline`` (default 60 s — a genome whose first
      launch builds the kernels must not read as a hang),
      capped at ``timeout``;
    - ``restart_backoff``/``restart_backoff_cap``: exponential
      restart delay with +-25% deterministic jitter (defaults 0.5 s /
      30 s; the first restart is immediate);
    - ``max_barren_restarts``: consecutive no-progress restarts
      before the remainder of the generation scores inf (default 3).
    """

    def __init__(self, worker_cmd: List[str], workers: int = 2,
                 timeout: float = 3600.0, seed: int = 1234,
                 prep: Optional[Callable[[Dict[str, Any]],
                                         Dict[str, Any]]] = None,
                 heartbeat_deadline: float = 60.0,
                 genome_deadline_factor: float = 4.0,
                 min_genome_deadline: float = 60.0,
                 restart_backoff: float = 0.5,
                 restart_backoff_cap: float = 30.0,
                 max_barren_restarts: int = 3) -> None:
        self.worker_cmd = list(worker_cmd)
        self.workers = max(1, workers)
        self.timeout = timeout
        self.seed = seed
        self.prep = prep
        self.heartbeat_deadline = max(0.0, heartbeat_deadline)
        self.genome_deadline_factor = genome_deadline_factor
        self.min_genome_deadline = min_genome_deadline
        self.restart_backoff = restart_backoff
        self.restart_backoff_cap = restart_backoff_cap
        self.max_barren_restarts = max(1, max_barren_restarts)
        self.hello: Optional[Dict[str, Any]] = None
        self._proc: Optional[subprocess.Popen] = None
        self._lines: "queue.Queue[Optional[str]]" = queue.Queue()
        self._reader: Optional[threading.Thread] = None
        self._next_id = 0
        #: EMA of measured per-genome durations (seconds) — feeds the
        #: adaptive deadline; survives evaluator restarts
        self.genome_duration_ema: Optional[float] = None
        #: the supervision counters' values when this pool was made: the
        #: properties report this pool's share.  The last-hang fields
        #: describe the CURRENT generation only (reset by
        #: ``_begin_generation``)
        self._counts_base = {attr: telemetry.counter(name).value
                             for attr, name in _COUNTS.items()}
        #: cohort splits and per-genome fallbacks the evaluator reported
        self.fallbacks = 0
        #: {"members", "seconds", "minibatches"} of each trained chunk
        self.cohort_stats: List[Dict[str, Any]] = []
        self.last_hang_wait: Optional[float] = None
        self.last_hang_kind: Optional[str] = None
        self._consecutive_restarts = 0
        #: evaluator pids whose snapshot was already merged
        self._adopted_pids: set = set()
        self._backoff_rng = np.random.default_rng(seed ^ 0x5EED)

    def _count(self, attr: str) -> int:
        return max(0, int(telemetry.counter(_COUNTS[attr]).value
                          - self._counts_base[attr]))

    @property
    def hangs_detected(self) -> int:
        return self._count("hangs_detected")

    @property
    def restarts(self) -> int:
        return self._count("restarts")

    @property
    def genome_retries(self) -> int:
        return self._count("genome_retries")

    @property
    def genomes_lost(self) -> int:
        return self._count("genomes_lost")

    def _note_hang(self, kind: str, wait: float) -> None:
        """One detected hang: how it was caught and after how long."""
        self.last_hang_kind = kind
        self.last_hang_wait = wait
        telemetry.counter(events.CTR_GA_HANGS_DETECTED).inc()
        telemetry.gauge(events.GAUGE_GA_LAST_HANG_WAIT).set(round(wait, 3))
        telemetry.event(events.EV_GA_HANG_DETECTED, kind=kind,
                        wait=round(wait, 3))

    def _begin_generation(self) -> None:
        """Reset the per-generation hang descriptors (the counters
        stay cumulative)."""
        self.last_hang_kind = None
        self.last_hang_wait = None

    # -- evaluator lifecycle ------------------------------------------

    def start(self) -> Dict[str, Any]:
        """Spawn the evaluator and block on its hello line — the ONLY
        device probe of the whole GA run, and it happens in the child.
        Returns the hello dict ({"platform", "is_accelerator", ...})."""
        self._proc = subprocess.Popen(
            self.worker_cmd, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, bufsize=1)
        self._lines = queue.Queue()
        # the queue is BOUND to this reader at spawn: a dead
        # evaluator's reader must deliver its EOF marker to its OWN
        # queue, never into the replacement's (the EOF would read as
        # the fresh evaluator dying before hello)
        self._reader = threading.Thread(
            target=self._read_stdout, args=(self._proc, self._lines),
            daemon=True)
        self._reader.start()
        hello = self._next_json(self.timeout)
        if not hello or not hello.get("ready"):
            self._kill()
            raise RuntimeError(
                f"evaluator did not come up: {hello!r}")
        self.hello = hello
        log.info("evaluator up: pid %s on %s (%s)", hello["pid"],
                 hello.get("device", hello["platform"]), hello["backend"])
        return hello

    def _restart_with_backoff(self) -> None:
        """Restart after a death/hang, with exponential backoff +
        deterministic jitter once restarts come consecutively (a
        crash-looping evaluator must not storm the host)."""
        telemetry.counter(events.CTR_GA_EVALUATOR_RESTARTS).inc()
        self._consecutive_restarts += 1
        n = self._consecutive_restarts
        telemetry.event(events.EV_GA_EVALUATOR_RESTART, consecutive=n)
        if n > 1:
            delay = min(self.restart_backoff_cap,
                        self.restart_backoff * (2.0 ** (n - 2)))
            delay *= 0.75 + 0.5 * float(self._backoff_rng.random())
            log.warning("restart storm (%d consecutive): backing off "
                         "%.2fs before respawn", n, delay)
            time.sleep(delay)
        self.start()

    @property
    def platform(self) -> str:
        return (self.hello or {}).get("platform", "unknown")

    @property
    def is_accelerator(self) -> bool:
        return bool((self.hello or {}).get("is_accelerator"))

    def close(self) -> None:
        if self._proc is None:
            return
        try:
            if self._proc.poll() is None and self._proc.stdin:
                self._proc.stdin.write(
                    json.dumps({"op": "shutdown"}) + "\n")
                self._proc.stdin.flush()
                self._proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 — cleanup must not raise
            pass
        self._kill()

    @property
    def device_name(self) -> str:
        return (self.hello or {}).get("device", "unknown")

    def __enter__(self) -> "ChipEvaluatorPool":
        if self.hello is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _kill(self) -> None:
        # self.hello is kept: callers may still read the platform of
        # the evaluator that just died
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(timeout=10)
        self._proc = None
        self._adopt_child_metrics()

    def _adopt_child_metrics(self) -> None:
        """Fold the dead or closed evaluator's last snapshot into this
        process's registry, once per pid."""
        pid = (self.hello or {}).get("pid")
        if not pid or pid in self._adopted_pids:
            return
        if telemetry.adopt_child_snapshot(pid):
            self._adopted_pids.add(pid)
            log.debug("merged evaluator pid %s telemetry snapshot", pid)

    def _read_stdout(self, proc, lines) -> None:
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)  # EOF marker

    def _next_event(self, timeout: float) -> Tuple[str, Any]:
        """Next stdout event within ``timeout``:
        ``("json", obj)`` — a protocol line (result or heartbeat);
        ``("line", raw)`` — a non-empty non-JSON line (still proof of
        life — e.g. an injected garbage line);
        ``("eof", None)`` — the evaluator died;
        ``("timeout", None)`` — nothing arrived in time."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return "timeout", None
            try:
                line = self._lines.get(timeout=min(remaining, 1.0))
            except queue.Empty:
                continue
            if line is None:
                return "eof", None
            line = line.strip()
            if not line:
                continue
            try:
                return "json", json.loads(line)
            except ValueError:
                return "line", line

    def _next_json(self, timeout: float) -> Optional[Dict[str, Any]]:
        """Next parseable JSON line from the evaluator within
        ``timeout``; None on timeout or death.  (Training runs may
        also log non-JSON to stdout-adjacent streams; stdout itself
        carries only our protocol, but stay tolerant.)"""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            kind, payload = self._next_event(remaining)
            if kind == "json":
                return payload
            if kind in ("eof", "timeout"):
                return None
            # "line": garbage — keep draining

    # -- evaluation ----------------------------------------------------

    def _prep_jobs(self, values_list: List[Dict[str, Any]]) \
            -> List[Dict[str, Any]]:
        """Fan the host-side staging hook out over the prep threads and
        draw wire ids — the CPU-parallel share of a generation."""
        lock = witness.lock("pool.prep")
        # the generation the optimizer exported: fault qualifiers and
        # the evaluator's log can target one
        gen = int(knobs.get(knobs.GA_GENERATION))

        def prep_one(values):
            if self.prep is not None:
                values = self.prep(dict(values))
            with lock:   # id draw is the only shared state
                self._next_id += 1
                jid = self._next_id
            job = {"id": jid, "values": values, "seed": self.seed,
                   "gen": gen}
            # each genome job is a trace root: the evaluator's spans
            # journal under it, so a slow generation decomposes per
            # genome across the process gap
            trace.to_wire(job, trace.mint())
            return job

        with ThreadPoolExecutor(self.workers) as pool:
            return list(pool.map(prep_one, values_list))

    def _genome_deadline(self) -> float:
        """Seconds the in-flight genome may run before it is declared
        hung: the duration-EMA-scaled adaptive deadline once any
        genome has completed, else the hard ``timeout`` cap."""
        if self.genome_duration_ema is None:
            return self.timeout
        return min(self.timeout,
                   max(self.min_genome_deadline,
                       self.genome_duration_ema
                       * self.genome_deadline_factor))

    def _observe_genome_duration(self, dt: float) -> None:
        ema = self.genome_duration_ema
        self.genome_duration_ema = dt if ema is None \
            else 0.7 * ema + 0.3 * dt
        telemetry.histogram(events.HIST_GA_GENOME_SECONDS).record(dt)

    def evaluate_many(self, values_list: List[Dict[str, Any]]) \
            -> List[float]:
        """One generation: prep fans out over the thread workers, the
        evaluator consumes the queue in submission order.

        Failure contract: when the evaluator dies or hangs (heartbeat
        silence, or the adaptive per-genome deadline), the job at the
        head of the unresolved queue was in flight — but an
        evaluator-side death (OOM from a previous genome, a crashed
        CUDA context) is not proof of a bad gene, so the in-flight
        genome is RETRIED ONCE on the fresh evaluator before being
        scored inf.  ``max_barren_restarts`` consecutive restarts that
        resolve nothing mean the evaluator itself is broken: the
        remainder scores inf rather than restart-looping forever."""
        self._begin_generation()
        if self._proc is None or self._proc.poll() is not None:
            self.start()
        jobs = self._prep_jobs(values_list)
        order = [j["id"] for j in jobs]
        fits: Dict[int, float] = {}
        pending = list(jobs)
        retried: set = set()
        barren_restarts = 0
        while pending:
            done = self._run_jobs(pending, fits)
            pending = [j for j in pending if j["id"] not in done]
            if done:
                self._consecutive_restarts = 0
            if not pending:
                break
            barren_restarts = 0 if done else barren_restarts + 1
            if barren_restarts >= self.max_barren_restarts:
                log.warning(
                    "evaluator resolved nothing across %d consecutive "
                    "restarts; scoring the remaining %d genomes inf",
                    barren_restarts, len(pending))
                break
            head = pending[0]
            if head["id"] in retried:
                # the same genome killed a fresh evaluator twice —
                # now the gene is the prime suspect: score it inf
                pending.pop(0)
                fits[head["id"]] = float("inf")
                telemetry.counter(events.CTR_GA_GENOMES_LOST).inc()
                telemetry.event(events.EV_GA_GENOME_LOST, job=head["id"])
                log.warning(
                    "evaluator lost genome %s twice (%s); scoring inf,"
                    " restarting for %d remaining", head["id"],
                    head["values"], len(pending))
            else:
                # first loss: the evaluator may have died or hung of
                # its own accord — give the innocent-until-proven
                # genome one retry on the fresh evaluator
                retried.add(head["id"])
                telemetry.counter(events.CTR_GA_GENOME_RETRIES).inc()
                telemetry.event(events.EV_GA_GENOME_RETRY, job=head["id"])
                log.warning(
                    "evaluator lost genome %s in flight; "
                    "retrying it once on a fresh evaluator",
                    head["id"])
            self._kill()
            if pending:
                self._restart_with_backoff()
        for j in pending:   # broken-evaluator bailout: score inf
            fits[j["id"]] = float("inf")
        return [fits[i] for i in order]

    def evaluate_one(self, values: Dict[str, Any]) -> float:
        return self.evaluate_many([values])[0]

    def evaluate_cohort(self, values_list: List[Dict[str, Any]]) \
            -> List[float]:
        """One same-shape-signature cohort as ONE evaluator job: the
        serve process trains all members through the population engine
        (``torch.func.vmap`` over the member axis) and answers
        with the per-member fitness list.  Prep still fans out over the
        thread workers.  A dead OR hung evaluator (heartbeat silence)
        gets one restart+retry of the whole cohort; an evaluator-side
        error raises so the GeneticOptimizer falls back to the
        per-genome oracle."""
        self._begin_generation()
        if self._proc is None or self._proc.poll() is not None:
            self.start()
        jobs = self._prep_jobs(values_list)
        job = {"id": jobs[0]["id"],
               "members": [j["values"] for j in jobs],
               "seed": self.seed, "gen": jobs[0]["gen"]}
        # the cohort rides under its first member's trace root (one
        # dispatch, one trace)
        trace.to_wire(job, trace.from_wire(jobs[0]))
        timeout = self.timeout * max(1, len(values_list))
        for attempt in (1, 2):
            try:
                self._proc.stdin.write(json.dumps(job) + "\n")
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError):
                msg = None
            else:
                msg = self._await_cohort_result(job["id"], timeout)
            if msg is not None and "fitnesses" in msg:
                self._consecutive_restarts = 0
                self.fallbacks += int(msg.get("fallbacks", 0))
                self.cohort_stats.extend(msg.get("stats", []))
                fits = msg["fitnesses"]
                if len(fits) != len(values_list):
                    raise RuntimeError(
                        f"evaluator returned {len(fits)} fitnesses "
                        f"for a {len(values_list)}-member cohort")
                return [float("inf") if f is None else float(f)
                        for f in fits]
            if msg is not None:   # evaluator-side error: not a death
                raise RuntimeError(
                    f"cohort failed in evaluator: {msg.get('error')}")
            log.warning("evaluator lost on a %d-member cohort "
                         "(attempt %d); restarting",
                         len(values_list), attempt)
            self._kill()
            self._restart_with_backoff()
        raise RuntimeError(
            f"evaluator died twice on a {len(values_list)}-member "
            f"cohort")

    def _await_cohort_result(self, want_id: int, timeout: float) \
            -> Optional[Dict[str, Any]]:
        """Wait for the cohort result while enforcing the heartbeat
        deadline (cohorts have no per-genome granularity, so the
        liveness signal IS the heartbeat stream)."""
        deadline = time.monotonic() + timeout
        last_activity = time.monotonic()
        while True:
            now = time.monotonic()
            remaining = deadline - now
            if remaining <= 0:
                return None
            if self.heartbeat_deadline:
                hb_left = last_activity + self.heartbeat_deadline - now
                if hb_left <= 0:
                    self._note_hang("heartbeat", now - last_activity)
                    log.warning(
                        "evaluator silent for %.1fs during a cohort "
                        "(heartbeat deadline %.1fs) — declaring hung",
                        now - last_activity, self.heartbeat_deadline)
                    return None
                remaining = min(remaining, hb_left)
            kind, payload = self._next_event(min(remaining, 1.0))
            if kind == "eof":
                return None
            if kind in ("json", "line"):
                last_activity = time.monotonic()
            if kind == "json" and payload.get("id") == want_id:
                return payload

    def _run_jobs(self, jobs, fits: Dict[int, float]) -> set:
        """Stream ``jobs`` to the evaluator, collect results by id.
        Returns the set of ids that resolved; stops early when the
        evaluator dies, falls silent past the heartbeat deadline, or
        the in-flight genome exceeds its (adaptive) deadline."""
        done: set = set()
        try:
            for j in jobs:
                self._proc.stdin.write(json.dumps(j) + "\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError):
            return done
        want = {j["id"] for j in jobs}
        now = time.monotonic()
        last_activity = now
        genome_start = now
        while done != want:
            now = time.monotonic()
            waits = [genome_start + self._genome_deadline() - now]
            if self.heartbeat_deadline:
                waits.append(last_activity + self.heartbeat_deadline
                             - now)
            wait = min(waits)
            if wait > 0:
                kind, payload = self._next_event(min(wait, 1.0))
            else:
                kind, payload = "timeout", None
            now = time.monotonic()
            if kind == "eof":
                return done  # death: caller restarts/retries
            if kind in ("json", "line"):
                last_activity = now
            if kind == "json":
                jid = payload.get("id")
                if jid in want and jid not in done and (
                        "fitness" in payload or "error" in payload):
                    if "fitness" in payload:
                        fits[jid] = float(payload["fitness"])
                    else:
                        log.warning(
                            "genome %s failed in evaluator: %s",
                            jid, payload.get("error"))
                        fits[jid] = float("inf")
                    done.add(jid)
                    self._observe_genome_duration(now - genome_start)
                    genome_start = now
                continue
            if kind == "line":
                continue   # garbage is still proof of life
            # timeout slice expired: check the real deadlines
            if self.heartbeat_deadline and \
                    now - last_activity >= self.heartbeat_deadline:
                self._note_hang("heartbeat", now - last_activity)
                log.warning(
                    "evaluator silent for %.1fs (heartbeat deadline "
                    "%.1fs) — declaring hung, replacing",
                    now - last_activity, self.heartbeat_deadline)
                return done
            if now - genome_start >= self._genome_deadline():
                self._note_hang("genome_deadline", now - genome_start)
                log.warning(
                    "genome in flight for %.1fs, over its deadline "
                    "%.1fs (duration EMA %.1fs) — declaring the "
                    "evaluator hung, replacing",
                    now - genome_start, self._genome_deadline(),
                    self.genome_duration_ema or -1.0)
                return done
        return done
