"""Line-protocol client for the port's Hive serving process.

Counterpart of ``veles_tpu/serve/client.py`` (``HiveClient``,
``ReplicaDied``).  Spawns ``python -m veles_tpu_torch --serve-models
NAME=PKG ... [--online]`` and multiplexes concurrent callers over its
stdin and stdout: every request draws a wire id under a lock, one
reader thread routes answer lines to per-id waiters or to asynchronous
collectors (:meth:`HiveClient.collect_async`); heartbeats and
non-protocol lines are proof of life (:attr:`HiveClient.last_line_ts`).

When the process's stdout reaches EOF (exit, SIGKILL, a lost pipe),
every pending waiter and collector fails at once with
:class:`ReplicaDied`, never by waiting out its own timeout: the fleet
router catches exactly that to retry a request on a peer.  A waiter that
gives up (:meth:`HiveClient.cancel`: a timeout, a hedge's loser) has its
late answer dropped and counted ``fleet.stale_response``.

A request may carry a trace context (``submit(..., ctx=)``): a sampled
one rides the wire in the ``trace``/``span``/``parent``/``sampled``
fields (``veles_tpu_torch/trace.py``), so the hive's spans join the
caller's trace.  The two locks come from the lock-order witness's
factories as ``client.wire`` and ``client.results``.  The process runs
on the card unless the caller asks for the CPU (``backend="cpu"``).
``mesh=N`` (> 1) starts a hive that owns N places (``--mesh N``); on
the CPU every place is ``cpu``, and no flag like the reference's
virtual-device count is needed.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from veles_tpu_torch import events, telemetry, trace
from veles_tpu_torch.analysis import witness

#: the directory that holds the ``veles_tpu_torch`` package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaDied(RuntimeError):
    """The serving process died (EOF or exit) with requests pending.
    ``rc`` is its exit code when known."""

    def __init__(self, msg: str, rc: Optional[int] = None) -> None:
        super().__init__(msg)
        self.rc = rc


def hive_command(models: Dict[str, str], backend: str = "auto",
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 hbm_budget: Optional[int] = None,
                 heartbeat_every: Optional[float] = None,
                 install_dir: Optional[str] = None,
                 online: bool = False,
                 metrics_dir: Optional[str] = None,
                 mesh: int = 0) -> List[str]:
    """The command line :class:`HiveClient` starts a hive with."""
    cmd = [sys.executable, "-m", "veles_tpu_torch", "--serve-models"]
    cmd += [f"{name}={path}" for name, path in models.items()]
    cmd += ["-b", backend]
    if online:
        cmd += ["--online"]
    if mesh and mesh > 1:
        cmd += ["--mesh", str(int(mesh))]
    for flag, value in (("--max-batch", max_batch),
                        ("--max-wait-ms", max_wait_ms),
                        ("--hbm-budget", hbm_budget),
                        ("--heartbeat-every", heartbeat_every),
                        ("--install-dir", install_dir),
                        ("--metrics-dir", metrics_dir)):
        if value is not None:
            cmd += [flag, str(value)]
    return cmd


class HiveClient:
    """Own one serving process; thread-safe request fan-in."""

    def __init__(self, models: Dict[str, str], backend: str = "auto",
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 hbm_budget: Optional[int] = None,
                 heartbeat_every: Optional[float] = None,
                 install_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None, online: bool = False,
                 stderr: Any = None,
                 start_timeout: float = 120.0,
                 metrics_dir: Optional[str] = None,
                 mesh: int = 0) -> None:
        cmd = hive_command(models, backend=backend, max_batch=max_batch,
                           max_wait_ms=max_wait_ms, hbm_budget=hbm_budget,
                           heartbeat_every=heartbeat_every,
                           install_dir=install_dir, online=online,
                           metrics_dir=metrics_dir, mesh=mesh)
        run_env = dict(os.environ)
        run_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, run_env.get("PYTHONPATH")) if p)
        if env:
            run_env.update(env)
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=stderr, text=True, bufsize=1, env=run_env, cwd=cwd)
        self._wlock = witness.lock("client.wire")
        self._cond = witness.condition("client.results")
        self._results: Dict[int, Dict[str, Any]] = {}
        #: asynchronous collectors (wire id -> callback(msg, err))
        self._callbacks: Dict[int, Callable[[Optional[Dict[str, Any]],
                                             Optional[BaseException]],
                                            None]] = {}
        #: wire ids whose waiter gave up: their late answer is dropped
        self._cancelled: set = set()
        self._next_id = 0
        self._eof = False
        self.exit_rc: Optional[int] = None
        self.hello: Optional[Dict[str, Any]] = None
        self.heartbeats = 0
        #: monotonic time of the last stdout line (any line is proof of
        #: life: the fleet's heartbeat deadline reads it)
        self.last_line_ts = time.monotonic()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name="hive-client-reader")
        self._reader.start()
        deadline = time.monotonic() + start_timeout
        with self._cond:
            while self.hello is None and not self._eof:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.5))
        if self.hello is None:
            rc = self.proc.poll()
            self.close(kill=True)
            raise RuntimeError(f"hive did not come up (rc={rc})")

    # -- wire ----------------------------------------------------------

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    @property
    def dead(self) -> bool:
        """True once the reader saw EOF or the process exited."""
        return self._eof or self.proc.poll() is not None

    def _read_loop(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            self.last_line_ts = time.monotonic()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue   # not a protocol line; still proof of life
            cb = None
            stale = False
            with self._cond:
                if msg.get("ready"):
                    self.hello = msg
                elif "hb" in msg:
                    self.heartbeats += 1
                elif msg.get("id") is not None:
                    mid = msg["id"]
                    if mid in self._cancelled:
                        # a hedge loser's or timed-out waiter's late
                        # answer: parked in _results it would leak
                        self._cancelled.discard(mid)
                        stale = True
                    elif not isinstance(mid, int) or mid > self._next_id:
                        stale = True   # an id this client never drew
                    else:
                        cb = self._callbacks.pop(mid, None)
                        if cb is None:
                            self._results[mid] = msg
                self._cond.notify_all()
            if stale:
                telemetry.counter(events.CTR_FLEET_STALE_RESPONSES).inc()
            if cb is not None:
                self._run_callback(cb, msg, None)
        # EOF: the process is gone; every waiter and collector fails now
        rc = self.proc.poll()
        err = ReplicaDied(
            f"hive pid {self.proc.pid} closed its pipe (rc={rc})", rc=rc)
        with self._cond:
            self._eof = True
            self.exit_rc = rc
            callbacks = list(self._callbacks.values())
            self._callbacks.clear()
            self._cancelled.clear()
            self._cond.notify_all()
        for cb in callbacks:
            self._run_callback(cb, None, err)

    @staticmethod
    def _run_callback(cb, msg, err) -> None:
        try:
            cb(msg, err)
        except Exception:  # noqa: BLE001 — a collector must not kill the
            pass           # reader thread

    def _send(self, obj: Dict[str, Any]) -> None:
        try:
            with self._wlock:
                self.proc.stdin.write(json.dumps(obj) + "\n")
                self.proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            raise ReplicaDied(
                f"hive pid {self.proc.pid} stdin is gone ({e})",
                rc=self.proc.poll()) from e

    def _draw_id(self) -> int:
        with self._wlock:
            self._next_id += 1
            return self._next_id

    def _wait(self, jid: int, timeout: float) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while jid not in self._results:
                if self._eof:
                    raise ReplicaDied(
                        f"hive pid {self.proc.pid} died before answering "
                        f"request {jid}", rc=self.exit_rc)
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"no response for request {jid} in {timeout}s")
                self._cond.wait(min(left, 0.5))
            return self._results.pop(jid)

    def _op(self, op: str, key: str, timeout: float) -> Any:
        jid = self._draw_id()
        self._send({"op": op, "id": jid})
        return self._wait(jid, timeout)[key]

    # -- API -----------------------------------------------------------

    def submit(self, model: str, rows: Any,
               deadline_ms: Optional[float] = None,
               label: Optional[Any] = None,
               ctx: Optional[trace.TraceContext] = None) -> int:
        """Send one request without waiting; returns its wire id (collect
        it with :meth:`wait_for` or :meth:`collect_async`).
        ``deadline_ms`` (absolute unix-epoch ms) rides the wire: the
        hive's batcher drops the request unanswered once it expires.
        ``label`` (per-row ground truth) feeds an ``--online`` hive's
        tap.  ``ctx`` (a sampled span, usually the router's leg) stamps
        the trace fields, so the hive's spans join the caller's
        trace."""
        jid = self._draw_id()
        msg = {"id": jid, "model": model,
               "rows": np.asarray(rows, np.float32).tolist()}
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        if label is not None:
            msg["label"] = np.asarray(label).tolist()
        trace.to_wire(msg, ctx)
        self._send(msg)
        return jid

    def send_label(self, jid: int, label: Any) -> None:
        """Late ground truth for an earlier request, by wire id (no
        answer; a hive without a learner ignores it)."""
        self._send({"label_of": jid, "label": np.asarray(label).tolist()})

    def learn(self, timeout: float = 60.0) -> Dict[str, Any]:
        """The learner's row per model (``op=learn``); {} when the hive
        is not learning."""
        return self._op("learn", "learn", timeout)

    def learner_ctl(self, suspend: bool,
                    timeout: float = 60.0) -> Dict[str, Any]:
        """Suspend or resume the hive's learner.  Acknowledgement:
        ``{"online": bool, "suspended": bool}``; ``online`` False means
        no learner is armed and the op did nothing."""
        return self._op("learner_suspend" if suspend else "learner_resume",
                        "learner_ctl", timeout)

    def stats(self, timeout: float = 60.0) -> Dict[str, Any]:
        """The serving process's counters and telemetry (``op=stats``)."""
        return self._op("stats", "stats", timeout)

    def cancel(self, jid: int) -> bool:
        """Give up on request ``jid``.  True when its answer had already
        arrived (it is dropped now); False when it is still pending: its
        late arrival is then dropped and counted ``fleet.stale_response``
        instead of leaking into another waiter."""
        with self._cond:
            if jid in self._results:
                self._results.pop(jid)
                return True
            self._callbacks.pop(jid, None)
            if not self._eof:
                self._cancelled.add(jid)
            return False

    def collect_async(self, jid: int,
                      callback: Callable[[Optional[Dict[str, Any]],
                                          Optional[BaseException]],
                                         None]) -> None:
        """Route request ``jid``'s answer to ``callback(msg, err)`` on
        the reader thread instead of a blocking waiter; exactly one of
        msg and err is set (err is :class:`ReplicaDied` when the process
        dies first).  The callback must be quick and must not raise."""
        ready = None
        with self._cond:
            if jid in self._results:
                ready = self._results.pop(jid)
            elif self._eof:
                ready = ReplicaDied(
                    f"hive pid {self.proc.pid} died before answering "
                    f"request {jid}", rc=self.exit_rc)
            else:
                self._callbacks[jid] = callback
        if isinstance(ready, ReplicaDied):
            self._run_callback(callback, None, ready)
        elif ready is not None:
            self._run_callback(callback, ready, None)

    def wait_for(self, jid: int, timeout: float = 60.0) -> Dict[str, Any]:
        return self._wait(jid, timeout)

    def request(self, model: str, rows: Any, timeout: float = 60.0,
                label: Optional[Any] = None,
                ctx: Optional[trace.TraceContext] = None
                ) -> Dict[str, Any]:
        """One round trip: the answer ({"pred", "probs", ...} or
        {"error"})."""
        return self.wait_for(self.submit(model, rows, label=label,
                                         ctx=ctx), timeout)

    # -- process control -----------------------------------------------

    def sigterm(self) -> None:
        self.proc.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.proc.kill()

    def wait(self, timeout: float = 60.0) -> int:
        return self.proc.wait(timeout=timeout)

    def close(self, kill: bool = False) -> None:
        """Shut the process down (``op=shutdown``, then SIGKILL after 15
        s), or kill it at once."""
        if self.proc.poll() is None and not kill:
            try:
                self._send({"op": "shutdown"})
                self.proc.wait(timeout=15)
            except Exception:  # noqa: BLE001 — cleanup must not raise
                pass
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
