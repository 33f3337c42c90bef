"""Line-protocol client for the port's Hive serving process.

Counterpart of ``veles_tpu/serve/client.py`` (``HiveClient``,
``ReplicaDied``).  Spawns ``python -m veles_tpu_torch --serve-models
NAME=PKG ... [--online]`` and multiplexes concurrent callers over its
stdin and stdout: every request draws a wire id under a lock, one
reader thread routes answer lines to per-id waiters; heartbeats and
non-protocol lines are skipped.

When the process's stdout reaches EOF (exit, SIGKILL, a lost pipe),
every pending waiter fails at once with :class:`ReplicaDied`, never by
waiting out its own timeout.

Left for the fleet: the reference's asynchronous collectors, request
cancellation, request deadlines, its process controls (``sigterm``,
``kill``, ``wait``) and liveness fields, and trace-context
propagation.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

#: the directory that holds the ``veles_tpu_torch`` package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaDied(RuntimeError):
    """The serving process died (EOF or exit) with requests pending.
    ``rc`` is its exit code when known."""

    def __init__(self, msg: str, rc: Optional[int] = None) -> None:
        super().__init__(msg)
        self.rc = rc


class HiveClient:
    """Own one serving process; thread-safe request fan-in."""

    def __init__(self, models: Dict[str, str], backend: str = "cpu",
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 heartbeat_every: Optional[float] = None,
                 install_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None, online: bool = False,
                 stderr: Any = None,
                 start_timeout: float = 120.0) -> None:
        cmd = [sys.executable, "-m", "veles_tpu_torch", "--serve-models"]
        cmd += [f"{name}={path}" for name, path in models.items()]
        cmd += ["-b", backend]
        if online:
            cmd += ["--online"]
        for flag, value in (("--max-batch", max_batch),
                            ("--max-wait-ms", max_wait_ms),
                            ("--heartbeat-every", heartbeat_every),
                            ("--install-dir", install_dir)):
            if value is not None:
                cmd += [flag, str(value)]
        run_env = dict(os.environ)
        run_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, run_env.get("PYTHONPATH")) if p)
        if env:
            run_env.update(env)
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=stderr, text=True, bufsize=1, env=run_env, cwd=cwd)
        self._wlock = threading.Lock()
        self._cond = threading.Condition()
        self._results: Dict[int, Dict[str, Any]] = {}
        self._next_id = 0
        self._eof = False
        self.exit_rc: Optional[int] = None
        self.hello: Optional[Dict[str, Any]] = None
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

    def _read_loop(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue   # not a protocol line
            with self._cond:
                if msg.get("ready"):
                    self.hello = msg
                elif isinstance(msg.get("id"), int) and \
                        msg["id"] <= self._next_id:
                    self._results[msg["id"]] = msg
                self._cond.notify_all()
        # EOF: the process is gone; every waiter fails now
        with self._cond:
            self._eof = True
            self.exit_rc = self.proc.poll()
            self._cond.notify_all()

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
               label: Optional[Any] = None) -> int:
        """Send one request without waiting; returns its wire id (collect
        it with :meth:`wait_for`).  ``label`` (per-row ground truth)
        feeds an ``--online`` hive's tap."""
        jid = self._draw_id()
        msg = {"id": jid, "model": model,
               "rows": np.asarray(rows, np.float32).tolist()}
        if label is not None:
            msg["label"] = np.asarray(label).tolist()
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
        """The serving process's counters (``op=stats``)."""
        return self._op("stats", "stats", timeout)

    def wait_for(self, jid: int, timeout: float = 60.0) -> Dict[str, Any]:
        return self._wait(jid, timeout)

    def request(self, model: str, rows: Any, timeout: float = 60.0,
                label: Optional[Any] = None) -> Dict[str, Any]:
        """One round trip: the answer ({"pred", "probs", ...} or
        {"error"})."""
        return self.wait_for(self.submit(model, rows, label=label),
                             timeout)

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
