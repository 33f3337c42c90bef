"""The run supervisor: resume a long run from its newest intact
snapshot whenever its process ends early (the port's own copy).

Counterpart of ``veles_tpu/supervisor.py``.  ``python -m
veles_tpu_torch --supervise [the usual arguments]`` runs the usual
command as a child and reads its exit code:

    0        done                -> exit 0
    13, 14   stopped cleanly     -> resume at once; never charged to the
             (14: a preemption      crash budget
             signal, after a
             final snapshot)
    2        usage error         -> give up (it would fail the same way)
    other    crash               -> resume, charged to the crash budget:
                                    the first restart at once, then an
                                    exponential backoff with +-25%
                                    jitter; ``max_crashes`` crashes
                                    within ``crash_window`` seconds
                                    give up with the child's code

Each restart's ``--snapshot`` is rewritten to the newest intact
snapshot: the resume manifest's pointer, else its lineage walked newest
first (``snapshotter.verify_snapshot`` checks the CRC envelope without
unpickling).  The supervisor exports ``$VELES_RESUME_MANIFEST`` (where
the child keeps the manifest) and ``$VELES_SUPERVISE_ATTEMPT`` (0 for
the first child, then 1, 2, ...), and forwards SIGTERM/SIGINT to the
child; after such a signal it does not resume but exits with the
child's code.

A GA run (``--optimize``) resumes through its own per-generation state
file instead: its restarts keep the arguments, and take the manifest's
``ga_state`` pointer as ``--ga-state`` when the command names none.
:func:`install_ga_stop` is the GA parent's graceful stop: SIGTERM or
SIGINT stops breeding at the next generation boundary, whose checkpoint
is already on disk, and the run exits 14.

The supervisor journals ``supervisor.restart`` / ``resumed`` /
``done`` / ``giveup`` / ``shutdown``, counts restarts and records each
downtime, into the metrics dir the child's ``--metrics-dir`` names (it
configures it, so the child inherits it as ``$VELES_METRICS_DIR``).  It
imports neither torch nor the model code, so it stays small beside its
child.
"""

from __future__ import annotations

import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, knobs, telemetry
from veles_tpu_torch.snapshotter import (MANIFEST_ENV, MANIFEST_NAME,
                                         read_resume_manifest,
                                         snapshot_candidates,
                                         verify_snapshot)

log = logging.getLogger("veles.supervisor")

EXIT_DONE = 0
EXIT_MULTIHOST_ABORT = 13
EXIT_PREEMPTED = 14
EXIT_USAGE = 2
#: codes that always resume and never charge the crash budget
RESUME_CODES = frozenset((EXIT_MULTIHOST_ABORT, EXIT_PREEMPTED))

#: exported to each child: 0 for the first, then one more per restart
ATTEMPT_ENV = knobs.SUPERVISE_ATTEMPT


def _normalize_rc(rc: int) -> int:
    """A signal death (negative returncode) as the shell's 128 + sig."""
    return 128 - rc if rc < 0 else rc


class Supervisor:
    """Spawn-and-resume loop around one run command.

    ``argv`` is the child's command-line tail; ``command`` defaults to
    ``[sys.executable, "-m", "veles_tpu_torch"]``.  ``max_crashes``
    ($VELES_SUPERVISE_MAX_CRASHES, 5) crashes inside ``crash_window``
    seconds ($VELES_SUPERVISE_CRASH_WINDOW, 300) give up;
    ``restart_backoff`` / ``restart_backoff_cap`` (0.5 s / 30 s) shape
    the delay between consecutive crashes."""

    def __init__(self, argv: List[str],
                 command: Optional[List[str]] = None,
                 max_crashes: Optional[int] = None,
                 crash_window: Optional[float] = None,
                 restart_backoff: float = 0.5,
                 restart_backoff_cap: float = 30.0,
                 seed: int = 1234,
                 manifest_path: Optional[str] = None) -> None:
        self.argv = list(argv)
        self.command = list(command) if command else \
            [sys.executable, "-m", "veles_tpu_torch"]
        self.max_crashes = int(knobs.get(knobs.SUPERVISE_MAX_CRASHES)
                               if max_crashes is None else max_crashes)
        self.crash_window = float(knobs.get(knobs.SUPERVISE_CRASH_WINDOW)
                                  if crash_window is None else crash_window)
        self.restart_backoff = restart_backoff
        self.restart_backoff_cap = restart_backoff_cap
        self._backoff_rng = np.random.default_rng(seed ^ 0x5EED)
        #: where the children keep the resume manifest; None: a directory
        #: of run()'s own, removed when it returns
        self.manifest_path = manifest_path or \
            knobs.get(knobs.RESUME_MANIFEST) or None
        # the supervisor's own journal lands in the run's metrics dir
        # even when the child was given it as a flag
        mdir = self._argv_value("--metrics-dir")
        if mdir and not telemetry.metrics_dir():
            telemetry.configure(mdir)
        self._child: Optional[subprocess.Popen] = None
        self._shutdown_sig: Optional[int] = None
        #: restarts performed so far
        self.restarts = 0

    def _argv_value(self, flag: str) -> Optional[str]:
        for i, a in enumerate(self.argv):
            if a == flag and i + 1 < len(self.argv):
                return self.argv[i + 1]
            if a.startswith(flag + "="):
                return a.split("=", 1)[1]
        return None

    # -- where to resume from -------------------------------------------

    def newest_intact_snapshot(self) -> Optional[str]:
        """The manifest's pointer (else the child's own ``--snapshot``)
        when intact, else its newest intact lineage sibling; None when
        the run left none."""
        manifest = (self.manifest_path and
                    read_resume_manifest(self.manifest_path)) or {}
        pointer = manifest.get("snapshot") or self._argv_value("--snapshot")
        if not pointer:
            return None
        for cand in [pointer] + snapshot_candidates(pointer):
            if os.path.isfile(cand) and verify_snapshot(cand):
                return cand
            log.warning("resume candidate %s is torn or missing; walking "
                        "the lineage", cand)
        return None

    def argv_for_attempt(self, attempt: int,
                         downtime: Optional[float] = None) -> List[str]:
        """The child's arguments; from the second attempt on, with
        ``--snapshot`` pointing at the newest intact snapshot."""
        argv = list(self.argv)
        if attempt == 0:
            return argv
        if "--optimize" in argv:
            manifest = (self.manifest_path and
                        read_resume_manifest(self.manifest_path)) or {}
            state = self._argv_value("--ga-state") or \
                manifest.get("ga_state")
            self._resumed(attempt, "ga_state" if state else "fresh",
                          state, downtime, "the GA ")
            if state and self._argv_value("--ga-state") is None:
                argv += ["--ga-state", state]
            return argv
        snap = self.newest_intact_snapshot()
        self._resumed(attempt, "snapshot" if snap else "fresh", snap,
                      downtime)
        if not snap:
            return argv
        done = False
        for i, a in enumerate(argv):
            if a == "--snapshot" and i + 1 < len(argv):
                argv[i + 1] = snap
                done = True
            elif a.startswith("--snapshot="):
                argv[i] = f"--snapshot={snap}"
                done = True
        return argv if done else argv + ["--snapshot", snap]

    @staticmethod
    def _resumed(attempt: int, source: str, state: Optional[str],
                 downtime: Optional[float], what: str = "") -> None:
        telemetry.event(events.EV_SUPERVISOR_RESUMED, attempt=attempt,
                        source=source, state=state,
                        downtime=None if downtime is None
                        else round(downtime, 3))
        log.info("attempt %d resumes %sfrom %s", attempt, what,
                 state or "a fresh start")

    # -- the loop --------------------------------------------------------

    def _install_forwarding(self):
        """SIGTERM/SIGINT to the supervisor go on to the child as
        SIGTERM, and its exit then ends the loop.  Main thread only;
        returns the uninstaller."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def handler(signum, frame):
            self._shutdown_sig = signum
            child = self._child
            if child is not None and child.poll() is None:
                child.send_signal(signal.SIGTERM)
        prev = {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

        def uninstall():
            for sig, h in prev.items():
                signal.signal(sig, h)
        return uninstall

    def run(self) -> int:
        own_dir = None
        if not self.manifest_path:
            own_dir = tempfile.mkdtemp(prefix="veles_supervise_")
            self.manifest_path = os.path.join(own_dir, MANIFEST_NAME)
        uninstall = self._install_forwarding()
        attempt = 0
        crash_times: deque = deque()
        consecutive_crashes = 0
        last_death: Optional[float] = None
        log.info("supervising: %s (manifest %s, crash budget %d in "
                 "%.0fs)", " ".join(self.command + self.argv),
                 self.manifest_path, self.max_crashes, self.crash_window)
        try:
            while True:
                downtime = None if last_death is None \
                    else time.monotonic() - last_death
                if downtime is not None:
                    telemetry.histogram(
                        events.HIST_SUPERVISOR_DOWNTIME_SECONDS).record(
                        downtime)
                argv = self.argv_for_attempt(attempt, downtime)
                env = dict(os.environ)
                env[MANIFEST_ENV] = self.manifest_path
                env[ATTEMPT_ENV] = str(attempt)
                self._child = subprocess.Popen(self.command + argv,
                                               env=env)
                code = _normalize_rc(self._child.wait())
                died = last_death = time.monotonic()
                if self._shutdown_sig is not None:
                    log.warning("supervisor was signalled: not resuming; "
                                "the child exited %d", code)
                    telemetry.event(events.EV_SUPERVISOR_SHUTDOWN, rc=code)
                    return code
                if code == EXIT_DONE:
                    telemetry.event(events.EV_SUPERVISOR_DONE,
                                    attempts=attempt + 1)
                    log.info("run complete after %d attempt(s), %d "
                             "restart(s)", attempt + 1, self.restarts)
                    return EXIT_DONE
                if code in RESUME_CODES:
                    consecutive_crashes = 0
                    self._note_restart(code, attempt, "preempt"
                                       if code == EXIT_PREEMPTED
                                       else "multihost_abort", 0.0)
                    attempt += 1
                    continue
                if code == EXIT_USAGE:
                    telemetry.event(events.EV_SUPERVISOR_GIVEUP, rc=code,
                                    reason="usage_error")
                    log.error("child failed with a usage error (2); "
                              "giving up")
                    return code
                crash_times.append(died)
                while died - crash_times[0] > self.crash_window:
                    crash_times.popleft()
                if len(crash_times) >= self.max_crashes:
                    telemetry.event(events.EV_SUPERVISOR_GIVEUP, rc=code,
                                    crashes=len(crash_times),
                                    window=self.crash_window)
                    telemetry.flush()
                    log.error("crash loop: %d failures inside %.0fs "
                              "(budget %d); giving up, last exit %d",
                              len(crash_times), self.crash_window,
                              self.max_crashes, code)
                    return code
                consecutive_crashes += 1
                delay = self.backoff(consecutive_crashes)
                self._note_restart(code, attempt, "crash", delay)
                time.sleep(delay)
                attempt += 1
        finally:
            uninstall()
            child = self._child
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()
            if own_dir is not None:
                shutil.rmtree(own_dir, ignore_errors=True)
                self.manifest_path = None

    def backoff(self, consecutive: int) -> float:
        """The first restart at once, then exponential with a
        deterministic +-25% jitter, capped."""
        if consecutive <= 1:
            return 0.0
        delay = min(self.restart_backoff_cap,
                    self.restart_backoff * (2.0 ** (consecutive - 2)))
        return delay * (0.75 + 0.5 * float(self._backoff_rng.random()))

    def _note_restart(self, code: int, attempt: int, kind: str,
                      delay: float) -> None:
        self.restarts += 1
        telemetry.counter(events.CTR_SUPERVISOR_RESTARTS).inc()
        telemetry.event(events.EV_SUPERVISOR_RESTART, rc=code,
                        attempt=attempt, kind=kind,
                        budget_charged=(kind == "crash"),
                        delay=round(delay, 3))
        log.warning("child exited %d (%s): restarting (attempt %d%s)",
                    code, kind, attempt + 1,
                    f", backoff {delay:.2f}s" if delay else "")


def run(argv: List[str], **kwargs) -> int:
    """``python -m veles_tpu_torch --supervise ...``: supervise the same
    command line without the flag."""
    return Supervisor(argv, **kwargs).run()


# -- the GA parent's graceful stop -------------------------------------

def install_ga_stop(grace: Optional[float] = None
                    ) -> Tuple[Callable[[], bool], Callable[[], Optional[int]]]:
    """SIGTERM/SIGINT -> stop the GA at the next generation boundary (an
    ``--optimize`` run has no Launcher).  The ``--ga-state`` checkpoint
    of the last generation is the resume point; a watchdog exits 14 on
    it if the stop has not landed within ``$VELES_PREEMPT_GRACE``
    seconds (25), and a second signal exits 14 at once.

    Returns ``(stop_check, finish)``: ``stop_check`` goes to
    ``GeneticOptimizer(stop_check=...)``; ``finish()``, called after the
    run, restores the handlers and returns 14 when a stop was asked
    for, else None.  Off the main thread it never stops."""
    if threading.current_thread() is not threading.main_thread():
        return (lambda: False), (lambda: None)
    if grace is None:
        grace = float(knobs.get(knobs.PREEMPT_GRACE))
    state = {"sig": None}
    done = threading.Event()

    def watchdog(name: str) -> None:
        telemetry.event(events.EV_PREEMPT_REQUESTED, signal=name,
                        grace=grace, mode="ga")
        log.warning("preemption requested (%s): stopping at the next GA "
                    "generation boundary; hard exit in %.0fs", name, grace)
        if done.wait(grace):
            return
        telemetry.event(events.EV_PREEMPT_DEADLINE_EXCEEDED, grace=grace,
                        mode="ga")
        log.error("GA graceful stop missed the %.0fs grace; exiting %d on "
                  "the last checkpoint", grace, EXIT_PREEMPTED)
        telemetry.flush()
        logging.shutdown()
        os._exit(EXIT_PREEMPTED)

    def handler(signum, frame):
        # the interrupted thread may hold any lock: set a flag, and talk
        # from the watchdog thread
        if state["sig"] is not None:
            os._exit(EXIT_PREEMPTED)
        state["sig"] = signum
        threading.Thread(target=watchdog,
                         args=(signal.Signals(signum).name,), daemon=True,
                         name="ga-preempt-watchdog").start()

    prev = {sig: signal.signal(sig, handler)
            for sig in (signal.SIGTERM, signal.SIGINT)}

    def stop_check() -> bool:
        return state["sig"] is not None

    def finish() -> Optional[int]:
        done.set()
        for sig, h in prev.items():
            signal.signal(sig, h)
        if state["sig"] is None:
            return None
        telemetry.event(events.EV_PREEMPT_GA_EXIT, code=EXIT_PREEMPTED)
        telemetry.flush()
        log.warning("GA preempted: exiting %d (resume with the same "
                    "--ga-state, or under --supervise)", EXIT_PREEMPTED)
        return EXIT_PREEMPTED

    return stop_check, finish
