"""The launcher: the device and seed around a workflow, resume from a
snapshot, the graceful stop, and loading workflow modules and config
files.

Counterpart of ``veles_tpu/launcher.py`` (``Launcher``,
``drive_workflow``, ``load_workflow_module``, ``apply_config_file``),
standalone mode:

- ``Launcher(snapshot=PATH)``: :meth:`Launcher.create_workflow`
  resumes the pickled workflow (``load_workflow(PATH, fallback=True)``:
  a torn file resumes from its newest intact sibling) instead of
  building a new one.
- :meth:`Launcher.run` installs SIGTERM/SIGINT handlers (from the main
  thread only).  A signal asks the workflow to stop before its next
  firing (``request_stop``) and starts a watchdog; once the loop has
  stopped, :meth:`Launcher.final_snapshot` writes the workflow into the
  Snapshotter's lineage, the resume manifest is pointed at it, and the
  process exits 14 (``PREEMPT_EXIT``), which the supervisor always
  resumes.  If the stop has not landed within ``$VELES_PREEMPT_GRACE``
  seconds (25), the watchdog writes the final snapshot itself and
  exits 14; a second signal exits 14 at once.
- ``Launcher(plotters=True)`` and ``Launcher(status_server=URL)``:
  :meth:`Launcher.create_workflow` attaches the standard plotters
  (``link_plotters``) and a status reporter posting to the web status
  page at URL (``link_status_reporter``) to a workflow that has them,
  made or resumed.  ``verbose=True`` logs at DEBUG.
- ``Launcher(profile=DIR)``: :meth:`Launcher.run` runs the workflow
  inside ``profiling.trace(DIR)`` (a ``torch.profiler`` Chrome trace)
  and then writes the analytic per-layer FLOPs table,
  ``DIR/flops_table.json``, atomically.

The preemption path journals ``preempt.requested``,
``preempt.deadline_exceeded`` and ``preempt.final_snapshot``, counts
the final snapshots, gauges their seconds, and flushes the telemetry
snapshot before every ``os._exit`` (atexit never runs there).  The
Launcher sets up logging (``logger.setup_logging``).  Fault point
``preempt.sigterm`` (:func:`~veles_tpu_torch.faults.maybe_inject_sigterm`)
delivers a real SIGTERM at the start of :meth:`Launcher.run`.

:func:`workflow_fitness` is the GA's fitness of a finished run.  Left
out: the multihost abort path, master/slave and the data-parallel
mesh.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import re
import signal
import sys
import threading
import time
from typing import Any, Optional

from veles_tpu_torch import events, faults, knobs, prng, profiling, \
    telemetry
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import setup_logging

log = logging.getLogger("veles.launcher")


class Launcher:
    """Seeds every named stream (``prng.seed_all``) and makes the device
    (``make_device``: the card unless ``backend="cpu"``; a missing card
    raises)."""

    #: exit code of a graceful stop after a preemption signal
    PREEMPT_EXIT = 14
    PREEMPT_GRACE_ENV = knobs.PREEMPT_GRACE

    def __init__(self, backend: str = "auto", seed: int = 1234,
                 snapshot: Optional[str] = None,
                 profile: Optional[str] = None,
                 plotters: bool = False,
                 status_server: Optional[str] = None,
                 verbose: bool = False) -> None:
        self.backend = backend
        self.snapshot = snapshot
        #: where ``run`` writes its profiler trace and FLOPs table
        self.profile_dir = profile
        #: attach the standard plotters / a status reporter posting to
        #: this web status URL to the workflow made or resumed
        self.plotters = plotters
        self.status_server = status_server
        setup_logging(logging.DEBUG if verbose else logging.INFO)
        prng.seed_all(seed)
        self.device = make_device(backend)
        self.workflow = None
        #: seconds the resume's load_workflow took, and the last final
        #: snapshot's save
        self.snapshot_load_seconds: Optional[float] = None
        self.final_snapshot_seconds: Optional[float] = None
        self._preempt_signum: Optional[int] = None
        self._preempt_done = threading.Event()
        log.info("launcher: backend=%s device=%r", backend, self.device)

    def create_workflow(self, factory, **kwargs: Any):
        """``factory(launcher, **kwargs)`` -> workflow, or the workflow
        resumed from ``snapshot``."""
        if self.snapshot:
            from veles_tpu_torch.snapshotter import load_workflow
            log.info("resuming from %s", self.snapshot)
            t0 = time.perf_counter()
            self.workflow = load_workflow(self.snapshot, fallback=True)
            self.snapshot_load_seconds = time.perf_counter() - t0
        else:
            self.workflow = factory(self, **kwargs)
        if self.plotters and hasattr(self.workflow, "link_plotters"):
            self.workflow.link_plotters()
        if self.status_server and hasattr(self.workflow,
                                          "link_status_reporter"):
            self.workflow.link_status_reporter(self.status_server)
        return self.workflow

    def initialize(self) -> None:
        self.workflow.initialize(device=self.device, train=True)

    def run(self) -> None:
        uninstall = self._install_preempt_handlers()
        faults.maybe_inject_sigterm(
            attempt=knobs.get(knobs.SUPERVISE_ATTEMPT), mode="standalone")
        try:
            with profiling.trace(self.profile_dir):
                self.workflow.run()
        finally:
            uninstall()
        if self._preempt_signum is not None:
            self._finish_preempt()   # never returns
        if self.profile_dir:
            self._dump_flops_table()

    def _dump_flops_table(self) -> None:
        """The analytic per-layer FLOPs and params table, next to the
        trace."""
        forwards = getattr(self.workflow, "forwards", None)
        if not forwards:
            return
        from veles_tpu_torch.snapshotter import atomic_write
        path = os.path.join(self.profile_dir, "flops_table.json")
        with atomic_write(path, "w") as f:
            json.dump({"layers": profiling.layer_flops_table(forwards),
                       "total": profiling.model_flops_per_sample(forwards)},
                      f, indent=1)
        log.info("profile: trace and flops_table.json in %s",
                 self.profile_dir)

    # -- the graceful stop ------------------------------------------------

    def _install_preempt_handlers(self):
        """SIGTERM/SIGINT -> graceful stop; only the main thread can
        install them, and a GA's genome worker
        (``$VELES_PREEMPT_DISABLE``) installs none: the GA parent owns
        preemption.  Returns the uninstaller."""
        if threading.current_thread() is not threading.main_thread() or \
                knobs.get(knobs.PREEMPT_DISABLE):
            return lambda: None
        prev = {sig: signal.signal(sig, self._on_preempt_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}

        def uninstall() -> None:
            for sig, handler in prev.items():
                signal.signal(sig, handler)
        return uninstall

    def _on_preempt_signal(self, signum, frame) -> None:
        # the interrupted main thread may hold any lock (logging's
        # among them): set flags here, talk from the watchdog thread
        if self._preempt_signum is not None:
            os.write(2, b"veles: second preempt signal - hard exit\n")
            os._exit(self.PREEMPT_EXIT)
        self._preempt_signum = signum
        self.workflow.request_stop()
        threading.Thread(target=self._preempt_watchdog, daemon=True,
                         name="preempt-watchdog").start()

    def preempt_grace(self) -> float:
        return float(knobs.get(self.PREEMPT_GRACE_ENV))

    def _signal_name(self) -> str:
        return signal.Signals(self._preempt_signum).name

    def _preempt_watchdog(self) -> None:
        grace = self.preempt_grace()
        name = self._signal_name()
        telemetry.event(events.EV_PREEMPT_REQUESTED, signal=name,
                        grace=grace, multihost=False)
        log.warning("preemption requested (%s): stopping at the next "
                    "firing; final snapshot due within %.0fs ($%s)",
                    name, grace, self.PREEMPT_GRACE_ENV)
        if self._preempt_done.wait(grace):
            return
        # the loop is wedged inside a firing: snapshot from here, bounded
        log.error("graceful stop missed the %.0fs grace; final snapshot "
                  "from the watchdog", grace)
        telemetry.event(events.EV_PREEMPT_DEADLINE_EXCEEDED, grace=grace)
        t = threading.Thread(target=self.final_snapshot,
                             args=(f"preempt-{name}",), daemon=True)
        t.start()
        t.join(timeout=max(10.0, grace))
        self._exit()

    def _finish_preempt(self) -> None:
        """The loop stopped between firings: write the final snapshot
        and exit 14."""
        path = self.final_snapshot(f"preempt-{self._signal_name()}")
        telemetry.gauge(events.GAUGE_PREEMPT_SNAPSHOT_SECONDS).set(
            round(self.final_snapshot_seconds or 0.0, 3))
        self._preempt_done.set()
        log.warning("preempted: final snapshot %s (%.2fs); exiting %d",
                    path or "FAILED", self.final_snapshot_seconds or 0.0,
                    self.PREEMPT_EXIT)
        self._exit()

    def _exit(self) -> None:
        # os._exit follows: atexit (and its flush) never runs
        telemetry.flush()
        logging.shutdown()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(self.PREEMPT_EXIT)

    def final_snapshot(self, reason: str) -> Optional[str]:
        """Write the workflow into the Snapshotter's lineage
        (``<prefix>_final_<reason>_pid<pid>`` in its directory, with its
        compression) and point the resume manifest at it.  Returns the
        path, or None when it could not be written: the exit must land
        regardless."""
        from veles_tpu_torch.snapshotter import (Snapshotter, save_workflow,
                                                 write_resume_manifest)
        snap = getattr(self.workflow, "snapshotter", None) or Snapshotter()
        safe = re.sub(r"[^A-Za-z0-9._-]+", "-", reason)
        path = os.path.join(
            snap.directory,
            f"{snap.prefix}_final_{safe}_pid{os.getpid()}{snap.suffix}")
        try:
            t0 = time.perf_counter()
            save_workflow(self.workflow, path)
            self.final_snapshot_seconds = time.perf_counter() - t0
            telemetry.counter(events.CTR_PREEMPT_FINAL_SNAPSHOTS).inc()
            telemetry.event(events.EV_PREEMPT_FINAL_SNAPSHOT, path=path,
                            reason=reason,
                            seconds=round(self.final_snapshot_seconds, 3))
            write_resume_manifest(path, reason=reason)
            telemetry.flush()
        except Exception as e:  # noqa: BLE001 — the exit must land
            log.exception("final snapshot (%s) failed: %s", reason, e)
            return None
        return path


def load_workflow_module(path: str):
    """Import a workflow file (a plain Python file, not necessarily on
    ``sys.path``)."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def apply_config_file(path: str) -> None:
    """Execute a config file for its side effect of mutating ``root``."""
    glb = {"root": root, "__file__": path, "__name__": "__veles_config__"}
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, glb)


def drive_workflow(launcher: Launcher, workflow_file: str) -> None:
    """Load a workflow module and drive it through the launcher: its
    ``run(launcher)``, or else create, initialize and run its
    ``create_workflow(launcher)``."""
    mod = load_workflow_module(workflow_file)
    if hasattr(mod, "run"):
        mod.run(launcher)
    elif hasattr(mod, "create_workflow"):
        launcher.create_workflow(getattr(mod, "create_workflow"))
        launcher.initialize()
        launcher.run()
    else:
        raise RuntimeError(
            f"{workflow_file}: defines neither run(launcher) nor "
            "create_workflow(launcher)")


def workflow_fitness(workflow) -> float:
    """The GA fitness of a finished workflow: its best validation
    ``n_err``, else (no validation split) its best train ``n_err``."""
    d = workflow.decision
    err = d.min_valid_error
    if err == float("inf"):
        err = d.min_train_error
    return err
