"""The launcher: the device and seed around a workflow, resume from a
snapshot, the graceful stop, and loading workflow modules and config
files.

Counterpart of ``veles_tpu/launcher.py`` (``Launcher``,
``drive_workflow``, ``load_workflow_module``, ``apply_config_file``):

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

Data parallelism (``parallel/``), one process per rank:

- ``Launcher(multihost=True)`` joins the group from torchrun's
  environment (:func:`init_multihost`: ``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; without them it refuses,
  unless ``$VELES_MULTIHOST_ALLOW_SOLO`` accepts a single process) and
  its device is the rank's (``parallel.RankDevice``);
  :meth:`Launcher.initialize` installs ``parallel.DataParallel`` on the
  workflow, made or resumed.  Fault point ``multihost.peer_exit``
  (``process`` = the rank) hard-exits the rank (17) at once or
  ``after`` seconds past joining.
- :meth:`Launcher.run` publishes a heartbeat into the group's store
  every ``$VELES_MULTIHOST_HEARTBEAT`` seconds (2) and watches each
  peer's; a peer silent for ``$VELES_MULTIHOST_DEADLINE`` seconds (15)
  without its clean ``done`` marker is dead: the watchdog writes a
  final snapshot (bounded, from its own thread: the main thread may be
  stuck in a collective against the dead peer) and exits 13, which the
  supervisor resumes.  A collective that fails in the main thread
  (gloo raises when its peer's socket closes) takes the same exit from
  there.  Neither waits in ``destroy_process_group``: ``os._exit``.
- A preemption stops every rank before the same firing (the workflow
  sums the stop request over the group); rank 0 writes the final
  snapshot, after the partial class metrics are summed, and every rank
  exits 14.
- :meth:`Launcher.close` ends a rank that ran to its end: it destroys
  the process group while the process is whole.  Left to the
  interpreter's exit, the group's teardown aborted a finished rank
  (SIGABRT, "terminate called without an active exception", no Python
  frame left) in about 1 of 50 two-rank CPU runs beside other load.
- :func:`run_ranks` is ``--dp N`` on one host: it starts N ranks of the
  same command with ``--multihost`` and a local rendezvous, forwards
  SIGTERM and SIGINT to them, kills what is left of the group
  ``$VELES_MULTIHOST_DEADLINE`` + 30 s after a rank failed, and returns
  the worst exit code (a failure over 13 over 14 over 0).

Modes (:attr:`Launcher.mode`), as the reference's: ``standalone``;
``master`` (``listen_address``: ``server.MasterServer`` serves the
workflow's jobs) and ``slave`` (``master_address``, which wins when both
are given: ``client.SlaveClient`` computes jobs, over the data-parallel
group when there is one).

:func:`workflow_fitness` is the GA's fitness of a finished run.
"""

from __future__ import annotations

import datetime
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
from veles_tpu_torch.parallel import mesh

log = logging.getLogger("veles.launcher")


class Launcher:
    """Seeds every named stream (``prng.seed_all``) and makes the device
    (``make_device``: the card unless ``backend="cpu"``; a missing card
    raises)."""

    #: exit code of a graceful stop after a preemption signal
    PREEMPT_EXIT = 14
    #: exit code of a clean abort after a peer's death or a failed
    #: collective
    MULTIHOST_ABORT_EXIT = 13
    PREEMPT_GRACE_ENV = knobs.PREEMPT_GRACE

    def __init__(self, backend: str = "auto", seed: int = 1234,
                 snapshot: Optional[str] = None,
                 profile: Optional[str] = None,
                 plotters: bool = False,
                 status_server: Optional[str] = None,
                 verbose: bool = False, multihost: bool = False,
                 dp: Optional[int] = None,
                 master_address: Optional[str] = None,
                 listen_address: Optional[str] = None) -> None:
        self.backend = backend
        self.snapshot = snapshot
        self.master_address = master_address
        self.listen_address = listen_address
        #: where ``run`` writes its profiler trace and FLOPs table
        self.profile_dir = profile
        #: attach the standard plotters / a status reporter posting to
        #: this web status URL to the workflow made or resumed
        self.plotters = plotters
        self.status_server = status_server
        setup_logging(logging.DEBUG if verbose else logging.INFO)
        prng.seed_all(seed)
        #: this rank's data-parallel group (None: one process)
        self.group = init_multihost(backend) if multihost else None
        if self.group is not None:
            if dp is not None and dp != self.group.world_size:
                raise ValueError(f"--dp {dp} but the group has "
                                 f"{self.group.world_size} ranks")
            from veles_tpu_torch.parallel import RankDevice
            self.device = RankDevice(self.group)
        else:
            self.device = make_device(backend)
        self.workflow = None
        #: seconds the resume's load_workflow took, and the last final
        #: snapshot's save
        self.snapshot_load_seconds: Optional[float] = None
        self.final_snapshot_seconds: Optional[float] = None
        self._preempt_signum: Optional[int] = None
        self._preempt_done = threading.Event()
        log.info("launcher: backend=%s device=%r mode=%s", backend,
                 self.device, self.mode)

    @property
    def mode(self) -> str:
        if self.master_address:
            return "slave"
        if self.listen_address:
            return "master"
        return "standalone"

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
        if self.group is not None:
            from veles_tpu_torch.parallel import DataParallel
            DataParallel(self.workflow, self.group,
                         device=self.device).install()
        self.workflow.initialize(device=self.device, train=True)

    def run(self) -> None:
        watchdog_stop = self._start_multihost_watchdog() \
            if self.group is not None else None
        uninstall = self._install_preempt_handlers()
        faults.maybe_inject_sigterm(
            attempt=knobs.get(knobs.SUPERVISE_ATTEMPT), mode=self.mode)
        try:
            with profiling.trace(self.profile_dir):
                if self.mode == "standalone":
                    self.workflow.run()
                elif self.mode == "master":
                    from veles_tpu_torch.server import MasterServer
                    MasterServer(self.workflow, self.listen_address).serve()
                else:
                    from veles_tpu_torch.client import SlaveClient
                    SlaveClient(self.workflow, self.master_address,
                                group=self.group).serve()
        except Exception as e:
            if self.group is not None:
                # a dead peer surfaces here as a failed collective
                self._abort_multihost(e)   # never returns
            raise
        finally:
            uninstall()
        if self.group is not None and self._preempt_signum is None and \
                getattr(self.workflow, "stop_requested", False):
            # a peer's preemption stopped this rank's loop too
            self._preempt_signum = int(signal.SIGTERM)
        if self._preempt_signum is not None:
            self._finish_preempt()   # never returns
        if watchdog_stop is not None:
            watchdog_stop()
        if self.profile_dir:
            self._dump_flops_table()

    def close(self) -> None:
        """Leave the data-parallel group after a run that reached its
        end (no-op without one): ``destroy_process_group`` joins the
        backend's threads here, not in the interpreter's teardown."""
        if self.group is None:
            return
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        self.group.store = None

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
        (rank 0's, in a data-parallel group, once the partial class
        metrics are summed over the group) and exit 14."""
        fused = getattr(self.workflow, "fused", None)
        if self.group is not None and fused is not None:
            fused.reduce_partial_metrics()
        path = self.final_snapshot(f"preempt-{self._signal_name()}")
        telemetry.gauge(events.GAUGE_PREEMPT_SNAPSHOT_SECONDS).set(
            round(self.final_snapshot_seconds or 0.0, 3))
        self._preempt_done.set()
        log.warning("preempted: final snapshot %s (%.2fs); exiting %d",
                    path or ("FAILED" if mesh.is_writer() else
                             "written by rank 0"),
                    self.final_snapshot_seconds or 0.0, self.PREEMPT_EXIT)
        self._exit()

    def _exit(self, code: Optional[int] = None) -> None:
        # os._exit follows: atexit (and its flush) never runs, nor does
        # destroy_process_group, which would wait on a dead peer
        telemetry.flush()
        logging.shutdown()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(self.PREEMPT_EXIT if code is None else code)

    # -- multihost: liveness and the clean abort --------------------------

    def _abort_multihost(self, exc: BaseException) -> None:
        """A collective failed (a peer died, the network broke): the
        final snapshot of this rank's state, then exit 13."""
        telemetry.event(events.EV_MULTIHOST_COLLECTIVE_FAILED,
                        error=f"{type(exc).__name__}: {exc}")
        path = self.final_snapshot("multihost-abort")
        log.error("multihost collective failed (%s: %s): peer death or "
                  "partition; aborting cleanly%s", type(exc).__name__, exc,
                  f"; final snapshot: {path}" if path
                  else " (no snapshot written)")
        self._exit(self.MULTIHOST_ABORT_EXIT)

    def _peer_death_abort(self, peer: int, deadline: float) -> None:
        """The watchdog's abort: the main thread may be stuck in a
        collective against the dead peer, so an NCCL communicator is
        aborted first (its kernel would hold the stream the snapshot
        copies on), and the snapshot is written from a thread of its
        own with a bounded wait; then exit 13."""
        telemetry.event(events.EV_MULTIHOST_PEER_DEATH, peer=peer,
                        deadline=deadline)
        log.error("multihost peer %d missed its liveness deadline "
                  "(%.1fs): peer death or partition; writing a final "
                  "snapshot and aborting cleanly", peer, deadline)
        if self.group.backend == "nccl":
            _abort_communicator()
        result: dict = {}
        t = threading.Thread(
            target=lambda: result.update(
                path=self.final_snapshot("multihost-abort")),
            daemon=True, name="mh-final-snapshot")
        t.start()
        t.join(timeout=30.0)
        path = result.get("path")
        log.error("multihost peer failure: aborting cleanly%s",
                  f"; final snapshot: {path}" if path
                  else " (snapshot did not complete)")
        self._exit(self.MULTIHOST_ABORT_EXIT)

    def _start_multihost_watchdog(self):
        """Cross-process liveness over the group's store: a heartbeat key
        every ``$VELES_MULTIHOST_HEARTBEAT`` seconds, and per peer a
        thread blocking on the peer's next key for at most
        ``$VELES_MULTIHOST_DEADLINE`` seconds.  A missed deadline with no
        clean ``done`` marker (or a store that is gone: it lives in rank
        0) is a peer's death.  Each thread keeps a store client of its
        own.  Returns the stopper: it publishes this rank's ``done``
        marker, and rank 0, whose process hosts the store, waits for its
        peers' before it returns."""
        group = self.group
        me, world = group.rank, group.world_size
        peers = [p for p in range(world) if p != me]
        interval = float(knobs.get(knobs.MULTIHOST_HEARTBEAT))
        deadline = float(knobs.get(knobs.MULTIHOST_DEADLINE))
        stop = threading.Event()

        def beat() -> None:
            store, seq = _store_client(group), 0
            while not stop.wait(interval):
                try:
                    store.set(f"veles_hb/{me}/{seq}", "1")
                    if seq >= 2:
                        store.delete_key(f"veles_hb/{me}/{seq - 2}")
                except Exception:  # noqa: BLE001 — the store is gone: the
                    return         # peers' watchdogs take it from here
                seq += 1

        def watch(peer: int) -> None:
            store, seq = _store_client(group), 0
            last = time.monotonic()
            while not stop.is_set():
                # polled, never a blocking wait: a stopped rank's threads
                # leave the store at once, before its process (or rank
                # 0's, which hosts the store) ends
                try:
                    if store.check([f"veles_hb/{peer}/{seq}"]):
                        now = time.monotonic()
                        telemetry.gauge(
                            events.GAUGE_MULTIHOST_PEER_HEARTBEAT_AGE).set(
                            round(now - last, 3))
                        last, seq = now, seq + 1
                        continue
                except Exception:  # noqa: BLE001 — the store is gone
                    pass
                if stop.wait(_POLL_S) or time.monotonic() - last < deadline:
                    continue
                try:   # did the peer just finish cleanly?
                    if store.check([f"veles_done/{peer}"]):
                        return
                except Exception:  # noqa: BLE001
                    pass
                if stop.is_set() or self._preempt_signum is not None:
                    # a preempted peer is exiting 14, as this rank is
                    return
                self._peer_death_abort(peer, deadline)

        threads = [threading.Thread(target=beat, daemon=True,
                                    name="mh-heartbeat")]
        threads += [threading.Thread(target=watch, args=(p,), daemon=True,
                                     name=f"mh-watch-{p}") for p in peers]
        for t in threads:
            t.start()
        log.info("multihost watchdog up: rank %d of %d, heartbeat %.1fs, "
                 "deadline %.1fs", me, world, interval, deadline)

        def stopper() -> None:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)
            try:
                group.store.set(f"veles_done/{me}", "1")
                if me == 0 and peers:
                    group.store.wait([f"veles_done/{p}" for p in peers],
                                     datetime.timedelta(seconds=deadline))
            except Exception:  # noqa: BLE001 — a peer left first: done
                pass

        return stopper

    def final_snapshot(self, reason: str) -> Optional[str]:
        """Write the workflow into the Snapshotter's lineage
        (``<prefix>_final_<reason>_pid<pid>`` in its directory, with its
        compression) and point the resume manifest at it.  Returns the
        path, or None when it could not be written: the exit must land
        regardless."""
        from veles_tpu_torch.snapshotter import (Snapshotter, save_workflow,
                                                 write_resume_manifest)
        multihost = reason.startswith("multihost")
        if not (multihost or mesh.is_writer()):
            return None   # rank 0 writes a group's final snapshot
        snap = getattr(self.workflow, "snapshotter", None) or Snapshotter()
        safe = re.sub(r"[^A-Za-z0-9._-]+", "-", reason)
        path = os.path.join(
            snap.directory,
            f"{snap.prefix}_final_{safe}_pid{os.getpid()}{snap.suffix}")
        try:
            t0 = time.perf_counter()
            save_workflow(self.workflow, path)
            self.final_snapshot_seconds = time.perf_counter() - t0
            seconds = round(self.final_snapshot_seconds, 3)
            if multihost:
                telemetry.counter(
                    events.CTR_MULTIHOST_EMERGENCY_SNAPSHOTS).inc()
                telemetry.event(events.EV_MULTIHOST_EMERGENCY_SNAPSHOT,
                                path=path, seconds=seconds)
            else:
                telemetry.counter(events.CTR_PREEMPT_FINAL_SNAPSHOTS).inc()
                telemetry.event(events.EV_PREEMPT_FINAL_SNAPSHOT, path=path,
                                reason=reason, seconds=seconds)
            write_resume_manifest(path, reason=reason)
            telemetry.flush()
        except Exception as e:  # noqa: BLE001 — the exit must land
            log.exception("final snapshot (%s) failed: %s", reason, e)
            return None
        return path


#: seconds between a watchdog thread's looks at the store
_POLL_S = 0.1


def _store_client(group):
    """A client of the group's store of its own (a watchdog thread's:
    one client's blocking wait would hold the others' calls)."""
    import torch.distributed as dist
    lay = group.layout
    return dist.TCPStore(lay["addr"], lay["port"], is_master=False,
                         timeout=mesh.GROUP_TIMEOUT)


def _abort_communicator() -> None:
    """Abort the NCCL communicator, releasing a collective that spins
    against a dead peer, where this torch has the call."""
    import torch.distributed as dist
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if abort is None:
        return
    try:
        abort()
    except Exception as e:  # noqa: BLE001 — the exit must land
        log.warning("could not abort the NCCL communicator: %s", e)


def init_multihost(backend: str):
    """Join the data-parallel group from torchrun's environment
    (``parallel.mesh.env_layout``) and return this rank's
    ``RankGroup``: the counterpart of the reference's
    ``jax.distributed.initialize()`` over ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.  Without a layout it
    raises, unless ``$VELES_MULTIHOST_ALLOW_SOLO`` accepts one process
    (then None): a --multihost launch that silently ran alone would
    train on its share of nothing and checkpoint a state no peer can
    join."""
    layout = mesh.env_layout()
    if layout is None:
        why = (f"--multihost needs torchrun's layout ("
               f"{', '.join(mesh.LAYOUT_VARS[:4])}) in the environment")
        telemetry.event(events.EV_MULTIHOST_INIT_REFUSED, error=why)
        if knobs.get(knobs.MULTIHOST_ALLOW_SOLO):
            log.warning("%s; continuing as one process ($%s)", why,
                        knobs.MULTIHOST_ALLOW_SOLO)
            return None
        raise RuntimeError(f"{why}; set {knobs.MULTIHOST_ALLOW_SOLO}=1 to "
                           f"accept one process")
    group = mesh.init_group(layout, "cpu" if backend == "cpu" else "cuda")
    log.info("multihost: %r", group)
    _maybe_inject_peer_exit(group.rank)
    return group


def _maybe_inject_peer_exit(rank: int) -> None:
    """Fault point ``multihost.peer_exit``: hard-exit this rank (17), now
    or ``after`` seconds later on a timer thread, so a drill rehearses a
    dying peer."""
    f = faults.fire("multihost.peer_exit", process=rank,
                    attempt=knobs.get(knobs.SUPERVISE_ATTEMPT))
    if not f:
        return
    delay = float(f.get("after", 0.0))
    if delay <= 0:
        os._exit(17)

    def die() -> None:
        time.sleep(delay)
        os._exit(17)

    threading.Thread(target=die, daemon=True,
                     name="fault-peer-exit").start()


#: seconds past the deadline a failed rank's peers get to exit on their
#: own before :func:`run_ranks` kills them
RANK_REAP_GRACE = 30.0


def _severity(code: int) -> int:
    order = (0, Launcher.PREEMPT_EXIT, Launcher.MULTIHOST_ABORT_EXIT)
    return order.index(code) if code in order else len(order)


def run_ranks(argv, n: int) -> int:
    """``--dp N`` on one host: start N ranks of the same command line
    with ``--multihost`` and a local rendezvous (``MASTER_ADDR``
    127.0.0.1, a free port, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
    each), each in a session of its own, forward SIGTERM and SIGINT to
    them, and wait.  Once a rank has
    failed, the others get ``$VELES_MULTIHOST_DEADLINE`` +
    ``RANK_REAP_GRACE`` seconds to end (a survivor exits 13) before they
    are killed: no rank outlives the command.  Returns the worst exit
    code: any failure over 13 over 14 over 0."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "veles_tpu_torch", "--multihost", *argv]
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(n), RANK=str(r),
                   LOCAL_RANK=str(r))
        # a session of its own: a terminal's Ctrl-C reaches the ranks
        # once, through ``forward``, not twice (a second signal is the
        # launcher's hard exit)
        procs.append(subprocess.Popen(cmd, env=env,
                                      start_new_session=True))
    log.info("--dp %d: ranks %s on 127.0.0.1:%d", n,
             [p.pid for p in procs], port)

    def forward(signum, frame) -> None:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = {}
    if threading.current_thread() is threading.main_thread():
        prev = {sig: signal.signal(sig, forward)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    reap_at = None
    try:
        while any(p.poll() is None for p in procs):
            if reap_at is None and any(p.returncode not in (None, 0)
                                       for p in procs):
                reap_at = time.monotonic() + RANK_REAP_GRACE + \
                    float(knobs.get(knobs.MULTIHOST_DEADLINE))
            if reap_at is not None and time.monotonic() > reap_at:
                log.error("--dp %d: killing the ranks still up after a "
                          "rank failed", n)
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    codes = [p.returncode if p.returncode >= 0 else 128 - p.returncode
             for p in procs]
    log.info("--dp %d: rank exit codes %s", n, codes)
    return max(codes, key=_severity)


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
