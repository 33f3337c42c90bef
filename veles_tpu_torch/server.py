"""Master server of the master--slave mode (the port's copy of
``veles_tpu/server.py``).

The master owns the canonical params, issues one-minibatch jobs to
slaves (``client.py``), applies their param diffs and metrics, and
lets slaves join and leave mid-run: the jobs of a slave that went
silent are issued again.  Data parallelism over ``torch.distributed``
(``parallel/``, ``--dp`` / ``--multihost``) is the port's training-scale
path; this mode is the reference's compat path for hosts that share no
process group.

Protocol, pickle (protocol 4) over zmq REQ / ROUTER, as the
reference's:

    slave -> {"type": "handshake", id}      -> {"type": "init", params}
    slave -> {"type": "job_request"}        -> {"type": "job", seq,
                                                loader, flags, params,
                                                lr_rates}
                                             | {"type": "wait", delay_ms}
                                             | {"type": "bye"}
    slave -> {"type": "job_done", seq, ...} -> {"type": "ack"}

- Jobs are issued on demand but applied in issue order
  (:meth:`MasterServer._apply_ready`): the decision sees the standalone
  metric sequence, so one slave follows the standalone run.
- The canonical params are host f32 arrays in the port's layout, taken
  from the fused runner once (the master never runs it) and written
  back into it before a snapshot and at the end.  A job carries the
  params current when it is sent, so a requeued job and a late joiner's
  handshake get the current ones.
- :meth:`MasterServer._issue_payload` fires the loader (one minibatch)
  and, since no loop runs on the master, the LR schedule by hand.
- At most twice as many jobs as there are slaves are issued and not
  yet applied; past it a request gets ``wait``.  A job unanswered for
  ``job_timeout`` seconds is requeued and its slave dropped
  (``drop_slave`` on every unit that has it).  Once the decision is
  complete, what is outstanding is discarded and the master lingers
  ``linger_s`` seconds so that connected slaves get their ``bye``.

:meth:`MasterServer.serve` binds a zmq ROUTER at ``listen_address`` (zmq
is imported there, and only there; ``tcp://HOST:*`` binds a free port,
logged and kept in ``endpoint``) and answers there until the run is
over.  :meth:`MasterServer._handle` answers one message and needs no
socket.
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
from collections import OrderedDict
from typing import Dict

import numpy as np

log = logging.getLogger("veles.server")

#: the pickle protocol of every message, the reference's
PROTOCOL = 4


def require_fused(workflow, role: str) -> None:
    """Refuse, with a clear error, a workflow the mode cannot drive: one
    without a fused runner initialized for training on a device."""
    fused = getattr(workflow, "fused", None)
    if fused is None or getattr(workflow, "device", None) is None \
            or not fused.has_params:
        raise ValueError(
            f"{role} mode runs jobs through the fused training step "
            f"(FusedStepRunner): give it a StandardWorkflow initialized "
            f"for training on a device (train=True), not "
            f"{type(workflow).__name__}")


class _Job:
    __slots__ = ("seq", "payload", "slave", "issued_at", "result")

    def __init__(self, seq: int, payload: dict) -> None:
        self.seq = seq
        self.payload = payload
        self.slave = None
        self.issued_at = 0.0
        self.result = None


class MasterServer:
    def __init__(self, workflow, listen_address: str = "",
                 job_timeout: float = 60.0, linger_s: float = 2.0) -> None:
        require_fused(workflow, "master")
        self.workflow = workflow
        self.listen_address = listen_address
        self.job_timeout = job_timeout
        self.linger_s = linger_s
        self._seq = 0
        #: issue-ordered jobs outstanding (applied from the head)
        self._pending: "OrderedDict[int, _Job]" = OrderedDict()
        self._requeue: list = []
        self._applied = 0
        self._slaves: set = set()
        self._params = None
        #: the bound endpoint (``tcp://host:*`` binds a free port) and the
        #: event set once it is bound
        self.endpoint = None
        self.bound = threading.Event()

    # -- the canonical params -------------------------------------------

    def _canonical_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The master's params (host f32, port layout), from the fused
        runner the first time: the master never runs it."""
        if self._params is None:
            self._params = {
                fn: {pn: np.array(a, np.float32) for pn, a in ps.items()}
                for fn, ps in self.workflow.fused.host_params().items()}
        return self._params

    def _apply_diff(self, diff) -> None:
        params = self._canonical_params()
        for fname, d in diff.items():
            for pname, delta in d.items():
                params[fname][pname] += delta

    def _sync_runner(self) -> None:
        """Write the canonical params into the fused runner (what a
        snapshot pickles, and what a caller reads after the run)."""
        if self._params is not None:
            self.workflow.fused.set_host_params(self._params)

    def _issue_payload(self) -> dict:
        """Fire the loader (one minibatch) and keep what the slave needs
        and the flags the decision reads when the job is applied."""
        w = self.workflow
        ld = w.loader
        ld.run()
        # no loop runs on the master: fire the LR schedule by hand, or
        # the slaves train at the initial rates
        if getattr(w, "lr_adjust", None) is not None:
            w.lr_adjust.run()
        flags = {"minibatch_class": ld.minibatch_class,
                 "class_ended": bool(ld.class_ended),
                 "epoch_ended": bool(ld.epoch_ended),
                 "last_minibatch": bool(ld.last_minibatch),
                 "epoch_number": ld.epoch_number}
        fused = getattr(w, "fused", None)
        return {"loader": ld.generate_data_for_slave(), "flags": flags,
                "lr_rates": fused.lr_rates if fused is not None else None}

    # -- in-order application ---------------------------------------------

    def _apply_ready(self) -> None:
        w = self.workflow
        decision = w.decision
        while self._pending:
            head = next(iter(self._pending.values()))
            if head.result is None:
                break
            self._pending.popitem(last=False)
            res = head.result
            if res.get("params_diff"):
                self._apply_diff(res["params_diff"])
            m = res["metrics"]
            decision.apply_data_from_slave({"n_err": [m["n_err"]],
                                            "loss": [m["loss_sum"]],
                                            "count": [m["count"]]})
            # the decision reads the loader's flags of the job's firing
            live = self._loader_flags()
            self._set_loader_flags(head.payload["flags"])
            decision.run()
            self._set_loader_flags(live)
            self._applied += 1
            snap = getattr(w, "snapshotter", None)
            if snap is not None and decision.improved:
                self._sync_runner()
                snap.run()

    def _loader_flags(self) -> dict:
        ld = self.workflow.loader
        return {"minibatch_class": ld.minibatch_class,
                "epoch_number": ld.epoch_number,
                "class_ended": bool(ld.class_ended),
                "epoch_ended": bool(ld.epoch_ended),
                "last_minibatch": bool(ld.last_minibatch)}

    def _set_loader_flags(self, flags: dict) -> None:
        ld = self.workflow.loader
        ld.minibatch_class = flags["minibatch_class"]
        ld.epoch_number = flags["epoch_number"]
        ld.class_ended = flags["class_ended"]
        ld.epoch_ended = flags["epoch_ended"]
        ld.last_minibatch = flags["last_minibatch"]

    # -- elasticity --------------------------------------------------------

    def _units(self) -> list:
        w = self.workflow
        units = getattr(w, "units", None)
        if units is None:
            units = [getattr(w, n, None) for n in
                     ("loader", "lr_adjust", "fused", "decision",
                      "snapshotter")]
        return [u for u in units if u is not None]

    def _reap_dead_jobs(self) -> None:
        now = time.monotonic()
        for job in self._pending.values():
            if job.result is None and job.slave is not None \
                    and now - job.issued_at > self.job_timeout:
                log.warning("job %d on slave %r timed out; requeueing",
                            job.seq, job.slave)
                dead = job.slave
                job.slave = None
                self._slaves.discard(dead)
                self._requeue.append(job)
                for u in self._units():
                    drop = getattr(u, "drop_slave", None)
                    if drop is not None:
                        drop(dead)

    # -- the loop ------------------------------------------------------------

    def _prepare(self) -> None:
        """Master-side semantics: one minibatch a job, indices only, and
        the decision fed from the jobs (the workflow was wired to its
        never-run fused runner)."""
        w = self.workflow
        w.loader.host_fill_enabled = False
        w.loader.superstep = 1
        if w.decision.metrics_source is not None:
            log.info("master: the decision takes the jobs' metrics, not "
                     "the fused runner's")
            w.decision.metrics_source = None
        self._canonical_params()

    def serve(self) -> None:
        """Bind a zmq ROUTER at ``listen_address`` and answer messages
        until the decision is complete and the linger has passed."""
        import zmq

        self._prepare()
        decision = self.workflow.decision
        sock = zmq.Context.instance().socket(zmq.ROUTER)
        sock.bind(self.listen_address)
        self.endpoint = sock.getsockopt_string(zmq.LAST_ENDPOINT)
        self.bound.set()
        log.info("master listening on %s", self.endpoint)
        deadline_idle = None
        try:
            while True:
                if sock.poll(100):
                    ident, _, raw = sock.recv_multipart()
                    reply = self._handle(pickle.loads(raw), ident)
                    sock.send_multipart(
                        [ident, b"", pickle.dumps(reply, protocol=PROTOCOL)])
                self._apply_ready()
                self._reap_dead_jobs()
                if decision.complete:
                    # outstanding jobs (a dead slave's) would never
                    # unblock the head: discard them; late results are
                    # acked and ignored
                    self._pending.clear()
                    self._requeue.clear()
                    if deadline_idle is None:
                        deadline_idle = time.monotonic() + self.linger_s
                    elif time.monotonic() > deadline_idle:
                        break
                else:
                    deadline_idle = None
        finally:
            sock.close(0)
            self._sync_runner()
            self.workflow.loader.stop()
        log.info("master done: %d jobs applied, final validation error "
                 "%.2f%%", self._applied, decision.epoch_error_pct[1])

    def _handle(self, msg: dict, ident) -> dict:
        kind = msg.get("type")
        if kind == "handshake":
            log.info("slave %s connected", msg.get("id", ident))
            self._slaves.add(ident)
            return {"type": "init", "params": self._canonical_params()}
        if kind == "job_request":
            # a slave reaped by a short job_timeout may still be alive
            # and asking: count it again for the issue window
            self._slaves.add(ident)
            if self.workflow.decision.complete:
                return {"type": "bye"}
            if self._requeue:
                job = self._requeue.pop(0)
            elif len(self._pending) >= 2 * max(len(self._slaves), 1):
                # the window is full: the head job straggles; the
                # requester backs off instead of training ahead on
                # stale params (without it a fast slave would compute
                # every diff against stale params while a stalled peer
                # holds the in-order application)
                return {"type": "wait", "delay_ms": 20}
            else:
                job = _Job(self._seq, self._issue_payload())
                self._seq += 1
                self._pending[job.seq] = job
            job.slave = ident
            job.issued_at = time.monotonic()
            return {"type": "job", "seq": job.seq, **job.payload,
                    "params": self._canonical_params()}
        if kind == "job_done":
            job = self._pending.get(msg["seq"])
            if job is not None and job.result is None:
                job.result = msg
            return {"type": "ack"}
        return {"type": "error", "error": f"unknown message {kind!r}"}
