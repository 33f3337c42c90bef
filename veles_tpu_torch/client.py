"""Slave client of the master--slave mode (the port's copy of
``veles_tpu/client.py``).

A slave connects to the master (``server.py``), takes the canonical
params from its handshake, then pulls one job at a time and computes it
as ONE firing of the workflow's fused training step on its own device
(:meth:`SlaveClient._run_job`): the job's minibatch indices into the
loader (``apply_data_from_master``), the job's params into the runner
(``set_host_params``; the momentum buffers stay the slave's, as the
reference's), the job's LR rates, ``fused.run()``, the class metrics,
and on a TRAIN minibatch the param diff.  Only the diff and three
scalars go back.  The data set is the slave's own, gathered on its
device from the indices.

A workflow without an initialized fused runner is refused at
construction (``ValueError``, ``server.require_fused``), as the
reference refuses one without a jax device; the master refuses it too.

Under data parallelism (``group``: ``--master-address`` with ``--dp N``
or ``--multihost``) the group is ONE slave: rank 0 holds the socket and
broadcasts each reply to the other ranks, every rank computes the job
on its rows of the minibatch (the gradients summed over the group, as
in a standalone data-parallel run), and rank 0 answers.

:meth:`SlaveClient.serve` connects a zmq REQ socket to
``master_address`` (zmq is imported there, and only there); every
message crosses it pickled (protocol 4).
"""

from __future__ import annotations

import logging
import pickle
import time
import uuid
from typing import Dict, Optional

import numpy as np
import torch

from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.server import PROTOCOL, require_fused

log = logging.getLogger("veles.client")


def _tree_sub(a: Dict[str, Dict[str, np.ndarray]],
              b: Dict[str, Dict[str, np.ndarray]]):
    return {fn: {pn: np.asarray(a[fn][pn]) - np.asarray(b[fn][pn])
                 for pn in a[fn]} for fn in a}


class SlaveClient:
    def __init__(self, workflow, master_address: str = "",
                 timeout_ms: int = 120000, group=None) -> None:
        require_fused(workflow, "slave")
        self.workflow = workflow
        self.master_address = master_address
        self.timeout_ms = timeout_ms
        #: the data-parallel group this slave spans (None: one device)
        self.group = group
        self.slave_id = uuid.uuid4().hex[:8]
        self.jobs_done = 0

    # -- one job -------------------------------------------------------------

    def _run_job(self, job: dict) -> dict:
        w = self.workflow
        loader, fused = w.loader, w.fused
        loader.apply_data_from_master(job["loader"])
        fused.set_host_params(job["params"])
        if job.get("lr_rates"):
            fused.lr_rates = job["lr_rates"]
        fused.run()
        n_err, loss_sum, count, _ = fused.take_class_metrics()
        metrics = {"n_err": n_err, "loss_sum": loss_sum, "count": count}
        diff = None
        if loader.minibatch_class == TRAIN:
            diff = _tree_sub(fused.host_params(), job["params"])
        return {"type": "job_done", "seq": job["seq"],
                "params_diff": diff, "metrics": metrics}

    # -- the loop --------------------------------------------------------------

    @property
    def _speaks(self) -> bool:
        """True on the process that talks to the master."""
        return self.group is None or self.group.rank == 0

    def serve(self) -> None:
        """Connect a zmq REQ socket to ``master_address`` (on a group's
        other ranks, none), then handshake and take jobs until the
        master says ``bye``."""
        sock = None
        if self._speaks:
            import zmq

            sock = zmq.Context.instance().socket(zmq.REQ)
            sock.setsockopt(zmq.RCVTIMEO, self.timeout_ms)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(self.master_address)
            log.info("slave %s connecting to %s", self.slave_id,
                     self.master_address)
        try:
            self._loop(sock)
        finally:
            if sock is not None:
                sock.close(0)

    def _loop(self, sock) -> None:
        # the fused step gathers the rows on the device from the local
        # data set
        self.workflow.loader.host_fill_enabled = False
        reply = self._exchange(sock, {"type": "handshake",
                                      "id": self.slave_id})
        self.workflow.fused.set_host_params(reply["params"])
        while True:
            reply = self._exchange(sock, {"type": "job_request"})
            if reply["type"] == "bye":
                break
            if reply["type"] == "wait":
                time.sleep(reply.get("delay_ms", 20) / 1000.0)
                continue
            if reply["type"] != "job":
                raise RuntimeError(f"unexpected reply {reply!r}")
            result = self._run_job(reply)
            if self._speaks:
                ack = self._rpc(sock, result)
                if ack["type"] != "ack":
                    raise RuntimeError(f"unexpected ack {ack!r}")
            self.jobs_done += 1
        log.info("slave %s done: %d jobs", self.slave_id, self.jobs_done)

    def _exchange(self, sock, msg: dict) -> dict:
        """One request's reply, on every rank of a group."""
        if self.group is None:
            return self._rpc(sock, msg)
        raw = self._request(sock, msg) if self._speaks else None
        return pickle.loads(self._broadcast_bytes(raw))

    @staticmethod
    def _request(sock, msg: dict) -> bytes:
        sock.send(pickle.dumps(msg, protocol=PROTOCOL))
        return sock.recv()

    def _rpc(self, sock, msg: dict) -> dict:
        return pickle.loads(self._request(sock, msg))

    def _broadcast_bytes(self, raw: Optional[bytes]) -> bytes:
        """Rank 0's ``raw`` on every rank of the group."""
        group = self.group
        n = torch.tensor([len(raw) if raw is not None else 0],
                         dtype=torch.int64, device=group.device)
        group.broadcast_(n)
        if raw is not None:
            buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            buf = buf.to(group.device)
        else:
            buf = torch.empty(int(n.item()), dtype=torch.uint8,
                              device=group.device)
        group.broadcast_(buf)
        return buf.cpu().numpy().tobytes()
