"""DataParallel: synchronous data parallelism on a StandardWorkflow.

Counterpart of ``veles_tpu/parallel/data_parallel.py``.  The reference
jits the fused step over a mesh and lets XLA insert the gradient
``psum``; the port runs one process per rank.  Every rank holds the
same params and velocities, takes its 1/N slice of every GLOBAL
minibatch, and sums the gradients over the group (``all_reduce``)
before each layer's update (``engine/core.py`` ``build_backward``).
The error seed is divided by the global minibatch's valid rows, so the
sum is the single-device gradient: synchronous SGD on the global
minibatch, the single-device trajectory up to summation order.

Each rank launches the LRN kernels on its own slice: the reference
forces its units onto their XLA form on a mesh (``force_xla``) because
the SPMD partitioner handles custom calls poorly; the port has no
partitioner, so the kernels stay.
"""

from __future__ import annotations

import logging
from typing import Any

from veles_tpu_torch.backends import TorchDevice
from veles_tpu_torch.parallel.mesh import RankGroup

log = logging.getLogger("veles.parallel")


class RankDevice(TorchDevice):
    """This rank's device in a group (the counterpart of
    ``MeshJaxDevice``).  ``h2d_bytes`` is per device, as the reference's
    accounting is per device: a replicated ``put`` lands one copy on this
    rank's device and charges its bytes here (every rank charges its
    own); a row-sharded upload (``mesh.put_row_sharded``) lands and
    charges this rank's padded tile."""

    def __init__(self, group: RankGroup) -> None:
        super().__init__(group.device)
        self.group = group
        self.backend_name = f"rank{group.rank}/{group.world_size}"

    def __repr__(self) -> str:
        return (f"<RankDevice {self.device} rank {self.group.rank}/"
                f"{self.group.world_size} {self.group.backend} "
                f"compute={self.compute_dtype}>")


class DataParallel:
    """Wires a group into a StandardWorkflow::

        dp = DataParallel(workflow, group)
        device = dp.install()          # BEFORE workflow.initialize
        workflow.initialize(device=device, train=True)

    ``install`` refuses a ``minibatch_size`` the group's size does not
    divide, and gives the loader, the fused step and the workflow the
    group; the fused step checks the static minibatch
    (``max_minibatch_size``) again once the data is loaded."""

    def __init__(self, workflow: Any, group: RankGroup,
                 device: Any = None) -> None:
        self.workflow = workflow
        self.group = group
        self.device = device if device is not None else RankDevice(group)

    def install(self) -> RankDevice:
        fused = getattr(self.workflow, "fused", None)
        if fused is None:
            raise ValueError(
                "DataParallel needs a StandardWorkflow with a fused step")
        n = self.group.world_size
        mb = self.workflow.loader.minibatch_size
        if mb % n:
            raise ValueError(
                f"minibatch_size {mb} not divisible by the {n}-rank group")
        fused.group = self.workflow.loader.group = self.group
        self.workflow.group = self.group
        log.info("data parallel over %d ranks (%s), global minibatch %d -> "
                 "%d a rank", n, self.group.backend, mb, mb // n)
        return self.device
