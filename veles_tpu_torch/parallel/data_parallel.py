"""DataParallel: synchronous data parallelism on a StandardWorkflow;
and the mesh of places as one device (:class:`MeshDevice`).

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
from typing import Any, List, Optional

import numpy as np
import torch

from veles_tpu_torch.backends import TorchDevice
from veles_tpu_torch.parallel import mesh as mesh_helpers
from veles_tpu_torch.parallel.mesh import Mesh, RankGroup

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


class MeshDevice(TorchDevice):
    """A process's mesh of places as one device (the counterpart of
    ``MeshJaxDevice``, ``veles_tpu/parallel/data_parallel.py:22``): a
    ``--mesh N`` hive replica's, and what a member-sharded engine reads
    its places from.  It is the head place's :class:`TorchDevice` for
    everything that is not placement-aware (``put``, ``get``,
    ``zeros``, the dtype policy): in the port an unsharded computation
    runs on the head place, where the reference's SPMD program runs it
    on every device, so ``put`` lands ONE copy there.  The placements:

    - :meth:`put_replicated`: one copy a place (the reference's
      replicated ``put``), charging ``h2d_bytes`` N copies;
    - :meth:`put_sharded`: place r's ``padded_rows(R, N) / N`` rows,
      the tail zero-padded, charging the padded total once;
    - :meth:`put_members`: place r's P/N members of a stacked member
      axis (``mesh.put_member_sharded``), the padded total once.

    Each returns the list of per-place tensors.  Places on one card
    share its memory, so :meth:`total_memory` is one place's share: a
    budget read from it is per place, as the reference's is per
    device."""

    def __init__(self, mesh: Mesh,
                 compute_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(mesh.head)
        if compute_dtype is not None:
            self.compute_dtype = compute_dtype
        self.mesh = mesh
        self.backend_name = "mesh"

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def places(self):
        return self.mesh.places

    def put_replicated(self, array: Any) -> List[torch.Tensor]:
        arr = np.ascontiguousarray(array)
        return [self.put(arr, to=place) for place in self.mesh.places]

    def put_sharded(self, array: Any) -> List[torch.Tensor]:
        arr = np.asarray(array)
        n = self.mesh.size
        return [self.put(mesh_helpers.row_tile(arr, r, n), to=place)
                for r, place in enumerate(self.mesh.places)]

    def put_members(self, array: Any) -> List[torch.Tensor]:
        return mesh_helpers.put_member_sharded(self.mesh, self,
                                               np.asarray(array))

    def total_memory(self) -> Optional[int]:
        """One place's share of its card's memory (the least over the
        places), or None on the CPU."""
        return self.mesh.place_memory()

    def synchronize(self) -> None:
        if self.platform == "cuda":
            for card in sorted({p.index for p in self.mesh.places}):
                torch.cuda.synchronize(card)

    def __repr__(self) -> str:
        return (f"<MeshDevice {self.mesh.size} places on {self.platform} "
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
