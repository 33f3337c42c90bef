"""Several devices: data parallelism over ``torch.distributed`` (one
process a rank), and one process's mesh of places (member sharding).

Counterpart of ``veles_tpu/parallel/``.  The reference replaces the
original master--slave gradient aggregation with an SPMD mesh whose
gradient ``psum`` XLA inserts; the port runs one process per rank and
sums the gradients with an explicit ``all_reduce`` (``mesh.py``,
``data_parallel.py``).  ``python -m veles_tpu_torch --dp N`` starts N
ranks on this host; ``--multihost`` joins from torchrun's environment.
A member-sharded cohort or ensemble runs in one process over a
:class:`Mesh` of places (``make_mesh``, :class:`MeshDevice`):
``--serve-models --mesh N`` and the GA worker's ``--dp N``.
"""

from veles_tpu_torch.parallel.data_parallel import (DataParallel,
                                                    MeshDevice, RankDevice)
from veles_tpu_torch.parallel.mesh import (Mesh, RankGroup, env_layout,
                                           init_group, make_mesh,
                                           padded_rows, put_member_sharded,
                                           put_row_sharded, shard_mode)

__all__ = ["RankGroup", "env_layout", "init_group", "padded_rows",
           "put_row_sharded", "put_member_sharded", "shard_mode",
           "DataParallel", "RankDevice", "Mesh", "make_mesh", "MeshDevice"]
