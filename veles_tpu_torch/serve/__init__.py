"""The port's serving tier: the hive and the fleet.

- :mod:`veles_tpu_torch.serve.batcher`: the dynamic micro-batching loop;
- :mod:`veles_tpu_torch.serve.residency`: the multi-model residency
  manager (budget accounting, LRU spill to the host);
- :mod:`veles_tpu_torch.serve.hive`: the serving process
  (``python -m veles_tpu_torch --serve-models NAME=PKG ...``);
- :mod:`veles_tpu_torch.serve.client`: the line-protocol client;
- :mod:`veles_tpu_torch.serve.fleet`: replica lifecycle and placement;
- :mod:`veles_tpu_torch.serve.router`: the fleet router
  (``python -m veles_tpu_torch --serve-fleet N NAME=PKG ...``);
- :mod:`veles_tpu_torch.serve.sentinel`: gray-failure defense;
- :mod:`veles_tpu_torch.serve.autoscale`: the elastic fleet;
- :mod:`veles_tpu_torch.serve.traffic`: open-loop traffic.

The exports are the reference's (``veles_tpu/serve/__init__.py``).
"""

from veles_tpu_torch.serve.batcher import (DeadlineExpired,  # noqa: F401
                                           MicroBatcher)
from veles_tpu_torch.serve.client import ReplicaDied  # noqa: F401
from veles_tpu_torch.serve.fleet import PlacementPolicy  # noqa: F401
from veles_tpu_torch.serve.residency import ResidencyManager  # noqa: F401
from veles_tpu_torch.serve.sentinel import Sentinel  # noqa: F401
