"""The device-resident full-batch loader.

Counterpart of ``veles_tpu/loader/fullbatch.py:FullBatchLoader``,
resident path only: ``load_data`` fills host arrays laid out test |
valid | train, and :meth:`initialize` uploads them to the device ONCE,
the samples as f32 (``original_data``) and the labels as int64
(``original_labels``, the index type ``index_select`` and ``gather``
take), where they stay for the whole run.  The fused step gathers its
minibatches from there.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from veles_tpu_torch.loader.base import Loader


class FullBatchLoader(Loader):
    def __init__(self, workflow: Any = None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        #: host arrays from load_data, dropped after the upload
        self.host_data = None
        self.host_labels = None
        #: the resident device tensors
        self.original_data = None
        self.original_labels = None

    def initialize(self, device: Any = None) -> None:
        super().initialize(device)
        self.original_data = device.put(
            np.asarray(self.host_data, np.float32))
        self.original_labels = device.put(
            np.asarray(self.host_labels, np.int64))
        self.host_data = self.host_labels = None
