"""The full-batch loader: the whole data set in one array.

Counterpart of ``veles_tpu/loader/fullbatch.py:FullBatchLoader``,
single device: ``load_data`` fills host arrays laid out test | valid |
train, and :meth:`initialize` charges the data set against the
residency budget (``max_resident_bytes``, else
``$VELES_MAX_RESIDENT_BYTES``, else 8 GiB).

- Within the budget, the samples are uploaded ONCE as f32
  (``original_data``) with the labels as int64 (``original_labels``,
  the index type ``index_select`` and ``gather`` take); they stay on
  the device for the whole run and the fused step gathers its
  minibatches there.
- Over it, or with ``on_device=False``, nothing is uploaded:
  ``device_resident`` is False, the host arrays stay, and every firing
  streams its rows from the host (:meth:`assemble_rows`,
  ``loader/base.py``).

A snapshot carries none of the data: ``load_data`` regenerates it at
every ``initialize``.  Not ported: the reference's mesh placements
(row-sharded residency), normalization and the uint8 ingest codec.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch.loader.base import Loader

log = logging.getLogger("veles.loader")

#: the residency budget's default, and the variable that overrides it
DEFAULT_RESIDENT_BYTES = 8 << 30
RESIDENT_BYTES_ENV = "VELES_MAX_RESIDENT_BYTES"


class FullBatchLoader(Loader):
    def __init__(self, workflow: Any = None,
                 max_resident_bytes: Optional[int] = None,
                 on_device: bool = True, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.max_resident_bytes = max_resident_bytes
        self.on_device = on_device
        #: host arrays from load_data (dropped after a resident upload)
        self.host_data = None
        self.host_labels = None
        #: the resident device tensors
        self.original_data = None
        self.original_labels = None

    _unpicklable = Loader._unpicklable + (
        "host_data", "host_labels", "original_data", "original_labels")

    def _resident_budget(self) -> int:
        if self.max_resident_bytes is not None:
            return int(self.max_resident_bytes)
        return int(os.environ.get(RESIDENT_BYTES_ENV,
                                  DEFAULT_RESIDENT_BYTES))

    def _decide_residency(self) -> None:
        data_bytes = self.host_data.nbytes
        budget = self._resident_budget()
        self.device_resident = self.on_device and data_bytes <= budget
        if not self.device_resident:
            log.info("%s: data set %.1f MiB (%s) %s; streaming superstep "
                     "batches from the host", self.name, data_bytes / 2**20,
                     self.host_data.dtype,
                     f"exceeds the {budget / 2**20:.1f} MiB residency "
                     f"budget" if self.on_device else "kept off the device")

    def initialize(self, device: Any = None) -> None:
        super().initialize(device)
        self.host_data = np.asarray(self.host_data, np.float32)
        self.host_labels = np.asarray(self.host_labels, np.int64)
        self._decide_residency()
        if self.device_resident:
            self.original_data = device.put(self.host_data)
            self.original_labels = device.put(self.host_labels)
            self.host_data = self.host_labels = None

    def assemble_rows(self, indices: np.ndarray):
        """The rows of the host arrays (a multi-threaded torch gather)."""
        idx = torch.from_numpy(np.asarray(indices, np.int64))
        return (torch.from_numpy(self.host_data).index_select(0, idx),
                self.host_labels[indices])
