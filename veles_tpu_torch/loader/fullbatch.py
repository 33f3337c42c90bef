"""The full-batch loader: the whole data set in one array.

Counterpart of ``veles_tpu/loader/fullbatch.py`` (``FullBatchLoader``,
``ArrayLoader``), single device: ``load_data`` fills host arrays laid
out test | valid | train, :meth:`post_load_data` normalizes them or
keeps them as bytes, and :meth:`initialize` charges the data set, at
the bytes of its stored dtype, against the residency budget
(``max_resident_bytes``, else ``$VELES_MAX_RESIDENT_BYTES``, else
8 GiB).

- Normalization (``normalization_type``, ``normalization_parameters``,
  ``normalization.py``): fitted once on the TRAIN split, applied to
  every split; the fitted normalizer rides the snapshot, so a resumed
  run does not refit.
- The uint8 codec (``quantized_ingest``, ``loader/quantize.py``):
  ``"auto"`` keeps a uint8 data set as uint8 (on the host, on the
  streaming wire, and on the device when resident) and folds the
  normalizer into the fused step's dequantization (``dequant``);
  ``True`` also re-encodes any byte-ranged source (integers or integral
  floats in [0, 255]) and raises where the codec cannot apply; ``False``
  always normalizes to f32 on the host.
- Within the budget, the samples are uploaded ONCE (``original_data``:
  uint8 under the codec, else f32) with the labels as int64
  (``original_labels``, the index type ``index_select`` takes); they
  stay on the device for the whole run and the fused step gathers its
  minibatches there.
- Over it, or with ``on_device=False``, nothing is uploaded:
  ``device_resident`` is False, the host arrays stay, and every firing
  streams its rows from the host (:meth:`assemble_rows`,
  ``loader/base.py``).

A snapshot carries no host or device array: ``load_data`` runs again
at every ``initialize`` (the synthetic and file loaders regenerate or
re-read their data; an :class:`ArrayLoader` keeps its split arrays).
Not ported: the reference's mesh placements (row-sharded residency),
regression targets, ``DeviceArrayLoader`` and the host
``fill_minibatch`` path.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch.loader.base import TEST, TRAIN, VALID, Loader
from veles_tpu_torch.loader.quantize import (derive_dequant,
                                             quantizable_source, to_uint8)
from veles_tpu_torch.normalization import make_normalizer

log = logging.getLogger("veles.loader")

#: the residency budget's default, and the variable that overrides it
DEFAULT_RESIDENT_BYTES = 8 << 30
RESIDENT_BYTES_ENV = "VELES_MAX_RESIDENT_BYTES"


class FullBatchLoader(Loader):
    def __init__(self, workflow: Any = None,
                 max_resident_bytes: Optional[int] = None,
                 on_device: bool = True, normalization_type: str = "none",
                 normalization_parameters: Optional[dict] = None,
                 quantized_ingest: Any = "auto", **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.max_resident_bytes = max_resident_bytes
        self.on_device = on_device
        self.normalization_type = normalization_type
        self.normalization_parameters = dict(normalization_parameters or {})
        #: fitted on TRAIN at the first post_load_data, then kept
        self.normalizer = None
        #: "auto" | True | False, see the module docstring
        self.quantized_ingest = quantized_ingest
        #: the float view of raw bytes is ``bytes * _quant_pre_scale``
        #: (image decoders set 1/255; raw-byte arrays leave 1.0)
        self._quant_pre_scale = 1.0
        #: host arrays from load_data (dropped after a resident upload)
        self.host_data = None
        self.host_labels = None
        #: the resident device tensors
        self.original_data = None
        self.original_labels = None

    _unpicklable = Loader._unpicklable + (
        "host_data", "host_labels", "original_data", "original_labels")

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        # a snapshot written before normalization and the codec were
        # ported loads with their defaults
        for key, value in (("normalization_type", "none"),
                           ("normalization_parameters", {}),
                           ("normalizer", None),
                           ("quantized_ingest", "auto"),
                           ("_quant_pre_scale", 1.0)):
            self.__dict__.setdefault(key, value)

    def post_load_data(self) -> None:
        """Decide the codec BEFORE normalizing (the point is never to
        make the float copy), fit the normalizer on TRAIN unless a
        snapshot brought it, then keep the bytes with the normalizer
        folded into ``dequant``, or normalize on the host to f32."""
        self.dequant = None
        pre = self.host_data
        want = self.quantized_ingest
        quantize = bool(want) and quantizable_source(
            pre, strict=(want == "auto"))
        if want is True and not quantize:
            raise ValueError(
                f"{self.name}: quantized_ingest=True but the dataset "
                f"cannot ride the uint8 codec (dtype {pre.dtype} is not "
                f"byte-ranged)")
        pre_scale = self._quant_pre_scale
        if self.normalization_type == "none" and self.normalizer is None:
            if quantize:
                self.host_data = to_uint8(pre)
                self.dequant = derive_dequant(None, pre_scale)
            elif pre_scale != 1.0:
                self.host_data = pre.astype(np.float32) * \
                    np.float32(pre_scale)
            return
        if self.normalizer is None:
            if self.class_lengths[TRAIN] == 0:
                raise ValueError(
                    f"{self.name}: normalization_type="
                    f"{self.normalization_type!r} needs a TRAIN split "
                    f"to fit on (class_lengths={self.class_lengths})")
            self.normalizer = make_normalizer(
                self.normalization_type, **self.normalization_parameters)
            fit_view = pre[self.class_offset(TRAIN):]
            if pre_scale != 1.0:
                # the statistics describe the FLOAT view its affine
                # reproduces
                fit_view = fit_view.astype(np.float32) * \
                    np.float32(pre_scale)
            self.normalizer.fit(fit_view)
        if quantize:
            dq = derive_dequant(self.normalizer, pre_scale)
            if dq is not None:
                self.host_data = to_uint8(pre)
                self.dequant = dq
                return
            if want is True:
                raise ValueError(
                    f"{self.name}: quantized_ingest=True but normalizer "
                    f"{self.normalizer.kind!r} exposes no affine_params() "
                    f"to fold into the dequantization")
        if pre_scale != 1.0:
            pre = pre.astype(np.float32) * np.float32(pre_scale)
        self.host_data = self.normalizer.apply(pre)

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
        if self.dequant is None:
            self.host_data = np.asarray(self.host_data, np.float32)
        self.host_labels = np.asarray(self.host_labels, np.int64)
        self._decide_residency()
        if self.device_resident:
            self.original_data = device.put(self.host_data)
            self.original_labels = device.put(self.host_labels)
            self.host_data = self.host_labels = None

    def normalized_host_rows(self, indices) -> np.ndarray:
        """f32 normalized rows for GLOBAL ``indices`` (or a slice),
        whatever the codec: host consumers never see raw bytes.  A
        resident data set is read back from the device."""
        if self.host_data is not None:
            rows = self.host_data[indices]
        else:
            if not isinstance(indices, slice):
                indices = torch.as_tensor(np.asarray(indices, np.int64),
                                          device=self.original_data.device)
            rows = self.device.get(self.original_data[indices])
        if self.dequant is not None:
            rows = self.dequant.apply_host(rows)
        return rows

    def assemble_rows(self, indices: np.ndarray):
        """The rows of the host arrays (a multi-threaded torch gather):
        normalized f32, or raw uint8 under the codec, which IS the wire
        format (the fused step dequantizes on the device)."""
        idx = torch.from_numpy(np.asarray(indices, np.int64))
        return (torch.from_numpy(self.host_data).index_select(0, idx),
                self.host_labels[indices])


class ArrayLoader(FullBatchLoader):
    """A FullBatchLoader over in-memory numpy arrays per split:
    ``train=(x, y)`` required, ``valid`` and ``test`` optional.  Unlike
    the generated data sets, the split arrays ride the snapshot (there
    is nothing to regenerate them from)."""

    def __init__(self, workflow: Any = None, train: Optional[tuple] = None,
                 valid: Optional[tuple] = None, test: Optional[tuple] = None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if train is None:
            raise ValueError(f"{self.name}: train=(x, y) is required")
        self._splits = {TRAIN: train, VALID: valid, TEST: test}

    @property
    def sample_shape(self):
        return tuple(np.shape(self._splits[TRAIN][0])[1:])

    def load_data(self) -> None:
        xs, ys = [], []
        for klass in (TEST, VALID, TRAIN):
            split = self._splits[klass]
            if split is None:
                self.class_lengths[klass] = 0
                continue
            if len(split) < 2 or split[1] is None:
                raise ValueError(f"{self.name}: every split needs labels "
                                 f"(the port trains classifiers only)")
            x = np.asarray(split[0])
            self.class_lengths[klass] = len(x)
            xs.append(x)
            ys.append(np.asarray(split[1]))
        self.host_data = np.concatenate(xs, axis=0)
        self.host_labels = np.concatenate(ys, axis=0).astype(np.int64)
