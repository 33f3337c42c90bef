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
  never encodes.
- Without the codec the host keeps the dtype ``post_load_data`` leaves
  (the reference's rule): a normalizer's f32 output, else the stored
  dtype, so a uint8 set with the codec off (and no normalizer) stays
  1 byte a pixel on the host, in the budget, on the device and on the
  streaming wire.  The device holds floating data as f32 (a float64
  set is charged its 8 bytes an element, as the reference charges it,
  and uploaded as f32) and any other dtype as stored; the fused step's
  forward casts the rows to the compute dtype (``engine/core.py``).
- Regression targets (``host_targets``; ``has_targets``): a loader's
  ``targets_from_data`` makes them ALIAS the input (an autoencoder's
  target is its normalized input).  Aliased targets never take the
  codec (``quantized_ingest=True`` raises: "targets alias the input
  data") and are the data array again after normalization.  The budget
  charges the data's bytes only, as the reference does.  Resident,
  aliased targets SHARE the data's device tensor (the fused step casts
  the gathered target rows to f32); other targets are uploaded as f32.
  Streamed, they cross as f32 (``loader/base.py``).
- Within the budget, the samples are uploaded ONCE (``original_data``)
  with the labels as int64 (``original_labels``, the index type
  ``index_select`` takes) and the targets (``original_targets``); they
  stay on the device for the whole run and the fused step gathers its
  minibatches there.
- Over it, or with ``on_device=False``, nothing is uploaded:
  ``device_resident`` is False, the host arrays stay, and every firing
  streams its rows from the host (:meth:`assemble_rows`,
  ``loader/base.py``).

A set without labels (an :class:`ArrayLoader` of ``(x,)`` splits, a
:class:`DeviceArrayLoader`) trains only against regression targets:
its ``host_labels`` and ``original_labels`` stay None.

A snapshot carries no host or device array: ``load_data`` runs again
at every ``initialize`` (the synthetic and file loaders regenerate or
re-read their data; an :class:`ArrayLoader` keeps its split arrays).
:class:`DeviceArrayLoader` takes splits that are already tensors on the
device and never makes a host copy.  A resident upload that runs out
of card memory (or fault point ``device.oom_on_put``, ``site=
resident_dataset``) degrades to streaming from the host, counted in
``device.oom_degraded``.

Under data parallelism (``parallel/``) the budget is charged per
device: a replicated set costs its whole size on every rank.  With
``mesh_shard`` (else ``$VELES_MESH_SHARD_DATA``) ``"auto"`` a set over
one device's budget whose 1/N fits is ROW-SHARDED instead of streamed
(``shard_resident``: each rank uploads its ``padded_rows(R, N) / N``
rows, at the stored dtype, so the uint8 codec's bytes stay 1 byte a
pixel), ``"always"`` shards whenever data parallel, ``"never"`` keeps
whole copies; ``resident_bytes`` is what this device holds.  A streamed
rank assembles only its own slice of every minibatch
(``loader/base.py``).  Not ported: the host ``fill_minibatch`` path.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch import events, faults, knobs, telemetry

from veles_tpu_torch.loader.base import TEST, TRAIN, VALID, Loader
from veles_tpu_torch.loader.quantize import (derive_dequant,
                                             quantizable_source, to_uint8)
from veles_tpu_torch.normalization import make_normalizer

log = logging.getLogger("veles.loader")

#: the residency budget's default, and the variable that overrides it
RESIDENT_BYTES_ENV = knobs.MAX_RESIDENT_BYTES
DEFAULT_RESIDENT_BYTES = knobs.KNOBS[RESIDENT_BYTES_ENV].default


class FullBatchLoader(Loader):
    def __init__(self, workflow: Any = None,
                 max_resident_bytes: Optional[int] = None,
                 on_device: bool = True, normalization_type: str = "none",
                 normalization_parameters: Optional[dict] = None,
                 quantized_ingest: Any = "auto",
                 mesh_shard: Optional[str] = None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.max_resident_bytes = max_resident_bytes
        #: the row-sharded residency policy under data parallelism
        #: ("auto" / "always" / "never"); None reads
        #: ``$VELES_MESH_SHARD_DATA``
        self.mesh_shard = mesh_shard
        #: True: each rank holds its 1/N of the rows (``original_*`` are
        #: its shards) and the fused step gathers through
        #: ``batching.make_sharded_row_gather``
        self.shard_resident = False
        #: device bytes of the resident set on this device (0 streamed)
        self.resident_bytes = 0
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
        #: regression targets (None: a classifier's set); ``load_data``
        #: aliases them to ``host_data`` for ``targets_from_data``
        self.host_targets = None
        #: the resident device tensors
        self.original_data = None
        self.original_labels = None
        self.original_targets = None

    _unpicklable = Loader._unpicklable + (
        "host_data", "host_labels", "host_targets", "original_data",
        "original_labels", "original_targets")

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        # a snapshot written before normalization, the codec and the
        # regression targets were ported loads with their defaults
        for key, value in (("normalization_type", "none"),
                           ("normalization_parameters", {}),
                           ("normalizer", None),
                           ("quantized_ingest", "auto"),
                           ("_quant_pre_scale", 1.0),
                           ("host_targets", None),
                           ("original_targets", None),
                           ("mesh_shard", None),
                           ("shard_resident", False),
                           ("resident_bytes", 0)):
            self.__dict__.setdefault(key, value)

    @property
    def has_targets(self) -> bool:
        return self.host_targets is not None or \
            self.original_targets is not None

    def post_load_data(self) -> None:
        """Decide the codec BEFORE normalizing (the point is never to
        make the float copy), fit the normalizer on TRAIN unless a
        snapshot brought it, then keep the bytes with the normalizer
        folded into ``dequant``, or normalize on the host to f32.
        Targets that alias the data keep aliasing it."""
        alias = self.host_targets is not None and \
            self.host_targets is self.host_data
        self._encode_or_normalize(alias)
        if alias:
            self.host_targets = self.host_data

    def _encode_or_normalize(self, targets_alias_data: bool) -> None:
        self.dequant = None
        pre = self.host_data
        want = self.quantized_ingest
        # aliased targets stay float: the loss reads them undequantized
        quantize = bool(want) and not targets_alias_data and \
            quantizable_source(pre, strict=(want == "auto"))
        if want is True and not quantize:
            why = "targets alias the input data" if targets_alias_data \
                else f"dtype {pre.dtype} is not byte-ranged"
            raise ValueError(
                f"{self.name}: quantized_ingest=True but the dataset "
                f"cannot ride the uint8 codec ({why})")
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
        return int(knobs.get(RESIDENT_BYTES_ENV))

    def _sharded_bytes(self, n: int) -> int:
        """This rank's bytes of the row-sharded placement: the data set
        padded to a whole per-rank tile, 1/N of its rows."""
        from veles_tpu_torch.parallel.mesh import padded_rows
        rows = len(self.host_data)
        return padded_rows(rows, n) // n * (self.host_data.nbytes // rows)

    def _decide_residency(self) -> None:
        """The budget is charged per device: a replicated set costs its
        whole size on every rank.  Under data parallelism the set is
        row-sharded when it is over one device's budget but its 1/N
        fits, or when the mode is ``always``."""
        data_bytes = self.host_data.nbytes
        budget = self._resident_budget()
        self.shard_resident = False
        group = self.group
        if self.on_device and group is not None and group.world_size > 1:
            from veles_tpu_torch.parallel.mesh import shard_mode
            mode = shard_mode(self.mesh_shard if self.mesh_shard is not None
                              else knobs.get(knobs.MESH_SHARD_DATA))
            per_rank = self._sharded_bytes(group.world_size)
            if mode != "never" and (data_bytes > budget or mode == "always") \
                    and per_rank <= budget:
                self.shard_resident = self.device_resident = True
                telemetry.event(events.EV_LOADER_SHARD_RESIDENT,
                                devices=group.world_size,
                                total_bytes=int(data_bytes),
                                per_device_bytes=int(per_rank))
                log.info("%s: data set %.1f MiB row-sharded over %d ranks "
                         "(%.1f MiB a rank)", self.name, data_bytes / 2**20,
                         group.world_size, per_rank / 2**20)
                return
        self.device_resident = self.on_device and data_bytes <= budget
        if not self.device_resident:
            log.info("%s: data set %.1f MiB (%s) %s; streaming superstep "
                     "batches from the host", self.name, data_bytes / 2**20,
                     self.host_data.dtype,
                     f"exceeds the {budget / 2**20:.1f} MiB residency "
                     f"budget" if self.on_device else "kept off the device")

    def initialize(self, device: Any = None) -> None:
        super().initialize(device)
        if self.host_labels is not None:
            self.host_labels = np.asarray(self.host_labels, np.int64)
        self._decide_residency()
        if not self.device_resident:
            return
        try:
            self._upload(device)
        except torch.cuda.OutOfMemoryError as e:
            # the budget said the set fits, the card disagreed (other
            # tenants, fragmentation): stream from the host instead
            self.original_data = self.original_labels = None
            self.original_targets = None
            self.shard_resident = False
            self.resident_bytes = 0
            telemetry.counter(events.CTR_DEVICE_OOM_DEGRADED).inc()
            telemetry.event(events.EV_DEVICE_OOM_DEGRADED,
                            site="resident_dataset")
            log.warning("%s: the data set's upload hit device OOM (%s); "
                        "streaming from the host instead", self.name, e)
            self.device_resident = False
            return
        self.host_data = self.host_labels = self.host_targets = None

    def _upload(self, device: Any) -> None:
        if faults.fire("device.oom_on_put", site="resident_dataset"):
            raise torch.cuda.OutOfMemoryError(
                "fault-injected OOM on the resident dataset upload")
        data = self.host_data
        if data.dtype.kind == "f" and data.dtype != np.float32:
            data = data.astype(np.float32)
        if self.shard_resident:
            from veles_tpu_torch.parallel.mesh import put_row_sharded

            def put(a):
                return put_row_sharded(self.group, device, a)[0]
        else:
            put = device.put
        self.original_data = put(data)
        if self.host_labels is not None:
            self.original_labels = put(self.host_labels)
        if self.host_targets is self.host_data:
            self.original_targets = self.original_data
        elif self.host_targets is not None:
            self.original_targets = put(
                np.asarray(self.host_targets, np.float32))
        stores = [self.original_data, self.original_labels]
        if self.original_targets is not self.original_data:
            stores.append(self.original_targets)
        self.resident_bytes = sum(t.numel() * t.element_size()
                                  for t in stores if t is not None)

    def normalized_host_rows(self, indices) -> np.ndarray:
        """f32 normalized rows for GLOBAL ``indices`` (or a slice),
        whatever the codec or the stored dtype: host consumers never see
        raw bytes.  A resident data set is read back from the device."""
        if self.host_data is not None:
            rows = self.host_data[indices]
        elif self.shard_resident:
            raise ValueError(f"{self.name}: the data set is row-sharded "
                             f"over the ranks; no rank holds every row")
        else:
            if not isinstance(indices, slice):
                indices = torch.as_tensor(np.asarray(indices, np.int64),
                                          device=self.original_data.device)
            rows = self.device.get(self.original_data[indices])
        if self.dequant is not None:
            return self.dequant.apply_host(rows)
        return np.asarray(rows, np.float32)

    def assemble_rows(self, indices: np.ndarray):
        """The rows of the host arrays (a multi-threaded torch gather):
        normalized data, or the stored bytes (under the codec, the wire
        format the fused step dequantizes on the device), with their
        labels and targets."""
        idx = torch.from_numpy(np.asarray(indices, np.int64))

        def rows(a):
            return None if a is None else \
                torch.from_numpy(a).index_select(0, idx)
        return (rows(self.host_data), rows(self.host_labels),
                rows(self.host_targets))


class DeviceArrayLoader(FullBatchLoader):
    """A FullBatchLoader over splits that are already torch tensors on
    the runner's device (``train`` required, ``valid`` and ``test``
    optional): the DBN's stage-chaining loader (``models/mnist_dbn.py``).
    ``load_data`` concatenates them on the device in the canonical
    [test | valid | train] layout and binds the result as
    ``original_data``: no host copy exists (``host_data`` stays None)
    and ``ingest_h2d_bytes``, the device's ``h2d_bytes`` delta across
    ``load_data``, is 0.  ``targets_from_data=True`` makes
    ``original_targets`` the same tensor.  A split on another device
    raises.  The set has no labels and takes no normalization or codec:
    it trains against its targets."""

    def __init__(self, workflow: Any = None, train: Any = None,
                 valid: Any = None, test: Any = None,
                 targets_from_data: bool = False, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if train is None:
            raise ValueError(f"{self.name}: a train split is required")
        self._splits = {TRAIN: train, VALID: valid, TEST: test}
        self._sample_shape = tuple(train.shape[1:])
        self.targets_from_data = targets_from_data
        #: the device's h2d_bytes consumed by load_data
        self.ingest_h2d_bytes = 0

    _unpicklable = FullBatchLoader._unpicklable + ("_splits",)

    @property
    def sample_shape(self):
        return self._sample_shape

    def load_data(self) -> None:
        dev = self.device
        before = dev.h2d_bytes
        xs = []
        for klass in (TEST, VALID, TRAIN):
            x = self._splits[klass]
            if x is None:
                self.class_lengths[klass] = 0
                continue
            if not isinstance(x, torch.Tensor) or x.device != dev.device:
                where = x.device if isinstance(x, torch.Tensor) \
                    else type(x).__name__
                raise ValueError(
                    f"{self.name}: split on {where}, not on the runner's "
                    f"device {dev.device}")
            self.class_lengths[klass] = int(x.shape[0])
            xs.append(x)
        data = xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)
        self.original_data = data
        if self.targets_from_data:
            self.original_targets = data
        self._splits = {TRAIN: None, VALID: None, TEST: None}
        self.ingest_h2d_bytes = dev.h2d_bytes - before

    def post_load_data(self) -> None:
        """No normalization and no codec: the set is on the device."""

    def initialize(self, device: Any = None) -> None:
        Loader.initialize(self, device)
        self.device_resident = True


class ArrayLoader(FullBatchLoader):
    """A FullBatchLoader over in-memory numpy arrays per split:
    ``train=(x, y)`` required (``(x,)``: a set without labels, for
    regression targets), ``valid`` and ``test`` optional;
    ``targets_from_labels=True`` makes the samples their own regression
    targets (the reference's name for an autoencoder's targets, aliased
    as above).  Unlike the generated data sets, the split arrays ride
    the snapshot (there is nothing to regenerate them from)."""

    def __init__(self, workflow: Any = None, train: Optional[tuple] = None,
                 valid: Optional[tuple] = None, test: Optional[tuple] = None,
                 targets_from_labels: bool = False, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if train is None:
            raise ValueError(f"{self.name}: train=(x, y) is required")
        self._splits = {TRAIN: train, VALID: valid, TEST: test}
        self._targets_from_labels = targets_from_labels

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        self.__dict__.setdefault("_targets_from_labels", False)

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
            x = np.asarray(split[0])
            self.class_lengths[klass] = len(x)
            xs.append(x)
            if len(split) > 1 and split[1] is not None:
                ys.append(np.asarray(split[1]))
        if ys and len(ys) != len(xs):
            raise ValueError(f"{self.name}: some splits have labels and "
                             f"some do not")
        self.host_data = np.concatenate(xs, axis=0)
        self.host_labels = np.concatenate(ys, axis=0).astype(np.int64) \
            if ys else None
        if self._targets_from_labels:
            self.host_targets = self.host_data
