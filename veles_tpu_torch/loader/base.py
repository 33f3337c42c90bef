"""Loader base: data set splits, epochs, superstep bookkeeping.

Counterpart of ``veles_tpu/loader/base.py:Loader``.  Samples are laid
out test | valid | train (TEST=0, VALID=1, TRAIN=2).  Each epoch the
TRAIN order is shuffled through the ``"loader"`` numpy stream (bitwise
the reference's draws, so minibatch order is the reference's), and each
firing (:meth:`run`) emits up to ``superstep`` same-class minibatches as
INDICES: ``superstep_indices`` and ``superstep_mask`` of shape (k, mb).
The last minibatch of a class is padded to the static size with
``np.resize`` (the class's first rows again) and its padded rows are
masked out.

- Resident (``device_resident``): the fused step gathers the rows on
  the device.
- Streaming (``device_resident`` False, a data set over the residency
  budget, ``loader/fullbatch.py``): each firing also assembles its rows
  on the host (:meth:`assemble_rows`) into ``superstep_data``,
  ``superstep_labels`` and, for a set with regression targets,
  ``superstep_targets``: CPU tensors of shape (k, mb, ...), (k, mb) and
  (k, mb, ...); a data-parallel rank assembles only its own columns
  of the (k, mb) indices (:meth:`rank_rows`), so every rank walks the
  same global index sequence from the same seed and holds its slice.
  Floating data is cast to ``stream_dtype`` (the fused
  runner sets the compute dtype, so bf16 is what crosses PCIe); any
  other data (the ingest codec's uint8, ``dequant`` set, or a byte set
  with the codec off, ``loader/fullbatch.py``) crosses as it is stored,
  1 byte a pixel for bytes, and the fused step casts or dequantizes it.
  Targets are always f32, never cast to ``stream_dtype``: the loss
  reads them in f32.  A
  prefetch thread assembles the NEXT group (:meth:`_next_group`, known
  once a firing returns) while the device computes this one; a
  prefetched group whose indices differ from the real one (after a
  resume) is thrown away.

Flags, plain booleans here (the reference's ``mutable.Bool``):
``class_ended`` (the firing ended a class), ``last_minibatch`` (it
ended TRAIN), ``epoch_ended`` (it ended the epoch; ``epoch_number`` is
then already the next one).

``initialize`` calls ``load_data``, then the :meth:`post_load_data`
hook (normalization and the codec, ``loader/fullbatch.py``).

Snapshots: the epoch order, class cursor, position and epoch number
ride along; the device, the prefetch thread and the assembled batches
do not.  ``load_data`` runs again on every ``initialize`` (the port's
loaders regenerate their data), and a resumed loader keeps its pickled
order instead of drawing a new shuffle.

Telemetry: each epoch's wall seconds (from the first firing, or the
last epoch end) go to ``loader.epoch_seconds``, with a
``loader.epoch`` event and the ``loader.epochs`` counter.

Distribution hooks (``distributable.py``; the master--slave mode,
``server.py`` / ``client.py``): :meth:`Loader.generate_data_for_slave`
gives the job of the firing that just ran, the reference's
``{"indices", "class", "size"}`` of its one minibatch (the master fires
one minibatch at a time), and :meth:`Loader.apply_data_from_master`
makes that job the loader's superstep of one minibatch on a slave: the
(1, mb) indices and mask the fused runner reads, and, for a streaming
loader, its rows assembled on the host.  ``host_fill_enabled`` False
(the master's) skips a streaming loader's host assembly in
:meth:`Loader.run`: the master ships indices only.

Not ported: the host ``fill_minibatch`` path.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch

from veles_tpu_torch import events, prng, telemetry
from veles_tpu_torch.distributable import Distributable

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")
#: the ``prng`` stream that shuffles TRAIN each epoch
PRNG_STREAM = "loader"


class Loader(Distributable):
    """Abstract loader: subclasses implement :meth:`load_data`, which
    sets ``class_lengths`` (and the data)."""

    def __init__(self, workflow: Any = None, name: str = "loader",
                 minibatch_size: int = 100, shuffle: bool = True) -> None:
        self.workflow = workflow
        self.name = name
        self.minibatch_size = minibatch_size
        #: samples per split: [n_test, n_valid, n_train]
        self.class_lengths: List[int] = [0, 0, 0]
        self.shuffle_enabled = shuffle
        self.device = None
        #: minibatches emitted per firing at most (same class)
        self.superstep = 1
        self.superstep_indices = None     # (k, mb) int64
        self.superstep_mask = None        # (k, mb) float32
        self.superstep_k = 0
        self.minibatch_class = TRAIN
        self.epoch_number = 0
        self.last_minibatch = False
        self.epoch_ended = False
        self.class_ended = False
        self._order: List[np.ndarray] = [np.empty(0, np.int64)] * 3
        self._pos = 0
        self._class_cursor = 0
        self._present_classes: List[int] = []
        #: False: the fused step consumes host-assembled batches
        self.device_resident = True
        #: False: a streaming loader's firing emits indices only (the
        #: master of the master--slave mode, which computes nothing)
        self.host_fill_enabled = True
        #: torch dtype the streamed data is cast to on the host (None:
        #: the loader's own)
        self.stream_dtype: Optional[torch.dtype] = None
        self.superstep_data: Optional[torch.Tensor] = None    # (k, mb, ..)
        self.superstep_labels: Optional[torch.Tensor] = None  # (k, mb)
        self.superstep_targets: Optional[torch.Tensor] = None  # (k, mb, ..)
        #: the uint8 codec's ``AffineDequant`` (set by post_load_data):
        #: the data stays bytes and the fused step dequantizes it on
        #: the device
        self.dequant = None
        #: host seconds spent assembling streamed minibatches, and their
        #: count
        self.assemble_seconds = 0.0
        self.assembled_minibatches = 0
        self._prefetch_pool = None
        self._prefetch_future = None       # (key, Future)
        #: monotonic start of the current epoch (None before a firing)
        self._epoch_t0 = None
        #: the data-parallel group (``parallel.DataParallel.install``);
        #: None: one device
        self.group = None

    #: process-local state a snapshot drops
    _unpicklable = ("device", "_prefetch_pool", "_prefetch_future",
                    "superstep_data", "superstep_labels",
                    "superstep_targets", "_epoch_t0", "group")

    def __getstate__(self) -> dict:
        d = dict(self.__dict__)
        for key in self._unpicklable:
            d[key] = None
        return d

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("dequant", None)
        self.__dict__.setdefault("superstep_targets", None)
        self.__dict__.setdefault("host_fill_enabled", True)
        self.__dict__["_epoch_t0"] = None
        self.__dict__["group"] = None

    # -- subclass contract --------------------------------------------

    def load_data(self) -> None:
        raise NotImplementedError

    def post_load_data(self) -> None:
        """Runs right after :meth:`load_data` (normalization and the
        codec in ``FullBatchLoader``)."""

    def assemble_rows(self, indices: np.ndarray):
        """(data, labels, targets) host rows (numpy arrays or CPU
        tensors; targets None for a set without them) for GLOBAL sample
        ``indices``: the streaming path's assembly primitive."""
        raise NotImplementedError(
            f"{type(self).__name__} has device_resident=False but does "
            f"not implement assemble_rows()")

    # -- helpers -------------------------------------------------------

    @property
    def max_minibatch_size(self) -> int:
        return min(self.minibatch_size,
                   max(c for c in self.class_lengths if c) if any(
                       self.class_lengths) else self.minibatch_size)

    def rank_rows(self):
        """This data-parallel rank's ``[lo, hi)`` of the static
        minibatch, or None on one device."""
        if self.group is None:
            return None
        return self.group.rows(self.max_minibatch_size)

    def class_offset(self, klass: int) -> int:
        """Global sample offset where ``klass`` starts."""
        return int(sum(self.class_lengths[:klass]))

    # -- lifecycle -----------------------------------------------------

    def initialize(self, device: Any = None) -> None:
        self.device = device
        self.load_data()
        if not any(self.class_lengths):
            raise ValueError(f"{self.name}: load_data produced no samples")
        self.post_load_data()
        self._present_classes = [c for c in (TEST, VALID, TRAIN)
                                 if self.class_lengths[c] > 0]
        # a resumed loader is mid-epoch: a new shuffle would both leave
        # the straight run's order and consume the stream twice
        if any(len(self._order[c]) != self.class_lengths[c]
               for c in (TEST, VALID, TRAIN)):
            self._reset_epoch()

    def _reset_epoch(self) -> None:
        self._class_cursor = 0
        self._pos = 0
        for c in (TEST, VALID, TRAIN):
            n = self.class_lengths[c]
            idx = np.arange(n, dtype=np.int64) + self.class_offset(c)
            if c == TRAIN and self.shuffle_enabled:
                prng.get(PRNG_STREAM).numpy.shuffle(idx)
            self._order[c] = idx

    # -- the firing ----------------------------------------------------

    def _next_group(self):
        """(indices, mask, position after it) of the group the next
        firing emits: up to ``superstep`` minibatches of the current
        class, (k, mb) each, the last one padded and masked."""
        order = self._order[self._present_classes[self._class_cursor]]
        n = len(order)
        mb = self.max_minibatch_size
        pos = self._pos
        k = max(1, min(self.superstep, -(-(n - pos) // mb)))
        idxs = np.empty((k, mb), np.int64)
        masks = np.zeros((k, mb), np.float32)
        for j in range(k):
            stop = min(pos + mb, n)
            raw = order[pos:stop]
            # pad to the static shape; padded rows are masked out
            idxs[j] = np.resize(raw, mb)
            masks[j, :len(raw)] = 1.0
            pos = stop
        return idxs, masks, pos

    def run(self) -> None:
        self.epoch_ended = False
        self.last_minibatch = False
        self.class_ended = False

        if self._epoch_t0 is None:   # the first firing of a (resumed) run
            self._epoch_t0 = time.monotonic()
        klass = self._present_classes[self._class_cursor]
        n = len(self._order[klass])
        idxs, masks, self._pos = self._next_group()
        self.superstep_indices = idxs
        self.superstep_mask = masks
        self.superstep_k = len(idxs)
        self.minibatch_class = klass
        streams = not self.device_resident and self.host_fill_enabled
        if streams:
            self._fill_superstep_streaming(idxs)

        if self._pos >= n:  # class exhausted
            self.class_ended = True
            if klass == TRAIN:
                self.last_minibatch = True
            self._class_cursor += 1
            self._pos = 0
            if self._class_cursor >= len(self._present_classes):
                self.epoch_ended = True
                self.epoch_number += 1
                dt = time.monotonic() - self._epoch_t0
                telemetry.histogram(
                    events.HIST_LOADER_EPOCH_SECONDS).record(dt)
                telemetry.counter(events.CTR_LOADER_EPOCHS).inc()
                telemetry.event(events.EV_LOADER_EPOCH,
                                epoch=self.epoch_number,
                                seconds=round(dt, 3))
                self._epoch_t0 = time.monotonic()
                self._reset_epoch()
        # the next group is now fully determined: assemble it while the
        # device computes this one
        if streams:
            self._start_prefetch()

    # -- streaming superstep assembly (device_resident False) ----------

    def _assemble_superstep(self, idxs: np.ndarray):
        """(k, mb) global indices -> ((k, mb, ...) data, (k, mb) labels,
        (k, mb, ...) f32 targets or None) CPU tensors, floating data cast
        to ``stream_dtype`` (other data stays as stored), and the seconds
        it took."""
        t0 = time.perf_counter()
        rows = self.rank_rows()
        if rows is not None:
            idxs = idxs[:, rows[0]:rows[1]]
        k, mb = idxs.shape
        data, labels, targets = self.assemble_rows(idxs.reshape(-1))
        data = torch.as_tensor(data)
        if self.stream_dtype is not None and data.is_floating_point():
            # torch's CPU cast rounds to nearest even, as the device's
            # .to(bfloat16) does in the resident path
            data = data.to(self.stream_dtype)

        def shape_back(t):
            return t.reshape((k, mb) + tuple(t.shape[1:]))
        if labels is not None:
            labels = shape_back(torch.as_tensor(labels, dtype=torch.int64))
        if targets is not None:
            targets = shape_back(torch.as_tensor(targets,
                                                 dtype=torch.float32))
        return (shape_back(data), labels, targets,
                time.perf_counter() - t0)

    def _fill_superstep_streaming(self, idxs: np.ndarray) -> None:
        key = idxs.tobytes()
        res = None
        if self._prefetch_future is not None:
            pkey, fut = self._prefetch_future
            self._prefetch_future = None
            if pkey == key:
                res = fut.result()
            else:
                # the peek missed (control flow changed between
                # firings, as after a resume): assemble afresh
                fut.cancel()
        if res is None:
            res = self._assemble_superstep(idxs)
        (self.superstep_data, self.superstep_labels,
         self.superstep_targets, dt) = res
        self.assemble_seconds += dt
        self.assembled_minibatches += len(idxs)

    def _start_prefetch(self) -> None:
        if self._prefetch_future is not None:
            return
        idxs = self._next_group()[0]
        if self._prefetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._prefetch_pool = ThreadPoolExecutor(
                1, thread_name_prefix=f"{self.name}-prefetch")
        self._prefetch_future = (
            idxs.tobytes(),
            self._prefetch_pool.submit(self._assemble_superstep, idxs))

    # -- distribution hooks (the master--slave mode) --------------------

    def generate_data_for_slave(self, slave=None) -> dict:
        """The job of the last firing: its last minibatch's indices,
        class and real rows."""
        return {"indices": self.superstep_indices[-1].copy(),
                "class": self.minibatch_class,
                "size": int(self.superstep_mask[-1].sum())}

    def apply_data_from_master(self, data) -> None:
        """Make a master's job this loader's superstep of one
        minibatch."""
        self.minibatch_class = data["class"]
        indices = np.asarray(data["indices"], np.int64)
        mask = np.zeros(len(indices), np.float32)
        mask[:data["size"]] = 1.0
        self.superstep_indices = indices[None]
        self.superstep_mask = mask[None]
        self.superstep_k = 1
        if not self.device_resident:
            self._fill_superstep_streaming(self.superstep_indices)

    def stop(self) -> None:
        """Shut the prefetch thread down (a later firing starts a new
        one)."""
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=False, cancel_futures=True)
            self._prefetch_pool = None
            self._prefetch_future = None
