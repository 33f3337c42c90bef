"""Loader base: data set splits, epochs, superstep bookkeeping.

Counterpart of ``veles_tpu/loader/base.py:Loader``, resident path only.
Samples are laid out test | valid | train (TEST=0, VALID=1, TRAIN=2).
Each epoch the TRAIN order is shuffled through the ``"loader"`` numpy
stream (bitwise the reference's draws, so minibatch order is the
reference's), and each firing (:meth:`run`) emits up to ``superstep``
same-class minibatches as INDICES only: ``superstep_indices`` and
``superstep_mask`` of shape (k, mb).  The last minibatch of a class is
padded to the static size with ``np.resize`` (the class's first rows
again) and its padded rows are masked out.  The gather happens on the
device, in the fused step.

Flags, plain booleans here (the reference's ``mutable.Bool``):
``class_ended`` (the firing ended a class), ``last_minibatch`` (it
ended TRAIN), ``epoch_ended`` (it ended the epoch; ``epoch_number`` is
then already the next one).

Not ported: streaming with prefetch, the host ``fill_minibatch`` path,
quantized ingest, normalization, and the master/slave hooks.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from veles_tpu_torch import prng

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")
#: the ``prng`` stream that shuffles TRAIN each epoch
PRNG_STREAM = "loader"


class Loader:
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

    # -- subclass contract --------------------------------------------

    def load_data(self) -> None:
        raise NotImplementedError

    # -- helpers -------------------------------------------------------

    @property
    def max_minibatch_size(self) -> int:
        return min(self.minibatch_size,
                   max(c for c in self.class_lengths if c) if any(
                       self.class_lengths) else self.minibatch_size)

    def class_offset(self, klass: int) -> int:
        """Global sample offset where ``klass`` starts."""
        return int(sum(self.class_lengths[:klass]))

    # -- lifecycle -----------------------------------------------------

    def initialize(self, device: Any = None) -> None:
        self.device = device
        self.load_data()
        if not any(self.class_lengths):
            raise ValueError(f"{self.name}: load_data produced no samples")
        self._present_classes = [c for c in (TEST, VALID, TRAIN)
                                 if self.class_lengths[c] > 0]
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

    def run(self) -> None:
        self.epoch_ended = False
        self.last_minibatch = False
        self.class_ended = False

        klass = self._present_classes[self._class_cursor]
        order = self._order[klass]
        n = len(order)
        mb = self.max_minibatch_size
        remaining = -(-(n - self._pos) // mb)  # minibatches left
        k = max(1, min(self.superstep, remaining))

        idxs = np.empty((k, mb), np.int64)
        masks = np.zeros((k, mb), np.float32)
        for j in range(k):
            start = self._pos
            stop = min(start + mb, n)
            raw = order[start:stop]
            # pad to the static shape; padded rows are masked out
            idxs[j] = np.resize(raw, mb)
            masks[j, :len(raw)] = 1.0
            self._pos = stop
        self.superstep_indices = idxs
        self.superstep_mask = masks
        self.superstep_k = k
        self.minibatch_class = klass

        if self._pos >= n:  # class exhausted
            self.class_ended = True
            if klass == TRAIN:
                self.last_minibatch = True
            self._class_cursor += 1
            self._pos = 0
            if self._class_cursor >= len(self._present_classes):
                self.epoch_ended = True
                self.epoch_number += 1
                self._reset_epoch()
