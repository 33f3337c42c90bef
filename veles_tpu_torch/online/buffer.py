"""The replay buffer: bounded, reservoir-sampled, uint8 where possible
(the port's counterpart of ``veles_tpu/online/buffer.py``, draw for
draw).

The buffer keeps at most ``capacity`` labeled training rows by
reservoir sampling: once full, the j-th arriving row replaces a
uniformly drawn slot with probability capacity/j, under a SEEDED numpy
generator, so the same tap order always yields the same buffer (the
determinism the offline replay of the online trainer rests on).  The
generator, its draws and the order of every add are the reference's,
so the retained set, ``sample`` and ``holdout`` equal the reference's
bitwise.

Storage: when the model's :class:`~veles_tpu_torch.loader.quantize.
AffineDequant` round-trips the first tapped rows exactly, rows store
as uint8 (a quarter of f32's bytes against the residency charge) and
decode through the same affine; rows the codec cannot represent
exactly stay float32.

The held-out slice: every ``holdout_every``-th labeled add lands in a
separate, never-trained-on partition the promotion gate scores shadow
and incumbent on, capped at ``capacity // 4`` rows with FIFO
replacement.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from veles_tpu_torch.analysis import witness


class ReplayBuffer:
    """Labeled-row store for one learning model.  Thread-safe: the
    hive main loop adds, the scavenger thread samples."""

    def __init__(self, capacity: int, seed: int = 0,
                 holdout_every: int = 8,
                 dequant: Optional[Any] = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.holdout_every = max(0, int(holdout_every))
        self.holdout_cap = max(1, self.capacity // 4)
        #: the model's AffineDequant (None = float-only storage)
        self.dequant = dequant
        self._lock = witness.lock("online.buffer")
        self._rng = np.random.default_rng(seed)
        self._rows: List[np.ndarray] = []
        self._labels: List[int] = []
        self._holdout_rows: List[np.ndarray] = []
        self._holdout_labels: List[int] = []
        #: labeled ADD batches ever offered (holdout routing)
        self._seen = 0
        #: rows ever offered to the TRAIN partition (the reservoir j)
        self._train_seen = 0
        #: labeled ADD batches accepted — the version the trainer logs
        #: per step so an offline replay reconstructs the exact buffer
        #: state each step sampled from
        self.version = 0
        #: quantization verdict: None until the first add decides,
        #: then True (uint8 storage) or False (float32)
        self._quantized: Optional[bool] = None

    # -- codec ---------------------------------------------------------

    def _encode(self, rows: np.ndarray) -> np.ndarray:
        """f32 rows -> storage dtype.  The first add pins the codec:
        uint8 iff the inverse affine round-trips these rows exactly
        (checked against the forward dequant, not a tolerance)."""
        if self._quantized is None:
            self._quantized = False
            if self.dequant is not None:
                q = self._inverse(rows)
                if q is not None:
                    self._quantized = True
                    return q
            return np.asarray(rows, np.float32)
        if self._quantized:
            q = self._inverse(rows)
            if q is not None:
                return q
            # a later request breaks the byte range: store the exact
            # f32 row; _decode handles mixed dtypes per row
            return np.asarray(rows, np.float32)
        return np.asarray(rows, np.float32)

    def _inverse(self, rows: np.ndarray) -> Optional[np.ndarray]:
        dq = self.dequant
        scale = np.where(dq.scale == 0.0, 1.0,
                         dq.scale).astype(np.float64)
        q = np.round((rows.astype(np.float64) - dq.bias) / scale)
        if q.min() < 0 or q.max() > 255:
            return None
        q8 = q.astype(np.uint8)
        if not np.array_equal(dq.apply_host(q8),
                              np.asarray(rows, np.float32)):
            return None
        return q8

    def _decode(self, row: np.ndarray) -> np.ndarray:
        if row.dtype == np.uint8:
            return self.dequant.apply_host(row)
        return row

    # -- intake --------------------------------------------------------

    def add(self, rows: np.ndarray, labels: np.ndarray) -> str:
        """One labeled tapped request: route to train (reservoir) or
        holdout (every Nth, FIFO).  Returns the slot ("train" /
        "holdout")."""
        rows = np.asarray(rows, np.float32)
        labels = np.asarray(labels, np.int32).reshape(-1)
        if len(labels) == 1 and len(rows) > 1:
            labels = np.repeat(labels, len(rows))
        if len(labels) != len(rows):
            raise ValueError(
                f"{len(rows)} rows with {len(labels)} labels")
        enc = self._encode(rows)
        with self._lock:
            self._seen += 1
            holdout = self.holdout_every > 0 and \
                self._seen % self.holdout_every == 0
            if holdout:
                for r, lb in zip(enc, labels):
                    if len(self._holdout_rows) >= self.holdout_cap:
                        self._holdout_rows.pop(0)
                        self._holdout_labels.pop(0)
                    self._holdout_rows.append(r)
                    self._holdout_labels.append(int(lb))
            else:
                for r, lb in zip(enc, labels):
                    self._train_seen += 1
                    if len(self._rows) < self.capacity:
                        self._rows.append(r)
                        self._labels.append(int(lb))
                    else:
                        # reservoir: row t survives with probability
                        # capacity/t, under the seeded stream
                        j = int(self._rng.integers(
                            0, self._train_seen))
                        if j < self.capacity:
                            self._rows[j] = r
                            self._labels[j] = int(lb)
                self.version += 1
        return "holdout" if holdout else "train"

    # -- views ---------------------------------------------------------

    @property
    def train_rows(self) -> int:
        with self._lock:
            return len(self._rows)

    @property
    def holdout_rows(self) -> int:
        with self._lock:
            return len(self._holdout_rows)

    @property
    def nbytes(self) -> int:
        """Host bytes the stored rows occupy — the residency charge."""
        with self._lock:
            return int(sum(r.nbytes for r in self._rows)
                       + sum(r.nbytes for r in self._holdout_rows))

    @property
    def quantized(self) -> bool:
        return bool(self._quantized)

    def sample(self, batch: int,
               rng: np.random.Generator) -> Tuple[np.ndarray,
                                                  np.ndarray]:
        """``batch`` decoded f32 training rows drawn with replacement
        under ``rng`` — the caller seeds it from (model seed, step),
        so a step is a pure function of (buffer state, step index)."""
        with self._lock:
            n = len(self._rows)
            if n == 0:
                raise ValueError("empty replay buffer")
            idx = rng.integers(0, n, size=batch)
            rows = [self._rows[i] for i in idx]
            labels = np.asarray([self._labels[i] for i in idx],
                                np.int32)
        x = np.stack([self._decode(r) for r in rows]).astype(
            np.float32)
        return x, labels

    def holdout(self, limit: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The decoded held-out slice (copy).  ``limit`` keeps only
        the NEWEST rows — the slicing happens BEFORE decode, so a
        bounded gate round never pays host decode for rows it will
        not score (the decode loop burns the GIL the serving threads
        share)."""
        with self._lock:
            rows = list(self._holdout_rows)
            labels = np.asarray(self._holdout_labels, np.int32)
        if limit is not None and len(rows) > limit:
            rows = rows[-limit:]
            labels = labels[-limit:]
        if not rows:
            return (np.zeros((0,), np.float32),
                    np.zeros((0,), np.int32))
        x = np.stack([self._decode(r) for r in rows]).astype(
            np.float32)
        return x, labels
