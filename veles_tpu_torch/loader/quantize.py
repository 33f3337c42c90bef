"""The uint8 ingest codec (the port's own copy).

Counterpart of ``veles_tpu/loader/quantize.py``.  A data set born as
bytes (IDX, CIFAR records, rounded pixels) can stay uint8 on the host,
on the streaming wire (1 byte a pixel instead of bf16's 2) and on the
device when resident (a quarter of f32's bytes against the residency
budget), because every normalizer is an affine map: the fused step
dequantizes on the device,

    x = q.float() * scale + bias        (f32, before the compute cast)

with ``(scale, bias)`` the fitted normalizer's ``affine_params()``
composed with the loader's byte-to-float convention (``pre_scale``).
The composed affine is accumulated in float64 and applied in f32, so it
lands within one f32 ulp of the host's two-op ``Normalizer.apply``.

Under data parallelism the bytes keep their width on every rank: a
row-sharded rank holds its 1/N of the rows as uint8, a streamed rank
receives its slice of each superstep as uint8, and the sharded gather
sums the bytes over the ranks as int32 and casts them back
(``loader/fullbatch.py``, ``ops/batching.py``); each rank dequantizes
its own rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class AffineDequant:
    """The on-device dequantization spec: ``x = q * scale + bias``.

    ``scale``/``bias`` are float32 scalars or arrays broadcasting over
    the sample shape (per-feature normalizers like mean_disp produce
    arrays).  Plain picklable state — it rides loader snapshots."""

    def __init__(self, scale, bias) -> None:
        self.scale = np.asarray(scale, np.float32)
        self.bias = np.asarray(bias, np.float32)

    def apply_host(self, q: np.ndarray) -> np.ndarray:
        """Host-side dequantize, the same arithmetic the fused step's
        prologue runs on the device (``engine/core.py``)."""
        return q.astype(np.float32) * self.scale + self.bias

    @property
    def nbytes(self) -> int:
        return int(self.scale.nbytes + self.bias.nbytes)

    def __repr__(self) -> str:
        return (f"AffineDequant(scale~{self.scale.shape}, "
                f"bias~{self.bias.shape})")


def derive_dequant(normalizer,
                   pre_scale: float = 1.0) -> Optional[AffineDequant]:
    """Compose a fitted normalizer's affine with the loader's
    byte->float convention: the float path computes
    ``apply(q * pre_scale)``; the quantized path must therefore
    dequantize with ``scale = s * pre_scale, bias = t`` where
    ``(s, t) = affine_params()``.  ``normalizer=None`` is the identity
    float view (``pre_scale`` alone).  Returns None when the
    normalizer is not affine (or not fitted) — the caller then keeps
    the float ingest path."""
    if normalizer is None:
        return AffineDequant(pre_scale, 0.0)
    params = normalizer.affine_params()
    if params is None:
        return None
    s, t = params
    scale = np.asarray(s, np.float64) * np.float64(pre_scale)
    return AffineDequant(scale.astype(np.float32), t)


def quantizable_source(data: np.ndarray, strict: bool = True) -> bool:
    """Is ``data`` byte-ranged, i.e. losslessly representable as uint8?

    ``strict=True`` (the loaders' ``quantized_ingest="auto"`` rule)
    accepts only dtype uint8 — activating on anything else would make
    the default silently re-encode user floats.  ``strict=False``
    (explicit ``quantized_ingest=True``) additionally accepts any
    integer dtype whose values fit [0, 255] and float arrays that are
    integral within [0, 255] (a full-array scan — one-time at load)."""
    if data.dtype == np.uint8:
        return True
    if strict:
        return False
    if np.issubdtype(data.dtype, np.integer):
        return bool(data.size == 0 or
                    (data.min() >= 0 and data.max() <= 255))
    if np.issubdtype(data.dtype, np.floating):
        if data.size == 0:
            return True
        lo, hi = float(data.min()), float(data.max())
        return (lo >= 0.0 and hi <= 255.0
                and bool(np.array_equal(data, np.round(data))))
    return False


def to_uint8(data: np.ndarray) -> np.ndarray:
    """Byte-ranged array -> uint8, validating the cast is lossless."""
    if data.dtype == np.uint8:
        return data
    q = data.astype(np.uint8)
    if not np.array_equal(q, data):
        raise ValueError(
            f"quantized_ingest=True but the dataset is not "
            f"byte-ranged (dtype {data.dtype}, values outside integer "
            f"[0, 255])")
    return q
