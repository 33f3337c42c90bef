"""Input normalizers (the port's own copy).

Counterpart of ``veles_tpu/normalization.py``, the same classes computed
with the same numpy calls: ``none``, ``linear`` (range rescale),
``mean_disp`` (standardize), ``external_mean`` (subtract a given mean
image) and ``pointwise`` (per-feature linear).  A loader fits its
normalizer once on the host, on the TRAIN split only, and applies it to
every split; the fitted state rides the loader's snapshot, so a resumed
run does not refit.  ``affine_params`` is what the uint8 ingest codec
folds into the dequantization on the device (``loader/quantize.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

_registry: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _registry[name] = cls
        cls.kind = name
        return cls
    return deco


def make_normalizer(kind: str, **kwargs: Any) -> "NormalizerBase":
    if kind not in _registry:
        raise ValueError(f"unknown normalizer {kind!r}; "
                         f"have {sorted(_registry)}")
    return _registry[kind](**kwargs)


class NormalizerBase:
    kind = "base"

    def fit(self, data: np.ndarray) -> "NormalizerBase":
        return self

    def apply(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def affine_params(self):
        """``(scale, bias)`` such that ``apply(x) == x * scale + bias``
        elementwise (scalars or arrays broadcasting over the sample
        shape), or ``None`` when the map is not affine or not fitted
        yet.  This is what the quantized-ingest path folds into the
        on-device dequantization (loader/quantize.py): a byte-ranged
        data set ships as uint8 and the fused step applies ``u8 *
        scale + bias`` instead of the host pre-normalizing to
        float32.  Computed in float64 so the composed affine stays
        within one f32 ulp of the two-op host ``apply``."""
        return None

    def state(self) -> dict:
        return {}


@register("none")
class NoneNormalizer(NormalizerBase):
    def apply(self, data):
        return np.asarray(data, np.float32)

    def affine_params(self):
        return 1.0, 0.0


@register("linear")
class LinearNormalizer(NormalizerBase):
    """Rescale the observed [min, max] to [lo, hi] (default [-1, 1])."""

    def __init__(self, lo: float = -1.0, hi: float = 1.0) -> None:
        self.lo, self.hi = lo, hi
        self.dmin: Optional[float] = None
        self.dmax: Optional[float] = None

    def fit(self, data):
        self.dmin = float(np.min(data))
        self.dmax = float(np.max(data))
        return self

    def apply(self, data):
        if self.dmin is None:
            self.fit(data)
        span = (self.dmax - self.dmin) or 1.0
        x = (np.asarray(data, np.float32) - self.dmin) / span
        return x * (self.hi - self.lo) + self.lo

    def affine_params(self):
        if self.dmin is None:
            return None
        span = (np.float64(self.dmax) - np.float64(self.dmin)) or 1.0
        scale = (np.float64(self.hi) - np.float64(self.lo)) / span
        return float(scale), float(self.lo - self.dmin * scale)

    def state(self):
        return {"dmin": self.dmin, "dmax": self.dmax}


@register("mean_disp")
class MeanDispNormalizer(NormalizerBase):
    """Per-feature standardization: (x - mean) / std."""

    def __init__(self) -> None:
        self.mean = None
        self.std = None

    def fit(self, data):
        self.mean = np.mean(data, axis=0, dtype=np.float64).astype(np.float32)
        self.std = np.std(data, axis=0, dtype=np.float64).astype(np.float32)
        self.std[self.std == 0] = 1.0
        return self

    def apply(self, data):
        if self.mean is None:
            self.fit(data)
        return (np.asarray(data, np.float32) - self.mean) / self.std

    def affine_params(self):
        if self.mean is None:
            return None
        scale = 1.0 / np.asarray(self.std, np.float64)
        return (scale.astype(np.float32),
                (-np.asarray(self.mean, np.float64) * scale)
                .astype(np.float32))

    def state(self):
        return {"mean": self.mean, "std": self.std}


@register("external_mean")
class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a provided mean image (AlexNet-style), optional scale."""

    def __init__(self, mean: Optional[np.ndarray] = None,
                 scale: float = 1.0) -> None:
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.scale = scale

    def fit(self, data):
        if self.mean is None:
            self.mean = np.mean(data, axis=0, dtype=np.float64) \
                .astype(np.float32)
        return self

    def apply(self, data):
        if self.mean is None:
            self.fit(data)
        return (np.asarray(data, np.float32) - self.mean) * self.scale

    def affine_params(self):
        if self.mean is None:
            return None
        return (float(self.scale),
                (-np.asarray(self.mean, np.float64) * self.scale)
                .astype(np.float32))

    def state(self):
        return {"mean": self.mean, "scale": self.scale}


@register("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map of observed [min,max] to [-1,1]."""

    def __init__(self) -> None:
        self.dmin = None
        self.dmax = None

    def fit(self, data):
        self.dmin = np.min(data, axis=0).astype(np.float32)
        self.dmax = np.max(data, axis=0).astype(np.float32)
        return self

    def apply(self, data):
        if self.dmin is None:
            self.fit(data)
        span = self.dmax - self.dmin
        span = np.where(span == 0, 1.0, span)
        return 2.0 * (np.asarray(data, np.float32) - self.dmin) / span - 1.0

    def affine_params(self):
        if self.dmin is None:
            return None
        span = (np.asarray(self.dmax, np.float64)
                - np.asarray(self.dmin, np.float64))
        span = np.where(span == 0, 1.0, span)
        scale = 2.0 / span
        return (scale.astype(np.float32),
                (-np.asarray(self.dmin, np.float64) * scale - 1.0)
                .astype(np.float32))

    def state(self):
        return {"dmin": self.dmin, "dmax": self.dmax}
