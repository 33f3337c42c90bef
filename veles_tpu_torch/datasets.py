"""The procedural classification data set (the port's own copy).

Counterpart of ``veles_tpu/datasets.py:_class_templates`` and
``synthetic_classification``, computed with the same numpy calls in the
same order, so the same arguments give bitwise the reference's arrays.
The reference's one-entry cache, the IDX/CIFAR readers and the ImageNet
preparation are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray]


def _class_templates(rng: np.random.Generator, n_classes: int,
                     shape: Tuple[int, ...]) -> np.ndarray:
    """Smooth per-class patterns: low-frequency random fields, upsampled
    bilinearly (rows first, then columns, float32 throughout)."""
    h, w = shape[0], shape[1]
    c = shape[2] if len(shape) > 2 else 1
    coarse = rng.standard_normal((n_classes, max(2, h // 4),
                                  max(2, w // 4), c)).astype(np.float32)
    ys = np.linspace(0, coarse.shape[1] - 1, h)
    xs = np.linspace(0, coarse.shape[2] - 1, w)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, coarse.shape[1] - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, coarse.shape[2] - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    rows = coarse[:, y0] * (1 - wy) + coarse[:, y1] * wy
    return rows[:, :, x0] * (1 - wx) + rows[:, :, x1] * wx


def synthetic_classification(
        n_train: int, n_valid: int, shape: Tuple[int, ...],
        n_classes: int = 10, noise: float = 0.4, max_shift: int = 2,
        seed: int = 20260729, n_test: int = 0,
) -> Tuple[Split, Split, Optional[Split]]:
    """Deterministic image-classification task.

    sample = circular-shifted class template + gaussian noise, values
    squashed to (0, 1).  Returns (train, valid, test-or-None).
    """
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, n_classes, shape)

    def make(n: int) -> Split:
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = templates[y]  # fancy indexing: a fresh array, safe in-place
        if max_shift > 0:
            sh, sw = (rng.integers(-max_shift, max_shift + 1, (2, n)))
            # per-sample circular shift, grouped by shift value (the
            # same values as a per-sample np.roll)
            for axis, shifts in ((1, sh), (2, sw)):
                for s in np.unique(shifts):
                    if s:
                        idx = np.nonzero(shifts == s)[0]
                        x[idx] = np.roll(x[idx], s, axis=axis)
        g = rng.standard_normal(x.shape, dtype=np.float32)
        np.multiply(g, np.float32(noise), out=g)
        x += g
        del g
        # squash into (0,1) like pixel data: sigmoid, in place
        np.negative(x, out=x)
        np.exp(x, out=x)
        x += 1.0
        np.reciprocal(x, out=x)
        if len(shape) == 2:
            x = x[..., 0] if x.shape[-1] == 1 else x
        return np.ascontiguousarray(x, np.float32), y

    train = make(n_train)
    valid = make(n_valid)
    test = make(n_test) if n_test else None
    return train, valid, test
