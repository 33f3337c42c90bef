"""Depooling: the decoder's inverse of pooling, and its gradient unit.

Counterpart of ``veles_tpu/ops/depooling.py`` (``Depooling``,
``GDDepooling``), used by MnistAE's decoder.  The forward repeats each
value of an NHWC input over its ``(ky, kx)`` window; the backward sums
the error over each window.  Only non-overlapping windows (``sliding
== (ky, kx)``) exist, as in the reference.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops.conv import _pair
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class Depooling(ForwardUnit):

    def __init__(self, workflow=None, kx: int = 2, ky: int = 2,
                 sliding: Any = None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = kx, ky
        self.sliding = _pair(sliding) if sliding is not None else (ky, kx)
        if tuple(self.sliding) != (self.ky, self.kx):
            raise ValueError("Depooling supports non-overlapping "
                             "windows only (sliding == kernel)")

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        return (b, h * self.ky, w * self.kx, c)

    def apply(self, params, x):
        b, h, w, c = x.shape
        return x[:, :, None, :, None, :].expand(
            b, h, self.ky, w, self.kx, c).reshape(
            b, h * self.ky, w * self.kx, c)


class GDDepooling(GradientUnit):
    def backward_from_saved(self, params, saved, err_output):
        f = self.forward
        x, _ = saved
        b, h, w, c = x.shape
        e = err_output.reshape(b, h, f.ky, w, f.kx, c)
        return e.sum(dim=(2, 4)), {}
