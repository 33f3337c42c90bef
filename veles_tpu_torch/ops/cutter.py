"""Cutter: a fixed spatial window cut out of NHWC input.

Counterpart of ``veles_tpu/ops/cutter.py``.  ``padding=(left, top,
right, bottom)`` are the amounts cut off each edge; the forward is a
static slice and the backward zero-pads the error back onto the input's
canvas.  A padding that consumes the whole input raises, with the
reference's message.
"""

from __future__ import annotations

from typing import Any

import torch.nn.functional as F

from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class Cutter(ForwardUnit):
    """output = input[:, top:H - bottom, left:W - right, :]."""

    def __init__(self, workflow=None, padding=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if padding is None or len(padding) != 4:
            raise ValueError(f"{self.name}: padding=(left, top, right, "
                             f"bottom) required")
        self.padding = tuple(int(p) for p in padding)

    def output_shape_for(self, input_shape):
        n, h, w = input_shape[0], input_shape[1], input_shape[2]
        left, top, right, bottom = self.padding
        oh, ow = h - top - bottom, w - left - right
        if oh <= 0 or ow <= 0:
            raise ValueError(f"{self.name}: padding {self.padding} "
                             f"consumes the whole {h}x{w} input")
        return (n, oh, ow) + tuple(input_shape[3:])

    def apply(self, params, x):
        left, top, right, bottom = self.padding
        return x[:, top:x.shape[1] - bottom, left:x.shape[2] - right]


class GDCutter(GradientUnit):
    """err_input = err_output zero-padded back to the input canvas."""

    def backward_from_saved(self, params, saved, err_output):
        left, top, right, bottom = self.forward.padding
        # F.pad lists (before, after) pairs from the LAST axis backwards
        pad = [0, 0] * (err_output.dim() - 3) + [left, right, top, bottom]
        return F.pad(err_output, pad), {}
