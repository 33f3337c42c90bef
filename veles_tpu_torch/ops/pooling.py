"""Pooling units: max and average over VALID windows with a floor-size
output, and their gradient units.

Counterpart of ``veles_tpu/ops/pooling.py`` (``MaxPooling``,
``AvgPooling``, ``GDMaxPooling``, ``GDAvgPooling``).  NHWC at the
boundary; the NCHW view inside is the same memory (see ``ops/conv.py``).
The backward is the backward of ``F.max_pool2d`` / ``F.avg_pool2d``
(``torch.autograd.grad`` over the saved input), as the reference takes
``jax.vjp`` of its ``reduce_window``.  Where a max window holds equal
values, torch and XLA may route the error to different ones; on a real
net those ties are the zeros a ReLU leaves, whose gradient the ReLU
kills anyway.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops.conv import _pair, conv_out_size
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class PoolingBase(ForwardUnit):

    def __init__(self, workflow=None, kx: int = 2, ky: int = 2,
                 sliding: Any = None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = kx, ky
        self.sliding = _pair(sliding) if sliding is not None else (ky, kx)

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        sy, sx = self.sliding
        return (b, conv_out_size(h, self.ky, 0, sy),
                conv_out_size(w, self.kx, 0, sx), c)

    def pool(self, x_nchw: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        return self.pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaxPooling(PoolingBase):
    def pool(self, x_nchw):
        return F.max_pool2d(x_nchw, (self.ky, self.kx), self.sliding)


class AvgPooling(PoolingBase):
    def pool(self, x_nchw):
        return F.avg_pool2d(x_nchw, (self.ky, self.kx), self.sliding)


class _GDPooling(GradientUnit):
    def backward_from_saved(self, params, saved, err_output):
        x, _ = saved
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            y = self.forward.apply({}, xx)
            (err_input,) = torch.autograd.grad(y, xx, err_output)
        return err_input, {}


GDMaxPooling = _GDPooling
GDAvgPooling = _GDPooling
