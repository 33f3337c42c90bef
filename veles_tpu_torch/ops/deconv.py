"""Deconvolution (the transposed convolution) and its gradient unit.

Counterpart of ``veles_tpu/ops/deconv.py`` (``Deconv``,
``GradientDescentDeconv``), MnistAE's decoder.  A Deconv with kernel,
stride and padding S inverts the geometry of a Conv with the same S:
the output height is ``(H - 1) * sy + ky - 2 * py``.  The reference
keeps its weights ``(ky, kx, n_kernels, C_in)`` and draws their init at
the fan-in ``ky * kx * C_in``; the port keeps them ``(C_in, n_kernels,
ky, kx)``, the layout ``torch.nn.functional.conv_transpose2d`` takes
(``convert.py`` maps one onto the other).  ``conv_transpose2d`` with
``padding=pad`` is the reference's input-dilated conv with the flipped,
io-transposed kernel, shape for shape, so no ``output_padding``.

The backward of a transposed conv is a plain conv: the input gradient
is ``conv2d(err, w)`` and the weight gradient
``torch.nn.grad.conv2d_weight(err, w.shape, x)`` at the same stride and
padding (cuDNN on the card), as the reference takes ``jax.vjp``.
Activations stay NHWC at the boundary (``ops/conv.py``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops.conv import _pair
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class Deconv(ForwardUnit):
    """Transposed 2-D convolution, NHWC x (C_in, n_kernels, ky, kx) ->
    NHWC with ``n_kernels`` output channels."""

    def __init__(self, workflow=None, n_kernels: int = None,  # type: ignore
                 kx: int = 3, ky: int = 3, padding: Any = 0,
                 sliding: Any = 1, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if n_kernels is None:
            raise ValueError(f"{self.name}: n_kernels required "
                             "(number of OUTPUT channels)")
        self.n_kernels = n_kernels
        self.kx, self.ky = kx, ky
        self.padding = _pair(padding)
        self.sliding = _pair(sliding)

    def output_shape_for(self, input_shape):
        b, h, w, _ = input_shape
        py, px = self.padding
        sy, sx = self.sliding
        return (b, (h - 1) * sy + self.ky - 2 * py,
                (w - 1) * sx + self.kx - 2 * px, self.n_kernels)

    def param_shapes(self, input_shape):
        shapes = {"weights": (input_shape[-1], self.n_kernels,
                              self.ky, self.kx)}
        if self.include_bias:
            shapes["bias"] = (self.n_kernels,)
        return shapes

    def reference_param_shapes(self, input_shape):
        shapes = {"weights": (self.ky, self.kx, self.n_kernels,
                              input_shape[-1])}
        if self.include_bias:
            shapes["bias"] = (self.n_kernels,)
        return shapes

    def weight_fan_in(self, shape):
        ky, kx, _, c_in = shape
        return ky * kx * c_in

    def apply(self, params, x):
        v = F.conv_transpose2d(x.permute(0, 3, 1, 2), params["weights"],
                               params.get("bias"), stride=self.sliding,
                               padding=self.padding)
        return v.permute(0, 2, 3, 1)


class GradientDescentDeconv(GradientUnit):

    can_skip_err_input = True

    def backward_from_saved(self, params, saved, err_output,
                            need_err_input=True):
        x, out = saved
        f = self.forward
        err_pre = self.act_deriv(out, err_output).permute(0, 3, 1, 2)
        w = params["weights"]
        grads = {"weights": torch.nn.grad.conv2d_weight(
            err_pre, w.shape, x.permute(0, 3, 1, 2), stride=f.sliding,
            padding=f.padding)}
        if "bias" in params:
            grads["bias"] = err_pre.sum(dim=(0, 2, 3))
        if not need_err_input:
            return None, grads
        err_input = F.conv2d(err_pre, w, stride=f.sliding,
                             padding=f.padding)
        return err_input.permute(0, 2, 3, 1), grads
