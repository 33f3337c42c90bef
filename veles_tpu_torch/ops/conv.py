"""Convolution units and their gradient unit.

Counterpart of ``veles_tpu/ops/conv.py`` (``Conv``, ``ConvTanh``,
``ConvRELU``, ``GradientDescentConv``): a 2-D convolution with
symmetric padding ``(py, px)`` and strides ``(sy, sx)``.  Activations
stay NHWC at the unit's boundary.  Inside, ``x.permute(0, 3, 1, 2)`` is
an NCHW view of the same memory (PyTorch's channels-last format), which
``torch.nn.functional.conv2d`` consumes and produces without a copy,
so the permute back is free too.  Weights are OIHW
``(n_kernels, C, ky, kx)`` in the port's params; ``convert.py`` maps
the reference's HWIO onto that once, at load.

The backward takes the weight and input gradients from
``torch.nn.grad.conv2d_weight`` / ``conv2d_input`` (cuDNN on the card),
as the reference left them to XLA (``jax.vjp``); the weight gradient
stays OIHW, like the params and the momentum buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_out_size(n: int, k: int, pad: int, stride: int) -> int:
    return (n + 2 * pad - k) // stride + 1


class Conv(ForwardUnit):
    """2-D convolution, NHWC x OIHW -> NHWC."""

    def __init__(self, workflow=None, n_kernels: int = None,  # type: ignore
                 kx: int = 3, ky: int = 3, padding: Any = 0,
                 sliding: Any = 1, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if n_kernels is None:
            raise ValueError(f"{self.name}: n_kernels required")
        self.n_kernels = n_kernels
        self.kx, self.ky = kx, ky
        self.padding = _pair(padding)   # (pad_y, pad_x)
        self.sliding = _pair(sliding)   # (stride_y, stride_x)

    def output_shape_for(self, input_shape):
        b, h, w, _ = input_shape
        py, px = self.padding
        sy, sx = self.sliding
        return (b, conv_out_size(h, self.ky, py, sy),
                conv_out_size(w, self.kx, px, sx), self.n_kernels)

    def param_shapes(self, input_shape):
        shapes = {"weights": (self.n_kernels, input_shape[-1],
                              self.ky, self.kx)}
        if self.include_bias:
            shapes["bias"] = (self.n_kernels,)
        return shapes

    def reference_param_shapes(self, input_shape):
        shapes = {"weights": (self.ky, self.kx, input_shape[-1],
                              self.n_kernels)}
        if self.include_bias:
            shapes["bias"] = (self.n_kernels,)
        return shapes

    def activation(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        v = F.conv2d(x.permute(0, 3, 1, 2), params["weights"],
                     params.get("bias"), stride=self.sliding,
                     padding=self.padding)
        return self.activation(v.permute(0, 2, 3, 1))


class ConvTanh(Conv):
    activation_mode = "tanh"

    def activation(self, v):
        return torch.tanh(v)


class ConvRELU(Conv):
    activation_mode = "relu"

    def activation(self, v):
        return torch.relu(v)


class GradientDescentConv(GradientUnit):
    """Backward for Conv*: weight, bias and (unless skipped) input
    gradients of the pre-activation, on the channels-last NCHW views."""

    can_skip_err_input = True

    def backward_from_saved(self, params, saved, err_output,
                            need_err_input=True):
        x, out = saved
        f = self.forward
        err_pre = self.act_deriv(out, err_output).permute(0, 3, 1, 2)
        x_nchw = x.permute(0, 3, 1, 2)
        w = params["weights"]
        grads = {"weights": torch.nn.grad.conv2d_weight(
            x_nchw, w.shape, err_pre, stride=f.sliding, padding=f.padding)}
        if "bias" in params:
            grads["bias"] = err_pre.sum(dim=(0, 2, 3))
        if not need_err_input:
            return None, grads
        err_input = torch.nn.grad.conv2d_input(
            x_nchw.shape, w, err_pre, stride=f.sliding, padding=f.padding)
        return err_input.permute(0, 2, 3, 1), grads


GDConvTanh = GradientDescentConv
GDConvRELU = GradientDescentConv
