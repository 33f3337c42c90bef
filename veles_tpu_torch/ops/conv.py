"""Convolution units (forward).

Counterpart of ``veles_tpu/ops/conv.py`` (``Conv``, ``ConvTanh``,
``ConvRELU``): a 2-D convolution with symmetric padding ``(py, px)``
and strides ``(sy, sx)``.  Activations stay NHWC at the unit's
boundary.  Inside, ``x.permute(0, 3, 1, 2)`` is an NCHW view of the
same memory (PyTorch's channels-last format), which
``torch.nn.functional.conv2d`` consumes and produces without a copy,
so the permute back is free too.  Weights are OIHW
``(n_kernels, C, ky, kx)`` in the port's params; ``convert.py`` maps
the reference's HWIO onto that once, at load.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops.nn_units import ForwardUnit


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

    def weight_fan_in(self, shape):
        return int(shape[1] * shape[2] * shape[3])

    def activation(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        v = F.conv2d(x.permute(0, 3, 1, 2), params["weights"],
                     params.get("bias"), stride=self.sliding,
                     padding=self.padding)
        return self.activation(v.permute(0, 2, 3, 1))


class ConvTanh(Conv):
    def activation(self, v):
        return torch.tanh(v)


class ConvRELU(Conv):
    def activation(self, v):
        return torch.relu(v)
