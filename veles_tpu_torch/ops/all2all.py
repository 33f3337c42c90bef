"""Fully-connected (All2All) units and their gradient unit.

Counterpart of ``veles_tpu/ops/all2all.py``: ``y = x @ W + b`` with W
of shape (n_in, n_out), the relu / tanh / sigmoid / softmax heads, and
``GradientDescent`` with its per-activation aliases, written as the
reference's explicit matmuls.  The
input is flattened in NHWC order, as the reference's ``_flat`` does:
the port's activations are NHWC at every unit boundary, so the
reference's fc weights apply row for row.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class All2All(ForwardUnit):
    """y = x @ W + b (linear)."""

    def __init__(self, workflow=None, output_sample_shape=None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if output_sample_shape is None:
            raise ValueError(f"{self.name}: output_sample_shape required")
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(output_sample_shape)

    @property
    def neurons_number(self) -> int:
        return int(np.prod(self.output_sample_shape))

    def output_shape_for(self, input_shape):
        return (input_shape[0],) + self.output_sample_shape

    def param_shapes(self, input_shape):
        shapes = {"weights": (int(np.prod(input_shape[1:])),
                              self.neurons_number)}
        if self.include_bias:
            shapes["bias"] = (self.neurons_number,)
        return shapes

    def activation(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        if "bias" in params:
            v = torch.addmm(params["bias"], flat, params["weights"])
        else:
            v = flat @ params["weights"]
        return self.activation(
            v.reshape((x.shape[0],) + self.output_sample_shape))


class All2AllTanh(All2All):
    activation_mode = "tanh"

    def activation(self, v):
        return torch.tanh(v)


class All2AllRELU(All2All):
    activation_mode = "relu"

    def activation(self, v):
        return torch.relu(v)


class All2AllSigmoid(All2All):
    """Sigmoid dense layer: ``sigmoid(x W + b)`` is the RBM's
    ``hidden_of``, so a pretrained RBM's (weights, bias) drop into one
    (``models/mnist_dbn.py``)."""
    activation_mode = "sigmoid"

    def activation(self, v):
        return torch.sigmoid(v)


class All2AllSoftmax(All2All):
    """Softmax output layer: its gradient unit takes the evaluator's
    err_output as d loss / d logits (the softmax+CE fusion), so nothing
    differentiates through the softmax a second time."""
    activation_mode = "softmax"

    def activation(self, v):
        return torch.softmax(v, dim=-1)


class GradientDescent(GradientUnit):
    """Backward for any All2All variant."""

    can_skip_err_input = True

    def backward_from_saved(self, params, saved, err_output,
                            need_err_input=True):
        x, out = saved
        err_pre = self.act_deriv(out, err_output)
        err_flat = err_pre.reshape(err_pre.shape[0], -1)
        xf = x.reshape(x.shape[0], -1)
        grads = {"weights": xf.t() @ err_flat}
        if "bias" in params:
            grads["bias"] = err_flat.sum(dim=0)
        if not need_err_input:
            return None, grads
        return (err_flat @ params["weights"].t()).reshape(x.shape), grads


GDTanh = GradientDescent
GDRELU = GradientDescent
GDSoftmax = GradientDescent
GDSigmoid = GradientDescent
