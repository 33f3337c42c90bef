"""Standalone activation units and their gradient unit.

Counterpart of ``veles_tpu/ops/activation.py``: param-less units that
sit between any two layers, each a forward ``fwd(x)`` and a backward
``bwd(x, y, err)`` (d loss / d x from the residual ``(x, y)`` and d loss
/ d y), in the reference's formulas:

- ``ActivationTanh``: ``tanh(x)``, backward ``err * (1 - y^2)``;
- ``ActivationSigmoid``: ``1 / (1 + exp(-x))``, backward ``err * y *
  (1 - y)``;
- ``ActivationStrictRELU``: ``max(x, 0)``, backward ``err * (y > 0)``;
- ``ActivationRELU``: softplus, the reference's historic "RELU",
  ``log1p(exp(-|x|)) + max(x, 0)``, backward ``err / (1 + exp(-x))``;
- ``ActivationLog``: ``asinh(x)``, backward ``err / sqrt(x^2 + 1)``.
"""

from __future__ import annotations

import torch

from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class ActivationBase(ForwardUnit):

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def bwd(self, x: torch.Tensor, y: torch.Tensor,
            err_output: torch.Tensor) -> torch.Tensor:
        """d loss / d x from ``(x, y, d loss / d y)``."""
        raise NotImplementedError

    def apply(self, params, x):
        return self.fwd(x)


class ActivationTanh(ActivationBase):
    def fwd(self, x):
        return torch.tanh(x)

    def bwd(self, x, y, err_output):
        return err_output * (1.0 - y * y)


class ActivationSigmoid(ActivationBase):
    def fwd(self, x):
        return 1.0 / (1.0 + torch.exp(-x))

    def bwd(self, x, y, err_output):
        return err_output * y * (1.0 - y)


class ActivationStrictRELU(ActivationBase):
    """max(0, x) (the reference's StrictRELU)."""

    def fwd(self, x):
        return torch.clamp(x, min=0)

    def bwd(self, x, y, err_output):
        return err_output * (y > 0).to(err_output.dtype)


class ActivationRELU(ActivationBase):
    """ln(1 + e^x), softplus: the reference's historic 'RELU'."""

    def fwd(self, x):
        return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)

    def bwd(self, x, y, err_output):
        return err_output / (1.0 + torch.exp(-x))


class ActivationLog(ActivationBase):
    """ln(x + sqrt(x^2 + 1)) = asinh(x)."""

    def fwd(self, x):
        return torch.asinh(x)

    def bwd(self, x, y, err_output):
        return err_output / torch.sqrt(x * x + 1.0)


class GDActivation(GradientUnit):
    def backward_from_saved(self, params, saved, err_output):
        x, y = saved
        return self.forward.bwd(x, y, err_output), {}
