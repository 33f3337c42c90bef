"""The forward-unit and gradient-unit contracts.

Counterpart of ``veles_tpu/ops/nn_units.py`` (``ForwardUnit``,
``GradientUnit``).  A unit is a pure function of ``(params, x)`` plus
its static config; it holds no tensors of its own.  Params are a
``{pname: tensor}`` dict in the PORT's layout (``convert.py`` maps the
reference's layout onto it).  Activations are NHWC (or (B, N) after a
fully-connected layer) at every unit boundary, as in the reference.

- ``ForwardUnit.apply_fwd(params, x, rng, train)`` returns ``(output,
  residual)``: in training mode the residual is what the matching
  gradient unit needs, ``(input, output)`` by default; in eval mode it
  is None (nothing runs backward through an eval forward).
- ``ForwardUnit.fill_params`` draws the initial params from the
  ``"weights"`` stream in the REFERENCE's shapes and order (HWIO for a
  conv; weights, then bias), then converts them, so a seed gives
  bitwise the reference's initial weights.
- ``GradientUnit.backward_from_saved(params, saved, err_output)`` returns
  ``(err_input, grads)``; ``update_params`` is the reference's momentum
  SGD, ``g += wd*w; v = mu*v - lr*g; w += v`` (not ``torch.optim.SGD``,
  whose ``v = mu*v + g; w -= lr*v`` parts from it when the rate
  changes).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.convert import params_from_jax


class ForwardUnit:
    """Base forward unit: input -> output, optional weights/bias."""

    #: how a GradientUnit treats this unit's nonlinearity: "linear" |
    #: "tanh" | "relu" | "sigmoid" | "softmax" (softmax's derivative is
    #: folded into the evaluator's err_output)
    activation_mode = "linear"
    #: True when training-mode apply consumes randomness (dropout,
    #: binarization, stochastic pooling, the RBM's CD sampling)
    stochastic = False

    def __init__(self, workflow: Any = None, name: Optional[str] = None,
                 include_bias: bool = True,
                 weights_filling: str = "uniform",
                 weights_stddev: Optional[float] = None,
                 bias_filling: str = "constant",
                 bias_stddev: float = 0.0) -> None:
        self.workflow = workflow
        self.name = name or type(self).__name__
        self.include_bias = include_bias
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.bias_filling = bias_filling
        self.bias_stddev = bias_stddev
        #: set by :meth:`initialize` (batch axis included)
        self.input_shape: Optional[Tuple[int, ...]] = None
        self.output_shape: Optional[Tuple[int, ...]] = None

    # -- shapes & params ----------------------------------------------

    def output_shape_for(self, input_shape: Tuple[int, ...]) \
            -> Tuple[int, ...]:
        raise NotImplementedError

    def param_shapes(self, input_shape: Tuple[int, ...]) \
            -> Dict[str, Tuple[int, ...]]:
        """Port-layout parameter shapes; {} when the unit has none."""
        return {}

    def reference_param_shapes(self, input_shape: Tuple[int, ...]) \
            -> Dict[str, Tuple[int, ...]]:
        """The same params in the reference's layout and order (conv
        overrides: HWIO)."""
        return self.param_shapes(input_shape)

    def weight_fan_in(self, shape: Tuple[int, ...]) -> int:
        """Inputs that feed one output element, from a param's
        REFERENCE-layout shape: every axis but the last (Deconv
        overrides: its output-channel axis is not last)."""
        return int(np.prod(shape[:-1]))

    def initialize(self, input_shape: Tuple[int, ...]) -> None:
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(self.output_shape_for(self.input_shape))

    def fill_params(self, gen: Optional[np.random.Generator] = None) \
            -> Dict[str, np.ndarray]:
        """Port-layout f32 initial params, drawn from ``gen`` (default:
        the ``"weights"`` stream) by the unit's fillings (uniform /
        gaussian / constant) and stddevs (an unset one is
        1/sqrt(:meth:`weight_fan_in`))
        in the reference's shapes and order, then converted."""
        gen = gen if gen is not None else prng.get("weights").numpy
        out = {}
        for pname, shape in self.reference_param_shapes(
                self.input_shape).items():
            weights = pname == "weights"
            filling = self.weights_filling if weights \
                else self.bias_filling
            std = self.weights_stddev if weights else self.bias_stddev
            if std is None:
                std = 1.0 / np.sqrt(self.weight_fan_in(shape) or 1)
            if filling == "uniform":
                a = gen.uniform(-std * np.sqrt(3), std * np.sqrt(3), shape)
            elif filling == "gaussian":
                a = gen.normal(0.0, std, shape)
            elif filling == "constant":
                a = np.full(shape, std)
            else:
                raise ValueError(f"unknown filling {filling!r}")
            out[pname] = a.astype(np.float32)
        return params_from_jax({self.name: out})[self.name]

    # -- compute -------------------------------------------------------

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_fwd(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                  rng: Optional[torch.Generator] = None,
                  train: bool = True) -> Tuple[torch.Tensor, Any]:
        """(output, residual): ``(input, output)`` in training mode,
        None in eval mode."""
        y = self.apply(params, x)
        return y, ((x, y) if train else None)


class GradientUnit:
    """Backward + SGD update for one ForwardUnit (counterpart of
    ``veles_tpu/ops/nn_units.py:GradientUnit``)."""

    #: True when backward_from_saved accepts need_err_input=False and then
    #: skips the err_input computation: the fused step passes it for the
    #: first gradient unit of the chain, whose err_input nothing consumes
    can_skip_err_input = False

    def __init__(self, workflow: Any = None,
                 forward: Optional[ForwardUnit] = None,
                 name: Optional[str] = None, learning_rate: float = 0.01,
                 learning_rate_bias: Optional[float] = None,
                 weight_decay: float = 0.0, weight_decay_bias: float = 0.0,
                 gradient_moment: float = 0.0) -> None:
        self.workflow = workflow
        self.forward = forward
        self.name = name or type(self).__name__
        self.learning_rate = learning_rate
        self.learning_rate_bias = learning_rate \
            if learning_rate_bias is None else learning_rate_bias
        self.weight_decay = weight_decay
        self.weight_decay_bias = weight_decay_bias
        self.gradient_moment = gradient_moment

    def act_deriv(self, output: torch.Tensor,
                  err_output: torch.Tensor) -> torch.Tensor:
        """d loss / d pre-activation from d loss / d output, by the
        forward's activation_mode.  Softmax is the identity: the
        evaluator's err_output already IS d loss / d logits."""
        mode = self.forward.activation_mode
        if mode in ("linear", "softmax"):
            return err_output
        if mode == "tanh":
            return err_output * (1.0 - output * output)
        if mode == "relu":
            return err_output * (output > 0).to(output.dtype)
        if mode == "sigmoid":
            return err_output * output * (1.0 - output)
        raise ValueError(f"unknown activation_mode {mode!r}")

    def backward_from_saved(self, params: Dict[str, torch.Tensor],
                            saved: Any, err_output: torch.Tensor) \
            -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        """(err_input, param_grads) from the forward's residual."""
        raise NotImplementedError

    def update_params(self, params: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor],
                      velocities: Dict[str, torch.Tensor],
                      rates: Optional[Tuple[Any, Any]] = None,
                      decays: Optional[Tuple[Any, Any]] = None) \
            -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(new_params, new_velocities): ``g = g + wd*w; v = mu*v - lr*g;
        w = w + v`` (``w - lr*g`` without momentum).  ``rates=(lr, bias
        lr)`` overrides the unit's own rates: the fused step passes each
        minibatch's scheduled rates this way.  ``decays=(wd, bias wd)``
        overrides its weight decays the same way: the population engine
        passes each member's (0-dim tensors on the member axis).  Params
        and velocities are f32; a bf16 gradient is promoted by the first
        sum."""
        new_p, new_v = {}, {}
        lr_w, lr_b = rates if rates is not None else (
            self.learning_rate, self.learning_rate_bias)
        wd_w, wd_b = decays if decays is not None else (
            self.weight_decay, self.weight_decay_bias)
        for pname, w in params.items():
            weights = pname == "weights"
            lr = lr_w if weights else lr_b
            wd = wd_w if weights else wd_b
            g = grads[pname] + wd * w
            if self.gradient_moment:
                v = self.gradient_moment * velocities[pname] - lr * g
                new_v[pname] = v
                new_p[pname] = w + v
            else:
                new_p[pname] = w - lr * g
        return new_p, new_v
