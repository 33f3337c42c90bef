"""The forward-unit contract of the serving chain.

Counterpart of ``veles_tpu/ops/nn_units.py:ForwardUnit`` (the part the
serving engine reads).  A unit is a pure function of ``(params, x)``
plus its static config; it holds no tensors of its own.  Params are a
``{pname: tensor}`` dict in the PORT's layout (``convert.py`` maps the
reference's layout onto it).  Activations are NHWC (or (B, N) after a
fully-connected layer) at every unit boundary, as in the reference.

Training (``train=True``, the backward and the update) belongs to the
next slice of the port and raises here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


class ForwardUnit:
    """Base forward unit: input -> output, optional weights/bias."""

    #: True when training-mode apply consumes randomness (dropout)
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

    def weight_fan_in(self, shape: Tuple[int, ...]) -> int:
        """Inputs feeding one output element (all axes but the last;
        conv overrides for its OIHW layout)."""
        return int(np.prod(shape[:-1]))

    def initialize(self, input_shape: Tuple[int, ...]) -> None:
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(self.output_shape_for(self.input_shape))

    def init_params(self, gen: np.random.Generator) \
            -> Dict[str, np.ndarray]:
        """Port-layout f32 params drawn from ``gen`` by the unit's
        declared fillings (uniform / gaussian / constant) and stddevs;
        an unset stddev is 1/sqrt(fan-in)."""
        out = {}
        for pname, shape in self.param_shapes(self.input_shape).items():
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
        return out

    # -- compute -------------------------------------------------------

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_fwd(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                  rng: Any = None, train: bool = False) \
            -> Tuple[torch.Tensor, Any]:
        """(output, residual).  Serving only: the residual is None, and
        ``train=True`` raises until the training slice lands."""
        if train:
            raise NotImplementedError(
                f"{self.name}: training mode belongs to the training "
                f"slice of the port (ROADMAP.md Queue 1)")
        return self.apply(params, x), None
