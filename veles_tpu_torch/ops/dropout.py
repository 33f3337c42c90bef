"""Dropout (forward, eval mode).

Counterpart of ``veles_tpu/ops/dropout.py``: inverted scaling, so eval
mode is the identity.  Training mode, with its mask from a
``torch.Generator``, belongs to the training slice and raises here.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops.nn_units import ForwardUnit


class Dropout(ForwardUnit):
    stochastic = True

    def __init__(self, workflow=None, dropout_ratio: float = 0.5,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.dropout_ratio = dropout_ratio

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def apply(self, params, x):
        return x
