"""Dropout and its gradient unit.

Counterpart of ``veles_tpu/ops/dropout.py``: inverted scaling (kept
units scaled by 1/(1-p)), so eval mode is the identity.  In training
mode the mask is drawn from the ``torch.Generator`` the fused step hands
each stochastic layer (``prng.torch_generator``) through
``prng.uniform``: deterministic within the port, not the reference's
threefry bits; a data-parallel rank draws the global minibatch's mask
and keeps its own rows (``prng.RowSlice``).  The residual is
``(x, mask)`` and ``GDDropout`` applies the mask to the error.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch import prng
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


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

    def apply_fwd(self, params, x, rng=None, train=True):
        if not train:
            return x, None
        if rng is None:
            raise ValueError(f"{self.name}: training mode needs a "
                             f"torch.Generator")
        keep = 1.0 - self.dropout_ratio
        draw = prng.uniform(rng, x.shape, x.device)
        mask = (draw < keep).to(x.dtype) / keep
        return x * mask, (x, mask)


class GDDropout(GradientUnit):
    def backward_from_saved(self, params, saved, err_output):
        _x, mask = saved
        return err_output * mask, {}
