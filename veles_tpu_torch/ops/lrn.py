"""Local response normalization across channels (forward).

Counterpart of ``veles_tpu/ops/lrn.py:LRNormalizer``:
``y_i = x_i / (k + alpha * sum_{j in window(i)} x_j^2) ^ beta`` with the
exactly-n-tap channel window of :func:`band_matrix`.  The reference
takes its XLA banded-matmul form by default and its Pallas kernel only
when asked; the port always takes ``lrn_cuda.lrn_fwd``, which launches
the Hopper kernel for a CUDA tensor and computes the plain PyTorch form
for a CPU tensor.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from veles_tpu_torch.ops.lrn_cuda import check_config, lrn_fwd
from veles_tpu_torch.ops.nn_units import ForwardUnit


class LRNormalizer(ForwardUnit):

    def __init__(self, workflow=None, alpha: float = 1e-4,
                 beta: float = 0.75, n: int = 5, k: float = 2.0,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.alpha, self.beta, self.n, self.k = alpha, beta, n, k

    def output_shape_for(self, input_shape):
        check_config(int(input_shape[-1]), self.n)
        return tuple(input_shape)

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        return lrn_fwd(x.contiguous(), self.n, self.k, self.alpha,
                       self.beta)
