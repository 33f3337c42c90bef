"""Local response normalization across channels, and its gradient unit.

Counterpart of ``veles_tpu/ops/lrn.py`` (``LRNormalizer``,
``GDLRNormalizer``):
``y_i = x_i / (k + alpha * sum_{j in window(i)} x_j^2) ^ beta`` with the
exactly-n-tap channel window of ``band_matrix``.  The reference takes
its XLA banded-matmul form by default and its Pallas kernels only when
asked; the port always takes ``lrn_cuda.lrn_fwd`` / ``lrn_bwd``, which
launch the Hopper kernels for CUDA tensors and compute the plain
PyTorch forms for CPU tensors.  As on the reference's Pallas path, the
forward keeps only x as its residual, ``(x, None)``, and the backward
recomputes den from it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from veles_tpu_torch.ops.lrn_cuda import check_config, lrn_bwd, lrn_fwd
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


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

    def apply_fwd(self, params, x, rng=None, train=True):
        y = self.apply(params, x)
        return y, ((x, None) if train else None)


class GDLRNormalizer(GradientUnit):
    def backward_from_saved(self, params, saved, err_output):
        f = self.forward
        x, _ = saved
        return lrn_bwd(x.contiguous(), err_output.contiguous(), f.n, f.k,
                       f.alpha, f.beta), {}


class LRNFunction(torch.autograd.Function):
    """LRN over the last axis as an autograd function: the forward is
    ``lrn_fwd``, the backward ``lrn_bwd`` (the kernels on the card, the
    plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, n: int, k: float, alpha: float, beta: float = 0.75):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.cfg = (n, k, alpha, beta)
        return lrn_fwd(x, n, k, alpha, beta)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return (lrn_bwd(x, grad.contiguous(), *ctx.cfg),
                None, None, None, None)
