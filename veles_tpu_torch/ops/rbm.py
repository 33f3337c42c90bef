"""The RBM family: Binarization, the Bernoulli-Bernoulli RBM and its
CD-k trainer.

Counterpart of ``veles_tpu/ops/rbm.py``, on the port's forward-unit and
gradient-unit contract.  Every draw goes through ``prng.uniform``
(``prng.py``), in ``jax.random.bernoulli``'s formula ``u < p``:

- ``Binarization``: train mode ``u < x`` (Bernoulli of [0, 1] inputs,
  the layer's draw for this minibatch), eval mode ``x > 0.5``;
  ``GDBinarization`` passes the error straight through.
- ``RBM``: params ``weights`` (n_vis, n_hid), ``bias`` (n_hid,), the
  hidden bias, and ``vbias`` (n_vis,).  :meth:`RBM.hidden_of` is
  ``sigmoid(x W + b)``, :meth:`RBM.reconstruct` ``sigmoid(h W^T +
  vbias)``; the output is the mean-field reconstruction of the input,
  so ``EvaluatorMSE`` against the input reports the reconstruction
  error.  The residual is ``(x, h0, rng)``.
- ``GDRBM``: CD-k (``cd_k >= 1``).  It ignores ``err_output`` and
  returns ``err_input = zeros``.  The first hidden sample uses the
  layer's draw (Gibbs step 0), step ``t > 0`` the draw keyed by
  ``(layer, t)``, the counterpart of ``fold_in(rng, t)``; the last
  step's mean-field ``(v, p(h))`` is the negative phase.  Its grads are
  ``-(positive - negative) / n``, so the shared SGD ascends the CD
  objective.  As in the reference, the statistics average over the
  whole static minibatch, padded rows included.
"""

from __future__ import annotations

from typing import Any

import torch

from veles_tpu_torch import prng
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _bernoulli(rng, p: torch.Tensor, t: int = 0) -> torch.Tensor:
    return (prng.uniform(rng, p.shape, p.device, t) < p).to(p.dtype)


class Binarization(ForwardUnit):
    """output ~ Bernoulli(input) in training, input > 0.5 in eval.
    Input values must lie in [0, 1]."""

    stochastic = True

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def apply(self, params, x):
        return (x > 0.5).to(x.dtype)

    def apply_fwd(self, params, x, rng=None, train=True):
        if not train:
            return self.apply(params, x), None
        if rng is None:
            raise ValueError(f"{self.name}: training mode needs a "
                             f"generator")
        return _bernoulli(rng, x), None


class GDBinarization(GradientUnit):
    """Straight-through: the error passes unchanged."""

    def backward_from_saved(self, params, saved, err_output):
        return err_output, {}


class RBM(ForwardUnit):
    """Bernoulli-Bernoulli RBM; the output is the reconstruction."""

    stochastic = True

    def __init__(self, workflow=None, n_hidden: int = None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if not n_hidden:
            raise ValueError(f"{self.name}: n_hidden required")
        self.n_hidden = int(n_hidden)

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def param_shapes(self, input_shape):
        n_vis = 1
        for s in input_shape[1:]:
            n_vis *= int(s)
        return {"weights": (n_vis, self.n_hidden),
                "bias": (self.n_hidden,), "vbias": (n_vis,)}

    def hidden_of(self, params, x: torch.Tensor) -> torch.Tensor:
        """p(h | x): the representation a stacked layer consumes."""
        return torch.sigmoid(_flat(x) @ params["weights"] + params["bias"])

    def reconstruct(self, params, h: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(h @ params["weights"].t() + params["vbias"])

    def apply(self, params, x):
        return self.reconstruct(params, self.hidden_of(params, x)) \
            .reshape(x.shape)

    def apply_fwd(self, params, x, rng=None, train=True):
        h0 = self.hidden_of(params, x)
        y = self.reconstruct(params, h0).reshape(x.shape)
        return y, ((x, h0, rng) if train else None)


class GDRBM(GradientUnit):
    """CD-k trainer for :class:`RBM` (``"<-": {"cd_k": k}``)."""

    def __init__(self, workflow=None, forward=None, cd_k: int = 1,
                 **kwargs: Any) -> None:
        super().__init__(workflow, forward=forward, **kwargs)
        self.cd_k = int(cd_k)
        if self.cd_k < 1:
            raise ValueError(f"{self.name}: cd_k must be >= 1, got "
                             f"{self.cd_k}")

    def backward_from_saved(self, params, saved, err_output):
        x, h0_prob, rng = saved
        if rng is None:
            raise ValueError(f"{self.name}: CD-{self.cd_k} needs the "
                             f"forward's generator in the residual")
        v0 = _flat(x)
        n = v0.shape[0]
        f = self.forward
        h = _bernoulli(rng, h0_prob)
        v1 = h1 = None
        for t in range(self.cd_k):
            v1 = f.reconstruct(params, h)
            h1 = f.hidden_of(params, v1)
            if t + 1 < self.cd_k:
                h = _bernoulli(rng, h1, t + 1)
        grads = {"weights": -(v0.t() @ h0_prob - v1.t() @ h1) / n,
                 "bias": -(h0_prob - h1).sum(dim=0) / n,
                 "vbias": -(v0 - v1).sum(dim=0) / n}
        return torch.zeros_like(x), grads
