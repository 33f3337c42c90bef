"""The evaluators: the softmax cross-entropy and the mean squared error.

Counterpart of ``veles_tpu/ops/evaluator.py`` (``EvaluatorSoftmax``,
``EvaluatorMSE``, their ``metrics_fn``).  From the net's f32 output, the
minibatch's target and its mask (padded rows are 0) each returns the
error seed of the backward pass (``err_output``) and the minibatch's
``n_err``, ``loss_sum`` and ``count`` as f32 device scalars, which the
fused step accumulates on the device.

- ``EvaluatorSoftmax``: int64 labels; ``err_output = (probs - onehot) *
  mask / max(mask.sum(), 1)`` (d mean CE / d logits, the softmax+CE
  fusion), ``loss_sum`` with eps 1e-12 under the log, and ``max_idx``,
  each row's predicted class.  With ``compute_confusion`` (the default,
  as in the reference) the fused step accumulates the (n, n) confusion
  matrix over ``(target, max_idx)`` on the device (``ops/fused.py``).
- ``EvaluatorMSE`` (``wants_targets``: the fused step hands it the f32
  regression targets in place of labels): normalized per ELEMENT, with
  D the features of a sample, ``err_output = (y - t) * mask /
  max(n * D, 1)``, ``loss_sum`` the sum over valid rows of ``0.5 *
  ||y - t||^2 / D``, and ``n_err`` 0.

On a data-parallel rank the fused step passes ``n_total``, the GLOBAL
minibatch's valid rows (every rank holds the whole mask on the host),
and it takes ``n``'s place in the error seed's denominator, so the
ranks' summed gradients are the global minibatch's; ``count`` stays the
rank's own.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


class EvaluatorSoftmax:
    #: the fused step gives this evaluator labels, not targets
    wants_targets = False

    def __init__(self, workflow: Any = None, name: str = "evaluator",
                 n_classes: Optional[int] = None,
                 compute_confusion: bool = True) -> None:
        self.workflow = workflow
        self.name = name
        self.n_classes = n_classes
        self.compute_confusion = compute_confusion

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("compute_confusion", True)

    def metrics_fn(self, output: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor, n_total: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        eps = 1e-12
        n = mask.sum()
        denom = n if n_total is None else n_total
        onehot = F.one_hot(target, output.shape[-1]).to(output.dtype)
        err = (output - onehot) * mask[:, None] / torch.clamp(denom, min=1.0)
        pred = output.argmax(-1)
        n_err = ((pred != target).to(mask.dtype) * mask).sum()
        p = output.gather(1, target[:, None])[:, 0]
        loss_sum = -(torch.log(torch.clamp(p, min=eps)) * mask).sum()
        return {"err_output": err, "n_err": n_err, "loss_sum": loss_sum,
                "count": n, "max_idx": pred}


class EvaluatorMSE:
    wants_targets = True

    def __init__(self, workflow: Any = None,
                 name: str = "evaluator") -> None:
        self.workflow = workflow
        self.name = name

    def metrics_fn(self, output: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor, n_total: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        diff = output - target
        m = mask.reshape((-1,) + (1,) * (diff.dim() - 1))
        n = mask.sum()
        denom = n if n_total is None else n_total
        d = float(math.prod(output.shape[1:]))
        err = diff * m / torch.clamp(denom * d, min=1.0)
        per_row = 0.5 * (diff * diff).reshape(len(diff), -1).sum(-1) / d
        loss_sum = (per_row * mask).sum()
        return {"err_output": err, "n_err": torch.zeros_like(n),
                "loss_sum": loss_sum, "count": n}
