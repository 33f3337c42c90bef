"""The softmax cross-entropy evaluator.

Counterpart of ``veles_tpu/ops/evaluator.py:EvaluatorSoftmax.metrics_fn``:
from the net's f32 probabilities, int64 labels and the minibatch mask
(padded rows are 0) it returns the error seed of the backward pass,
``err_output = (probs - onehot) * mask / max(mask.sum(), 1)`` (d mean
CE / d logits, the softmax+CE fusion), and the minibatch's ``n_err``,
``loss_sum`` (eps 1e-12 under the log) and ``count`` as f32 device
scalars, which the fused step accumulates on the device.  The confusion
matrix and ``EvaluatorMSE`` are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


class EvaluatorSoftmax:
    def __init__(self, workflow: Any = None, name: str = "evaluator",
                 n_classes: Optional[int] = None) -> None:
        self.workflow = workflow
        self.name = name
        self.n_classes = n_classes

    def metrics_fn(self, output: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        eps = 1e-12
        n = mask.sum()
        onehot = F.one_hot(target, output.shape[-1]).to(output.dtype)
        err = (output - onehot) * mask[:, None] / torch.clamp(n, min=1.0)
        pred = output.argmax(-1)
        n_err = ((pred != target).to(mask.dtype) * mask).sum()
        p = output.gather(1, target[:, None])[:, 0]
        loss_sum = -(torch.log(torch.clamp(p, min=eps)) * mask).sum()
        return {"err_output": err, "n_err": n_err, "loss_sum": loss_sum,
                "count": n}
