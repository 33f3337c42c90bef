"""Decision: end-of-class metrics and the end of training.

Counterpart of ``veles_tpu/ops/decision.py:DecisionGD``.  At each class
end it takes the class's ``[n_err, loss_sum, count]`` from the fused
runner (one host fetch), appends a ``history`` row, tracks the best
validation error (``improved``), and sets ``complete`` once
``max_epochs`` is reached or validation has not improved for
``fail_iterations`` epochs.  ``improved`` and ``complete`` are plain
booleans: the port has no ``mutable.Bool`` graph.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

from veles_tpu_torch.loader.base import CLASS_NAMES, TRAIN, VALID

log = logging.getLogger("veles.decision")


class DecisionGD:
    def __init__(self, workflow: Any = None, name: str = "decision",
                 max_epochs: Optional[int] = None,
                 fail_iterations: int = 100) -> None:
        self.workflow = workflow
        self.name = name
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.improved = False
        self.loader = None
        #: the fused runner: metrics accumulate on its device
        self.metrics_source = None
        self.epoch_n_err = [0.0, 0.0, 0.0]
        self.epoch_loss = [0.0, 0.0, 0.0]
        self.epoch_error_pct = [100.0, 100.0, 100.0]
        self.min_valid_error = float("inf")
        self.min_valid_epoch = -1
        self.min_train_error = float("inf")
        #: per-class-end rows: epoch, class, n_err, loss, error_pct, count
        self.history: List[dict] = []

    def run(self) -> None:
        self.improved = False
        ld = self.loader
        if not ld.class_ended:
            return
        klass = ld.minibatch_class
        n_err, loss, count = self.metrics_source.take_class_metrics()
        self.epoch_n_err[klass] = n_err
        self.epoch_loss[klass] = loss / max(count, 1.0)
        self.epoch_error_pct[klass] = 100.0 * n_err / max(count, 1.0)
        self.history.append({
            "epoch": ld.epoch_number, "class": CLASS_NAMES[klass],
            "n_err": n_err, "loss": self.epoch_loss[klass],
            "error_pct": self.epoch_error_pct[klass], "count": count})
        log.info("epoch %d %s: n_err=%g loss=%.6f error=%.2f%%",
                 ld.epoch_number, CLASS_NAMES[klass], n_err,
                 self.epoch_loss[klass], self.epoch_error_pct[klass])
        if klass == VALID:
            self.on_validation_ended()
        if klass == TRAIN:
            self.on_train_ended()

    def on_validation_ended(self) -> None:
        err = self.epoch_n_err[VALID]
        if err < self.min_valid_error:
            self.min_valid_error = err
            self.min_valid_epoch = self.loader.epoch_number
            self.improved = True

    def on_train_ended(self) -> None:
        # without a validation split, improvement is on train error
        if self.loader.class_lengths[VALID] == 0:
            err = self.epoch_n_err[TRAIN]
            if err < self.min_train_error:
                self.min_train_error = err
                self.improved = True
        epoch = self.loader.epoch_number  # already past the end
        if self.max_epochs is not None and epoch >= self.max_epochs:
            log.info("complete: reached max_epochs=%d", self.max_epochs)
            self.complete = True
        if (self.loader.class_lengths[VALID] > 0
                and self.min_valid_epoch >= 0
                and epoch - self.min_valid_epoch > self.fail_iterations):
            log.info("complete: no validation improvement in %d epochs",
                     self.fail_iterations)
            self.complete = True
