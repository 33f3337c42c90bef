"""Decision: end-of-class metrics and the end of training.

Counterpart of ``veles_tpu/ops/decision.py:DecisionGD``.  At each class
end it takes the class's ``[n_err, loss_sum, count]`` from the fused
runner (one host fetch), appends a ``history`` row, tracks the best
validation error (``improved``), and sets ``complete`` once
``max_epochs`` is reached or validation has not improved for
``fail_iterations`` epochs.  With an evaluator's confusion matrix, the
class's matrix is kept in ``confusion_per_class[klass]`` (a host int32
array, replaced at every end of that class).  ``epoch_ended_flag`` is
set by the firing that ended a train class (the plotters' gate).
``improved``, ``complete`` and ``epoch_ended_flag`` are plain booleans
the workflow's loop reads.  All of it is plain state that rides in a
snapshot as it is.

The master of the master--slave mode (``server.py``) computes nothing:
it sets ``metrics_source`` to None and hands each applied job's
``[n_err, loss_sum, count]`` to :meth:`DecisionGD.apply_data_from_slave`
(the reference's format, a list a metric), and a class end then sums
what the jobs gave in f32, in the order they were applied, as the
fused runner's device accumulator does.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import numpy as np

from veles_tpu_torch.distributable import Distributable
from veles_tpu_torch.loader.base import CLASS_NAMES, TRAIN, VALID

log = logging.getLogger("veles.decision")


class DecisionGD(Distributable):
    def __init__(self, workflow: Any = None, name: str = "decision",
                 max_epochs: Optional[int] = None,
                 fail_iterations: int = 100) -> None:
        self.workflow = workflow
        self.name = name
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.improved = False
        self.epoch_ended_flag = False
        self.loader = None
        #: the fused runner: metrics accumulate on its device; None:
        #: the jobs' metrics a master applied (``apply_data_from_slave``)
        self.metrics_source = None
        self._acc_n_err: List[float] = []
        self._acc_loss: List[float] = []
        self._acc_count: List[float] = []
        self.epoch_n_err = [0.0, 0.0, 0.0]
        self.epoch_loss = [0.0, 0.0, 0.0]
        self.epoch_error_pct = [100.0, 100.0, 100.0]
        self.min_valid_error = float("inf")
        self.min_valid_epoch = -1
        self.min_train_error = float("inf")
        #: per-class-end rows: epoch, class, n_err, loss, error_pct, count
        self.history: List[dict] = []
        #: the last completed class's confusion matrix, per class
        self.confusion_per_class: List[Any] = [None, None, None]

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("confusion_per_class", [None, None, None])
        self.__dict__.setdefault("epoch_ended_flag", False)
        for key in ("_acc_n_err", "_acc_loss", "_acc_count"):
            self.__dict__.setdefault(key, [])

    def run(self) -> None:
        self.improved = False
        self.epoch_ended_flag = False
        ld = self.loader
        if not ld.class_ended:
            return
        klass = ld.minibatch_class
        if self.metrics_source is None:
            n_err, loss, count, conf = self._take_slave_metrics()
        else:
            n_err, loss, count, conf = \
                self.metrics_source.take_class_metrics()
        if conf is not None:
            self.confusion_per_class[klass] = conf
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
        self.epoch_ended_flag = True
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

    # -- distribution hooks (the master--slave mode) --------------------

    @staticmethod
    def _f32_sum(values) -> float:
        acc = np.float32(0.0)
        for v in values:
            acc = np.float32(acc + np.float32(v))
        return float(acc)

    def _take_slave_metrics(self):
        out = tuple(self._f32_sum(a) for a in (self._acc_n_err,
                                               self._acc_loss,
                                               self._acc_count))
        for a in (self._acc_n_err, self._acc_loss, self._acc_count):
            a.clear()
        return out + (None,)

    def apply_data_from_slave(self, data, slave=None) -> None:
        self._acc_n_err.extend(data["n_err"])
        self._acc_loss.extend(data["loss"])
        self._acc_count.extend(data["count"])
