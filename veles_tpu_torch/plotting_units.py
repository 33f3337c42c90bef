"""Plotting units: error and loss curves, the confusion matrix, the first
layer's weights as images (the port's copy of
``veles_tpu/plotting_units.py``).

- :class:`AccumulatingPlotter`: a curve per class over the epochs, from
  the decision's ``history`` rows.
- :class:`MatrixPlotter`: the last completed validation (else train)
  class's confusion matrix, ``DecisionGD.confusion_per_class``.
- :class:`Weights2D`: the first forward unit's weights as image tiles,
  read from the card through the fused runner
  (``fused.host_params``) and turned into the reference's layout by
  ``convert.params_to_jax`` (HWIO for convs), as the export does, so the
  tiles are the reference's for the same weights.

Each is a :class:`~veles_tpu_torch.units.Unit` whose ``gate_skip`` is
derived from the decision (:meth:`Plotter.link_decision`): the
workflow's loop fires it after every decision, and it runs only when a
train epoch has just ended.  Its event goes onto the process's graphics
bus (:func:`~veles_tpu_torch.graphics_server.get_server`).  None of
them touches a kernel.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from veles_tpu_torch.graphics_server import get_server
from veles_tpu_torch.loader.base import CLASS_NAMES, TRAIN, VALID
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit


class Plotter(Unit):
    """Base plotting unit: skipped unless a train epoch just ended."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        # the port's StandardWorkflow is not a unit container: the unit
        # keeps a reference to it without being added to it
        super().__init__(None, **kwargs)
        self.workflow = workflow
        self.decision = None

    def link_decision(self, decision) -> None:
        """Gate on ``decision`` (again after a resume: a pickled derived
        Bool keeps only its value)."""
        self.decision = decision
        self.gate_skip = Bool.from_expr(
            lambda d=decision: not d.epoch_ended_flag)

    def make_event(self) -> Optional[dict]:
        raise NotImplementedError

    def run(self) -> None:
        event = self.make_event()
        if event is not None:
            event.setdefault("plotter", self.name)
            get_server().enqueue(event)


class AccumulatingPlotter(Plotter):
    """Error % (or loss) curves per class over the epochs."""

    def __init__(self, workflow=None, field: str = "error_pct",
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.field = field

    def make_event(self) -> Optional[dict]:
        series = {}
        for klass_name in CLASS_NAMES:
            rows = [h for h in self.decision.history
                    if h["class"] == klass_name]
            if rows:
                series[klass_name] = ([h["epoch"] for h in rows],
                                      [h[self.field] for h in rows])
        if not series:
            return None
        return {"kind": "curves", "series": series,
                "ylabel": self.field,
                "title": f"{self.workflow.name}: {self.field}"}


class MatrixPlotter(Plotter):
    """The confusion matrix of the last completed validation (else
    train) class."""

    def __init__(self, workflow=None, evaluator=None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.evaluator = evaluator

    def make_event(self) -> Optional[dict]:
        per = getattr(self.decision, "confusion_per_class", None)
        conf = None
        klass = None
        if per is not None:
            for klass in (VALID, TRAIN):
                if per[klass] is not None:
                    conf = per[klass]
                    break
        if conf is None:
            return None
        return {"kind": "matrix", "matrix": np.asarray(conf),
                "title": f"{self.workflow.name}: confusion "
                         f"({CLASS_NAMES[klass]})"}


class Weights2D(Plotter):
    """The first forward unit's weights as image tiles (at most
    ``limit``)."""

    def __init__(self, workflow=None, unit=None, limit: int = 25,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.unit = unit
        self.limit = limit

    def weights(self) -> Optional[np.ndarray]:
        """The unit's weights on the host, in the reference's layout;
        None for a unit without weights."""
        from veles_tpu_torch.convert import params_to_jax
        f = self.unit
        if f is None:
            return None
        host = self.workflow.fused.host_params([f.name])
        params = params_to_jax(host).get(f.name, {})
        w = params.get("weights")
        return None if w is None else np.asarray(w)

    def make_event(self) -> Optional[dict]:
        w = self.weights()
        if w is None:
            return None
        tiles = self._to_tiles(w)
        if tiles is None:
            return None
        return {"kind": "image_grid", "tiles": tiles[:self.limit],
                "title": f"{self.workflow.name}: {self.unit.name} "
                         f"weights"}

    @staticmethod
    def _to_tiles(w: np.ndarray) -> Optional[List[np.ndarray]]:
        if w.ndim == 4:            # conv HWIO: a tile per output channel
            h, kw, cin, cout = w.shape
            t = np.transpose(w, (3, 0, 1, 2))
            if cin == 3:
                lo, hi = t.min(), t.max()
                return list((t - lo) / max(hi - lo, 1e-12))
            return list(t.mean(-1))
        if w.ndim == 2:            # dense: rows as a square image
            n = w.shape[0]
            side = int(np.sqrt(n))
            if side * side == n:
                return list(np.transpose(
                    w.reshape(side, side, -1), (2, 0, 1)))
            side3 = int(np.sqrt(n // 3)) if n % 3 == 0 else 0
            if side3 and side3 * side3 * 3 == n:
                t = np.transpose(w.reshape(side3, side3, 3, -1),
                                 (3, 0, 1, 2))
                lo, hi = t.min(), t.max()
                return list((t - lo) / max(hi - lo, 1e-12))
            return None
        return None
