"""StandardWorkflow: a training workflow from a declarative ``layers``
config.

Counterpart of ``veles_tpu/ops/standard_workflow.py``: a list of layer
dicts ``{"type": ..., "->": {forward kwargs}, "<-": {gd kwargs}}``
becomes a chain of forward units named ``fwd{i}_{kind}`` (the names key
the members npz, so they must match the reference's), their gradient
units ``gd{i}_{kind}``, the evaluator (``loss_function``: ``"softmax"``,
or ``"mse"`` against the loader's regression targets), ``DecisionGD``,
the optional ``LearningRateAdjust``, the fused step and the optional
``Snapshotter`` (``snapshotter_config``).

- :meth:`initialize` with ``train=False`` (what serving calls) only
  gives every forward its shape from the loader's sample shape: no data
  is generated.  With ``train=True`` (the launcher's call) the loader
  generates its data (and uploads it, or streams it), the forwards draw
  their initial params from the ``"weights"`` stream in order, and the
  fused step is bound to the device.  A workflow resumed from a
  snapshot keeps its trained params and draws nothing.
- :meth:`run` is a plain loop in the order the reference's fused wiring
  gives (``wire_fused``): loader -> lr_adjust -> fused step -> decision
  -> snapshotter (on a validation improvement) -> the units attached
  after the decision, until ``decision.complete``, or until
  :meth:`request_stop` was called: the loop then stops before the next
  firing of the loader, where every unit has finished the iteration, so
  a snapshot taken there resumes exactly.  Under data parallelism the
  request is summed over the group before each firing, so every rank
  stops before the same one.
- :meth:`link_plotters` attaches the reference's standard plotters
  (error and loss curves, the confusion matrix where the evaluator
  computes one, the first layer's weights) and
  :meth:`link_status_reporter` a unit that POSTs the run's status to a
  web status page.  Each fires after every decision and runs when a
  train epoch has just ended (its ``gate_skip``); a resumed workflow
  derives their gates from its live decision again at
  :meth:`initialize`, as the reference does at wiring time.

Not ported: the reference's eager per-unit wiring; the loop is not
driven through the unit graph (``workflow.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.ops.decision import DecisionGD
from veles_tpu_torch.ops.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.ops.fused import FusedStepRunner
from veles_tpu_torch.ops.lr_adjust import LearningRateAdjust
from veles_tpu_torch.ops.registry import forward_registry, gd_registry
from veles_tpu_torch.snapshotter import Snapshotter

log = logging.getLogger("veles.workflow")


class StandardWorkflow:
    def __init__(self, workflow: Any = None, loader: Any = None,
                 loader_factory: Optional[Callable[..., Any]] = None,
                 layers: Optional[List[Dict[str, Any]]] = None,
                 loss_function: str = "softmax",
                 decision_config: Optional[Dict[str, Any]] = None,
                 lr_adjust_config: Optional[Dict[str, Any]] = None,
                 snapshotter_config: Optional[Dict[str, Any]] = None,
                 superstep: int = 8,
                 name: str = "StandardWorkflow") -> None:
        self.workflow = workflow
        self.name = name
        self.layers_config = layers or []
        #: same-class minibatches per fused firing
        self.superstep = max(1, superstep)
        if loader is None:
            if loader_factory is None:
                raise ValueError("need loader or loader_factory")
            loader = loader_factory(self)
        self.loader = loader
        self.device = None
        #: seconds the last :meth:`run` took
        self.wall_time = 0.0
        self.stop_requested = False
        #: the data-parallel group (``parallel.DataParallel.install``)
        self.group = None
        self.forwards: List[Any] = []
        self.gds: List[Any] = []
        for i, cfg in enumerate(self.layers_config):
            kind = cfg["type"]
            if kind not in forward_registry:
                raise ValueError(f"unknown layer type {kind!r}; have "
                                 f"{sorted(forward_registry)}")
            fwd = forward_registry[kind](
                self, name=f"fwd{i}_{kind}", **dict(cfg.get("->", {})))
            self.forwards.append(fwd)
            self.gds.append(gd_registry[kind](
                self, forward=fwd, name=f"gd{i}_{kind}",
                **dict(cfg.get("<-", {}))))
        evaluators = {"softmax": EvaluatorSoftmax, "mse": EvaluatorMSE}
        if loss_function not in evaluators:
            raise ValueError(f"unknown loss {loss_function!r}; have "
                             f"{sorted(evaluators)}")
        self.evaluator = evaluators[loss_function](self, name="evaluator")
        self.decision = DecisionGD(self, name="decision",
                                   **(decision_config or {}))
        self.fused = FusedStepRunner(
            self, loader=self.loader, forwards=self.forwards,
            evaluator=self.evaluator, gds=self.gds, name="fused_step")
        self.decision.loader = self.loader
        self.decision.metrics_source = self.fused
        self.lr_adjust = None
        if lr_adjust_config:
            self.lr_adjust = LearningRateAdjust(self, name="lr_adjust",
                                                **lr_adjust_config)
            self.lr_adjust.loader = self.loader
            self.lr_adjust.gds = self.gds
            self.lr_adjust.fused = self.fused
        self.snapshotter = None
        if snapshotter_config is not None:
            self.snapshotter = Snapshotter(self, name="snapshotter",
                                           **snapshotter_config)
            self.snapshotter.decision = self.decision
        #: units fired after the decision (and the snapshotter), in order
        self._extra_after_decision: list = []
        self.plotters: list = []

    def __getstate__(self) -> dict:
        return dict(self.__dict__, device=None, group=None)

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        # a graceful stop's snapshot carries its request: never into
        # the resumed run
        self.stop_requested = False
        self.__dict__.setdefault("_extra_after_decision", [])
        self.__dict__.setdefault("plotters", [])
        self.__dict__.setdefault("group", None)

    # -- plotters and the status reporter --------------------------------

    def link_plotters(self) -> None:
        """Attach the standard plotters (reference:
        ``StandardWorkflow.link_plotters``); a resumed workflow keeps
        its pickled ones."""
        if self.plotters:
            return
        from veles_tpu_torch.plotting_units import (AccumulatingPlotter,
                                                    MatrixPlotter,
                                                    Weights2D)
        ps = [AccumulatingPlotter(self, name="plt_error"),
              AccumulatingPlotter(self, field="loss", name="plt_loss")]
        if getattr(self.evaluator, "compute_confusion", False):
            ps.append(MatrixPlotter(self, evaluator=self.evaluator,
                                    name="plt_confusion"))
        ps.append(Weights2D(self, unit=self.forwards[0],
                            name="plt_weights"))
        for p in ps:
            p.link_decision(self.decision)
        self._extra_after_decision.extend(ps)
        self.plotters = ps

    def link_status_reporter(self, url: str,
                             mode: str = "standalone") -> None:
        """Attach a per-epoch POST to the web status page at ``url``; a
        resumed workflow keeps its pickled reporter."""
        from veles_tpu_torch.web_status import StatusReporter
        if any(type(u) is StatusReporter
               for u in self._extra_after_decision):
            return
        rep = StatusReporter(self, url=url, mode=mode,
                             name="status_reporter")
        rep.link_decision(self.decision)
        self._extra_after_decision.append(rep)

    def initialize(self, device: Any = None, batch: int = 1,
                   train: bool = False) -> None:
        """Bind the device and give every forward its input shape; with
        ``train=True`` also load the data and set up training."""
        self.device = device
        # derived gates pickle as their momentary values: derive them
        # from the live decision again
        for extra in self._extra_after_decision:
            extra.link_decision(self.decision)
        if train:
            self.loader.superstep = self.superstep
            self.loader.initialize(device)
            batch = self.loader.max_minibatch_size
        shape = (batch,) + tuple(self.loader.sample_shape)
        for f in self.forwards:
            f.initialize(shape)
            shape = f.output_shape
        if train:
            # the fused runner feeds the decision from the loader's
            # batches (a master of the master--slave mode unhooks both,
            # and its snapshot keeps that)
            self.decision.metrics_source = self.fused
            self.loader.host_fill_enabled = True
            if not self.evaluator.wants_targets:
                self.evaluator.n_classes = int(shape[-1])
            # a resumed runner carries its trained params: drawing the
            # "weights" stream again would overwrite them
            params = None if self.fused.restored else \
                {f.name: f.fill_params() for f in self.forwards}
            self.fused.initialize(device, params)

    def request_stop(self) -> None:
        """Stop :meth:`run` before the loader's next firing (a
        preemption: the launcher snapshots right after)."""
        self.stop_requested = True

    def _stopping(self) -> bool:
        """A stop was requested: on any rank of a data-parallel group,
        so that every rank stops before the same firing."""
        if self.group is None:
            return self.stop_requested
        return self.group.any(self.stop_requested)

    def run(self) -> None:
        t0 = time.perf_counter()
        self.stop_requested = False
        try:
            while not self.decision.complete and not self._stopping():
                self.loader.run()
                if self.lr_adjust is not None:
                    self.lr_adjust.run()
                self.fused.run()
                self.decision.run()
                if self.snapshotter is not None and self.decision.improved:
                    self.snapshotter.run()
                for extra in self._extra_after_decision:
                    extra.fire()
        finally:
            self.loader.stop()
            self.fused.stop()
        self.wall_time = time.perf_counter() - t0
        log.info("wall-clock: %.0f train + %.0f eval images in %.1fs",
                 self.fused.processed_images,
                 self.fused.processed_eval_images, self.wall_time)
