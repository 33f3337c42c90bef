"""StandardWorkflow: a training workflow from a declarative ``layers``
config.

Counterpart of ``veles_tpu/ops/standard_workflow.py``: a list of layer
dicts ``{"type": ..., "->": {forward kwargs}, "<-": {gd kwargs}}``
becomes a chain of forward units named ``fwd{i}_{kind}`` (the names key
the members npz, so they must match the reference's), their gradient
units ``gd{i}_{kind}``, the softmax evaluator, ``DecisionGD``, the
optional ``LearningRateAdjust`` and the fused step.

- :meth:`initialize` with ``train=False`` (what serving calls) only
  gives every forward its shape from the loader's sample shape: no data
  is generated.  With ``train=True`` (the launcher's call) the loader
  generates and uploads its data, the forwards draw their initial
  params from the ``"weights"`` stream in order, and the fused step is
  bound to the device.
- :meth:`run` is a plain loop in the order the reference's fused wiring
  gives (``wire_fused``): loader -> lr_adjust -> fused step -> decision,
  until ``decision.complete``.

Not ported: the reference's generic unit graph (``workflow.py``,
``units.py``, ``mutable.py``) and its eager per-unit wiring, the MSE
evaluator, snapshots and plotters.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.ops.decision import DecisionGD
from veles_tpu_torch.ops.evaluator import EvaluatorSoftmax
from veles_tpu_torch.ops.fused import FusedStepRunner
from veles_tpu_torch.ops.lr_adjust import LearningRateAdjust
from veles_tpu_torch.ops.registry import forward_registry, gd_registry

log = logging.getLogger("veles.workflow")


class StandardWorkflow:
    def __init__(self, workflow: Any = None, loader: Any = None,
                 loader_factory: Optional[Callable[..., Any]] = None,
                 layers: Optional[List[Dict[str, Any]]] = None,
                 loss_function: str = "softmax",
                 decision_config: Optional[Dict[str, Any]] = None,
                 lr_adjust_config: Optional[Dict[str, Any]] = None,
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
        if loss_function != "softmax":
            raise ValueError(f"loss {loss_function!r}: only the softmax "
                             f"evaluator is ported")
        self.evaluator = EvaluatorSoftmax(self, name="evaluator")
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

    def initialize(self, device: Any = None, batch: int = 1,
                   train: bool = False) -> None:
        """Bind the device and give every forward its input shape; with
        ``train=True`` also load the data and set up training."""
        self.device = device
        if train:
            self.loader.superstep = self.superstep
            self.loader.initialize(device)
            batch = self.loader.max_minibatch_size
        shape = (batch,) + tuple(self.loader.sample_shape)
        for f in self.forwards:
            f.initialize(shape)
            shape = f.output_shape
        if train:
            self.evaluator.n_classes = int(shape[-1])
            params = {f.name: f.fill_params() for f in self.forwards}
            self.fused.initialize(device, params)

    def run(self) -> None:
        t0 = time.perf_counter()
        while not self.decision.complete:
            self.loader.run()
            if self.lr_adjust is not None:
                self.lr_adjust.run()
            self.fused.run()
            self.decision.run()
        self.wall_time = time.perf_counter() - t0
        log.info("wall-clock: %.0f train + %.0f eval images in %.1fs",
                 self.fused.processed_images,
                 self.fused.processed_eval_images, self.wall_time)
