"""The Kohonen SOM workflow (the port's counterpart of
``veles_tpu/models/kohonen.py``, BASELINE config #5 with MnistAE).

An unsupervised 8x8 self-organizing map trained on the synthetic
classification set (5 000 samples of 8x8x1, seed 888, no validation
split), alpha 0.3 -> 0.01 and sigma 4 -> 0.5 over 15 epochs, with the
reference's ``DEFAULTS``.  The tracked metric is the quantization error
(the history's ``loss``: the mean distance of a sample to its winner).
Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/kohonen.py \
        [root.kohonen.k=v ...]

The reference wires the workflow on its unit graph (``Repeater``,
``mutable.Bool``); the port runs a plain loop, loader -> trainer ->
decision, until ``decision.complete`` or :meth:`request_stop`.  Each
firing of the loader is a whole class (the loader clamps its group to
the class), which the trainer runs on the device in one go: the
reference's fused wiring.  ``$VELES_SOM_SUPERSTEP`` groups that many
minibatches a firing instead, and ``$VELES_SOM_FUSED=0`` one, the
reference's eager loop.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional

from veles_tpu_torch import knobs
from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.decision import DecisionGD
from veles_tpu_torch.ops.kohonen import KohonenForward, KohonenTrainer

log = logging.getLogger("veles.workflow")

DEFAULTS = {
    "loader": {"minibatch_size": 100, "n_train": 5000, "n_valid": 0,
               "shape": (8, 8, 1), "n_classes": 10, "seed": 888},
    "som_shape": (8, 8),
    "trainer": {"alpha0": 0.3, "alpha_min": 0.01, "decay_epochs": 15},
    "decision": {"max_epochs": 15},
}

#: the loader's group size: larger than any class, so one firing runs
#: the whole class
WHOLE_CLASS = 1 << 30


class KohonenWorkflow:
    def __init__(self, workflow: Any = None,
                 loader_cfg: Optional[dict] = None, som_shape=(8, 8),
                 trainer_cfg: Optional[dict] = None,
                 decision_cfg: Optional[dict] = None,
                 name: str = "KohonenWorkflow") -> None:
        self.workflow = workflow
        self.name = name
        self.loader = SyntheticClassificationLoader(
            self, name="loader", **(loader_cfg or {}))
        self.forward = KohonenForward(self, shape=tuple(som_shape),
                                      name="kohonen_fwd")
        self.trainer = KohonenTrainer(self, forward=self.forward,
                                      name="kohonen_trainer",
                                      **(trainer_cfg or {}))
        self.trainer.loader = self.loader
        self.decision = DecisionGD(self, name="decision",
                                   **(decision_cfg or {}))
        self.decision.loader = self.loader
        self.decision.metrics_source = self.trainer
        #: the forwards list that serving and packaging read
        self.forwards = [self.forward]
        self.device = None
        self.wall_time = 0.0
        self.stop_requested = False

    def initialize(self, device: Any = None, batch: int = 1,
                   train: bool = False) -> None:
        """Bind the device and give the map its input shape; with
        ``train=True`` also load the data, draw the weights and set the
        trainer up on the device."""
        self.device = device
        if train:
            self.loader.superstep = (
                int(knobs.get(knobs.SOM_SUPERSTEP)) or WHOLE_CLASS) \
                if knobs.get(knobs.SOM_FUSED) else 1
            self.loader.initialize(device)
            batch = self.loader.max_minibatch_size
        self.forward.initialize((batch,) + tuple(self.loader.sample_shape))
        if train:
            self.trainer.initialize(device,
                                    self.forward.fill_params()["weights"])

    def request_stop(self) -> None:
        """Stop :meth:`run` before the loader's next firing."""
        self.stop_requested = True

    def run(self) -> None:
        t0 = time.perf_counter()
        self.stop_requested = False
        try:
            while not self.decision.complete and not self.stop_requested:
                self.loader.run()
                self.trainer.run()
                self.decision.run()
        finally:
            self.loader.stop()
        self.wall_time = time.perf_counter() - t0
        log.info("wall-clock: %.0f train + %.0f eval samples, %d SOM "
                 "steps in %.1fs", self.trainer.processed_images,
                 self.trainer.processed_eval_images, self.trainer.steps,
                 self.wall_time)


def create_workflow(launcher, **overrides):
    cfg = model_config("kohonen", DEFAULTS).todict()
    cfg.update(overrides)
    w = KohonenWorkflow(
        loader_cfg=cfg["loader"], som_shape=tuple(cfg["som_shape"]),
        trainer_cfg=cfg["trainer"], decision_cfg=cfg["decision"],
        name="KohonenWorkflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
