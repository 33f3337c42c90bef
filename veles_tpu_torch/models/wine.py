"""Wine, the smallest tabular classifier (the port's counterpart of
``veles_tpu/models/wine.py``).

All2AllTanh(8) -> All2AllSoftmax(3) over 13 features, with the
reference's ``DEFAULTS``: the deterministic synthetic stand-in for UCI
Wine (13 features as a (13, 1) sample, 3 classes, 140 + 38 samples,
minibatch 10), 30 epochs.  Real data placed as arrays can go through
``ArrayLoader`` with the same layers.  Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/wine.py \\
        [root.wine.k=v ...]
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

DEFAULTS = {
    "loader": {"minibatch_size": 10, "n_train": 140, "n_valid": 38,
               "shape": (13, 1), "n_classes": 3, "noise": 0.6,
               "max_shift": 0, "seed": 1317},
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
         "<-": {"learning_rate": 0.3, "weight_decay": 0.0}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.3, "weight_decay": 0.0}},
    ],
    "decision": {"max_epochs": 30, "fail_iterations": 100},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("wine", DEFAULTS).todict()
    cfg.update(overrides)
    w = StandardWorkflow(
        loader_factory=lambda wf: SyntheticClassificationLoader(
            wf, name="loader", **cfg["loader"]),
        layers=cfg["layers"],
        loss_function="softmax",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        name="WineWorkflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
