"""CIFAR-10 convolutional workflow (the port's counterpart of
``veles_tpu/models/cifar10.py``, BASELINE config #3).

Three ConvRELU(5x5, padding 2) stages with max and average pooling and a
softmax layer, L2 weight decay, and the ``inv`` lr policy by iteration,
with the reference's ``DEFAULTS``.  It reads CIFAR-10 batch files
(binary or python-pickle layout) under ``<data_dir>/cifar10`` when they
are there (``python -m veles_tpu_torch.datasets make-cifar10-batches``
writes the synthetic stand-in as binary batches), else generates the
stand-in.  Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/cifar10.py \
        [root.common.data_dir=DIR] [root.cifar10.k=v ...]
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import Cifar10Loader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

GD = {"learning_rate": 0.02, "weight_decay": 0.0005,
      "gradient_moment": 0.9}

DEFAULTS = {
    "loader": {"minibatch_size": 100, "n_train": 50000,
               "n_valid": 10000},
    "layers": [
        {"type": "conv_relu",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": GD},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
         "<-": {}},
        {"type": "conv_relu",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": GD},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
         "<-": {}},
        {"type": "conv_relu",
         "->": {"n_kernels": 64, "kx": 5, "ky": 5, "padding": 2},
         "<-": GD},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
         "<-": {}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": GD},
    ],
    "lr_adjust": {"policy_name": "inv",
                  "policy_kwargs": {"gamma": 0.0001, "power": 0.75},
                  "by": "iteration"},
    "decision": {"max_epochs": 20, "fail_iterations": 50},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("cifar10", DEFAULTS).todict()
    cfg.update(overrides)
    w = StandardWorkflow(
        loader_factory=lambda wf: Cifar10Loader(
            wf, name="loader", **cfg["loader"]),
        layers=cfg["layers"],
        loss_function="softmax",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        lr_adjust_config=cfg.get("lr_adjust"),
        name="Cifar10Workflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
