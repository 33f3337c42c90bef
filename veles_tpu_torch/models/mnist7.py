"""MNIST7 convolutional workflow (the port's counterpart of
``veles_tpu/models/mnist7.py``, BASELINE config #2, and the secondary
workload: MNIST-conv time-to-99% validation accuracy).

ConvTanh(25, 5x5) -> MaxPooling 2x2 -> ConvTanh(50, 5x5) -> MaxPooling
2x2 -> All2AllTanh(100) -> All2AllSoftmax(10), momentum SGD, with the
reference's ``DEFAULTS``.  It reads MNIST IDX files under
``<data_dir>/mnist`` when they are there, else generates the stand-in.
Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/mnist7.py \
        [root.common.data_dir=DIR] [root.mnist7.k=v ...]
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import MnistLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

GD = {"learning_rate": 0.03, "weight_decay": 0.0005,
      "gradient_moment": 0.9}

DEFAULTS = {
    "loader": {"minibatch_size": 100, "n_train": 60000,
               "n_valid": 10000},
    "layers": [
        {"type": "conv_tanh",
         "->": {"n_kernels": 25, "kx": 5, "ky": 5}, "<-": GD},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}, "<-": {}},
        {"type": "conv_tanh",
         "->": {"n_kernels": 50, "kx": 5, "ky": 5}, "<-": GD},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}, "<-": {}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
         "<-": GD},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": GD},
    ],
    "decision": {"max_epochs": 12, "fail_iterations": 25},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("mnist7", DEFAULTS).todict()
    cfg.update(overrides)
    w = StandardWorkflow(
        loader_factory=lambda wf: MnistLoader(
            wf, name="loader", **cfg["loader"]),
        layers=cfg["layers"],
        loss_function="softmax",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        name="Mnist7Workflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
