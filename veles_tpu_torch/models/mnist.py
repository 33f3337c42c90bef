"""MNIST All2All fully-connected workflow (the port's counterpart of
``veles_tpu/models/mnist.py``, BASELINE config #1).

MnistLoader -> All2AllTanh(100) -> All2AllSoftmax(10) -> the softmax
evaluator -> the gradient chain -> DecisionGD, with the reference's
``DEFAULTS``.  It reads MNIST IDX files under ``<data_dir>/mnist`` when
they are there (``python -m veles_tpu_torch.datasets make-mnist-idx``
writes the synthetic stand-in as such files), else generates the
stand-in.  Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/mnist.py \
        [root.common.data_dir=DIR] [root.mnist.k=v ...]
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import MnistLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

DEFAULTS = {
    "loader": {"minibatch_size": 60, "n_train": 60000, "n_valid": 10000},
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.1, "weight_decay": 0.0}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.1, "weight_decay": 0.0}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("mnist", DEFAULTS).todict()
    cfg.update(overrides)
    w = StandardWorkflow(
        loader_factory=lambda wf: MnistLoader(
            wf, name="loader", **cfg["loader"]),
        layers=cfg["layers"],
        loss_function="softmax",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        name="MnistWorkflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
