"""MNIST RBM pretraining (the port's counterpart of
``veles_tpu/models/mnist_rbm.py``).

Binarized 28x28 digits feed a 196-unit Bernoulli RBM trained by CD-k
(k = 1, ``layers[1]["<-"]["cd_k"]`` to raise; ``ops/rbm.py``), lr 0.1,
moment 0.5, with the reconstruction MSE against the input (the
loader's ``targets_from_data``) on the validation split, 10 epochs: the
reference's ``DEFAULTS``.  It reads MNIST IDX files under
``<data_dir>/mnist`` when they are there, else generates the stand-in.
Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/mnist_rbm.py \\
        [root.common.data_dir=DIR] [root.mnist_rbm.k=v ...]
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import MnistLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

DEFAULTS = {
    "loader": {"minibatch_size": 100, "n_train": 60000,
               "n_valid": 10000, "targets_from_data": True},
    "layers": [
        {"type": "binarization", "->": {}, "<-": {}},
        {"type": "rbm", "->": {"n_hidden": 196},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.5,
                "cd_k": 1}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("mnist_rbm", DEFAULTS).todict()
    cfg.update(overrides)
    w = StandardWorkflow(
        loader_factory=lambda wf: MnistLoader(
            wf, name="loader", **cfg["loader"]),
        layers=cfg["layers"],
        loss_function="mse",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        name="MnistRbmWorkflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
