"""MnistAE, the convolutional autoencoder (the port's counterpart of
``veles_tpu/models/mnist_ae.py``, BASELINE config #5 with the Kohonen
SOM).

ConvTanh(9, 5x5, padding 2) -> MaxPooling 2x2 -> Depooling 2x2 ->
Deconv(1, 5x5, padding 2), trained by momentum SGD on the MSE against
the input image (the loader's ``targets_from_data``), with the
reference's ``DEFAULTS``.  It reads MNIST IDX files under
``<data_dir>/mnist`` when they are there, else generates the stand-in.
Train it with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/mnist_ae.py \
        [root.common.data_dir=DIR] [root.mnist_ae.k=v ...]
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import MnistLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

GD = {"learning_rate": 0.005, "weight_decay": 0.0,
      "gradient_moment": 0.9}

DEFAULTS = {
    "loader": {"minibatch_size": 100, "n_train": 60000,
               "n_valid": 10000},
    "layers": [
        {"type": "conv_tanh",
         "->": {"n_kernels": 9, "kx": 5, "ky": 5, "padding": 2},
         "<-": GD},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}, "<-": {}},
        {"type": "depooling", "->": {"kx": 2, "ky": 2}, "<-": {}},
        {"type": "deconv",
         "->": {"n_kernels": 1, "kx": 5, "ky": 5, "padding": 2},
         "<-": GD},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 20},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("mnist_ae", DEFAULTS).todict()
    cfg.update(overrides)
    w = StandardWorkflow(
        loader_factory=lambda wf: MnistLoader(
            wf, name="loader", targets_from_data=True, **cfg["loader"]),
        layers=cfg["layers"],
        loss_function="mse",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        name="MnistAEWorkflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
