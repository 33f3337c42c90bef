"""ImageNet AlexNet (the port's counterpart of
``veles_tpu/models/alexnet.py``).

The classic 8-layer net (Krizhevsky 2012): 5 conv stages (with LRN and
overlapping max pooling) and 3 fully-connected layers with dropout;
single-group convolutions.  ``alexnet_layers`` and ``DEFAULTS`` are the
reference's, so a package built for either framework describes the
same net, and ``create_workflow`` passes the reference's decision,
lr_adjust and loss config.  Train it with

    python -m veles_tpu_torch veles_tpu_torch/models/alexnet.py \
        [config.py ...] [root.alexnet.k=v ...]

on the synthetic stand-in data set (227x227x3, 1000 classes).  The
prepared-ImageNet loader (``loader.data_dir``) is not ported.
"""

from __future__ import annotations

from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

GD = {"learning_rate": 0.01, "weight_decay": 0.0005,
      "gradient_moment": 0.9}
GD_FC = {"learning_rate": 0.01, "weight_decay": 0.0005,
         "gradient_moment": 0.9}


def alexnet_layers(n_classes: int = 1000, dropout: float = 0.5):
    return [
        {"type": "conv_relu",
         "->": {"n_kernels": 96, "kx": 11, "ky": 11, "sliding": 4,
                "weights_filling": "gaussian", "weights_stddev": 0.01},
         "<-": GD},
        {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                                "k": 2.0}, "<-": {}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
         "<-": {}},
        {"type": "conv_relu",
         "->": {"n_kernels": 256, "kx": 5, "ky": 5, "padding": 2,
                "weights_filling": "gaussian", "weights_stddev": 0.01},
         "<-": GD},
        {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                                "k": 2.0}, "<-": {}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
         "<-": {}},
        {"type": "conv_relu",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
                "weights_filling": "gaussian", "weights_stddev": 0.01},
         "<-": GD},
        {"type": "conv_relu",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
                "weights_filling": "gaussian", "weights_stddev": 0.01},
         "<-": GD},
        {"type": "conv_relu",
         "->": {"n_kernels": 256, "kx": 3, "ky": 3, "padding": 1,
                "weights_filling": "gaussian", "weights_stddev": 0.01},
         "<-": GD},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
         "<-": {}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 4096,
                                        "weights_filling": "gaussian",
                                        "weights_stddev": 0.005},
         "<-": GD_FC},
        {"type": "dropout", "->": {"dropout_ratio": dropout}, "<-": {}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 4096,
                                        "weights_filling": "gaussian",
                                        "weights_stddev": 0.005},
         "<-": GD_FC},
        {"type": "dropout", "->": {"dropout_ratio": dropout}, "<-": {}},
        {"type": "softmax", "->": {"output_sample_shape": n_classes,
                                   "weights_filling": "gaussian",
                                   "weights_stddev": 0.01},
         "<-": GD_FC},
    ]


DEFAULTS = {
    "loader": {"minibatch_size": 128,
               "n_train": 4096, "n_valid": 512,
               "shape": (227, 227, 3), "n_classes": 1000,
               "noise": 0.5, "max_shift": 8, "seed": 227227},
    "n_classes": 1000,
    "dropout": 0.5,
    "lr_adjust": {"policy_name": "step",
                  "policy_kwargs": {"gamma": 0.1, "step": 30},
                  "by": "epoch"},
    "decision": {"max_epochs": 90, "fail_iterations": 1000},
    "snapshotter": None,
}


def create_workflow(launcher, **overrides):
    cfg = model_config("alexnet", DEFAULTS).todict()
    cfg.update(overrides)
    lcfg = dict(cfg["loader"])
    if lcfg.pop("data_dir", None):
        raise ValueError("loader.data_dir (prepared ImageNet) is not "
                         "ported yet")
    if cfg.get("snapshotter"):
        raise ValueError("snapshots are not ported yet")
    w = StandardWorkflow(
        loader_factory=lambda wf: SyntheticClassificationLoader(
            wf, name="loader", **lcfg),
        layers=cfg.get("layers") or
        alexnet_layers(cfg["n_classes"], cfg["dropout"]),
        loss_function="softmax",
        decision_config=cfg["decision"],
        lr_adjust_config=cfg.get("lr_adjust"),
        name="AlexNetWorkflow")
    launcher.workflow = w
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
