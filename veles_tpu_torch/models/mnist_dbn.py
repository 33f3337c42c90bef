"""MNIST DBN: greedy layer-wise RBM pretraining, then a backprop
fine-tune (the port's counterpart of ``veles_tpu/models/mnist_dbn.py``).

1. :func:`pretrain`: for each hidden width, a Bernoulli RBM trained by
   CD-k (``ops/rbm.py``), the first on the binarized pixels, each later
   one on the previous RBM's mean-field hidden probabilities
   (``RBM.hidden_of``); it returns each RBM's ``(weights, bias)``.
2. :func:`create_workflow`: the fine-tune net, binarization ->
   All2AllSigmoid per hidden width -> softmax(10), trained with
   cross-entropy.  A sigmoid dense layer computes exactly ``hidden_of``,
   so the transplanted weights reproduce the pretrained representation.
3. :func:`apply_pretrained`: the transplant into the runner's f32 master
   params, after ``initialize``.

The stages chain on the device when the stage-1 set is resident and not
under the uint8 codec: the binarization is the ``> 0.5`` threshold over
the resident tensor, each stage's hidden representations are
``RBM.hidden_of`` over the previous ones with the trained params still
on the device, sliced there and handed to the next stage through
``DeviceArrayLoader``.  ``stats`` then reads ``device_chain`` True,
``interstage_h2d_bytes`` 0 (the device's ``h2d_bytes`` delta over each
handoff) and ``host_free`` True on every stage.  Otherwise the handoff
goes through host arrays and ``ArrayLoader``.  :func:`run` does the
three steps with the reference's ``DEFAULTS`` (hidden [196, 64], 3
pretraining epochs a stage with CD-1, 10 fine-tuning epochs).  Train it
with

    python -m veles_tpu_torch [-b cpu] veles_tpu_torch/models/mnist_dbn.py \\
        [root.common.data_dir=DIR] [root.mnist_dbn.k=v ...]
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch import events, telemetry
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import ArrayLoader, DeviceArrayLoader
from veles_tpu_torch.loader.synthetic import MnistLoader
from veles_tpu_torch.models import model_config
from veles_tpu_torch.ops.all2all import All2AllSigmoid
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

log = logging.getLogger("veles.mnist_dbn")

DEFAULTS = {
    "loader": {"minibatch_size": 100, "n_train": 60000,
               "n_valid": 10000},
    "hidden": [196, 64],
    "pretrain": {"epochs": 3, "learning_rate": 0.1,
                 "gradient_moment": 0.5, "cd_k": 1},
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "snapshotter": None,
}


def _stage(name: str, loader_factory, layers, epochs: int, device):
    w = StandardWorkflow(loader_factory=loader_factory, layers=layers,
                         loss_function="mse",
                         decision_config={"max_epochs": epochs}, name=name)
    w.initialize(device=device, train=True)
    return w


def _trained(w, rbm) -> Dict[str, np.ndarray]:
    p = w.fused.host_params()[rbm.name]
    return {"weights": p["weights"], "bias": p["bias"]}


def pretrain(device, loader_cfg: Optional[Dict[str, Any]] = None,
             hidden=(196, 64), epochs: int = 3, learning_rate: float = 0.1,
             gradient_moment: float = 0.5, cd_k: int = 1,
             stats: Optional[Dict[str, Any]] = None,
             ) -> List[Dict[str, np.ndarray]]:
    """Greedy layer-wise CD-k pretraining on ``device``.  Returns one
    ``{"weights": (n_in, n_hid), "bias": (n_hid,)}`` per entry of
    ``hidden``, for :func:`apply_pretrained`.  A ``stats`` dict receives
    ``device_chain``, ``interstage_h2d_bytes`` and one ``stages``
    record per later stage (``stage``, ``rows``, ``h2d_bytes``,
    ``host_free``), as the reference fills them."""
    loader_cfg = dict(DEFAULTS["loader"], **(loader_cfg or {}))
    mb = loader_cfg["minibatch_size"]
    rbm_cfg = {"learning_rate": learning_rate,
               "gradient_moment": gradient_moment, "cd_k": int(cd_k)}

    def rbm_layer(n_hid):
        return {"type": "rbm", "->": {"n_hidden": int(n_hid)},
                "<-": dict(rbm_cfg)}

    # stage 1: binarized pixels -> RBM
    w1 = _stage("DbnPretrain1", lambda wf: MnistLoader(
        wf, name="loader", targets_from_data=True, **loader_cfg),
        [{"type": "binarization", "->": {}, "<-": {}},
         rbm_layer(hidden[0])], epochs, device)
    w1.run()
    rbm_unit = w1.forwards[1]
    results = [_trained(w1, rbm_unit)]

    ld = w1.loader
    off_v, off_t = ld.class_offset(VALID), ld.class_offset(TRAIN)
    n_v, n_t = ld.class_lengths[VALID], ld.class_lengths[TRAIN]
    chain_on_device = ld.device_resident and ld.dequant is None
    if stats is not None:
        stats["device_chain"] = bool(chain_on_device and hidden[1:])
        stats["interstage_h2d_bytes"] = 0
        stats["stages"] = []

    # what the next stage trains on: the eval-mode binarization, then
    # each trained RBM's hidden_of
    if chain_on_device:
        d = ld.original_data
        x = (d > 0.5).to(torch.float32).reshape(d.shape[0], -1)
        prev_dev = w1.fused.device_params(rbm_unit.name)
    else:
        data = ld.host_data if ld.host_data is not None \
            else device.get(ld.original_data)
        data = np.asarray(data, np.float32)
        x = (data > 0.5).astype(np.float32).reshape(len(data), -1)

    for depth, n_hid in enumerate(hidden[1:], start=2):
        if chain_on_device:
            # the handoff window: the hidden representations, the
            # slices and the loader's ingest, all on the device
            t0 = device.h2d_bytes
            with torch.no_grad():
                h = rbm_unit.hidden_of(prev_dev, x)
            ht = h[off_t:off_t + n_t]
            hv = h[off_v:off_v + n_v] if n_v else None
            compute_h2d = device.h2d_bytes - t0
            wk = _stage(f"DbnPretrain{depth}", lambda wf: DeviceArrayLoader(
                wf, name="loader", train=ht, valid=hv,
                targets_from_data=True, minibatch_size=mb),
                [rbm_layer(n_hid)], epochs, device)
            handoff = compute_h2d + wk.loader.ingest_h2d_bytes
            telemetry.event(events.EV_DBN_STAGE_HANDOFF, stage=depth,
                            rows=int(h.shape[0]), h2d_bytes=int(handoff))
            if stats is not None:
                stats["interstage_h2d_bytes"] += int(handoff)
                stats["stages"].append(
                    {"stage": depth, "rows": int(h.shape[0]),
                     "h2d_bytes": int(handoff),
                     "host_free": wk.loader.host_data is None})
        else:
            prev = results[-1]
            h = rbm_unit.hidden_of(
                {k: torch.from_numpy(v) for k, v in prev.items()},
                torch.from_numpy(x)).numpy()
            wk = _stage(f"DbnPretrain{depth}", lambda wf: ArrayLoader(
                wf, name="loader", train=(h[off_t:off_t + n_t],),
                valid=(h[off_v:off_v + n_v],) if n_v else None,
                targets_from_labels=True, minibatch_size=mb),
                [rbm_layer(n_hid)], epochs, device)
        wk.run()
        rbm = wk.forwards[0]
        results.append(_trained(wk, rbm))
        if chain_on_device:
            prev_dev = wk.fused.device_params(rbm.name)
        x = h   # the next stage stacks on this one's representation
    return results


def create_workflow(launcher, **overrides):
    """The fine-tune net (binarization -> sigmoid stack -> softmax),
    cold unless :func:`apply_pretrained` transplants RBM weights after
    ``initialize``."""
    cfg = model_config("mnist_dbn", DEFAULTS).todict()
    cfg.update(overrides)
    layers = [{"type": "binarization", "->": {}, "<-": {}}]
    for n_hid in cfg["hidden"]:
        layers.append({"type": "all2all_sigmoid",
                       "->": {"output_sample_shape": int(n_hid)},
                       "<-": {"learning_rate": 0.1,
                              "gradient_moment": 0.9}})
    layers.append({"type": "softmax",
                   "->": {"output_sample_shape": 10},
                   "<-": {"learning_rate": 0.1,
                          "gradient_moment": 0.9}})
    w = StandardWorkflow(
        loader_factory=lambda wf: MnistLoader(
            wf, name="loader", **cfg["loader"]),
        layers=layers,
        loss_function="softmax",
        decision_config=cfg["decision"],
        snapshotter_config=cfg.get("snapshotter"),
        name="MnistDbnWorkflow")
    launcher.workflow = w
    return w


def apply_pretrained(workflow,
                     pretrained: List[Dict[str, np.ndarray]]) -> None:
    """Write the pretrained RBM (weights, hidden bias) pairs into the
    runner's f32 master params of the workflow's sigmoid stack, in
    order.  Call after ``initialize`` and before ``run``."""
    sigmoids = [f for f in workflow.forwards
                if isinstance(f, All2AllSigmoid)]
    if len(sigmoids) != len(pretrained):
        raise ValueError(
            f"{len(pretrained)} pretrained layers for "
            f"{len(sigmoids)} sigmoid layers in the stack")
    params = workflow.fused.host_params()
    for f, p in zip(sigmoids, pretrained):
        have = tuple(params[f.name]["weights"].shape)
        if have != tuple(p["weights"].shape):
            raise ValueError(
                f"{f.name}: weights {have} vs pretrained "
                f"{tuple(p['weights'].shape)}")
        params[f.name]["weights"] = p["weights"]
        params[f.name]["bias"] = p["bias"]
    workflow.fused.set_host_params(params)


def run(launcher):
    """Initialize the fine-tune net, pretrain, transplant, fine-tune.
    The workflow keeps the pretraining's ``stats`` and seconds as
    ``pretrain_stats`` and ``pretrain_seconds``."""
    cfg = model_config("mnist_dbn", DEFAULTS).todict()
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    pre = cfg["pretrain"]
    stats: Dict[str, Any] = {}
    t0 = time.perf_counter()
    pretrained = pretrain(
        launcher.device, loader_cfg=cfg["loader"], hidden=cfg["hidden"],
        epochs=pre["epochs"], learning_rate=pre["learning_rate"],
        gradient_moment=pre["gradient_moment"], cd_k=pre.get("cd_k", 1),
        stats=stats)
    w = launcher.workflow
    w.pretrain_stats = stats
    w.pretrain_seconds = time.perf_counter() - t0
    log.info("pretrained %d stages in %.1fs: %s", len(pretrained),
             w.pretrain_seconds, stats)
    apply_pretrained(w, pretrained)
    launcher.run()
