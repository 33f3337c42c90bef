"""The port's DBN: ``DeviceArrayLoader``, greedy pretraining chained on
the device, and the transplant, against the JAX package on XLA:CPU with
the reference's own uniforms injected through the port's draw seam.

- ``DeviceArrayLoader``: splits already on the device, concatenated
  there in [test | valid | train] order with no host copy, 0 bytes
  host-to-device, targets aliasing the data; a split on another device
  (or a numpy array) raises; it trains through the fused step.
- ``mnist_dbn.pretrain`` on a cut set, stage 1 resident (the stages
  chain on the device) and streamed (the host handoff): each stage's
  (weights, bias) within rtol 1e-4 / atol 1e-5 of the reference's, and
  ``stats`` equal to the reference's, keys and values
  (``interstage_h2d_bytes`` 0 and ``host_free`` True on the chain).
- ``apply_pretrained`` writes the pairs into the runner's master params
  and refuses a count or a shape that does not fit, with the reference's
  messages.
- ``python -m veles_tpu_torch -b cpu veles_tpu_torch/models/mnist_dbn.py``
  with a cut config pretrains on the device chain and fine-tunes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_data import data_dir_in_both
from test_torch_layers import reference_draws  # noqa: F401
from test_torch_train import _seed_both
from test_torch_zoo import _FL
from veles_tpu.backends import JaxDevice
from veles_tpu.models import mnist_dbn as ref_mnist_dbn
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import DeviceArrayLoader
from veles_tpu_torch.models import mnist_dbn
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 6420


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


# -- DeviceArrayLoader -------------------------------------------------------

def test_device_array_loader_binds_the_device_tensors():
    dev = make_device("cpu")
    rng = np.random.default_rng(0)
    tr = torch.from_numpy(rng.random((30, 8)).astype(np.float32))
    va = torch.from_numpy(rng.random((10, 8)).astype(np.float32))
    h2d = dev.h2d_bytes
    w = StandardWorkflow(
        loader_factory=lambda wf: DeviceArrayLoader(
            wf, name="loader", train=tr, valid=va, targets_from_data=True,
            minibatch_size=10),
        layers=[{"type": "rbm", "->": {"n_hidden": 4},
                 "<-": {"learning_rate": 0.1, "gradient_moment": 0.5}}],
        loss_function="mse", decision_config={"max_epochs": 2},
        name="dal")
    w.initialize(device=dev, train=True)
    ld = w.loader
    assert ld.ingest_h2d_bytes == 0
    assert ld.class_lengths == [0, 10, 30] and ld.device_resident
    assert ld.host_data is None and ld.host_labels is None
    assert ld.original_targets is ld.original_data
    torch.testing.assert_close(ld.original_data, torch.cat([va, tr]),
                               rtol=0, atol=0)
    assert dev.h2d_bytes == h2d     # the params go up at the first firing
    w.run()
    assert [(h["class"], h["count"]) for h in w.decision.history] == \
        [("validation", 10), ("train", 30)] * 2


def test_device_array_loader_refuses_a_split_off_the_device():
    dev = make_device("cpu")
    for bad in (torch.zeros((4, 3), device="meta"),
                np.zeros((4, 3), np.float32)):
        ld = DeviceArrayLoader(None, train=torch.zeros((4, 3)), valid=bad)
        with pytest.raises(ValueError, match="not on the runner's device"):
            ld.initialize(dev)


# -- pretraining -------------------------------------------------------------

CUT = {"minibatch_size": 50, "n_train": 150, "n_valid": 50}
PRE = dict(hidden=(24, 8), epochs=2)


def _pretrain(port: bool, tmp_path, stream: bool):
    loader = dict(CUT, max_resident_bytes=0) if stream else dict(CUT)
    stats = {}
    with data_dir_in_both(tmp_path):
        _seed_both(SEED)
        if port:
            out = mnist_dbn.pretrain(make_device("cpu"), loader_cfg=loader,
                                     stats=stats, **PRE)
        else:
            out = ref_mnist_dbn.pretrain(JaxDevice(platform="cpu"),
                                         loader_cfg=loader, stats=stats,
                                         **PRE)
    return [{k: np.asarray(v) for k, v in p.items()} for p in out], stats


@pytest.mark.parametrize("stream", [False, True], ids=["chain", "host"])
def test_pretrain_is_the_references(tmp_path, reference_draws, stream):
    want, want_stats = _pretrain(False, tmp_path, stream)
    got, stats = _pretrain(True, tmp_path, stream)
    assert stats == want_stats
    assert stats["device_chain"] is (not stream)
    if not stream:
        assert stats["interstage_h2d_bytes"] == 0
        assert stats["stages"] == [{"stage": 2, "rows": 200,
                                    "h2d_bytes": 0, "host_free": True}]
    assert [p["weights"].shape for p in got] == [(784, 24), (24, 8)]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"weights", "bias"}
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5)


def test_apply_pretrained_writes_the_master_params_and_checks_them():
    w = mnist_dbn.create_workflow(
        _FL(), loader=dict(CUT), hidden=[12, 5],
        decision={"max_epochs": 1})
    w.initialize(device=make_device("cpu"), train=True)
    rng = np.random.default_rng(4)
    pre = [{"weights": rng.random((784, 12)).astype(np.float32),
            "bias": rng.random(12).astype(np.float32)},
           {"weights": rng.random((12, 5)).astype(np.float32),
            "bias": rng.random(5).astype(np.float32)}]
    mnist_dbn.apply_pretrained(w, pre)
    got = w.fused.host_params()
    for name, p in zip(("fwd1_all2all_sigmoid", "fwd2_all2all_sigmoid"), pre):
        for k in p:
            np.testing.assert_array_equal(got[name][k], p[k])
    with pytest.raises(ValueError) as e:
        mnist_dbn.apply_pretrained(w, pre[:1])
    assert str(e.value) == "1 pretrained layers for 2 sigmoid layers in " \
        "the stack"
    bad = [pre[0], {"weights": pre[1]["weights"].T, "bias": pre[1]["bias"]}]
    with pytest.raises(ValueError) as e:
        mnist_dbn.apply_pretrained(w, bad)
    assert str(e.value) == "fwd2_all2all_sigmoid: weights (12, 5) vs " \
        "pretrained (5, 12)"


def test_mnist_dbn_cli_pretrains_on_the_device_chain(tmp_path):
    assert mnist_dbn.DEFAULTS == ref_mnist_dbn.DEFAULTS
    env = dict(os.environ, HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
         "veles_tpu_torch/models/mnist_dbn.py",
         "root.mnist_dbn.loader={'minibatch_size': 50, 'n_train': 100, "
         "'n_valid': 50}", "root.mnist_dbn.hidden=[16, 8]",
         "root.mnist_dbn.pretrain={'epochs': 1}",
         "root.mnist_dbn.decision.max_epochs=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'device_chain': True, 'interstage_h2d_bytes': 0" in proc.stderr
    assert "'host_free': True" in proc.stderr
    assert "complete: reached max_epochs=2" in proc.stderr
