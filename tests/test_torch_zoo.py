"""The port's mnist, mnist7 and cifar10 models and its quantized ingest,
trained against the JAX package's.

The rule of ``test_torch_train.py``: the same seeds and data through the
reference's ``StandardWorkflow`` on XLA:CPU and the port's on the CPU, in
f32, give the same initial params bitwise, the same minibatch order,
equal n_err and count at every class end, loss within rtol 1e-4, and
final params within rtol 1e-4 / atol 1e-5.

- ``models/{mnist,mnist7,cifar10}.py`` through their
  ``create_workflow``, cut to a few hundred images read from files the
  port's generators wrote (IDX, CIFAR-10 binary batches), 2 epochs;
- an ``ArrayLoader`` byte set with the ``linear`` and ``mean_disp``
  normalizers under the uint8 codec, resident and streamed, against the
  reference's quantized run (the rule above), and against the port's own
  float run (``quantized_ingest=False``) within the reference's bar
  (``tests/test_ingest_quantized.py``): validation loss within 5e-3 at
  every class end, n_err equal;
- the streamed superstep stays uint8 and ``stream_transfer_bytes`` is
  exactly the pixels plus 8 bytes a label;
- a resumed quantized run equals the straight one bitwise and does not
  refit its normalizer;
- ``python -m veles_tpu_torch -b cpu veles_tpu_torch/models/mnist7.py``
  with a cut config trains from IDX files in a temp dir.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_data import data_dir_in_both
from test_torch_train import _record_order, _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.loader.fullbatch import ArrayLoader as RefArrayLoader
from veles_tpu.models import cifar10 as ref_cifar10
from veles_tpu.models import mnist as ref_mnist
from veles_tpu.models import mnist7 as ref_mnist7
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import datasets, normalization, prng, snapshotter
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.models import cifar10, mnist, mnist7
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2468


@pytest.fixture(autouse=True)
def _port_state():
    """A fresh port stream registry, and the port's config tree restored
    after (``model_config`` writes ``root.<model>``)."""
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


class _FL:
    workflow = None


def _run(w, init):
    """(first params, minibatch order, history, last params)."""
    init(w)
    first = {f: {p: np.asarray(a) for p, a in ps.items()}
             for f, ps in w.fused.host_params().items()}
    order = []
    _record_order(w, order)
    w.run()
    last = {f: {p: np.asarray(a) for p, a in ps.items()}
            for f, ps in w.fused.host_params().items()}
    return first, order, list(w.decision.history), last


def _ref_init(w):
    w.evaluator.compute_confusion = False
    w.initialize(device=JaxDevice(platform="cpu"))


def _port_init(w):
    w.initialize(device=make_device("cpu"), train=True)


def assert_reference_rule(ref, port):
    (rfirst, rorder, rhist, rlast), (pfirst, porder, phist, plast) = \
        ref, port
    rfirst, rlast = params_from_jax(rfirst), params_from_jax(rlast)
    assert set(pfirst) == set(rfirst)
    for f in rfirst:
        for p in rfirst[f]:
            np.testing.assert_array_equal(pfirst[f][p], rfirst[f][p])
    assert porder == rorder
    assert [(h["epoch"], h["class"], h["n_err"], h["count"])
            for h in phist] == [(h["epoch"], h["class"], h["n_err"],
                                 h["count"]) for h in rhist]
    for g, w in zip(phist, rhist):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    moved = 0.0
    for f in rlast:
        for p in rlast[f]:
            np.testing.assert_allclose(plast[f][p], rlast[f][p], rtol=1e-4,
                                       atol=1e-5)
            moved = max(moved, float(np.abs(rlast[f][p]
                                            - rfirst[f][p]).max()))
    assert moved > 1e-3      # training moved the params well past atol


# -- the three models --------------------------------------------------------

#: (port module, reference module, file generator and its sizes, loader cut)
MODELS = {
    "mnist": (mnist, ref_mnist, "generate_mnist_idx", (300, 80),
              {"minibatch_size": 60, "n_train": 240, "n_valid": 60}),
    "mnist7": (mnist7, ref_mnist7, "generate_mnist_idx", (300, 80),
               {"minibatch_size": 100, "n_train": 200, "n_valid": 80}),
    "cifar10": (cifar10, ref_cifar10, "generate_cifar10_batches", (250, 100),
                {"minibatch_size": 100, "n_train": 200, "n_valid": 100}),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_trains_as_the_reference(tmp_path, name):
    port_mod, ref_mod, gen, sizes, loader = MODELS[name]
    overrides = {"loader": loader,
                 "decision": {"max_epochs": 2, "fail_iterations": 50}}
    with data_dir_in_both(tmp_path):
        getattr(datasets, gen)(None, *sizes)
        _seed_both(SEED)
        ref = _run(ref_mod.create_workflow(_FL(), **overrides), _ref_init)
        _seed_both(SEED)
        w = port_mod.create_workflow(_FL(), **overrides)
        port = _run(w, _port_init)
    assert w.loader.class_lengths == [0, loader["n_valid"], loader["n_train"]]
    assert w.layers_config == port_mod.DEFAULTS["layers"]
    assert_reference_rule(ref, port)


def test_models_keep_the_references_defaults():
    for port_mod, ref_mod, *_ in MODELS.values():
        assert port_mod.DEFAULTS == ref_mod.DEFAULTS
    w = cifar10.create_workflow(_FL(), loader={"n_train": 10, "n_valid": 5})
    assert (w.lr_adjust.policy_name, w.lr_adjust.by) == ("inv", "iteration")
    assert [f.padding for f in w.forwards if hasattr(f, "padding")] == \
        [(2, 2)] * 3


# -- quantized ingest ------------------------------------------------------

def byte_set(n_train=96, n_valid=32, shape=(6, 6, 2), n_classes=3, seed=7):
    """Byte-ranged samples with a per-class mean, so the net learns."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n_train + n_valid).astype(np.int32)
    centers = rng.randint(40, 216, (n_classes,) + shape)
    x = np.clip(centers[y] + rng.randint(-60, 61, (len(y),) + shape), 0,
                255).astype(np.uint8)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
QLAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3},
     "<-": GD},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}, "<-": {}},
    {"type": "softmax", "->": {"output_sample_shape": 3}, "<-": GD},
]
MB = 16


def quant_workflow(cls, loader_cls, norm, quant, epochs=2, **kw):
    train, valid = byte_set()
    params = {"lo": 0.0, "hi": 1.0} if norm == "linear" else {}
    return cls(loader_factory=lambda wf: loader_cls(
        wf, train=train, valid=valid, minibatch_size=MB, name="loader",
        normalization_type=norm, normalization_parameters=params,
        quantized_ingest=quant, **kw),
        layers=QLAYERS,
        decision_config={"max_epochs": epochs, "fail_iterations": 50},
        superstep=3, name="quant")


def _port_quant(norm, quant, **kw):
    _seed_both(SEED)
    w = quant_workflow(StandardWorkflow, ArrayLoader, norm, quant, **kw)
    return w, _run(w, _port_init)


@pytest.fixture(scope="module", params=["linear", "mean_disp"])
def quantized(request):
    norm = request.param
    _seed_both(SEED)
    ref = _run(quant_workflow(RefWorkflow, RefArrayLoader, norm, "auto"),
               _ref_init)
    runs = {"ref": ref}
    for path, kw in (("resident", {}), ("stream", {"max_resident_bytes": 0}),
                     ("float", {"quantized_ingest": False})):
        quant = kw.pop("quantized_ingest", "auto")
        runs[path] = _port_quant(norm, quant, **kw)
    prng._streams.clear()
    return runs


def test_quantized_run_matches_the_references(quantized):
    w = quantized["resident"][0]
    assert w.loader.dequant is not None and w.loader.device_resident
    assert w.loader.original_data.dtype == torch.uint8
    assert_reference_rule(quantized["ref"], quantized["resident"][1])


def test_streamed_quantized_run_matches_the_references(quantized):
    w = quantized["stream"][0]
    assert w.fused.streaming and w.loader.host_data.dtype == np.uint8
    assert_reference_rule(quantized["ref"], quantized["stream"][1])
    # the same rows in the same f32 operations: bitwise the resident run
    _, _, hist, last = quantized["resident"][1]
    assert quantized["stream"][1][2] == hist
    for f in last:
        for p in last[f]:
            np.testing.assert_array_equal(quantized["stream"][1][3][f][p],
                                          last[f][p])


def test_quantized_run_matches_the_float_run(quantized):
    wf, (_, forder, fhist, _) = quantized["float"]
    assert wf.loader.dequant is None and \
        wf.loader.original_data.dtype == torch.float32
    _, qorder, qhist, _ = quantized["resident"][1]
    assert qorder == forder
    valid = [(q, f) for q, f in zip(qhist, fhist)
             if q["class"] == "validation"]
    assert len(valid) == 2 and len(qhist) == len(fhist)
    for q, f in valid:
        assert q["n_err"] == f["n_err"] and q["count"] == f["count"]
        assert abs(q["loss"] - f["loss"]) < 5e-3


def test_streamed_superstep_is_uint8_and_counted_exactly(quantized):
    w = quantized["stream"][0]
    ld, fused = w.loader, w.fused
    ld.run()
    assert ld.superstep_data.dtype == torch.uint8
    assert ld.superstep_labels.dtype == torch.int64
    ld.stop()
    per_epoch = -(-32 // MB) + -(-96 // MB)
    assert ld.assembled_minibatches == 2 * per_epoch + ld.superstep_k
    assert fused.stream_transfer_bytes == \
        2 * per_epoch * MB * (6 * 6 * 2 + 8)


def test_resumed_quantized_run_equals_the_straight_one(tmp_path,
                                                       monkeypatch):
    _, straight = _port_quant("mean_disp", "auto", epochs=3)
    _seed_both(SEED)
    w = quant_workflow(StandardWorkflow, ArrayLoader, "mean_disp", "auto",
                       epochs=1)
    _port_init(w)
    w.run()
    fitted = w.loader.normalizer.state()
    path = str(tmp_path / "q.pickle")
    snapshotter.save_workflow(w, path)
    back = snapshotter.load_workflow(path)
    back.decision.max_epochs, back.decision.complete = 3, False

    def no_refit(self, data):
        raise AssertionError("the resumed run refitted its normalizer")
    monkeypatch.setattr(normalization.MeanDispNormalizer, "fit", no_refit)
    back.initialize(device=make_device("cpu"), train=True)
    for k, v in fitted.items():
        np.testing.assert_array_equal(back.loader.normalizer.state()[k], v)
    assert back.loader.host_data is None and \
        back.loader.original_data.dtype == torch.uint8
    back.run()
    assert back.decision.history == straight[2]
    last = back.fused.host_params()
    for f in straight[3]:
        for p in straight[3][f]:
            np.testing.assert_array_equal(last[f][p], straight[3][f][p])


# -- the command line --------------------------------------------------------

def test_cli_trains_mnist7_from_idx_files(tmp_path):
    """Files of 150 + 50 images under caps of 1000: the run's image
    counts show that the files, not the synthetic stand-in, were read."""
    datasets.generate_mnist_idx(str(tmp_path / "mnist"), 150, 50)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s", "5",
         "veles_tpu_torch/models/mnist7.py",
         f"root.common.data_dir={tmp_path}",
         "root.mnist7.loader={'minibatch_size': 50, 'n_train': 1000, "
         "'n_valid': 1000}",
         "root.mnist7.decision={'max_epochs': 1}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "epoch 1 train" in proc.stderr
    assert "complete: reached max_epochs=1" in proc.stderr
    assert "wall-clock: 150 train + 50 eval images" in proc.stderr
