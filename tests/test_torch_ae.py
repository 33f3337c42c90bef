"""The port's MnistAE autoencoder and the loader's regression targets,
against the JAX package on XLA:CPU; and the loader's stored dtype.

- ``Depooling``, ``Deconv`` and their gradient units against the
  reference's (deconv at stride 1 and 2, padding 0 and 2): output,
  ``err_input`` and the weight and bias gradients within rtol 1e-5 /
  atol 1e-5 (the reference's own numpy and JAX paths differ by up to
  7.6e-6 absolute on unit-normal inputs, on summation order alone);
  depooling refuses overlapping windows as the reference does; a deconv
  kernel crosses ``convert.py`` with the conv kernel's permutation.
- ``EvaluatorMSE`` against the reference's with a padded mask: every key
  within rtol 1e-6 (the same f32 operations in another summation order).
- Aliased targets: no codec under ``"auto"``, the reference's
  ``ValueError`` under ``quantized_ingest=True``, and the normalized
  targets ARE the normalized data, bitwise the reference's.
- ``models/mnist_ae.py`` through ``create_workflow``, resident and
  streamed, from IDX files the port's generator wrote, under
  ``test_torch_zoo.py``'s rule (initial params bitwise, the same
  minibatch order, equal n_err and count, loss within rtol 1e-4, final
  params within rtol 1e-4 / atol 1e-5); the streamed wire is exactly
  the f32 pixels and the f32 targets.
- The loader keeps the stored dtype without the codec: a uint8 and a
  float64 set under a budget of their stored bytes stay resident, one
  byte under it they stream, as the reference decides, with the same
  pixel bytes on the wire and the same training.
- ``python -m veles_tpu_torch -b cpu veles_tpu_torch/models/mnist_ae.py``
  with a cut config trains from IDX files in a temp dir.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import data_dir_in_both
from test_torch_train import _seed_both
from test_torch_zoo import (_FL, _port_init, _ref_init, _run,
                            assert_reference_rule)
from veles_tpu.loader.fullbatch import ArrayLoader as RefArrayLoader
from veles_tpu.models import mnist_ae as ref_mnist_ae
from veles_tpu.ops import deconv as ref_deconv
from veles_tpu.ops import depooling as ref_depooling
from veles_tpu.ops.evaluator import EvaluatorMSE as RefEvaluatorMSE
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu.backends import JaxDevice
from veles_tpu_torch import datasets, prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, params_to_jax
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.models import mnist_ae
from veles_tpu_torch.ops import deconv, depooling
from veles_tpu_torch.ops.evaluator import EvaluatorMSE
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1357


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# -- the units ---------------------------------------------------------------

def test_depooling_and_its_gradient_are_the_references():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 4, 2)).astype(np.float32)
    ref = ref_depooling.Depooling(None, kx=2, ky=3)
    port = depooling.Depooling(None, kx=2, ky=3)
    want = np.asarray(ref.apply({}, {"input": jnp.asarray(x)})["output"])
    got = port.apply({}, torch.from_numpy(x))
    assert port.output_shape_for(x.shape) == want.shape == (3, 15, 8, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    err = rng.standard_normal(want.shape).astype(np.float32)
    want_in, _ = ref_depooling.GDDepooling(None, forward=ref) \
        .backward_from_saved({}, (jnp.asarray(x), want), jnp.asarray(err))
    got_in, grads = depooling.GDDepooling(None, forward=port) \
        .backward_from_saved({}, (torch.from_numpy(x), got),
                             torch.from_numpy(err))
    assert grads == {}
    _close(got_in, want_in)
    for cls in (ref_depooling.Depooling, depooling.Depooling):
        with pytest.raises(ValueError, match="non-overlapping"):
            cls(None, kx=2, ky=2, sliding=1)


@pytest.mark.parametrize("sliding", [1, 2])
@pytest.mark.parametrize("padding", [0, 2])
def test_deconv_and_its_gradient_are_the_references(sliding, padding):
    rng = np.random.default_rng(10 * sliding + padding)
    x = rng.standard_normal((3, 7, 7, 4)).astype(np.float32)
    w = rng.standard_normal((5, 5, 3, 4)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    kw = dict(n_kernels=3, kx=5, ky=5, padding=padding, sliding=sliding)
    ref, port = ref_deconv.Deconv(None, **kw), deconv.Deconv(None, **kw)
    rparams = {"weights": jnp.asarray(w), "bias": jnp.asarray(b)}
    pparams = {k: torch.from_numpy(v) for k, v in params_from_jax(
        {"d": {"weights": w, "bias": b}})["d"].items()}
    assert tuple(pparams["weights"].shape) == \
        port.param_shapes(x.shape)["weights"] == (4, 3, 5, 5)
    want = np.asarray(ref.pre_activation(rparams, jnp.asarray(x)))
    got = port.apply(pparams, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == port.output_shape_for(x.shape)
    _close(got, want)
    err = rng.standard_normal(want.shape).astype(np.float32)
    want_in, want_g = ref_deconv.GradientDescentDeconv(None, forward=ref) \
        .backward_from_saved(rparams, (jnp.asarray(x), want),
                             jnp.asarray(err))
    got_in, got_g = deconv.GradientDescentDeconv(None, forward=port) \
        .backward_from_saved(pparams, (torch.from_numpy(x), got),
                             torch.from_numpy(err))
    _close(got_in, want_in)
    _close(params_to_jax({"d": {"weights": got_g["weights"].numpy()}})
           ["d"]["weights"], want_g["weights"])
    _close(got_g["bias"], want_g["bias"])


def test_deconv_weights_cross_convert_both_ways():
    """(ky, kx, n_out, C_in) -> (C_in, n_out, ky, kx) and back, bitwise,
    and the init draw at the fan-in ky * kx * C_in is the reference's."""
    w = np.arange(5 * 3 * 2 * 4, dtype=np.float32).reshape(5, 3, 2, 4)
    port = params_from_jax({"d": {"weights": w}})["d"]["weights"]
    np.testing.assert_array_equal(port, w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        params_to_jax({"d": {"weights": port}})["d"]["weights"], w)
    unit = deconv.Deconv(None, n_kernels=2, kx=3, ky=5)
    unit.initialize((1, 6, 6, 4))
    assert unit.weight_fan_in((5, 3, 2, 4)) == 5 * 3 * 4
    gen = np.random.default_rng(0)
    std = 1.0 / np.sqrt(60)
    want = gen.uniform(-std * np.sqrt(3), std * np.sqrt(3), (5, 3, 2, 4))
    got = unit.fill_params(np.random.default_rng(0))
    np.testing.assert_array_equal(got["weights"], params_from_jax(
        {"d": {"weights": want.astype(np.float32)}})["d"]["weights"])


def test_evaluator_mse_is_the_references():
    rng = np.random.default_rng(5)
    y = rng.standard_normal((6, 4, 4, 2)).astype(np.float32)
    t = rng.standard_normal((6, 4, 4, 2)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    want = RefEvaluatorMSE(None).metrics_fn(
        jnp.asarray(y), jnp.asarray(t), jnp.asarray(mask))
    got = EvaluatorMSE(None).metrics_fn(
        torch.from_numpy(y), torch.from_numpy(t), torch.from_numpy(mask))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=0)
    assert float(got["n_err"]) == 0.0 and float(got["count"]) == 4.0
    assert not got["err_output"][4:].any()


# -- aliased targets in the loader -------------------------------------------

def _byte_splits(n_train=40, n_valid=8, shape=(4, 4, 2), seed=9):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n_train + n_valid,) + shape).astype(np.uint8)
    y = rng.integers(0, 3, n_train + n_valid).astype(np.int32)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


@pytest.mark.parametrize("norm", ["none", "linear", "mean_disp"])
def test_aliased_targets_follow_the_references_rule(norm):
    train, valid = _byte_splits()
    kw = dict(train=train, valid=valid, targets_from_labels=True,
              normalization_type=norm, name="loader")
    port = ArrayLoader(None, **kw)
    port.initialize(make_device("cpu"))
    ref = RefArrayLoader(None, **kw)
    ref.initialize(device=JaxDevice(platform="cpu"))
    assert port.dequant is None and ref.dequant is None
    assert port.has_targets and ref.has_targets
    assert port.original_targets is port.original_data
    want = ref.original_targets.map_read()
    np.testing.assert_array_equal(want, ref.original_data.map_read())
    got = port.device.get(port.original_targets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for cls in (ArrayLoader, RefArrayLoader):
        ld = cls(None, train=train, valid=valid, targets_from_labels=True,
                 normalization_type=norm, quantized_ingest=True)
        ld.load_data()
        with pytest.raises(ValueError,
                           match="targets alias the input data"):
            ld.post_load_data()


# -- mnist_ae against the reference ----------------------------------------

LOADER = {"minibatch_size": 25, "n_train": 200, "n_valid": 50}
EPOCHS = 2


@pytest.fixture(scope="module")
def mnist_ae_runs(tmp_path_factory):
    """The reference's run, and the port's resident and streamed runs,
    from one set of IDX files."""
    saved = dict(root.__dict__)
    path = tmp_path_factory.mktemp("mnist_ae")
    datasets.generate_mnist_idx(str(path / "mnist"), 240, 60)
    runs = {}
    decision = {"max_epochs": EPOCHS, "fail_iterations": 50}
    with data_dir_in_both(path):
        _seed_both(SEED)
        runs["ref"] = _run(ref_mnist_ae.create_workflow(
            _FL(), loader=dict(LOADER), decision=decision), _ref_init)
        for name, extra in (("resident", {}),
                            ("stream", {"max_resident_bytes": 0})):
            _seed_both(SEED)
            w = mnist_ae.create_workflow(
                _FL(), loader=dict(LOADER, **extra), decision=decision)
            runs[name] = (w, _run(w, _port_init))
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)
    return runs


def test_mnist_ae_keeps_the_references_defaults():
    assert mnist_ae.DEFAULTS == ref_mnist_ae.DEFAULTS


@pytest.mark.parametrize("path", ["resident", "stream"])
def test_mnist_ae_trains_as_the_reference(mnist_ae_runs, path):
    w, port = mnist_ae_runs[path]
    ld = w.loader
    assert ld.class_lengths == [0, LOADER["n_valid"], LOADER["n_train"]]
    assert ld.device_resident == (path == "resident")
    assert ld.dequant is None and ld.has_targets
    assert [f.output_shape[1:] for f in w.forwards] == \
        [(28, 28, 9), (14, 14, 9), (28, 28, 9), (28, 28, 1)]
    assert_reference_rule(mnist_ae_runs["ref"], port)
    assert all(h["n_err"] == 0 for h in port[2])
    valid = [h["loss"] for h in port[2] if h["class"] == "validation"]
    assert valid[-1] < valid[0]


def test_streamed_mnist_ae_ships_f32_pixels_and_targets(mnist_ae_runs):
    w, _ = mnist_ae_runs["stream"]
    per_epoch = -(-LOADER["n_valid"] // 25) + -(-LOADER["n_train"] // 25)
    rows = EPOCHS * per_epoch * 25
    assert w.fused.stream_transfer_bytes == rows * (784 * 4 + 784 * 4)
    ld = w.loader
    ld.run()
    assert ld.superstep_targets.dtype == torch.float32
    np.testing.assert_array_equal(ld.superstep_targets.numpy(),
                                  ld.superstep_data.numpy())
    ld.stop()


# -- the stored dtype (the loader's f32 widening, repaired) -----------------

LAYERS = [{"type": "softmax", "->": {"output_sample_shape": 3},
           "<-": {"learning_rate": 0.01}}]


def _small_set(dtype):
    rng = np.random.default_rng(21)
    x = rng.integers(0, 4, (64, 4, 4, 3)).astype(dtype)
    y = rng.integers(0, 3, 64).astype(np.int32)
    return (x[:48], y[:48]), (x[48:], y[48:])


def _stored_dtype_run(cls, loader_cls, init, dtype, budget):
    train, valid = _small_set(dtype)
    w = cls(loader_factory=lambda wf: loader_cls(
        wf, train=train, valid=valid, minibatch_size=16, name="loader",
        quantized_ingest=False, max_resident_bytes=budget),
        layers=LAYERS, decision_config={"max_epochs": 1}, name="bytes")
    _seed_both(SEED)
    return w, _run(w, init)


@pytest.mark.parametrize("dtype", [np.uint8, np.float64])
def test_stored_dtype_is_charged_kept_and_streamed_as_the_references(dtype):
    """The repro of the widening fault: the budget charges the stored
    bytes; resident, a uint8 set stays bytes on the device (a float64 set
    goes up as f32); streamed, bytes cross at 1 byte a pixel and float64
    as f32, as the reference's wire.  Labels cross as int64 in the port
    (the index type) where the reference ships int32."""
    stored = 64 * 4 * 4 * 3 * np.dtype(dtype).itemsize
    for budget, resident in ((stored, True), (stored - 1, False)):
        rw, ref = _stored_dtype_run(RefWorkflow, RefArrayLoader, _ref_init,
                                    dtype, budget)
        pw, port = _stored_dtype_run(StandardWorkflow, ArrayLoader,
                                     _port_init, dtype, budget)
        assert pw.loader.device_resident == rw.loader.device_resident == \
            resident
        assert rw.loader.original_data.mem.dtype == dtype
        if resident:
            want = torch.uint8 if dtype == np.uint8 else torch.float32
            assert pw.loader.original_data.dtype == want
            assert pw.fused.stream_transfer_bytes == 0
        else:
            assert pw.loader.host_data.dtype == dtype
            rows = 4 * 16
            assert pw.fused.stream_transfer_bytes - 8 * rows == \
                rw.fused.stream_transfer_bytes - 4 * rows == \
                rows * 48 * min(np.dtype(dtype).itemsize, 4)
        assert_reference_rule(ref, port)


# -- the command line --------------------------------------------------------

def test_cli_trains_mnist_ae_from_idx_files(tmp_path):
    datasets.generate_mnist_idx(str(tmp_path / "mnist"), 100, 30)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s", "5",
         "veles_tpu_torch/models/mnist_ae.py",
         f"root.common.data_dir={tmp_path}",
         "root.mnist_ae.loader={'minibatch_size': 50, 'n_train': 1000, "
         "'n_valid': 1000}",
         "root.mnist_ae.decision={'max_epochs': 1}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "epoch 1 train: n_err=0" in proc.stderr
    assert "complete: reached max_epochs=1" in proc.stderr
    assert "wall-clock: 100 train + 30 eval images" in proc.stderr


def test_a_loader_pickled_before_targets_were_ported_loads():
    """A snapshot's loader from before regression targets were ported
    (no target attributes) resumes as a set without targets."""
    import pickle
    train, valid = _byte_splits()
    ld = ArrayLoader(None, train=train, valid=valid, name="loader")
    state = ld.__getstate__()
    for key in ("host_targets", "original_targets", "superstep_targets",
                "_targets_from_labels"):
        del state[key]
    old = ArrayLoader.__new__(ArrayLoader)
    old.__setstate__(state)
    old = pickle.loads(pickle.dumps(old))
    old.initialize(make_device("cpu"))
    assert not old.has_targets and old.original_targets is None
    assert old.superstep_targets is None
