"""Ensembles in the port (``veles_tpu_torch/ensemble/``, and
``EnsembleEvalEngine``'s scoring paths) against the JAX package's.

- ``EnsembleTrainer`` on wine (2 members, seeds ``base + 7919 i``)
  against the reference's: the same seeds, validation errors and member
  params within rtol 1e-4 / atol 1e-5 (the port's training-parity bar,
  ``tests/test_torch_zoo.py``), written in the reference's layout.
- ``EnsemblePredictor`` over the same members in both packages: mean
  probabilities within 1e-5 and the same error %, through the engine
  (``device="auto"``) and the CPU member loop (``"host"``).
- A members npz the reference saved loads into the port and predicts
  what the reference predicts (the conv layer's HWIO kernels converted
  at load), and one the port saved loads into the reference.
- The engine's ``error_pct`` (chunks with a padded, masked tail) and
  ``error_pct_resident`` (an attached split) equal the host oracle's
  wrong count; ``predict_proba_resident`` equals ``predict_proba``.
- ``normalize_npz_path`` is the reference's rule; ``from_ga`` seeds the
  members from a GA's final generation.
- ``python -m veles_tpu_torch -b cpu --ensemble-train 2 --ensemble-test``
  on wine, and ``--ensemble-test --ensemble-device host`` on the file it
  wrote: the same ensemble error.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_train import _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.ensemble import EnsemblePredictor as RefPredictor
from veles_tpu.ensemble import EnsembleTrainer as RefTrainer
from veles_tpu.ensemble import load_members as ref_load_members
from veles_tpu.ensemble import normalize_npz_path as ref_normalize
from veles_tpu.ensemble import save_members as ref_save_members
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu.loader.synthetic import \
    SyntheticClassificationLoader as RefLoader
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.ensemble import (EnsemblePredictor, EnsembleTrainer,
                                      load_members, normalize_npz_path,
                                      save_members)
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.models import wine
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3


class _FL:
    workflow = None


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _port_wine():
    return wine.create_workflow(_FL(), decision={"max_epochs": EPOCHS})


def _ref_wine():
    return ref_wine.create_workflow(_FL(), decision={"max_epochs": EPOCHS})


def _cpu():
    return make_device("cpu")


def _ref_cpu():
    return JaxDevice(platform="cpu")


def _valid_split(pred):
    ld = pred.workflow.loader
    off, n = ld.class_offset(VALID), ld.class_lengths[VALID]
    x = ld.normalized_host_rows(slice(off, off + n))
    y = pred.workflow.device.get(ld.original_labels[off:off + n])
    return x, y


@pytest.fixture(scope="module")
def trained():
    """Both packages' 2-member wine ensembles, trained once."""
    _seed_both(1234)
    ref = RefTrainer(_ref_wine, _ref_cpu, n_members=2, base_seed=555)
    ref_members = ref.train()
    port = EnsembleTrainer(_port_wine, _cpu, n_members=2, base_seed=555)
    members = port.train()
    prng._streams.clear()
    return ref_members, members


def test_trainer_is_the_references(trained):
    ref_members, members = trained
    assert [m["seed"] for m in members] == [555, 555 + 7919]
    assert [m["seed"] for m in members] == [m["seed"] for m in ref_members]
    for m, r in zip(members, ref_members):
        assert m["valid_error"] == pytest.approx(r["valid_error"])
        assert m["forward_names"] == r["forward_names"]
        for fn, ps in r["params"].items():
            for pn, a in ps.items():
                np.testing.assert_allclose(m["params"][fn][pn], a,
                                           rtol=1e-4, atol=1e-5)
    w0 = members[0]["params"]["fwd0_all2all_tanh"]["weights"]
    w1 = members[1]["params"]["fwd0_all2all_tanh"]["weights"]
    assert not np.allclose(w0, w1)


@pytest.mark.parametrize("device", ["auto", "host"])
def test_predictor_is_the_references(trained, device):
    ref_members, _ = trained
    ref = RefPredictor(_ref_wine, _ref_cpu, ref_members, device="host")
    port = EnsemblePredictor(_port_wine, _cpu, ref_members, device=device)
    assert (port.engine is not None) == (device == "auto")
    x, y = _valid_split(port)
    np.testing.assert_allclose(port.predict_proba(x),
                               ref.predict_proba(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.predict_proba(x).sum(-1), 1.0,
                               atol=1e-5)
    assert port.error_pct(x, y, chunk=16) == ref.error_pct(x, y, chunk=16)
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_members_npz_crosses_packages(tmp_path, writer):
    """A conv net (HWIO kernels in the file, OIHW in the port)."""
    layers = [{"type": "conv_relu", "->": {"n_kernels": 4, "kx": 3,
                                           "ky": 3, "padding": 1},
               "<-": {"learning_rate": 0.05}},
              {"type": "max_pooling", "->": {"kx": 2, "ky": 2}, "<-": {}},
              {"type": "softmax", "->": {"output_sample_shape": 3},
               "<-": {"learning_rate": 0.05}}]
    lcfg = dict(n_train=60, n_valid=30, shape=(8, 8, 2), n_classes=3,
                minibatch_size=10, seed=3)

    def ref_factory():
        return RefWorkflow(loader_factory=lambda wf: RefLoader(
            wf, name="loader", **lcfg), layers=layers,
            decision_config={"max_epochs": 2}, name="conv")

    def port_factory():
        return StandardWorkflow(loader_factory=lambda wf:
                                SyntheticClassificationLoader(
                                    wf, name="loader", **lcfg),
                                layers=layers,
                                decision_config={"max_epochs": 2},
                                name="conv")
    path = str(tmp_path / "ensemble")
    _seed_both(77)
    if writer == "reference":
        members = RefTrainer(ref_factory, _ref_cpu, n_members=2).train()
        real = ref_save_members(path, members)
        loaded = load_members(normalize_npz_path(path))
    else:
        members = EnsembleTrainer(port_factory, _cpu, n_members=2).train()
        real = save_members(path, members)
        loaded = ref_load_members(ref_normalize(path))
    assert real == path + ".npz"
    ref = RefPredictor(ref_factory, _ref_cpu, loaded if writer == "port"
                       else members, device="host")
    port = EnsemblePredictor(port_factory, _cpu, loaded
                             if writer == "reference" else members)
    assert loaded[0]["params"]["fwd1_max_pooling"] == {}
    x, y = _valid_split(port)
    np.testing.assert_allclose(port.predict_proba(x), ref.predict_proba(x),
                               rtol=1e-5, atol=1e-5)
    assert port.error_pct(x, y) == ref.error_pct(x, y)


def test_engine_scoring_equals_the_host_oracle(trained):
    _, members = trained
    pred = EnsemblePredictor(_port_wine, _cpu, members)
    eng = pred.engine
    x, y = _valid_split(pred)
    wrong = int((np.argmax(pred.predict_proba_host(x), -1) != y).sum())
    want = 100.0 * wrong / len(x)
    for chunk in (5, 16, 38, 256):      # 38 rows: ragged tails and none
        assert eng.error_pct(x, y, chunk=chunk) == pytest.approx(want)
    with pytest.raises(RuntimeError):
        eng.error_pct_resident()
    eng.attach_dataset(x, y)
    assert eng.error_pct_resident(chunk=16) == pytest.approx(want)
    head = int((np.argmax(pred.predict_proba_host(x[:20]), -1)
                != y[:20]).sum())
    assert eng.error_pct_resident(n=20, chunk=7) == \
        pytest.approx(100.0 * head / 20)
    idx = [3, 0, 17, 17]
    np.testing.assert_allclose(eng.predict_proba_resident(idx),
                               eng.predict_proba(x[idx]), rtol=1e-6,
                               atol=1e-7)
    eng.release()
    assert eng._dataset is None


@pytest.mark.parametrize("path", ["a/b", "a/b.npz", "ens", "x.npz.npz",
                                  "y.NPZ"])
def test_normalize_npz_path_is_the_references(path):
    assert normalize_npz_path(path) == ref_normalize(path)


def test_from_ga_and_bad_arguments():
    class Opt:
        history = []
    with pytest.raises(ValueError, match="history"):
        EnsembleTrainer.from_ga(Opt(), lambda v: None, lambda: None)
    Opt.history = [[(1.0, {"lr": 0.5})],
                   [(0.5, {"lr": 0.2}), (0.7, {"lr": 0.3}),
                    (0.9, {"lr": 0.4})]]
    seen = []

    def factory(values):
        seen.append(values)
        return wine.create_workflow(_FL(), decision={"max_epochs": 1},
                                    layers=[
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": values["lr"]}}])
    trainer = EnsembleTrainer.from_ga(Opt(), factory, _cpu, k=2)
    members = trainer.train()
    assert seen == [{"lr": 0.2}, {"lr": 0.3}]
    assert [m["values"] for m in members] == seen
    with pytest.raises(ValueError, match="empty"):
        EnsemblePredictor(_port_wine, _cpu, [])
    with pytest.raises(ValueError):
        EnsemblePredictor(_port_wine, _cpu, members, device="tpu")


def test_cli_ensemble_train_and_test(tmp_path):
    path = str(tmp_path / "members")
    common = [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
              "--ensemble-file", path,
              os.path.join(REPO, "veles_tpu_torch", "models", "wine.py"),
              "root.wine.decision.max_epochs=2"]
    res = subprocess.run(common + ["--ensemble-train", "2",
                                   "--ensemble-test"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    train, test = [json.loads(ln) for ln in res.stdout.strip().splitlines()
                   if ln.startswith("{")]
    assert train["members"] == 2 and train["file"] == path + ".npz"
    assert test["ensemble_eval_engine"] == "device"
    res = subprocess.run(common + ["--ensemble-test", "--ensemble-device",
                                   "host"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    host = json.loads(res.stdout.strip().splitlines()[-1])
    assert host["ensemble_eval_engine"] == "host"
    assert host["ensemble_valid_error_pct"] == \
        test["ensemble_valid_error_pct"]
    assert host["member_valid_errors_pct"] == \
        train["member_valid_errors_pct"]
    res = subprocess.run(common[:6] + [str(tmp_path / "none")] +
                         common[7:] + ["--ensemble-test"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "does not exist" in res.stderr
