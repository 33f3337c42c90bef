"""The port's scaling model (``veles_tpu_torch/tools/scaling_model.py``)
against the reference's ``scripts/scaling_model.py``: AlexNet-1000's
param bytes and the row-sharded residency prediction equal, the
all-reduce arithmetic the reference's, and no step time of another
device as a default."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from veles_tpu_torch.tools import scaling_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def reference_module():
    path = os.path.join(REPO, "scripts", "scaling_model.py")
    spec = importlib.util.spec_from_file_location("ref_scaling_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return reference_module()


def test_alexnet_param_bytes_equal_the_reference(ref):
    from veles_tpu import prng
    from veles_tpu.backends import NumpyDevice
    from veles_tpu.loader.synthetic import SyntheticClassificationLoader
    from veles_tpu.models.alexnet import alexnet_layers
    from veles_tpu.ops.standard_workflow import StandardWorkflow

    prng.seed_all(1)
    w = StandardWorkflow(
        loader_factory=lambda wf: SyntheticClassificationLoader(
            wf, name="loader", minibatch_size=8, n_train=16, n_valid=0,
            shape=(227, 227, 3), n_classes=1000, seed=1),
        layers=alexnet_layers(1000), loss_function="softmax",
        decision_config={"max_epochs": 1}, name="ScalingModel")
    w.initialize(device=NumpyDevice())
    want = ref.param_bytes(list(w.forwards))
    got = scaling_model.param_bytes(scaling_model.alexnet_forwards())
    assert got == want == 62378344 * 4


@pytest.mark.parametrize("n_rows,row_bytes,n_devices", [
    (1024, 227 * 227 * 3 * 4, 8), (1000, 7, 3), (5, 1, 8), (672, 152, 2)])
def test_sharded_residency_equals_the_reference(ref, n_rows, row_bytes,
                                                n_devices):
    assert scaling_model.sharded_residency_prediction(
        n_rows, row_bytes, n_devices) == ref.sharded_residency_prediction(
        n_rows, row_bytes, n_devices)


def test_rows_follow_the_reference_arithmetic():
    b, step_ms, n = 249513376, 8.5, 8
    assert scaling_model.N_CARDS == n     # the reference's ring
    (nv, pcie) = scaling_model.scaling_rows(b, step_ms)
    traffic = 2.0 * b * (n - 1) / n
    for row, rate in ((nv, 450e9), (pcie, 64e9)):
        t = traffic / rate * 1000.0
        assert row["t_comm_ms"] == round(t, 3)
        assert row["scaling_x_zero_overlap"] == round(
            n * step_ms / (step_ms + t), 3)
        assert row["scaling_x_full_overlap"] == n
    assert nv["scaling_x_zero_overlap"] > pcie["scaling_x_zero_overlap"]


def test_no_tpu_default_and_the_card_is_named():
    src = open(scaling_model.__file__).read()
    assert "14029" not in src and "ici_" not in src.lower()
    for bad in (dict(step_ms=0.0, card=CARD), dict(step_ms=8.5, card="")):
        with pytest.raises(ValueError):
            scaling_model.model(**bad, forwards=[])
    out = scaling_model.model(8.5, CARD, forwards=[])
    assert out["measured_on"] == CARD and "spec" in out["links_are"]
    assert [r["link"] for r in out["rows"]] == ["nvlink4_sxm",
                                                "pcie_gen5_x16"]


def test_cli_needs_a_measured_step_and_prints_json():
    cmd = [sys.executable, "-m", "veles_tpu_torch.tools.scaling_model"]
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 2 and "--step-ms" in p.stderr
    p = subprocess.run(cmd + ["--step-ms", "8.5", "--card", CARD], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout)
    assert out["param_bytes_f32"] == 62378344 * 4
    assert out["sharded_residency"]["n_rows"] == 1024
