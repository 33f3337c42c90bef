"""The GA evaluator's ``--dp N`` in the port (``python -m
veles_tpu_torch.genetics.worker --serve --dp N``, the reference's
``genetics/worker.py:198-211``, ``:473-479``) on the CPU:

- one cohort job of 3 wine genomes (the first layer's learning rate the
  gene) answered by a ``--dp 2`` evaluator and a one-device one: the same
  fitnesses, the hello's ``places`` 2 and 1, each chunk's ``places`` and
  a cap twice the one-device one's (the reference's ``_hbm_cohort_cap``
  at ``n_devices`` 2 and 1), and each member's ``change_norms`` equal;
- ``--dp 2 -b cuda`` without the cards exits 2 before its hello, naming
  ``$VELES_MESH_RANKS_PER_CARD``.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = '''
from veles_tpu_torch.config import root
from veles_tpu_torch.genetics import Tune
root.wine.decision = {"max_epochs": 3, "fail_iterations": 50}
root.wine.layers = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": Tune(0.1, 0.01, 1.0),
            "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}]
'''
GENE = "wine.layers[0]['<-']['learning_rate']"


def _evaluator(cfg, dp, backend="cpu", env=None, jobs=()):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.genetics.worker", "--serve",
         os.path.join(REPO, "veles_tpu_torch", "models", "wine.py"), cfg,
         "-b", backend, "-s", "7", "--dp", str(dp), "--heartbeat-every",
         "0"], input="".join(json.dumps(j) + "\n" for j in jobs),
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))


@pytest.fixture
def cfg(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text(CONFIG)
    return str(path)


def test_a_dp_evaluator_scores_its_cohort_as_one_device_does(cfg):
    from veles_tpu.genetics.worker import _hbm_cohort_cap as ref_cap
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics.core import find_tunes
    from veles_tpu_torch.launcher import apply_config_file
    saved = dict(root.__dict__)
    try:
        apply_config_file(cfg)
        assert list(find_tunes(root)) == [GENE]
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)
    job = {"id": 1, "members": [{GENE: v} for v in (0.1, 0.05, 0.3)],
           "seed": 7}
    out = {}
    with ThreadPoolExecutor(2) as tp:
        runs = {dp: tp.submit(_evaluator, cfg, dp, jobs=[job])
                for dp in (2, 0)}
    for dp in (2, 0):
        p = runs[dp].result()
        assert p.returncode == 0, p.stderr[-3000:]
        lines = [json.loads(ln) for ln in p.stdout.splitlines()]
        hello = lines[0]
        (res,) = [m for m in lines if m.get("id") == 1]
        assert res["fallbacks"] == 0
        (chunk,) = res["stats"]
        out[dp] = (hello, res, chunk)
    assert out[2][0]["places"] == 2 and out[0][0]["places"] == 1
    assert out[2][1]["fitnesses"] == out[0][1]["fitnesses"]
    assert out[2][2]["places"] == 2 and out[0][2]["places"] == 1
    assert out[2][2]["members"] == 3
    assert not any(out[2][2]["kernel_launches"].values())
    # each member's distance from its start, leaf by leaf: the same
    # members trained alike on either placement, each its own distance
    norms = {dp: np.asarray(out[dp][2]["change_norms"]) for dp in (2, 0)}
    assert norms[2].shape == (3, 4)
    np.testing.assert_allclose(norms[2], norms[0], rtol=1e-4, atol=5e-6)
    assert len(set(np.round(norms[0][:, 0], 6))) == 3
    # the cap: 2 places' worth of the same budget, as the reference's
    cap1, cap2 = out[0][2]["cap"], out[2][2]["cap"]
    assert cap2 in (2 * cap1, 2 * cap1 + 1)
    assert [cap1, cap2] == [ref_cap(_ref_workflow(), 0, n_devices=n)
                            for n in (1, 2)]


def _ref_workflow():
    """The reference's wine net of the config (13 -> 8 -> 3)."""
    from veles_tpu.backends import JaxDevice
    from veles_tpu.models import wine as ref_wine

    class FL:
        workflow = None

    rw = ref_wine.create_workflow(FL(), layers=[
        {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}])
    rw.initialize(device=JaxDevice(platform="cpu"))
    return rw


def test_a_dp_evaluator_without_the_cards_exits_2(cfg):
    p = _evaluator(cfg, 2, backend="cuda", env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2, p.stderr[-2000:]
    assert "--dp 2" in p.stderr and "VELES_MESH_RANKS_PER_CARD" in p.stderr
    assert "ready" not in p.stdout
