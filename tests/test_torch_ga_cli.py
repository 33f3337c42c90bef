"""``python -m veles_tpu_torch --optimize`` in the port's execution
modes, on wine (1 epoch a genome).

- ``-b cpu --optimize 3:1``: the CPU fan-out, one
  ``genetics.worker --values`` subprocess a genome; a finite best
  fitness, no cohorts, no evaluator.
- ``-b cpu-evaluator --optimize 4:1``: one evaluator process, genomes
  bucketed by shape signature (``cohorts:`` on stderr); every genome
  of a generation in one cohort when only liftable genes vary.
- ``-b auto`` without a card: exit 1 with a message that names the CUDA
  card (no CPU fallback); ``-b cpu-evaluator`` outside ``--optimize`` is
  a usage error; a config without Tune markers is refused.
- The one-shot worker prints ``{"fitness": ...}`` for ``--values``.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_ga_fixtures import LR, REPO, WIDTH, write_files


def _optimize(args, files, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", *args, *files],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_cpu_fan_out(tmp_path):
    res = _optimize(["-b", "cpu", "--optimize", "3:1", "--ga-workers",
                     "3"], write_files(tmp_path, epochs=1))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["fitness"]) and set(out["best"]) == {LR, WIDTH}
    assert out["cohort_sizes"] == [] and "evaluator" not in out
    # the population is at least 2 + elite = 4; then 2 children a
    # generation beside the 2 elites
    assert out["evaluations"] == 4 + 2
    assert "cohorts:" not in res.stderr


@pytest.mark.parametrize("tune_width", [True, False])
def test_cpu_evaluator_runs_cohorts(tmp_path, tune_width):
    res = _optimize(["-b", "cpu-evaluator", "--optimize", "4:1",
                     "--ga-workers", "2"],
                    write_files(tmp_path, epochs=1, tune_width=tune_width))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "cohorts:" in res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["fitness"])
    assert [sum(s) for s in out["cohort_sizes"]] == [4, 2]
    if not tune_width:
        assert out["cohort_sizes"] == [[4], [2]]
    ev = out["evaluator"]
    assert ev["platform"] == "cpu" and ev["fallbacks"] == 0
    assert out["cohort_fallbacks"] == 0 and ev["restarts"] == 0


def test_auto_without_a_card_fails_naming_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: -b auto would use it")
    res = _optimize(["--optimize", "2:1"], write_files(tmp_path, epochs=1),
                    timeout=120)
    assert res.returncode == 1
    assert "CUDA card" in res.stderr and res.stdout.strip() == ""


def test_usage_errors(tmp_path):
    files = write_files(tmp_path, epochs=1)
    res = _optimize(["-b", "cpu-evaluator"], files, timeout=120)
    assert res.returncode == 2 and "--optimize only" in res.stderr
    plain = tmp_path / "plain.py"
    plain.write_text("from veles_tpu_torch.config import root\n"
                     "root.wine.decision = {'max_epochs': 1}\n")
    res = _optimize(["-b", "cpu", "--optimize", "2:1"], [files[0],
                                                         str(plain)],
                    timeout=120)
    assert res.returncode == 2 and "no Tune" in res.stderr


def test_one_shot_worker(tmp_path):
    wf, cfg = write_files(tmp_path, epochs=1)
    res = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.genetics.worker", wf, cfg,
         "-b", "cpu", "--values", json.dumps({WIDTH: 8, LR: 0.3})],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["fitness"]) and out["seconds"] > 0.0
