"""The port's evaluator pool (``genetics/pool.py``) and its serve-mode
worker (``genetics/worker.py --serve -b cpu``) on wine, 2 epochs a
genome.

- The hello line names the device the evaluator got (the CPU here).
- A cohort of two same-signature genomes, trained as one population
  batch, equals their per-genome results within atol 1e-3 (the
  reference's pin); a singleton cohort too; a member whose decode gives
  another structure scores inf without poisoning the others.
- A failing batched cohort is split and retried (a CUDA out-of-memory
  error alike); a failing singleton trains per genome; the pool reports
  every split and per-genome fallback in ``fallbacks``, and the answers
  still equal the per-genome ones.
- The evaluator's death: a genome whose first run kills the evaluator
  is retried once on a fresh one and scores; a genome that kills it
  twice scores inf; the pool counts the retries, the lost genome and
  the restarts, and the other genomes score as usual.
"""

import sys

import numpy as np
import pytest

from torch_ga_fixtures import LR, WIDTH, write_files
from veles_tpu_torch.genetics.pool import ChipEvaluatorPool


def _serve_cmd(wf, cfg):
    return [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
            "--serve", wf, cfg, "-b", "cpu", "-s", "1234",
            "--heartbeat-every", "1"]


@pytest.fixture
def files(tmp_path, monkeypatch):
    for var in ("GA_TEST_DIE_ABOVE", "GA_TEST_DIE_ONCE_MARKER",
                "GA_TEST_COHORT_FAILS"):
        monkeypatch.delenv(var, raising=False)
    return write_files(tmp_path)


COHORT = [{WIDTH: 8, LR: 0.3}, {WIDTH: 8, LR: 0.05}]
SINGLETON = [{WIDTH: 12, LR: 0.3}]


def test_cohort_equals_per_genome_and_isolates_a_bad_member(files):
    with ChipEvaluatorPool(_serve_cmd(*files), workers=2,
                           timeout=300) as pool:
        assert pool.platform == "cpu" and not pool.is_accelerator
        assert pool.device_name == "cpu"
        oracle = pool.evaluate_many(COHORT + SINGLETON)
        batched = pool.evaluate_cohort(COHORT) + \
            pool.evaluate_cohort(SINGLETON)
        assert all(np.isfinite(f) for f in oracle), oracle
        assert np.allclose(batched, oracle, atol=1e-3), (batched, oracle)
        mixed = pool.evaluate_cohort([COHORT[0], {WIDTH: -5, LR: 0.1},
                                      COHORT[1]])
        assert mixed[1] == float("inf")
        assert np.allclose([mixed[0], mixed[2]], oracle[:2], atol=1e-3)
        assert pool.fallbacks == 0 and pool.restarts == 0
        assert [s["members"] for s in pool.cohort_stats] == [2, 1, 2]
        assert all(s["minibatches"] > 0 for s in pool.cohort_stats)


@pytest.mark.parametrize("mode,fallbacks", [("batched", 1), ("oom", 1),
                                            ("all", 3)])
def test_failing_cohorts_split_and_are_counted(files, monkeypatch, mode,
                                               fallbacks):
    with ChipEvaluatorPool(_serve_cmd(*files), workers=1,
                           timeout=300) as pool:
        oracle = pool.evaluate_many(COHORT)
    monkeypatch.setenv("GA_TEST_COHORT_FAILS",
                       "1" if mode == "batched" else mode)
    with ChipEvaluatorPool(_serve_cmd(*files), workers=1,
                           timeout=300) as pool:
        got = pool.evaluate_cohort(COHORT)
        # the split halves train as cohorts of one; with "all" those fail
        # too and each trains per genome
        assert pool.fallbacks == fallbacks
        assert [s["members"] for s in pool.cohort_stats] == \
            ([] if mode == "all" else [1, 1])
    assert np.allclose(got, oracle, atol=1e-3), (got, oracle)


def test_evaluator_death_retries_once_then_scores_inf(files, tmp_path,
                                                       monkeypatch):
    wf, cfg = files
    monkeypatch.setenv("GA_TEST_DIE_ABOVE", "0.9")
    monkeypatch.setenv("GA_TEST_DIE_ONCE_MARKER", str(tmp_path / "died"))
    genomes = [{WIDTH: 8, LR: 0.3}, {WIDTH: 8, LR: 0.55},
               {WIDTH: 8, LR: 0.95}, {WIDTH: 8, LR: 0.2}]
    with ChipEvaluatorPool(_serve_cmd(wf, cfg), workers=2, timeout=300,
                           restart_backoff=0.05) as pool:
        fits = pool.evaluate_many(genomes)
        assert (tmp_path / "died").exists()
        assert np.isfinite(fits[0]) and np.isfinite(fits[1])
        assert fits[2] == float("inf") and np.isfinite(fits[3])
        assert pool.genome_retries == 2 and pool.genomes_lost == 1
        assert pool.restarts == 3
        # the evaluator is up again and answers as before
        again = pool.evaluate_many([genomes[0], genomes[1]])
        assert np.allclose(again, fits[:2], atol=1e-3)
