"""The evaluator pool's hang supervision in the port
(``genetics/pool.py``), on wine through ``genetics/worker.py --serve -b
cpu``: a genome that hangs the evaluator (it sleeps in its workflow's
``create_workflow``) is caught, the evaluator replaced, the genome
retried once and then scored inf, and the others score as usual.

- With heartbeats off, silence past ``heartbeat_deadline`` (2 s) is the
  signal (``last_hang_kind`` "heartbeat").
- With heartbeats flowing, the adaptive per-genome deadline is: once a
  genome has finished, the in-flight one may run ``max(
  min_genome_deadline, ema * genome_deadline_factor)`` (here 2 s) before
  it is declared hung ("genome_deadline").
"""

import sys
import time

import numpy as np
import pytest

from torch_ga_fixtures import LR, WIDTH, write_files
from veles_tpu_torch.genetics.pool import ChipEvaluatorPool

GENOMES = [{WIDTH: 8, LR: 0.3}, {WIDTH: 8, LR: 0.95}, {WIDTH: 8, LR: 0.2}]


@pytest.mark.parametrize("heartbeat_every,kind", [(0, "heartbeat"),
                                                  (0.5, "genome_deadline")])
def test_a_hung_genome_is_caught_retried_and_scored_inf(
        tmp_path, monkeypatch, heartbeat_every, kind):
    wf, cfg = write_files(tmp_path)
    monkeypatch.setenv("GA_TEST_HANG_ABOVE", "0.9")
    cmd = [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
           "--serve", wf, cfg, "-b", "cpu", "--heartbeat-every",
           str(heartbeat_every)]
    with ChipEvaluatorPool(cmd, workers=1, timeout=300,
                           heartbeat_deadline=2.0 if kind == "heartbeat"
                           else 60.0,
                           min_genome_deadline=2.0,
                           restart_backoff=0.05) as pool:
        t0 = time.monotonic()
        fits = pool.evaluate_many(GENOMES)
        elapsed = time.monotonic() - t0
        assert np.isfinite(fits[0]) and np.isfinite(fits[2])
        assert fits[1] == float("inf")
        assert pool.hangs_detected == 2 and pool.last_hang_kind == kind
        assert pool.genome_retries == 1 and pool.genomes_lost == 1
        assert pool.restarts == 2
        # caught in seconds, far inside the 60 s the genome sleeps
        assert elapsed < 45.0
