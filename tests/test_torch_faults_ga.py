"""The GA's fault sites in the port, armed through ``$VELES_FAULTS`` as
the reference's ``tests/test_faultline.py`` arms them:
``evaluator.garbage_line`` and ``evaluator.hang`` in a real ``-b cpu``
evaluator (noise before a result, then a silent hang caught by the
heartbeat deadline, each dead evaluator's telemetry merged into the
pool's), and ``preempt.sigterm`` through ``--optimize`` (a stop at the
generation boundary, exit 14).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_ga_fixtures import LR, WIDTH, write_files
from veles_tpu_torch import faults, knobs, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(knobs.GA_GENERATION, raising=False)
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    yield
    faults.arm("")
    telemetry.configure(None)
    if saved is not None:
        os.environ[telemetry.ENV_DIR] = saved
    telemetry.reset()


GENOMES = [{WIDTH: 8, LR: 0.3}, {WIDTH: 8, LR: 0.5}, {WIDTH: 8, LR: 0.2}]


def test_evaluator_garbage_line_and_hang_with_merged_telemetry(
        tmp_path, monkeypatch):
    from veles_tpu_torch.genetics.pool import ChipEvaluatorPool
    wf, cfg = write_files(tmp_path, epochs=1)
    telemetry.configure(str(tmp_path / "m"))
    monkeypatch.setenv(faults.ENV_VAR,
                       "evaluator.garbage_line@seq=0,"
                       "evaluator.hang@seq=1&silent=1&seconds=60")
    cmd = [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
           "--serve", wf, cfg, "-b", "cpu", "--heartbeat-every", "0.3"]
    with ChipEvaluatorPool(cmd, workers=1, timeout=300,
                           heartbeat_deadline=2.0,
                           restart_backoff=0.05) as pool:
        first_pid = pool.hello["pid"]
        # every evaluator inherits the arming: its first job answers
        # after a garbage line, its second hangs silent; the hung
        # genome is retried on the next evaluator, where it is job 0
        fits = pool.evaluate_many(GENOMES)
    assert np.isfinite(fits).all()
    assert pool.hangs_detected == 2 and pool.last_hang_kind == "heartbeat"
    c = telemetry.snapshot()["counters"]
    assert c["ga.hangs_detected"] == 2 and c["ga.genome_retries"] == 2
    assert c["ga.evaluator_restarts"] == 2 and "ga.genomes_lost" not in c
    # each dead or closed evaluator's last snapshot merged once: the
    # two hung ones flushed after their job 0, the last at its exit
    assert os.path.exists(tmp_path / "m" / f"metrics-{first_pid}.json.merged")
    assert c["evaluator.jobs"] == 3
    assert telemetry.histogram("evaluator.job_seconds").count == 3
    assert len(list((tmp_path / "m").glob("metrics-*.json.merged"))) == 3



def test_preempt_sigterm_through_optimize(tmp_path):
    wf, cfg = write_files(tmp_path, epochs=1)
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
         "--optimize", "2:3", "--ga-workers", "2", "--ga-state",
         str(tmp_path / "ga.json"), wf, cfg],
        env=dict(os.environ, VELES_FAULTS="preempt.sigterm@mode=ga"), cwd=REPO,
        capture_output=True, text=True, timeout=180)
    assert p.returncode == 14, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["preempted"] is True
    assert json.load(open(tmp_path / "ga.json"))["generation"] == 0
