"""The port's fault matrix: ``preempt.sigterm_resume`` through the CLI
with ``-b cpu`` (a SIGTERM mid-training, the final snapshot within the
grace, exit 14, the supervisor's resume, the trajectory equal to an
uninterrupted run's)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["preempt.sigterm_resume"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    assert res["trajectory_match"] and res["child_exit"] == 14
    assert res["final_snapshot"].startswith("phx_final_preempt")
