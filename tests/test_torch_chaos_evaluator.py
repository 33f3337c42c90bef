"""The port's fault matrix: ``evaluator.hang_and_garbage`` through the CLI
with ``-b cpu`` (a real evaluator pool on wine: a silent hang caught
within the heartbeat deadline, a garbage line, fitnesses equal to an
unfaulted pass)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["evaluator.hang_and_garbage"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    assert res["fitness_parity"]
    assert res["hang_detect_sec"] <= res["heartbeat_deadline"] + 5.0
