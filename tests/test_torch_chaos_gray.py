"""The port's fault matrix: gray failures through the CLI with ``-b cpu``,
one replica of a real 2-replica fleet armed: ``hive.wedge`` (ejected with
no heartbeat lost) and ``hive.garbage_response`` (no corrupt answer
reaches a client)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["hive.wedge", "hive.garbage_response"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    assert res["journal_event"] == "fleet.eject.replica"
