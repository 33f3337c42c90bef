"""The port's fault matrix: a gray failure through the CLI with ``-b
cpu``, one replica of a real 2-replica fleet armed with
``hive.slow_dispatch`` (hedged, ejected, reinstated)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["hive.slow_dispatch"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    assert res["journal_event"] == "fleet.eject.replica"
