"""The port's fault matrix: ``fleet.replica_flap`` through the CLI with
``-b cpu`` (a replica that kills itself after every hello: a growing
respawn backoff, no scale action, every request answered)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["fleet.replica_flap"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    assert res["lost"] == 0 and res["scale_actions"] == 0
    assert res["flap_deaths"] >= 2
