"""The port's fault matrix through the CLI with ``-b cpu``: the online
learner's ``online.poison_batch`` (never promoted) and
``online.swap_mid_request`` (no torn answer)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["online.poison_batch",
                                   "online.swap_mid_request"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    if fault == "online.poison_batch":
        assert res["promotions"] == 0
    else:
        assert res["torn"] == 0
