"""The port's fault matrix: ``supervisor.sigkill_ga_resume`` through the
CLI with ``-b cpu`` (a GA run SIGKILLed mid-generation under
``--supervise``, resumed from its checkpoint bit-identically)."""

import pytest

from torch_chaos_fixtures import run_drill


@pytest.mark.parametrize("fault", ["supervisor.sigkill_ga_resume"])
def test_drill(fault, tmp_path):
    assert run_drill(fault, tmp_path)["bit_identical_resume"]
