"""The port's fault matrix (``veles_tpu_torch/tools/chaos_drill.py``), its
in-process drills, each through the CLI with ``-b cpu``:
``snapshot.torn_write``, ``checkpoint.corrupt`` and
``device.oom_on_put`` on the streamed and the resident upload; the
matrix's shape against the reference's ``scripts/chaos_drill.py``
(every drill under its name, the unported one listed with
``"ported": false``); ``-b auto`` without a card exits 1 naming it.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_chaos_fixtures import REPO, run_drill
from veles_tpu_torch.tools import chaos_drill


@pytest.mark.parametrize("fault", ["snapshot.torn_write",
                                   "checkpoint.corrupt",
                                   "device.oom_on_put_stream",
                                   "device.oom_on_put_resident"])
def test_drill(fault, tmp_path):
    res = run_drill(fault, tmp_path)
    if fault.startswith("device."):
        assert res["device"] == "cpu"


def _reference_drills():
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       "chaos_drill.py")).read())
    (drills,) = [n.value for n in tree.body if isinstance(n, ast.Assign)
                 and n.targets[0].id == "DRILLS"]
    return [e.id.replace("drill_", "").replace("__", ".")
            for e in drills.elts]


def test_the_matrix_is_the_references_less_two():
    # since data parallelism was ported, only the image loader's drill is
    # missing: the matrix is the reference's less one
    ported = [chaos_drill.fault_name(f) for f in chaos_drill.DRILLS]
    want = _reference_drills()
    assert len(want) == 15 and len(ported) == 14
    assert sorted(ported + list(chaos_drill.NOT_PORTED)) == sorted(want)
    assert set(chaos_drill.NOT_PORTED) == {"stream.corrupt_file"}
    assert "multihost.peer_exit" in ported


def test_the_unported_drills_are_listed_not_run(tmp_path):
    todo, skipped = chaos_drill.selected(None)
    assert len(todo) == 14 and sorted(skipped) == sorted(
        chaos_drill.NOT_PORTED)
    env = dict(os.environ, PYTHONPATH=REPO,
               VELES_METRICS_DIR=str(tmp_path / "m"))
    env.pop("VELES_FAULTS", None)
    for only, name in (("corrupt_file", "stream.corrupt_file"),):
        p = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch.tools.chaos_drill",
             "-b", "cpu", "--only", only, "--json"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        # listed, neither run nor counted as passed
        assert rec["results"] == [{"fault": name, "ported": False,
                                   "why": chaos_drill.NOT_PORTED[name]}]
        assert rec["fault_drill_journal_verified"] is False


def test_without_a_card_auto_exits_naming_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: -b auto drills on it")
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.chaos_drill",
         "--only", "snapshot"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 1
    assert "CUDA card" in p.stderr and "-b cpu" in p.stderr
    assert p.stdout == ""
