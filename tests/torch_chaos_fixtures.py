"""Running the port's fault matrix (``python -m
veles_tpu_torch.tools.chaos_drill``) for its tests.

Not a test module: ``test_torch_chaos_*.py`` import it.  Each drill runs
in a process of its own, on the CPU, with a metrics dir of the test's.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_drill(fault: str, tmp_path, timeout: float = 600.0) -> dict:
    """One drill (``--only`` its dotted name) with ``-b cpu --json``: the
    record of the one result, after checking the run's verdict."""
    env = dict(os.environ, PYTHONPATH=REPO,
               VELES_METRICS_DIR=str(tmp_path / "metrics"))
    for key in ("VELES_FAULTS", "VELES_LOCK_WITNESS",
                "VELES_SUPERVISE_ATTEMPT", "VELES_RESUME_MANIFEST"):
        env.pop(key, None)
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.chaos_drill", "-b",
         "cpu", "--only", fault, "--json"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout)
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    (res,) = [r for r in rec["results"] if r["ported"]]
    assert res["fault"] == fault, rec
    assert res["ok"], (res, p.stderr[-3000:])
    assert p.returncode == 0 and rec["fault_drill_ok"], p.stderr[-3000:]
    assert rec["backend"] == "cpu"
    assert rec["fault_drill_journal_verified"] and res["journal_event"]
    assert rec["lock_witness_ok"] and rec["flight_recorder_ok"], rec
    return res
