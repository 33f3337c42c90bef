"""``python -m veles_tpu_torch.tools.trace_cost`` on the CPU: a short run
of the traced-over-untraced comparison on two ``-b cpu`` replicas of the
tier-1 fleet model, and its stage timings; and its refusal without a
card when ``-b cpu`` is not given."""

import json
import os
import subprocess
import sys

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_short_run_reports_both_sides_and_every_stage():
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.trace_cost", "-b",
         "cpu", "--pairs", "40", "--stage-calls", "50", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["backend"] == "cpu" and rec["replicas"] == 2
    e = rec["end_to_end"]
    assert e["requests_each"] == 40
    for side in ("traced", "untraced"):
        assert 0 < e[f"{side}_ms"]["p50"] <= e[f"{side}_ms"]["p99"]
    assert np.isclose(e["p50_ratio"], e["traced_ms"]["p50"]
                      / e["untraced_ms"]["p50"])
    stages = rec["stages_us"]
    assert {"mint", "leg_span", "wire_encode", "trace_leg",
            "trace_request", "wire_decode", "from_wire_span",
            "hive_record", "trace_serve", "trace_batch",
            "journal_line"} <= set(stages)
    assert all(np.isfinite(v) for v in stages.values())


def test_without_a_card_it_exits_1_naming_it():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from veles_tpu_torch.tools import trace_cost\n"
            "sys.exit(trace_cost.main(['--json']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "needs a CUDA card" in proc.stderr and proc.stdout == ""
