"""One short production day of the port's elastic fleet on the CPU
(``python -m veles_tpu_torch.tools.gauntlet -b cpu``): a 30 s open-loop
day under the autoscaler with the learner armed, a gray blip on the
founding replica and a SIGTERM mid-burst, whose books balance
(``gauntlet_ok``).

The reference's default day is 150 s of a diurnal swing.  This one keeps
its sizes but is shaped for 30 s through the reference's own
``GAUNTLET_*`` knobs: a flat base rate with 10x bursts every few seconds
and a short cooldown, so that the autoscaler's pressure (the replicas'
dispatch cadence) crosses its band both ways more than twice within the
day.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DAY = {"GAUNTLET_DURATION": "30", "GAUNTLET_EPILOGUE": "5",
       "GAUNTLET_PEAK_RPS": "8", "GAUNTLET_SWING": "1",
       "GAUNTLET_BURST_MULT": "10", "GAUNTLET_BURST_EVERY": "8",
       "GAUNTLET_BURST_LEN": "3", "GAUNTLET_UP_MS": "100",
       "GAUNTLET_DOWN_MS": "40", "GAUNTLET_MAX_WAIT_MS": "5",
       "GAUNTLET_COOLDOWN": "1", "GAUNTLET_UP_SUSTAIN": "0.5",
       "GAUNTLET_DOWN_SUSTAIN": "0.5"}


def test_a_short_day_on_the_cpu_balances_its_books(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, **DAY)
    for key in ("VELES_FAULTS", "VELES_METRICS_DIR", "VELES_LOCK_WITNESS"):
        env.pop(key, None)
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.gauntlet", "-b", "cpu",
         "--json"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and rec["gauntlet_ok"] is True, \
        (rec, p.stderr[-3000:])
    assert rec["backend"] == "cpu" and rec["day_sec"] == 30.0
    assert rec["lost"] == rec["errors"] == rec["corrupt"] == 0
    assert rec["answered"] + rec["shed"] == rec["arrivals"] > 0
    assert rec["crc_checked"] == rec["answered"]
    assert rec["scale_ups"] >= 2 and rec["scale_downs"] >= 2
    assert rec["trace_deterministic"] is True
    assert rec["oracle_spot_checks"] > 0
    assert rec["oracle_max_abs_diff"] < 1e-3
    assert rec["accountability"]["accounted"] is True
    assert rec["accountability"]["unexplained"] == []
    assert len(rec["preemptions"]) == 1
