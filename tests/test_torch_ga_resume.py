"""The GA's graceful stop and resume in the port, through the CLI on
wine (``-b cpu-evaluator``, 1 epoch a genome, ``--optimize 4:2``).

- SIGTERM to the GA parent right after generation 1's state is saved:
  breeding stops at the next generation boundary and the run exits 14,
  printing its best so far with ``"preempted": true``; the same command
  then resumes from ``--ga-state`` and ends with the state, best genome
  and fitness of an uninterrupted run, bit for bit.
- The same under ``--supervise``: the child exits 14, the supervisor
  starts it again, it resumes and the supervisor exits 0; the resume
  manifest (``$VELES_RESUME_MANIFEST``) points at the GA state.
"""

import json
import os
import subprocess
import sys

from torch_ga_fixtures import REPO, write_files

GA = ["-b", "cpu-evaluator", "--optimize", "4:2", "--ga-workers", "2"]


def _run(args, files, env=None):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", *args, *files],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def _state(path):
    with open(path) as f:
        s = json.load(f)
    return s["generation"], s["history"], s["population"], s["fits"]


def _straight(tmp_path, files):
    state = str(tmp_path / "straight.json")
    res = _run(GA + ["--ga-state", state], files)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), _state(state)


def test_sigterm_stops_at_a_generation_and_resumes_bitwise(tmp_path):
    files = write_files(tmp_path, epochs=1, sigterm=True)
    marker = str(tmp_path / "signalled")
    state = str(tmp_path / "ga.json")
    env = {"GA_TEST_SIGTERM_MARKER": marker}
    res = _run(GA + ["--ga-state", state], files, env)
    assert res.returncode == 14, res.stderr[-2000:]
    assert os.path.exists(marker)
    stopped = json.loads(res.stdout.strip().splitlines()[-1])
    assert stopped["preempted"] is True
    assert _state(state)[0] == 1
    res = _run(GA + ["--ga-state", state], files, env)
    assert res.returncode == 0, res.stderr[-2000:]
    resumed = json.loads(res.stdout.strip().splitlines()[-1])
    assert "resumed GA at generation 1" in res.stderr
    straight, straight_state = _straight(tmp_path, files)
    assert (resumed["best"], resumed["fitness"]) == \
        (straight["best"], straight["fitness"])
    assert _state(state) == straight_state


def test_supervise_resumes_the_ga_through_the_manifest(tmp_path):
    files = write_files(tmp_path, epochs=1, sigterm=True)
    state = str(tmp_path / "ga.json")
    manifest = str(tmp_path / "resume.json")
    env = {"GA_TEST_SIGTERM_MARKER": str(tmp_path / "signalled"),
           "VELES_RESUME_MANIFEST": manifest}
    res = _run(["--supervise"] + GA + ["--ga-state", state], files, env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "child exited 14" in res.stderr
    assert "resumes the GA from" in res.stderr
    with open(manifest) as f:
        assert json.load(f)["ga_state"] == state
    _, straight_state = _straight(tmp_path, files)
    assert _state(state) == straight_state
