"""The port's run supervisor and the preemption round trip.

- The exit-code contract, the crash budget, the backoff and the
  ``--snapshot`` rewrite, with fake child commands (the counterpart of
  ``tests/test_supervisor.py``'s unit tests of the reference's
  supervisor).
- Signals sent to the supervisor go on to the child, whose exit then
  ends the loop.
- One real round trip on the CPU: ``python -m veles_tpu_torch
  --supervise -b cpu WF.py``, where WF.py sends its own process SIGTERM
  in the middle of a TRAIN class on the first attempt; the child exits
  14 after a final snapshot, the supervisor resumes it to rc 0, and the
  run equals an uninterrupted run of the same file bitwise (history and
  params, f32 on the CPU, dropout on).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from veles_tpu_torch import snapshotter, supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a fake child: logs its attempt, arguments and manifest, then exits
#: with the code of its attempt in $FAKE_CODES (a negative one: killed
#: by that signal)
CHILD = textwrap.dedent("""
    import json, os, sys
    attempt = int(os.environ["VELES_SUPERVISE_ATTEMPT"])
    with open(os.environ["FAKE_LOG"], "a") as f:
        f.write(json.dumps({"attempt": attempt, "argv": sys.argv[1:],
                            "manifest": os.environ["VELES_RESUME_MANIFEST"]
                            }) + "\\n")
    code = [int(c) for c in os.environ["FAKE_CODES"].split(",")][attempt]
    if code < 0:
        os.kill(os.getpid(), -code)
    sys.exit(code)
""")


def _supervise(tmp_path, monkeypatch, codes, **kw):
    log = tmp_path / "children.jsonl"
    monkeypatch.setenv("FAKE_CODES", ",".join(map(str, codes)))
    monkeypatch.setenv("FAKE_LOG", str(log))
    manifest = str(tmp_path / "m.json")
    sup = supervisor.Supervisor(["wf.py", "-b", "cpu"],
                                command=[sys.executable, "-c", CHILD],
                                manifest_path=manifest,
                                restart_backoff=0.01, **kw)
    rc = sup.run()
    with open(log) as f:
        children = [json.loads(line) for line in f]
    assert [c["attempt"] for c in children] == list(range(len(children)))
    assert all(c["manifest"] == manifest for c in children)
    assert all(c["argv"] == ["wf.py", "-b", "cpu"] for c in children)
    return rc, sup.restarts, len(children)


@pytest.mark.parametrize("codes,max_crashes,want", [
    ([0], 5, (0, 0, 1)),
    ([14, 13, 14, 0], 1, (0, 3, 4)),     # never charged to the budget
    ([2, 0], 5, (2, 0, 1)),               # a usage error gives up
    ([1, 0], 5, (0, 1, 2)),               # a crash resumes
    ([1, 3, 1, 0], 3, (1, 2, 3)),         # the third crash gives up
    ([-9, 0], 5, (0, 1, 2)),              # killed by a signal: a crash
    ([-9, 0], 1, (137, 0, 1)),            # ... charged as 128 + 9
], ids=["done", "preempted", "usage", "crash", "budget", "signal",
        "signal-budget"])
def test_exit_code_contract(tmp_path, monkeypatch, codes, max_crashes,
                            want):
    assert _supervise(tmp_path, monkeypatch, codes,
                      max_crashes=max_crashes) == want


def test_exit_codes_are_the_launchers():
    from veles_tpu_torch.launcher import Launcher
    assert supervisor.EXIT_PREEMPTED == Launcher.PREEMPT_EXIT == 14
    assert supervisor.RESUME_CODES == {13, 14}


def test_backoff_is_the_pools_shape():
    a = supervisor.Supervisor([], restart_backoff=0.5,
                              restart_backoff_cap=30.0, seed=3)
    b = supervisor.Supervisor([], restart_backoff=0.5,
                              restart_backoff_cap=30.0, seed=3)
    got = [a.backoff(n) for n in range(1, 12)]
    assert got == [b.backoff(n) for n in range(1, 12)]   # deterministic
    assert got[0] == 0.0                                  # first: at once
    for n, d in enumerate(got[1:], start=2):
        base = min(30.0, 0.5 * 2.0 ** (n - 2))
        assert 0.75 * base <= d <= 1.25 * base


def test_crash_window_forgets_old_crashes(tmp_path, monkeypatch):
    # with a window of 0 s no two crashes are counted together
    assert _supervise(tmp_path, monkeypatch, [1, 1, 1, 0], max_crashes=2,
                      crash_window=0.0) == (0, 3, 4)


def _snap(path, mtime):
    snapshotter.save_workflow({"at": path}, path)
    os.utime(path, (mtime, mtime))
    return path


def test_snapshot_argument_is_rewritten_to_the_newest_intact(tmp_path):
    d = tmp_path / "snaps"
    d.mkdir()
    older = _snap(str(d / "t_epoch1_1.00pt.pickle"), 1000)
    newer = _snap(str(d / "t_epoch2_1.00pt.pickle.gz"), 1001)
    manifest = str(tmp_path / "m.json")
    for argv, want in (
            (["wf.py"], ["wf.py", "--snapshot", newer]),
            (["--snapshot", older, "wf.py"], ["--snapshot", newer,
                                              "wf.py"]),
            ([f"--snapshot={older}", "wf.py"], [f"--snapshot={newer}",
                                                "wf.py"])):
        sup = supervisor.Supervisor(argv, manifest_path=manifest)
        assert sup.argv_for_attempt(0) == argv
        # no manifest: the child's own --snapshot is the pointer
        own = older if "wf.py" != argv[0] else None
        assert sup.newest_intact_snapshot() == own
        snapshotter.write_json_atomic(manifest, {"snapshot": newer})
        assert sup.argv_for_attempt(1) == want
        os.remove(manifest)
    # a torn pointer: its newest intact sibling
    final = str(d / "t_final_preempt-SIGTERM_pid9.pickle")
    with open(final, "wb") as f:
        f.write(snapshotter.MAGIC)
    os.utime(final, (1002, 1002))
    snapshotter.write_json_atomic(manifest, {"snapshot": final})
    sup = supervisor.Supervisor(["wf.py"], manifest_path=manifest)
    assert sup.argv_for_attempt(2) == ["wf.py", "--snapshot", newer]
    # nothing intact at all: a fresh start with the child's own flags
    for p in (older, newer):
        os.remove(p)
    assert sup.argv_for_attempt(2) == ["wf.py"]


#: a child that waits for SIGTERM, then exits 14
PATIENT_CHILD = textwrap.dedent("""
    import os, signal, sys, time
    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(14))
    open(os.environ["READY"], "w").close()
    time.sleep(60)
    sys.exit(0)
""")


def test_signals_go_to_the_child_and_end_the_loop(tmp_path):
    ready = tmp_path / "ready"
    code = ("import sys; from veles_tpu_torch.supervisor import Supervisor;"
            f"sys.exit(Supervisor([], command=[sys.executable, '-c', "
            f"{PATIENT_CHILD!r}], manifest_path={str(tmp_path / 'm')!r})"
            ".run())")
    env = dict(os.environ, READY=str(ready))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while not ready.exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 14, err
    assert "restarting" not in err


# -- the real round trip -------------------------------------------------

WORKFLOW_FILE = textwrap.dedent("""
    import os
    import signal

    import numpy as np

    from veles_tpu_torch.loader.synthetic import \\
        SyntheticClassificationLoader
    from veles_tpu_torch.ops.fused import FusedStepRunner
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

    HERE = os.path.dirname(os.path.abspath(__file__))
    ATTEMPT = os.environ.get("VELES_SUPERVISE_ATTEMPT")
    #: firings per epoch: validation, train (2 minibatches), train (1);
    #: the 5th is the first train firing of epoch 1
    STOP_AFTER = 5
    LAYERS = [
        {"type": "conv_relu", "->": {"n_kernels": 4, "kx": 5, "ky": 5,
                                     "sliding": 2}},
        {"type": "norm", "->": {"n": 3}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 8},
         "<-": {"gradient_moment": 0.9}},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "softmax", "->": {"output_sample_shape": 3}},
    ]


    def create_workflow(launcher):
        snaps = "snaps" if ATTEMPT is not None else "straight_snaps"
        return StandardWorkflow(
            loader_factory=lambda wf: SyntheticClassificationLoader(
                wf, name="loader", n_train=24, n_valid=8, shape=(13, 13, 2),
                n_classes=3, minibatch_size=8),
            layers=LAYERS, decision_config={"max_epochs": 3},
            lr_adjust_config={"policy_name": "step",
                              "policy_kwargs": {"gamma": 0.5, "step": 1}},
            snapshotter_config={"directory": os.path.join(HERE, snaps),
                                "prefix": "rt", "compression": ""},
            superstep=2, name="round_trip")


    def run(launcher):
        launcher.create_workflow(create_workflow)
        launcher.initialize()
        if ATTEMPT == "0":
            fire, count = FusedStepRunner.run, [0]

            def preempting(runner):
                fire(runner)
                count[0] += 1
                if count[0] == STOP_AFTER:
                    os.kill(os.getpid(), signal.SIGTERM)
            FusedStepRunner.run = preempting
        launcher.run()
        w = launcher.workflow
        out = {f"{f}.{p}": a for f, ps in w.fused.host_params().items()
               for p, a in ps.items()}
        out["history"] = np.array([[r["epoch"], r["n_err"], r["loss"],
                                    r["count"]] for r in w.decision.history])
        np.savez(os.path.join(HERE, f"result_{ATTEMPT or 'straight'}.npz"),
                 **out)
""")


def test_sigterm_then_supervised_resume_equals_the_straight_run(tmp_path):
    wf = tmp_path / "round_trip.py"
    wf.write_text(WORKFLOW_FILE)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), VELES_PREEMPT_GRACE="60")
    for key in (supervisor.ATTEMPT_ENV, snapshotter.MANIFEST_ENV):
        env.pop(key, None)
    sup = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "--supervise", "-b", "cpu",
         "-s", "11", str(wf)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert sup.returncode == 0, sup.stderr[-3000:]
    assert "child exited 14 (preempt)" in sup.stderr
    assert "preempted: final snapshot" in sup.stderr
    finals = [f for f in os.listdir(tmp_path / "snaps")
              if f.startswith("rt_final_preempt-SIGTERM_pid")]
    assert len(finals) == 1 and finals[0].endswith(".pickle")
    assert not (tmp_path / "result_0.npz").exists()
    straight = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s", "11",
         str(wf)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert straight.returncode == 0, straight.stderr[-3000:]
    got = np.load(tmp_path / "result_1.npz")
    want = np.load(tmp_path / "result_straight.npz")
    assert sorted(got.files) == sorted(want.files)
    assert len(want["history"]) == 6
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
