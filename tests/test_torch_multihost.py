"""The multihost abort on the CPU (two gloo ranks):

- ``--supervise --dp 2`` with fault point ``multihost.peer_exit`` armed
  for rank 1 of the first attempt: rank 1 hard-exits (17), rank 0 exits
  13 after a final snapshot in the lineage, the ``--dp`` command returns
  the worst code, and the supervisor resumes the run from that snapshot
  to its end, both ranks' params bitwise equal (the snapshot is taken
  inside the firing the abort interrupted, so that class may leave no
  row in the history);
- a peer that stops answering (SIGSTOP: no exit, no closed socket) is
  caught by the heartbeat watchdog: rank 0 exits 13 within
  ``$VELES_MULTIHOST_DEADLINE`` plus a grace of 30 s, with the peer's
  death and the final snapshot in its journal.

The command line's refusals are in ``test_torch_dp_resume.py``.
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time

from torch_dp_fixtures import REPO, SEED, results, run_cli, write_case

from veles_tpu_torch import events


def test_dead_peer_exits_13_and_the_supervisor_resumes(tmp_path):
    snaps = str(tmp_path / "snaps")
    # rank 1 dies half a second after joining, long before the first
    # attempt could train 60 epochs (30 epochs once ended within 1 s)
    wf, env, out = write_case(tmp_path, epochs=60, snapshots=snaps)
    env.update(VELES_FAULTS="multihost.peer_exit@process=1&attempt=0"
                            "&after=0.5",
               VELES_MULTIHOST_DEADLINE="5", VELES_MULTIHOST_HEARTBEAT="0.5")
    p = run_cli(["--supervise", "--dp", "2", "-b", "cpu", "-s", str(SEED),
                 wf], env, timeout=180)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "--dp 2: rank exit codes [13, 17]" in p.stderr, p.stderr[-4000:]
    final = glob.glob(os.path.join(snaps, "*_final_multihost-abort_pid*"))
    assert len(final) == 1, os.listdir(snaps)
    assert f"resuming from {final[0]}" in p.stderr or \
        final[0] in p.stderr.split("restarting")[-1], p.stderr[-4000:]
    (m0, p0), (m1, p1) = results(out, 2)
    assert m0["crc"] == m1["crc"] and m0["history"] == m1["history"]
    # the run reached its 60th epoch; the abort lands inside a firing, so
    # the class it interrupted may leave no row
    valid = [h["epoch"] for h in m0["history"] if h["class"] == "validation"]
    assert valid[-1] == 59 and len(valid) in (59, 60), valid


def test_a_silent_peer_is_caught_by_the_heartbeat(tmp_path):
    deadline = 3.0
    wf, env, out = write_case(tmp_path, epochs=100000,
                              snapshots=str(tmp_path / "snaps"))
    mdir = str(tmp_path / "m")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        e = dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                 VELES_METRICS_DIR=mdir,
                 VELES_MULTIHOST_DEADLINE=str(deadline),
                 VELES_MULTIHOST_HEARTBEAT="0.3")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--multihost", "-b",
             "cpu", "-s", str(SEED), wf], cwd=REPO, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        # wait for training: the loader's first epoch ends in the journal
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end and not any(
                '"loader.epoch"' in open(f).read()
                for f in glob.glob(os.path.join(mdir, "journal-*.jsonl"))):
            time.sleep(0.1)
        os.kill(procs[1].pid, signal.SIGSTOP)
        t0 = time.monotonic()
        _, err0 = procs[0].communicate(timeout=deadline + 60)
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode == 13, err0[-3000:]
    assert waited <= deadline + 30, waited
    assert "missed its liveness deadline" in err0, err0[-3000:]
    evs = []
    for f in glob.glob(os.path.join(mdir, "journal-*.jsonl")):
        with open(f) as fh:
            evs += [json.loads(line) for line in fh if line.strip()]
    names = [e["event"] for e in evs]
    assert events.EV_MULTIHOST_PEER_DEATH in names, names
    snap = [e for e in evs
            if e["event"] == events.EV_MULTIHOST_EMERGENCY_SNAPSHOT]
    assert snap and os.path.exists(snap[-1]["path"]), snap
