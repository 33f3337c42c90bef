"""The master--slave mode through the command line, on the CPU: ``python
-m veles_tpu_torch -b cpu --listen-address tcp://127.0.0.1:*`` (the
master, which logs the port it bound) and ``--master-address`` (a slave)
as two processes over zmq, on the data-parallel tests' tiny workflow
(``tests/torch_dp_fixtures.py``), against the one-process standalone run
of the same file and seed:

- one slave: the master's validation rows and final params those of the
  standalone run, within ``test_torch_dp.py``'s one-rank bars (loss
  1e-5, ``n_err`` equal, params 1e-6);
- a ``--dp 2`` slave (two gloo ranks computing each job over their
  rows, rank 0 talking to the master): the same bars, as ``--dp 2``
  standalone holds them.
"""

import os
import re
import subprocess
import sys
import threading

from test_torch_dp import within_one_rank
from torch_dp_fixtures import REPO, SEED, results, run_dp, write_case


def start_master(tmp):
    wf, env, out = write_case(tmp)
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s",
         str(SEED), "--listen-address", "tcp://127.0.0.1:*", wf],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    lines, found = [], threading.Event()
    endpoint = {}

    def read():
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"master listening on (tcp://\S+)", line)
            if m:
                endpoint["addr"] = m.group(1)
                found.set()
        found.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    assert found.wait(60) and "addr" in endpoint, "".join(lines[-30:])
    return proc, reader, lines, endpoint["addr"], out


def run_master_and_slave(tmp, slave_args=()):
    proc, reader, lines, addr, out = start_master(tmp / "master")
    try:
        wf, env, sout = write_case(tmp / "slave")
        s = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s",
             str(SEED), "--master-address", addr, *slave_args, wf],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert s.returncode == 0, s.stderr[-4000:]
        assert proc.wait(timeout=60) == 0, "".join(lines[-30:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    assert any("master done: 28 jobs applied" in x for x in lines), \
        "".join(lines[-10:])
    return results(out, 1)


def test_master_and_one_slave_follow_the_standalone_run(tmp_path):
    one = run_dp(tmp_path / "one", n=1)
    master = run_master_and_slave(tmp_path)
    within_one_rank(master, one)


def test_a_dp2_slave_follows_the_standalone_run(tmp_path):
    one = run_dp(tmp_path / "one", n=1)
    master = run_master_and_slave(tmp_path, ("--dp", "2"))
    within_one_rank(master, one)
    assert os.path.exists(os.path.join(tmp_path, "slave", "out",
                                       "result_1.json"))
