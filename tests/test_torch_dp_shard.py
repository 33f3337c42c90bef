"""Row-sharded residency under ``--dp 2 -b cpu``
(``$VELES_MESH_SHARD_DATA=always``: each rank holds half the rows and
the rows of a minibatch are assembled by one ``all_reduce`` a store)
trains bitwise as the replicated placement, with each rank's resident
bytes the padded half of the whole copy's.  And a ``--dp 2`` run
preempted by SIGTERM to the command: every rank stops before the same
firing and exits 14, rank 0 alone writing the final snapshot."""

import glob
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_dp import bitwise_across_ranks
from torch_dp_fixtures import REPO, SEED, run_dp, write_case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_shard")
    return {"dp2": run_dp(base / "dp2", n=2),
            "sharded": run_dp(base / "sharded", n=2,
                              env_extra={"VELES_MESH_SHARD_DATA": "always"})}


def test_row_sharded_residency_is_bitwise_replicated(runs):
    bitwise_across_ranks(runs["sharded"])
    (full, pf), _ = runs["dp2"]
    for meta, params in runs["sharded"]:
        assert meta["shard_resident"] and meta["device_resident"]
        # 672 rows padded to 2 x 336: each rank holds half of every
        # store (f32 pixels, int64 labels)
        assert meta["resident_bytes"] * 2 == full["resident_bytes"]
        assert meta["history"] == full["history"]
        assert meta["crc"] == full["crc"]
        for key in pf:
            np.testing.assert_array_equal(params[key], pf[key], err_msg=key)


def test_a_preempted_dp_run_exits_14_with_rank_0s_snapshot(tmp_path):
    snaps = str(tmp_path / "snaps")
    wf, env, _ = write_case(tmp_path, epochs=100000, snapshots=snaps)
    p = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--dp", "2", "-b", "cpu",
         "-s", str(SEED), wf], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # training: rank 0's first snapshot of an improvement
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end and not glob.glob(
                os.path.join(snaps, "dp_epoch*")):
            time.sleep(0.1)
        p.send_signal(signal.SIGTERM)
        _, err = p.communicate(timeout=90)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 14, err[-3000:]
    assert "--dp 2: rank exit codes [14, 14]" in err, err[-3000:]
    assert "final snapshot written by rank 0" in err, err[-3000:]
    final = glob.glob(os.path.join(snaps, "dp_final_preempt-SIGTERM_pid*"))
    assert len(final) == 1, os.listdir(snaps)
