"""Snapshots under data parallelism, and the refusals of
``DataParallel``:

- ``--dp 2 -b cpu`` with a Snapshotter: only rank 0 writes (one
  ``snapshot ->`` line an improvement, every rank holding the same
  params), the group never reaches the pickle (the loaded workflow, its
  loader and its fused step have none), and ``--dp 2 --snapshot FILE``
  resumes it to the end with both ranks' params bitwise equal and the
  first epoch's history kept;
- the command line refuses what it cannot run, exit 2 with a message
  and before any rank starts: ``--dp 2`` with fewer visible cards than
  ``$VELES_MESH_RANKS_PER_CARD`` allows, ``--dp`` with ``--optimize``,
  and ``--multihost`` without torchrun's variables;
- ``DataParallel.install`` refuses a ``minibatch_size`` the group does
  not divide, and the fused step refuses a static minibatch
  (``max_minibatch_size``, clamped below ``minibatch_size`` when every
  class is smaller) that it does not divide, as the reference does
  (``tests/test_parallel.py``);
- the placements per rank (``parallel/mesh.py``): row-sharded with the
  tail zero-padded, member-sharded, and the shard mode's spellings;
- the fault matrix's ``multihost.peer_exit`` drill, now ported, passes
  through its CLI with ``-b cpu``.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_dp_fixtures import REPO, SEED, results, run_cli, write_case

from veles_tpu_torch.backends import TorchDevice
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow
from veles_tpu_torch.parallel import DataParallel, RankGroup
from veles_tpu_torch.snapshotter import load_workflow


def test_snapshot_round_trip_under_dp(tmp_path):
    snaps = str(tmp_path / "snaps")
    wf, env, out = write_case(tmp_path, epochs=1, snapshots=snaps)
    args = ["--dp", "2", "-b", "cpu", "-s", str(SEED)]
    p = run_cli(args + [wf], env)
    assert p.returncode == 0, p.stderr[-3000:]
    (first, _), _ = results(out, 2)
    written = glob.glob(os.path.join(snaps, "dp_epoch*"))
    assert len(written) == 1, os.listdir(snaps)
    assert p.stderr.count("snapshot -> ") == 1, p.stderr[-3000:]
    w = load_workflow(written[0])
    assert w.group is None and w.fused.group is None and \
        w.loader.group is None

    wf, env, out = write_case(tmp_path, epochs=2, snapshots=snaps)
    p = run_cli(args + ["--snapshot", written[0], wf], env)
    assert p.returncode == 0, p.stderr[-3000:]
    (m0, p0), (m1, p1) = results(out, 2)
    assert m0["crc"] == m1["crc"] and m0["history"] == m1["history"]
    assert m0["history"][:len(first["history"])] == first["history"]
    assert [h["epoch"] for h in m0["history"]
            if h["class"] == "validation"] == [0, 1]
    for key in p0:
        np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)


def _workflow(n_train, n_valid, mb):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_train + n_valid, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 4, n_train + n_valid)
    return StandardWorkflow(
        loader_factory=lambda w: ArrayLoader(
            w, train=(x[:n_train], y[:n_train]),
            valid=(x[n_train:], y[n_train:]), minibatch_size=mb,
            name="loader"),
        layers=[{"type": "softmax", "->": {"output_sample_shape": 4},
                 "<-": {"learning_rate": 0.1}}],
        decision_config={"max_epochs": 1}, name="refusals")


def test_indivisible_minibatches_are_refused():
    group = RankGroup(0, 5, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        DataParallel(_workflow(100, 40, 48), group).install()
    # 128 divides by 8, but every class is smaller: the static shape
    # clamps to 100, which does not
    w = _workflow(100, 40, 128)
    dev = DataParallel(w, RankGroup(0, 8, torch.device("cpu"))).install()
    with pytest.raises(ValueError, match="max_minibatch_size"):
        w.initialize(device=dev, train=True)
    assert isinstance(dev, TorchDevice)


def test_placements_per_rank():
    """Row-sharded: rank r's padded_rows(R, N) / N rows, the tail zeros;
    member-sharded (a mesh of places, one process): place p's P/N
    members on place p, P a multiple of N; shard_mode reads the
    reference's spellings."""
    from veles_tpu_torch.parallel import (make_mesh, padded_rows,
                                          put_member_sharded,
                                          put_row_sharded, shard_mode)
    dev = TorchDevice(torch.device("cpu"))
    a = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    assert padded_rows(7, 2) == 8 and padded_rows(8, 2) == 8
    r0, n = put_row_sharded(RankGroup(0, 2, "cpu"), dev, a)
    r1, _ = put_row_sharded(RankGroup(1, 2, "cpu"), dev, a)
    assert n == 7
    np.testing.assert_array_equal(torch.cat([r0, r1]).numpy()[:7], a)
    assert r1.shape == (4, 2) and not r1[-1].any()
    mesh = make_mesh(2, "cpu")
    m = put_member_sharded(mesh, dev, np.arange(6))
    assert [t.device for t in m] == list(mesh.places)
    np.testing.assert_array_equal(m[1].numpy(), [3, 4, 5])
    np.testing.assert_array_equal(m[0].numpy(), [0, 1, 2])
    with pytest.raises(ValueError, match="pad members"):
        put_member_sharded(make_mesh(4, "cpu"), dev, np.arange(6))
    assert [shard_mode(v) for v in ("0", "never", "1", "always", "auto",
                                    "x")] == ["never", "never", "always",
                                              "always", "auto", "auto"]


def test_the_peer_exit_drill_is_ported(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO,
               VELES_METRICS_DIR=str(tmp_path / "m"))
    env.pop("VELES_FAULTS", None)
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.chaos_drill", "-b",
         "cpu", "--only", "peer_exit", "--json"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    (res,) = rec["results"]
    assert rec["fault_drill_ok"] and res["fault"] == "multihost.peer_exit"
    assert res["ported"] and res["ok"] and res["survivor_exit"] == 13
    assert res["peer_exit"] == 17


def test_the_command_line_refuses_what_it_cannot_run(tmp_path):
    wf, env, _ = write_case(tmp_path)
    no_card = dict(env, CUDA_VISIBLE_DEVICES="")
    p = run_cli(["--dp", "2", "-b", "cuda", wf], no_card)
    assert p.returncode == 2, p.stderr[-2000:]
    assert "only 0 visible" in p.stderr and \
        "VELES_MESH_RANKS_PER_CARD" in p.stderr, p.stderr[-2000:]
    p = run_cli(["--dp", "2", "-b", "cpu", "--optimize", "2:1", wf], env)
    assert p.returncode == 2 and "genetics.worker --serve --dp N" in \
        p.stderr, p.stderr[-2000:]
    p = run_cli(["--multihost", "-b", "cpu", wf], env)
    assert p.returncode == 2, p.stderr[-2000:]
    assert "torchrun" in p.stderr and "MASTER_ADDR" in p.stderr, \
        p.stderr[-2000:]
