"""Data parallelism, streamed and under the uint8 codec, and the dropout
mask's slice:

- ``--dp 2 -b cpu`` with ``max_resident_bytes=0`` (every rank assembles
  only its own slice of each superstep on the host) against the
  reference's single-device streamed run within the reference's bars
  (loss within 5e-3, ``n_err`` within 3; ``tests/test_parallel.py``),
  and against the port's one-process streamed run within the tighter
  bars of ``test_torch_dp.py`` (loss 1e-5, ``n_err`` equal, params
  1e-6), both ranks' params bitwise equal;
- the uint8 codec under ``--dp 2``: a byte data set row-sharded (each
  rank holds its half at 1 byte a pixel, dequantized on the device)
  against the one-process run within the same tight bars;
- a rank's dropout mask is the global minibatch's mask's rows
  (``prng.RowSlice``), so two ranks together draw what one device draws.
"""

import numpy as np
import torch

from test_torch_dp import (bitwise_across_ranks, reference_single_device,
                           within_one_rank, within_reference_bars)
from torch_dp_fixtures import run_dp, valid_history

from veles_tpu_torch import prng
from veles_tpu_torch.ops.dropout import Dropout

STREAM = {"max_resident_bytes": 0}


def test_streamed_dp2_matches_reference_and_one_rank(tmp_path):
    dp2 = run_dp(tmp_path / "dp2", n=2, loader=STREAM)
    one = run_dp(tmp_path / "one", n=1, loader=STREAM)
    for meta, _ in dp2 + one:
        assert not meta["device_resident"] and meta["resident_bytes"] == 0
    want = reference_single_device(max_resident_bytes=0)
    for meta, _ in dp2:
        within_reference_bars(valid_history(meta["history"]), want)
    within_one_rank(dp2, one)
    bitwise_across_ranks(dp2)


def _bytes(x):
    return np.clip(np.rint(x * 40.0 + 128.0), 0, 255).astype(np.uint8)


def test_uint8_codec_row_sharded_under_dp2(tmp_path):
    kw = dict(x_transform=_bytes,
              loader={"normalization_type": "mean_disp"})
    dp2 = run_dp(tmp_path / "dp2", n=2,
                 env_extra={"VELES_MESH_SHARD_DATA": "always"}, **kw)
    one = run_dp(tmp_path / "one", n=1, **kw)
    (m1, _), = one
    assert m1["dequant"] and not m1["shard_resident"]
    for meta, _ in dp2:
        assert meta["dequant"] and meta["shard_resident"]
        # half of 672 rows of 144 bytes, and of their int64 labels
        assert meta["resident_bytes"] == 336 * (144 + 8)
        assert m1["resident_bytes"] == 2 * meta["resident_bytes"]
    within_one_rank(dp2, one)
    bitwise_across_ranks(dp2)


def test_a_ranks_dropout_mask_is_its_rows_of_the_global_mask():
    x = torch.randn(8, 5, 3)
    f = Dropout(dropout_ratio=0.4)
    whole, (_, mask) = f.apply_fwd({}, x, rng=prng.torch_generator(
        11, 3, 2, torch.device("cpu")))
    for lo, hi in ((0, 4), (4, 8)):
        rng = prng.torch_generator(11, 3, 2, torch.device("cpu"),
                                   rows=(lo, hi, 8))
        y, (_, m) = f.apply_fwd({}, x[lo:hi], rng=rng)
        assert torch.equal(m, mask[lo:hi]) and torch.equal(y, whole[lo:hi])
        # the other layers' draws, and their Gibbs steps, slice the
        # same way
        for t in (0, 3):
            u = prng.uniform(prng.torch_generator(
                11, 3, 2, torch.device("cpu"), rows=(lo, hi, 8)),
                (hi - lo, 7), torch.device("cpu"), t)
            full = prng.uniform(prng.torch_generator(
                11, 3, 2, torch.device("cpu")), (8, 7),
                torch.device("cpu"), t)
            assert torch.equal(u, full[lo:hi])


def test_a_rank_leaves_its_group_before_the_interpreter_exits(tmp_path):
    """``Launcher.close()`` (called by the CLI after a rank's run reached
    its end) destroys the process group while the process is whole: a
    finished rank left that to the interpreter's teardown and aborted
    (exit 134, "terminate called without an active exception") in about
    1 of 50 loaded two-rank runs."""
    import os
    import subprocess
    import sys

    from torch_dp_fixtures import REPO
    code = (
        "import torch.distributed as dist\n"
        "from veles_tpu_torch.launcher import Launcher\n"
        "la = Launcher(backend='cpu', multihost=True)\n"
        "assert dist.is_initialized() and la.group.world_size == 1\n"
        "la.close()\n"
        "assert not dist.is_initialized() and la.group.store is None\n"
        "la.close()\n"
        "print('closed')\n")
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT="0", WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "closed", p.stderr
