"""Data parallelism, resident (``veles_tpu_torch/parallel/``): ``python
-m veles_tpu_torch --dp 2 -b cpu`` trains the reference's tiny
data-parallel workflow over two gloo ranks, and

- follows the reference's SINGLE-device fused step on XLA:CPU within
  the reference's own bars (``tests/test_parallel.py``: validation loss
  within 5e-3, ``n_err`` within 3);
- follows the port's one-process run much closer: every validation
  loss within 1e-5 and ``n_err`` equal, every param within 1e-6 (the
  two runs differ only in the order the gradient's rows are summed:
  0.3e-7 to 1.1e-7 measured on this workflow);
- ends with bitwise equal params on both ranks (the CRC of every param,
  the counterpart of the reference's ``is_fully_replicated``).

Row-sharded residency: ``test_torch_dp_shard.py``.
"""

import numpy as np
import pytest

from torch_dp_fixtures import SEED, data_arrays, run_dp, valid_history


def reference_single_device(**loader_kw):
    """The reference's fused step on one XLA:CPU device, the same
    workflow, data and seed (``tests/test_parallel.py``)."""
    from veles_tpu import prng
    from veles_tpu.backends import JaxDevice
    from veles_tpu.loader import ArrayLoader
    from veles_tpu.ops.standard_workflow import StandardWorkflow

    prng.seed_all(SEED)
    train, valid = data_arrays()
    gd = {"learning_rate": 0.1, "weight_decay": 0.0001,
          "gradient_moment": 0.9}
    w = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(
            wf, train=train, valid=valid, minibatch_size=48,
            name="loader", **loader_kw),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 32},
                 "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": gd}],
        decision_config={"max_epochs": 2}, name="dp_test")
    w.initialize(device=JaxDevice(platform="cpu"))
    w.run()
    return valid_history(w.decision.history)


def within_reference_bars(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) < 5e-3, (a, b)
        assert abs(a["n_err"] - b["n_err"]) <= 3, (a, b)


def within_one_rank(ranks, one):
    """Both ranks against the one-process run: the stated bars."""
    h1 = valid_history(one[0][0]["history"])
    for meta, params in ranks:
        h = valid_history(meta["history"])
        assert len(h) == len(h1) == 2
        for a, b in zip(h, h1):
            assert abs(a["loss"] - b["loss"]) < 1e-5, (a, b)
            assert a["n_err"] == b["n_err"], (a, b)
        for key, want in one[0][1].items():
            np.testing.assert_allclose(params[key], want, rtol=0, atol=1e-6,
                                       err_msg=key)


def bitwise_across_ranks(ranks):
    (m0, p0), (m1, p1) = ranks
    assert m0["world"] == m1["world"] == 2
    assert m0["crc"] == m1["crc"]
    assert m0["history"] == m1["history"]
    for key in p0:
        np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp")
    return {"dp2": run_dp(base / "dp2", n=2),
            "one": run_dp(base / "one", n=1)}


def test_dp2_matches_the_references_single_device_step(runs):
    want = reference_single_device()
    for meta, _ in runs["dp2"]:
        within_reference_bars(valid_history(meta["history"]), want)


def test_dp2_matches_one_rank_and_ranks_agree_bitwise(runs):
    within_one_rank(runs["dp2"], runs["one"])
    bitwise_across_ranks(runs["dp2"])
    for meta, _ in runs["dp2"]:
        # two param layers: two gradient sums a train minibatch (10 an
        # epoch), a stop vote a firing, the class ends' metrics
        assert meta["device"] == "cpu"
        assert meta["collectives"]["grads"][0] == 2 * 10 * 2
        assert meta["collectives"]["stop"][0] == 2 * (10 + 4)
        assert not meta["shard_resident"]
