"""Host-streamed supersteps in the port, against the resident path and
against the JAX package's own streaming run.

The tiny AlexNet-shaped net of ``test_torch_train.py`` on the CPU, in
f32.  Tolerances:

- forced streaming (``max_resident_bytes=0``) vs resident in the port:
  the history exactly and the params bitwise (the same rows in the same
  f32 operations; dropout on);
- the port's streaming run vs the reference's streaming run on XLA:CPU
  (dropout 0): ``test_torch_train.py``'s tolerance, n_err and count
  equal, loss within rtol 1e-4, params within rtol 1e-4 / atol 1e-5.

The CUDA half of the streaming firing (pinned staging buffers, the copy
stream, its events) runs only on the card, in ``chip_smoke.py``'s
stream phase.
"""

import numpy as np
import pytest
import torch

from test_torch_snapshot import assert_same_run, build, trained
from test_torch_train import LOADER, SEED, TINY_LAYERS, WORKFLOW, _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.loader.synthetic import \
    SyntheticClassificationLoader as RefLoader
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import prng, snapshotter
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader import fullbatch
from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader

SAMPLE = int(np.prod(LOADER["shape"]))
MB = LOADER["minibatch_size"]


@pytest.fixture(autouse=True)
def _port_streams():
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()


def run(max_epochs=3, **loader_kw):
    w = build(max_epochs, **loader_kw)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    return w


def test_forced_streaming_equals_resident():
    wr = run()
    assert wr.loader.device_resident and not wr.fused.streaming
    assert wr.fused.stream_transfer_bytes == 0
    assert wr.fused.stream_transfer_seconds == 0.0
    ws = run(max_resident_bytes=0)
    assert ws.fused.streaming and not ws.loader.device_resident
    assert ws.loader.original_data is None
    assert_same_run(trained(ws), trained(wr))
    # every padded row crossed once: per epoch 2 validation and 6 train
    # minibatches of 16 rows, the samples in f32 and the labels in int64
    rows = 3 * (2 + 6) * MB
    assert ws.loader.assembled_minibatches == 3 * (2 + 6)
    assert ws.fused.stream_transfer_bytes == rows * (SAMPLE * 4 + 8)
    assert ws.fused.stream_transfer_seconds > 0.0
    assert ws.loader.assemble_seconds > 0.0


def test_stream_counters_ride_in_a_snapshot(tmp_path):
    ws = run(max_epochs=1, max_resident_bytes=0)
    path = str(tmp_path / "s.pickle")
    snapshotter.save_workflow(ws, path)
    back = snapshotter.load_workflow(path).fused
    assert back.stream_transfer_bytes == ws.fused.stream_transfer_bytes
    assert back.stream_transfer_seconds == ws.fused.stream_transfer_seconds


def test_streaming_resume_matches_the_straight_run(tmp_path):
    straight = trained(run(max_epochs=4, max_resident_bytes=0))
    w = run(max_epochs=2, max_resident_bytes=0)
    path = str(tmp_path / "s.pickle.gz")
    snapshotter.save_workflow(w, path)
    w2 = snapshotter.load_workflow(path)
    w2.decision.max_epochs, w2.decision.complete = 4, False
    w2.initialize(device=make_device("cpu"), train=True)
    assert w2.fused.streaming and w2.loader.host_data is not None
    w2.run()
    assert_same_run(trained(w2), straight)


def _loader(**kw):
    ld = SyntheticClassificationLoader(None, name="loader",
                                       **dict(LOADER, max_resident_bytes=0,
                                              **kw))
    ld.superstep = 3
    ld.initialize(make_device("cpu"))
    return ld


def _check_rows(ld):
    want = ld.host_data[ld.superstep_indices.reshape(-1)]
    np.testing.assert_array_equal(
        ld.superstep_data.reshape(want.shape).numpy(), want)
    np.testing.assert_array_equal(
        ld.superstep_labels.numpy(),
        ld.host_labels[ld.superstep_indices])


def test_prefetched_groups_are_the_right_rows_across_epochs():
    ld = _loader()
    calls = []
    assemble = ld._assemble_superstep

    def counted(idxs):
        calls.append(idxs.shape)
        return assemble(idxs)
    ld._assemble_superstep = counted
    for _ in range(3 * 3 + 1):          # 3 epochs and a bit
        ld.run()
        _check_rows(ld)
        assert ld._prefetch_future is not None   # the next one is coming
    assert ld.epoch_number == 3
    # the last group is assembled on the prefetch thread: wait for it
    ld._prefetch_future[1].result()
    # each group assembled once: the first in the firing, the rest ahead
    assert len(calls) == 3 * 3 + 2
    ld.stop()
    assert ld._prefetch_pool is None


def test_a_peek_that_missed_is_thrown_away():
    ld = _loader()
    ld.run()
    key, fut = ld._prefetch_future
    ld._prefetch_future = (b"another group", fut)
    ld.run()
    _check_rows(ld)
    ld.stop()


def test_a_resumed_loader_streams_the_right_rows(tmp_path):
    straight = _loader()
    for _ in range(4):
        straight.run()
    path = str(tmp_path / "ld.pickle")
    snapshotter.save_workflow(straight, path)
    assert straight._prefetch_future is not None
    want = []
    for _ in range(4):                  # past the next epoch's shuffle
        straight.run()
        want.append(straight.superstep_indices)
    straight.stop()
    resumed = snapshotter.load_workflow(path)
    assert resumed._prefetch_future is None
    assert resumed.superstep_data is None and resumed.host_data is None
    resumed.initialize(make_device("cpu"))
    for idxs in want:
        resumed.run()
        _check_rows(resumed)
        np.testing.assert_array_equal(resumed.superstep_indices, idxs)
    resumed.stop()


def test_stream_dtype_is_cast_on_the_host():
    ld = _loader()
    ld.stream_dtype = torch.bfloat16
    ld.run()
    rows = ld.host_data[ld.superstep_indices.reshape(-1)]
    assert ld.superstep_data.dtype == torch.bfloat16
    assert ld.superstep_labels.dtype == torch.int64
    assert torch.equal(ld.superstep_data.reshape(rows.shape),
                       torch.from_numpy(rows).to(torch.bfloat16))
    ld.stop()


def test_residency_budget(monkeypatch):
    nbytes = (LOADER["n_train"] + LOADER["n_valid"]) * SAMPLE * 4
    assert fullbatch.DEFAULT_RESIDENT_BYTES == 8 << 30
    monkeypatch.setenv(fullbatch.RESIDENT_BYTES_ENV, str(nbytes))
    ld = SyntheticClassificationLoader(None, **LOADER)
    ld.initialize(make_device("cpu"))
    assert ld.device_resident and ld.host_data is None
    monkeypatch.setenv(fullbatch.RESIDENT_BYTES_ENV, str(nbytes - 1))
    ld = SyntheticClassificationLoader(None, **LOADER)
    ld.initialize(make_device("cpu"))
    assert not ld.device_resident and ld.original_data is None
    # the loader's own key wins over the variable
    ld = SyntheticClassificationLoader(None, max_resident_bytes=nbytes,
                                       **LOADER)
    ld.initialize(make_device("cpu"))
    assert ld.device_resident
    ld = SyntheticClassificationLoader(None, on_device=False, **LOADER)
    ld.initialize(make_device("cpu"))
    assert not ld.device_resident


def test_streaming_matches_the_references_streaming_run():
    _seed_both(SEED)
    ref = RefWorkflow(loader_factory=lambda wf: RefLoader(
        wf, name="loader", max_resident_bytes=0, **LOADER), name="tiny",
        **WORKFLOW)
    ref.evaluator.compute_confusion = False
    ref.initialize(device=JaxDevice(platform="cpu"))
    assert ref.fused.streaming
    ref.run()
    want = params_from_jax({f: {p: np.asarray(a) for p, a in ps.items()}
                            for f, ps in ref.fused.host_params().items()})
    w = build(2, layers=TINY_LAYERS, max_resident_bytes=0)
    w.initialize(device=make_device("cpu"), train=True)
    assert w.fused.streaming
    w.run()
    got = w.fused.host_params()
    assert [(r["class"], r["n_err"], r["count"])
            for r in w.decision.history] == \
        [(r["class"], r["n_err"], r["count"]) for r in ref.decision.history]
    for g, r in zip(w.decision.history, ref.decision.history):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-4)
    for f in want:
        for p in want[f]:
            np.testing.assert_allclose(got[f][p], want[f][p], rtol=1e-4,
                                       atol=1e-5)

