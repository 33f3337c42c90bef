"""Snapshots and resume in the port, against a straight run and against
the JAX package's own resumed run.

The tiny AlexNet-shaped net of ``test_torch_train.py`` on the CPU, in
f32.  Tolerances:

- port resumed vs port straight: the history exactly (n_err, loss and
  count of every class end) and the params bitwise.  The resumed run
  does the same f32 operations in the same order; with dropout on and
  an lr step per epoch, a re-drawn ``"weights"`` stream, a re-shuffled
  ``"loader"`` stream, a lost dropout counter, a lost partial class
  accumulator or a restarted epoch counter each changes bits;
- port resumed vs the reference's resumed run on XLA:CPU (dropout 0:
  the two frameworks draw different masks; no lr schedule: the
  reference cannot pickle one, its policies are closures):
  ``test_torch_train.py``'s tolerance, n_err and count equal, loss
  within rtol 1e-4, params within rtol 1e-4 / atol 1e-5.

Also the envelope, byte-compatible with the reference's in both
directions, torn and corrupt files, the fallback walk, the Snapshotter's
files and the resume manifest.
"""

import gzip
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_train import LOADER, SEED, TINY_LAYERS, WORKFLOW, _seed_both
from veles_tpu import snapshotter as ref_snapshotter
from veles_tpu.backends import JaxDevice
from veles_tpu.loader.synthetic import \
    SyntheticClassificationLoader as RefLoader
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import prng, snapshotter
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.ops.fused import FusedStepRunner
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

#: the tiny net with dropout on: resume must carry the dropout counter
DROP_LAYERS = [dict(c, **{"->": {"dropout_ratio": 0.3}})
               if c["type"] == "dropout" else c for c in TINY_LAYERS]
#: firings of one epoch: 1 validation (2 minibatches), 2 train (3 each)
FIRINGS_PER_EPOCH = 3


@pytest.fixture(autouse=True)
def _port_streams():
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()


def build(max_epochs, layers=DROP_LAYERS, snap=None, **loader_kw):
    """The tiny workflow, its streams seeded as a launcher seeds them."""
    _seed_both(SEED)
    cfg = dict(WORKFLOW, layers=layers,
               decision_config={"max_epochs": max_epochs,
                                "fail_iterations": 100},
               snapshotter_config=snap)
    return StandardWorkflow(
        loader_factory=lambda wf: SyntheticClassificationLoader(
            wf, name="loader", **dict(LOADER, **loader_kw)),
        name="tiny", **cfg)


def trained(w):
    return ([(h["epoch"], h["class"], h["n_err"], h["loss"], h["count"])
             for h in w.decision.history], w.fused.host_params())


def assert_same_run(a, b):
    (ha, pa), (hb, pb) = a, b
    assert ha == hb
    assert set(pa) == set(pb)
    for f in pa:
        for p in pa[f]:
            np.testing.assert_array_equal(pa[f][p], pb[f][p])


def resume(path, max_epochs=None):
    w = snapshotter.load_workflow(path)
    if max_epochs is not None:
        w.decision.max_epochs = max_epochs
        w.decision.complete = False
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    return w


@pytest.fixture(scope="module")
def straight():
    w = build(4)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    return trained(w)


# -- resume equals the straight run ----------------------------------------

def test_resume_at_an_epoch_end_matches_the_straight_run(tmp_path, straight):
    w = build(2)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    path = str(tmp_path / "snap.pickle.gz")
    snapshotter.save_workflow(w, path)
    prng.seed_all(99)     # the snapshot's streams replace these
    got = resume(path, max_epochs=4)
    assert got.fused.restored
    assert_same_run(trained(got), straight)


@pytest.mark.parametrize("stop_after", [2, 5, 7])
def test_stop_mid_class_then_final_snapshot_resumes(tmp_path, monkeypatch,
                                                    straight, stop_after):
    """``request_stop`` after firing ``stop_after``, inside a TRAIN class
    (2 and 5: the first of its two firings) or at the start of one (7:
    after a validation firing), then the launcher's final snapshot and a
    resume by a new launcher: the straight run, partial class metrics
    included."""
    snap = {"directory": str(tmp_path / "snaps"), "prefix": "tiny",
            "compression": ""}
    launcher = Launcher(backend="cpu", seed=SEED)
    w = launcher.create_workflow(lambda lch: build(4, snap=snap))
    launcher.initialize()
    fire, count = FusedStepRunner.run, [0]

    def counting(runner):     # on the class: snapshots pickle instances
        fire(runner)
        count[0] += 1
        if count[0] == stop_after:
            runner.workflow.request_stop()
    monkeypatch.setattr(FusedStepRunner, "run", counting)
    launcher.run()
    monkeypatch.undo()
    assert w.stop_requested
    mid_train = stop_after % FIRINGS_PER_EPOCH == 2
    assert w.loader.minibatch_class == (TRAIN if mid_train else VALID)
    assert w.loader.class_ended != mid_train
    path = launcher.final_snapshot("test stop")
    assert os.path.basename(path) == \
        f"tiny_final_test-stop_pid{os.getpid()}.pickle"
    manifest = snapshotter.read_resume_manifest(
        os.path.join(snap["directory"], snapshotter.MANIFEST_NAME))
    assert manifest["snapshot"] == path and manifest["reason"] == "test stop"
    carried = snapshotter._read_payload(path)["workflow"]
    # the partial metrics of the class in flight ride along as numbers:
    # 3 minibatches of 16
    acc = carried.fused._acc_carry
    if mid_train:
        assert isinstance(acc, np.ndarray) and acc[2] == 48.0
    else:
        assert acc is None
    assert not carried.stop_requested

    again = Launcher(backend="cpu", seed=SEED + 1, snapshot=path)
    w2 = again.create_workflow(lambda lch: pytest.fail("not resumed"))
    again.initialize()
    again.run()
    assert again.snapshot_load_seconds > 0
    assert_same_run(trained(w2), straight)


def test_run_clears_a_stale_stop_request():
    w = build(1)
    w.initialize(device=make_device("cpu"), train=True)
    w.request_stop()
    w.run()   # the request predates run(): it must not stop at once
    assert [h["class"] for h in w.decision.history] == \
        ["validation", "train"]


def test_resume_draws_neither_weights_nor_a_new_shuffle(tmp_path):
    w = build(1)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    order = [o.copy() for o in w.loader._order]
    path = str(tmp_path / "s.pickle")
    snapshotter.save_workflow(w, path)
    w2 = snapshotter.load_workflow(path)
    streams = {n: s.numpy.bit_generator.state
               for n, s in prng._streams.items()}
    w2.initialize(device=make_device("cpu"), train=True)
    assert {n: s.numpy.bit_generator.state
            for n, s in prng._streams.items()} == streams
    for a, b in zip(order, w2.loader._order):
        np.testing.assert_array_equal(a, b)
    before, after = w.fused.host_params(), w2.fused.host_params()
    for f in before:
        for p in before[f]:
            np.testing.assert_array_equal(before[f][p], after[f][p])


def test_snapshot_holds_no_tensor_and_no_data(tmp_path):
    """A snapshot must open without a card: no tensor anywhere in it
    (params, velocities and metrics are numpy), and the data set is
    regenerated, not carried."""
    w = build(1)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    w.loader.run()
    w.fused.run()                       # mid-epoch, metrics in flight
    found = []

    class Scan(pickle.Pickler):
        def persistent_id(self, obj):
            if isinstance(obj, torch.Tensor):
                found.append(obj.shape)
            return None
    import io
    Scan(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL).dump(w)
    assert found == []
    state = w.fused.__getstate__()
    assert all(isinstance(a, np.ndarray)
               for ps in state["_host_params"].values() for a in ps.values())
    assert set(state["_host_opt"]) == {g.name for g in w.gds
                                       if g is not None and g.gradient_moment}
    path = str(tmp_path / "s.pickle")
    snapshotter.save_workflow(w, path)
    param_bytes = sum(a.nbytes for ps in state["_host_params"].values()
                      for a in ps.values())
    data_bytes = (LOADER["n_train"] + LOADER["n_valid"]) * \
        int(np.prod(LOADER["shape"])) * 4
    assert os.path.getsize(path) < 2 * param_bytes + data_bytes // 4


def test_prng_state_round_trip():
    prng.seed_all(5)
    a = prng.get("weights")
    a.numpy.random(3)
    state = prng.snapshot_state()
    want = a.numpy.random(4)
    prng.seed_all(6)
    prng.restore_state(state)
    np.testing.assert_array_equal(prng.get("weights").numpy.random(4), want)


def test_a_save_carries_the_streams_it_is_given(tmp_path):
    """``save_workflow(..., streams)`` writes the streams taken earlier
    (a save on a thread of its own), not the process's at the time of
    the save; a load puts those back."""
    w = build(1)
    w.initialize(device=make_device("cpu"), train=True)
    prng.get("weights").numpy.random(3)
    taken = prng.snapshot_state()
    prng.get("weights").numpy.random(5)          # the process moves on
    path = str(tmp_path / "s.pickle")
    snapshotter.save_workflow(w, path, taken)
    later = prng.snapshot_state()
    assert later != taken
    snapshotter.load_workflow(path)
    assert prng.snapshot_state() == taken
    prng.restore_state(later)
    snapshotter.save_workflow(w, path)           # no streams: the process's
    snapshotter.load_workflow(path)
    assert prng.snapshot_state() == later


# -- against the reference's resumed run -----------------------------------

#: the reference's snapshots fail on an lr schedule (a closure)
REF_WORKFLOW = dict(WORKFLOW, lr_adjust_config=None,
                    decision_config={"max_epochs": 2,
                                     "fail_iterations": 100})


def _reference_resumed(tmp_path):
    _seed_both(SEED)
    w = RefWorkflow(loader_factory=lambda wf: RefLoader(
        wf, name="loader", **LOADER), name="tiny", **REF_WORKFLOW)
    w.evaluator.compute_confusion = False
    w.initialize(device=JaxDevice(platform="cpu"))
    w.run()
    path = str(tmp_path / "ref.pickle.gz")
    ref_snapshotter.save_workflow(w, path)
    w2 = ref_snapshotter.load_workflow(path)
    w2.decision.max_epochs = 4
    w2.decision.complete.set(False)
    w2.initialize(device=JaxDevice(platform="cpu"))
    w2.run()
    return (list(w2.decision.history),
            params_from_jax({f: {p: np.asarray(a) for p, a in ps.items()}
                             for f, ps in w2.fused.host_params().items()}))


def test_resumed_run_matches_the_references_resumed_run(tmp_path):
    want_hist, want = _reference_resumed(tmp_path)
    _seed_both(SEED)
    w = StandardWorkflow(loader_factory=lambda wf:
                         SyntheticClassificationLoader(wf, name="loader",
                                                       **LOADER),
                         name="tiny", **REF_WORKFLOW)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    path = str(tmp_path / "port.pickle.gz")
    snapshotter.save_workflow(w, path)
    got_w = resume(path, max_epochs=4)
    got_hist, got = got_w.decision.history, got_w.fused.host_params()
    assert [(r["epoch"], r["class"], r["n_err"], r["count"])
            for r in got_hist] == \
        [(r["epoch"], r["class"], r["n_err"], r["count"])
         for r in want_hist]
    assert len(got_hist) == 8
    for g, r in zip(got_hist, want_hist):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-4)
    for f in want:
        for p in want[f]:
            np.testing.assert_allclose(got[f][p], want[f][p], rtol=1e-4,
                                       atol=1e-5)


# -- the envelope ----------------------------------------------------------

@pytest.fixture
def port_snapshot(tmp_path):
    w = build(1)
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    path = str(tmp_path / "port_epoch1.pickle.gz")
    snapshotter.save_workflow(w, path)
    return path


def test_envelope_is_the_references_in_both_directions(tmp_path,
                                                       port_snapshot):
    assert ref_snapshotter.verify_snapshot(port_snapshot)
    assert snapshotter.verify_snapshot(port_snapshot)
    assert snapshotter.MAGIC == ref_snapshotter.MAGIC
    assert snapshotter._HEADER.format == ref_snapshotter._HEADER.format
    ref_path = str(tmp_path / "ref.pickle.xz")
    ref_snapshotter.save_workflow({"a reference": "payload"}, ref_path)
    assert snapshotter.verify_snapshot(ref_path)
    assert snapshotter._read_payload(ref_path)["workflow"] == \
        {"a reference": "payload"}


@pytest.mark.parametrize("suffix", [".pickle", ".pickle.gz",
                                    ".pickle.bz2", ".pickle.xz"])
def test_torn_and_corrupt_files_are_refused(tmp_path, suffix):
    path = str(tmp_path / f"s{suffix}")
    snapshotter.save_workflow({"x": np.arange(50_000)}, path)
    assert snapshotter.verify_snapshot(path)
    with open(path, "rb") as f:
        raw = f.read()
    torn = str(tmp_path / f"torn{suffix}")
    with open(torn, "wb") as f:
        f.write(raw[:len(raw) // 2])
    for p in (torn, str(tmp_path / f"missing{suffix}")):
        assert not snapshotter.verify_snapshot(p)
        assert not ref_snapshotter.verify_snapshot(p)
        with pytest.raises(snapshotter.SnapshotCorruptError):
            snapshotter.load_workflow(p)
    # flip one payload byte inside the (decompressed) envelope
    opener = snapshotter._opener(path)
    with opener(path, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0xFF
    bad = str(tmp_path / f"crc{suffix}")
    with opener(bad, "wb") as f:
        f.write(bytes(blob))
    assert not snapshotter.verify_snapshot(bad)
    assert not ref_snapshotter.verify_snapshot(bad)
    with pytest.raises(snapshotter.SnapshotCorruptError, match="CRC"):
        snapshotter.load_workflow(bad)


def test_fallback_walks_to_the_newest_intact_sibling(tmp_path):
    d = tmp_path / "snaps"
    d.mkdir()
    older, newer = str(d / "t_epoch1_5.00pt.pickle"), \
        str(d / "t_epoch2_4.00pt.pickle")
    final = str(d / "t_final_preempt-SIGTERM_pid7.pickle.gz")
    snapshotter.save_workflow("older", older)
    snapshotter.save_workflow("newer", newer)
    with gzip.open(final, "wb") as f:
        f.write(snapshotter.MAGIC + b"\0" * 5)        # torn header
    snapshotter.save_workflow("other lineage", str(d / "u_epoch9.pickle"))
    for i, p in enumerate((older, newer, final)):
        os.utime(p, (1000 + i, 1000 + i))
    assert snapshotter.snapshot_candidates(final) == [newer, older]
    with pytest.raises(snapshotter.SnapshotCorruptError):
        snapshotter.load_workflow(final)
    assert snapshotter.load_workflow(final, fallback=True) == "newer"
    with open(newer, "r+b") as f:
        f.truncate(20)
    assert snapshotter.load_workflow(final, fallback=True) == "older"
    os.remove(older)
    with pytest.raises(snapshotter.SnapshotCorruptError):
        snapshotter.load_workflow(final, fallback=True)


def test_snapshotter_writes_its_lineage_and_the_manifests(tmp_path,
                                                          monkeypatch):
    env_manifest = str(tmp_path / "elsewhere" / "m.json")
    monkeypatch.setenv(snapshotter.MANIFEST_ENV, env_manifest)
    d = tmp_path / "snaps"
    w = build(3, snap={"directory": str(d), "prefix": "t", "keep": 2})
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    # a snapshot at each validation end that improved on the best error
    improved, best = [], float("inf")
    for row in w.decision.history:
        if row["class"] == "validation" and row["n_err"] < best:
            best = row["n_err"]
            improved.append((row["epoch"], row["error_pct"]))
    want = [f"t_epoch{e}_{err:.2f}pt.pickle.gz" for e, err in improved]
    assert improved and w.snapshotter.saves == len(improved)
    assert sorted(os.listdir(d)) == sorted(
        want[-2:] + [snapshotter.MANIFEST_NAME])
    for m in (str(d / snapshotter.MANIFEST_NAME), env_manifest):
        got = snapshotter.read_resume_manifest(m)
        assert got["snapshot"] == str(d / want[-1])
        assert got["pid"] == os.getpid()
    # the newest one resumes
    assert snapshotter.load_workflow(str(d / want[-1])).decision.history


def test_atomic_write_leaves_nothing_on_error(tmp_path):
    path = str(tmp_path / "f.json")
    snapshotter.write_json_atomic(path, {"a": 1})
    with pytest.raises(RuntimeError):
        with snapshotter.atomic_write(path, "w") as f:
            f.write("partial")
            raise RuntimeError("boom")
    assert os.listdir(tmp_path) == ["f.json"]
    assert snapshotter.read_resume_manifest(path) == {"a": 1}
    assert snapshotter.read_resume_manifest(str(tmp_path / "no")) is None
