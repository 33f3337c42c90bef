"""The port's plotters and graphics bus (``veles_tpu_torch/
plotting_units.py``, ``graphics_server.py``) against the reference's.

- ``python -m veles_tpu_torch -b cpu -p`` and ``python -m veles_tpu -b
  cpu -p`` on a tiny ``mnist`` from the same IDX files write the same
  four PNGs into their ``$VELES_PLOTS_DIR``.
- In process, the same seeds and files through both packages' ``mnist``
  with ``link_plotters()``: the events each graphics server is handed
  are the same, in the same order; curves within the training parity's
  tolerance (``tests/test_torch_zoo.py``: n_err exact, loss rtol 1e-4),
  the confusion matrix exactly, the weight tiles within the params'.
- ``Weights2D`` on equal weights makes the reference's ``_to_tiles``
  tiles within 1e-6, for conv (3 and 1 input channels) and dense
  weights, read from the fused runner and turned into HWIO.
- ``encode_event`` is byte for byte the reference's; ``--dump-config``
  prints the reference's tree for the same config; ``-v`` logs at
  DEBUG; a resumed workflow's plotters fire again.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_data import data_dir_in_both
from test_torch_train import _seed_both
from veles_tpu import graphics_server as ref_gs
from veles_tpu.backends import JaxDevice
from veles_tpu.models import mnist as ref_mnist
from veles_tpu.plotting_units import Weights2D as RefWeights2D
from veles_tpu_torch import datasets, graphics_server, prng, snapshotter
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.models import mnist
from veles_tpu_torch.plotting_units import Weights2D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 4321
LOADER = {"minibatch_size": 60, "n_train": 240, "n_valid": 60}
PLOTS = ["plt_confusion.png", "plt_error.png", "plt_loss.png",
         "plt_weights.png"]


class _FL:
    workflow = None


@pytest.fixture(autouse=True)
def _state():
    """Fresh stream registries and graphics servers; the port's config
    tree restored after."""
    saved = dict(root.__dict__)
    prng._streams.clear()
    ref_gs.shutdown_server()
    graphics_server.shutdown_server()
    yield
    ref_gs.shutdown_server()
    graphics_server.shutdown_server()
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _spy(module) -> list:
    """Capture every event ``module``'s server is handed, unrendered."""
    events = []
    server = module.get_server()
    server.render = False
    server.enqueue = events.append
    return events


def _roundtrip(event: dict) -> dict:
    """The event as a viewer receives it (JSON)."""
    return graphics_server.decode_event(graphics_server.encode_event(event))


# -- the CLI ---------------------------------------------------------------

def _both(args_of, env_of=lambda pkg: {}, timeout=300):
    """``python -m PKG ARGS`` for both packages at once, ``args_of(pkg)``
    the arguments and ``env_of(pkg)`` more environment; their
    (returncode, stdout, stderr), the port's first."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", pkg, *args_of(pkg)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **env_of(pkg)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("veles_tpu_torch", "veles_tpu")]
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=timeout)
        finally:
            p.kill()
        out.append((p.returncode, so, se))
    return out


def test_both_clis_write_the_same_four_plots(tmp_path):
    data = str(tmp_path / "data")
    with data_dir_in_both(data):
        datasets.generate_mnist_idx(None, 300, 80)
    results = _both(
        lambda pkg: ["-b", "cpu", "-p",
                     os.path.join(REPO, pkg, "models", "mnist.py"),
                     f"root.common.data_dir={data}",
                     "root.mnist.loader.minibatch_size=60",
                     "root.mnist.loader.n_train=240",
                     "root.mnist.loader.n_valid=60",
                     "root.mnist.decision.max_epochs=2"],
        lambda pkg: {"VELES_PLOTS_DIR": str(tmp_path / pkg)})
    for pkg, (rc, _, err) in zip(("veles_tpu_torch", "veles_tpu"),
                                 results):
        assert rc == 0, err[-3000:]
        plots = str(tmp_path / pkg)
        assert sorted(os.listdir(plots)) == PLOTS, pkg
        for name in PLOTS:
            assert os.path.getsize(os.path.join(plots, name)) > 1000


# -- the events, in process ------------------------------------------------

def _run_both(tmp_path, epochs=2):
    overrides = {"loader": LOADER,
                 "decision": {"max_epochs": epochs, "fail_iterations": 50}}
    with data_dir_in_both(str(tmp_path)):
        datasets.generate_mnist_idx(None, 300, 80)
        _seed_both(SEED)
        ref_events = _spy(ref_gs)
        rw = ref_mnist.create_workflow(_FL(), **overrides)
        rw.link_plotters()
        rw.initialize(device=JaxDevice(platform="cpu"))
        rw.run()
        _seed_both(SEED)
        events = _spy(graphics_server)
        w = mnist.create_workflow(_FL(), **overrides)
        w.link_plotters()
        w.initialize(device=make_device("cpu"), train=True)
        w.run()
    return (rw, [_roundtrip(e) for e in ref_events]), \
        (w, [_roundtrip(e) for e in events])


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    saved = dict(root.__dict__)
    try:
        return _run_both(tmp_path_factory.mktemp("plot_events"))
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)


def test_the_plotters_are_the_references(both_runs):
    (rw, _), (w, _) = both_runs
    assert [p.name for p in w.plotters] == [p.name for p in rw.plotters]
    assert [type(p).__name__ for p in w.plotters] == \
        [type(p).__name__ for p in rw.plotters]


def test_the_events_are_the_references(both_runs):
    (rw, ref_events), (w, events) = both_runs
    names = [e["plotter"] for e in events]
    assert names == [e["plotter"] for e in ref_events]
    assert names == ["plt_error", "plt_loss", "plt_confusion",
                     "plt_weights"] * 2
    for got, want in zip(events, ref_events):
        assert set(got) == set(want) and got["kind"] == want["kind"]
        assert got["title"] == want["title"].replace(
            rw.name, w.name), (got["title"], want["title"])
        if got["kind"] == "curves":
            assert got["ylabel"] == want["ylabel"]
            assert set(got["series"]) == set(want["series"])
            for klass, (xs, ys) in got["series"].items():
                wxs, wys = want["series"][klass]
                assert xs == wxs
                if got["ylabel"] == "error_pct":
                    assert ys == wys      # n_err and counts are exact
                else:
                    np.testing.assert_allclose(ys, wys, rtol=1e-4)
        elif got["kind"] == "matrix":
            assert got["matrix"] == want["matrix"]
            assert sum(map(sum, got["matrix"])) == LOADER["n_valid"]
        else:
            assert len(got["tiles"]) == len(want["tiles"]) == 25
            np.testing.assert_allclose(np.asarray(got["tiles"]),
                                       np.asarray(want["tiles"]),
                                       rtol=1e-4, atol=1e-5)
            assert np.asarray(got["tiles"]).shape == (25, 28, 28)


def test_the_confusion_event_is_the_decisions(both_runs):
    _, (w, events) = both_runs
    last = [e for e in events if e["plotter"] == "plt_confusion"][-1]
    from veles_tpu_torch.loader.base import VALID
    np.testing.assert_array_equal(last["matrix"],
                                  w.decision.confusion_per_class[VALID])


# -- the tiles on equal weights --------------------------------------------

@pytest.mark.parametrize("shape", [(5, 5, 3, 7), (3, 3, 1, 4), (64, 10),
                                   (48, 6), (13, 3)],
                         ids=["conv_rgb", "conv_gray", "dense_square",
                              "dense_rgb", "dense_none"])
def test_weights2d_tiles_are_the_references(shape):
    hwio = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32)
    port = params_from_jax({"fwd0": {"weights": hwio}})["fwd0"]

    class Fused:
        def host_params(self, names=None):
            assert names == ["fwd0"]
            return {"fwd0": port}

    wf = SimpleNamespace(name="wf", fused=Fused())
    p = Weights2D(wf, unit=SimpleNamespace(name="fwd0"), limit=4,
                  name="plt_weights")
    want = RefWeights2D._to_tiles(hwio)
    event = p.make_event()
    if want is None:
        assert event is None
        return
    np.testing.assert_allclose(np.asarray(event["tiles"]),
                               np.asarray(want[:4]), rtol=0, atol=1e-6)
    assert event["title"] == "wf: fwd0 weights"


# -- the wire, the config, the log level, a resume -------------------------

def test_encode_event_is_byte_equal_to_the_references():
    event = {"plotter": "p", "kind": "image_grid",
             "tiles": [np.arange(6, dtype=np.float32).reshape(2, 3)],
             "series": {"train": ([0, np.int64(1)], (np.float32(0.5),))},
             "nested": {"a": np.bool_(True), "b": [np.float64(2.25)]},
             "figsize": (6, 4)}
    assert graphics_server.encode_event(event) == ref_gs.encode_event(event)
    raw = ref_gs.encode_event(event)
    assert graphics_server.decode_event(raw) == ref_gs.decode_event(raw)
    for mod in (graphics_server, ref_gs):
        with pytest.raises(ValueError, match="JSON object"):
            mod.decode_event(b"[1, 2]")


def test_dump_config_prints_the_references_tree(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text("root.mnist.update({'loader': {'minibatch_size': 20},"
                   " 'decision': {'max_epochs': 3}})\n"
                   "root.common.note = 'x'\n")
    results = _both(lambda pkg: [
        "--dump-config", os.path.join(REPO, pkg, "models", "mnist.py"),
        str(cfg), "root.mnist.loader.n_train=100", "root.extra.k=[1, 2]"],
        timeout=120)
    (rc, out, err), (ref_rc, ref_out, ref_err) = results
    assert rc == ref_rc == 0, (err, ref_err)
    # no difference: both print the tree the config file and the
    # overrides wrote, keys sorted
    assert out == ref_out
    assert out.splitlines() == [
        "common:", "  note = 'x'", "extra:", "  k = [1, 2]", "mnist:",
        "  decision:", "    max_epochs = 3", "  loader:",
        "    minibatch_size = 20", "    n_train = 100"]


def test_verbose_logs_at_debug():
    import logging

    from veles_tpu_torch import __main__ as cli
    vlog = logging.getLogger("veles")
    saved = vlog.level
    try:
        levels = []
        for flags in (["-v"], []):
            assert cli.main(flags + ["-b", "cpu", "--dump-config",
                                     "no_such.py"]) == 0
            levels.append(vlog.level)
    finally:
        vlog.setLevel(saved)
    assert levels == [logging.DEBUG, logging.INFO]


def test_resumed_plotters_fire_again(tmp_path):
    """Gates pickle as their momentary values; initialize derives them
    from the live decision again, so a resumed run plots each of its
    epochs once."""
    with data_dir_in_both(str(tmp_path / "data")):
        datasets.generate_mnist_idx(None, 300, 80)
        prng.seed_all(SEED)
        events = _spy(graphics_server)
        w = mnist.create_workflow(_FL(), loader=LOADER,
                                  decision={"max_epochs": 1})
        w.link_plotters()
        w.initialize(device=make_device("cpu"), train=True)
        w.run()
        assert [e["plotter"] for e in events] == [
            "plt_error", "plt_loss", "plt_confusion", "plt_weights"]
        path = snapshotter.save_workflow(w, str(tmp_path / "w.pickle"))
        w2 = snapshotter.load_workflow(path)
        del events[:]
        w2.decision.max_epochs = 3
        w2.decision.complete = False
        w2.link_plotters()      # the launcher's call: keeps the pickled
        assert len(w2.plotters) == 4
        w2.initialize(device=make_device("cpu"), train=True)
        w2.run()
    assert [e["plotter"] for e in events].count("plt_error") == 2
    last = [e for e in events if e["plotter"] == "plt_error"][-1]
    assert last["series"]["train"][0] == [1, 2, 3]


def test_an_old_snapshot_without_the_new_attributes_resumes(tmp_path):
    with data_dir_in_both(str(tmp_path / "data")):
        datasets.generate_mnist_idx(None, 300, 80)
        prng.seed_all(SEED)
        w = mnist.create_workflow(_FL(), loader=LOADER,
                                  decision={"max_epochs": 1})
        w.initialize(device=make_device("cpu"), train=True)
        w.run()
        for k in ("_extra_after_decision", "plotters"):
            del w.__dict__[k]
        del w.decision.__dict__["epoch_ended_flag"]
        path = snapshotter.save_workflow(w, str(tmp_path / "w.pickle"))
        w2 = snapshotter.load_workflow(path)
        w2.decision.max_epochs = 2
        w2.decision.complete = False
        w2.initialize(device=make_device("cpu"), train=True)
        w2.run()
    assert w2.plotters == [] and w2.decision.epoch_ended_flag
    assert len(w2.decision.history) == 4


def test_render_needs_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    r = graphics_server.FileRenderer(str(tmp_path))
    with pytest.raises(graphics_server.PlotsUnavailable,
                       match="matplotlib"):
        r.render({"kind": "curves", "plotter": "p", "series": {}})
    assert json.loads(graphics_server.encode_event({"a": 1})) == {"a": 1}
