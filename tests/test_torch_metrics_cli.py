"""Metrics dirs and journals of the port, read by the reference's reader.

- One tiny AlexNet-shaped run (conv, LRN, pool, dense, softmax; the
  ``tests/test_torch_train.py`` scale) trained by both packages through
  their Launchers, each with a metrics dir: the reference's
  ``veles_tpu/obs.py`` ``load_dir`` reads both, the names of counters,
  gauges, histograms and events are the reference's but for
  :data:`NOT_PORTED`, and the integer counters are equal.
- ``python -m veles_tpu_torch -b cpu --metrics-dir D --log-events F``:
  the dir as ``obs.load_dir`` reads it, the journal in time order, and
  the events file read as the reference's sink writes it.
- ``--serve-fleet 2 ... -b cpu --metrics-dir D``: ``obs.fleet_rows`` and
  ``obs.arbiter_ledger`` over the router's dir and each replica's.
- The warm-up of a ``-b cpu --online`` hive: the first-dispatch gauge is
  set before the hello, the answers are bitwise the in-process
  engine's, and no request, dispatch, tap or buffer counter sees the
  warm-up.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from veles_tpu import obs
from veles_tpu import telemetry as ref_telemetry
from veles_tpu_torch import telemetry
from tests.test_torch_fleet import packages  # noqa: F401 — a fixture
from tests.test_torch_online_hive import (LEARN_ENV,  # noqa: F401
                                          online_pkg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WF = """
from {pkg}.loader.synthetic import SyntheticClassificationLoader
from {pkg}.ops.standard_workflow import StandardWorkflow

GD = {{"learning_rate": 0.05, "gradient_moment": 0.9}}
LAYERS = [
    {{"type": "conv_relu", "->": {{"n_kernels": 4, "kx": 5, "ky": 5,
                                   "sliding": 2}}, "<-": GD}},
    {{"type": "norm", "->": {{"n": 3}}, "<-": {{}}}},
    {{"type": "max_pooling", "->": {{"kx": 2, "ky": 2}}, "<-": {{}}}},
    {{"type": "all2all_relu", "->": {{"output_sample_shape": 8}},
      "<-": GD}},
    {{"type": "softmax", "->": {{"output_sample_shape": 3}}, "<-": GD}},
]


def create_workflow(launcher):
    w = StandardWorkflow(
        loader_factory=lambda wf: SyntheticClassificationLoader(
            wf, name="loader", n_train=32, n_valid=8, shape=(13, 13, 2),
            n_classes=3, minibatch_size=8, seed=5),
        layers=LAYERS, decision_config={{"max_epochs": 2}},
        superstep=2, name="metrics_tiny")
    launcher.workflow = w
    return w
"""

#: names the reference's run has and the port's does not, and why
#: (none: the lock witness brought the last two, ``lockstep.*``)
NOT_PORTED = set()

#: the counters both runs must count alike
INTEGER_COUNTERS = ("fused.dispatches", "fused.minibatches",
                    "fused.train_images", "fused.eval_images",
                    "loader.epochs")


def _names(reg, events):
    return (set(reg.counters) | set(reg.gauges) | set(reg.histograms)
            | {e["event"] for e in events})


@pytest.fixture
def port_telemetry():
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    yield
    telemetry.configure(None)
    if saved is not None:
        os.environ[telemetry.ENV_DIR] = saved
    telemetry.reset()


def test_tiny_run_names_and_counters_equal_the_reference(
        tmp_path, port_telemetry, monkeypatch):
    from veles_tpu.launcher import Launcher as RefLauncher
    from veles_tpu.launcher import drive_workflow as ref_drive
    from veles_tpu.serve import residency as ref_residency
    from veles_tpu_torch.launcher import Launcher, drive_workflow
    from veles_tpu_torch.serve import residency

    # a training process's own arbiter, not one an earlier test in this
    # process installed with models (its serve.* gauges would show)
    monkeypatch.setattr(ref_residency, "_process_arbiter", None)
    monkeypatch.setattr(residency, "_process_arbiter", None)

    dirs = {}
    for pkg, tm, launcher, drive in (
            ("veles_tpu", ref_telemetry, RefLauncher, ref_drive),
            ("veles_tpu_torch", telemetry, Launcher, drive_workflow)):
        wf = tmp_path / f"wf_{pkg}.py"
        wf.write_text(WF.format(pkg=pkg))
        d = dirs[pkg] = str(tmp_path / pkg)
        tm.configure(d)
        try:
            drive(launcher(backend="cpu", seed=7), str(wf))
            tm.flush()
        finally:
            tm.configure(None)
    ref_reg, _, _, ref_events = obs.load_dir(dirs["veles_tpu"])
    reg, snaps, journals, events = obs.load_dir(dirs["veles_tpu_torch"])
    assert len(snaps) == len(journals) == 1
    assert _names(reg, events) == _names(ref_reg, ref_events) - NOT_PORTED
    for name in INTEGER_COUNTERS:
        assert reg.counters[name].value == ref_reg.counters[name].value, \
            name
    assert reg.counters["fused.dispatches"].value == 6
    ledger = obs.arbiter_ledger(reg)
    assert ledger["pools"]["train"] == \
        obs.arbiter_ledger(ref_reg)["pools"]["train"] > 0


def test_training_cli_metrics_dir_and_event_log(tmp_path):
    wf = tmp_path / "wf.py"
    wf.write_text(WF.format(pkg="veles_tpu_torch"))
    d, log = tmp_path / "m", tmp_path / "events.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(telemetry.ENV_DIR, None)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
         "--metrics-dir", str(d), "--log-events", str(log), str(wf)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    reg, snaps, journals, events = obs.load_dir(str(d))
    assert len(snaps) == 1 and len(journals) == 1
    assert reg.counters["fused.train_images"].value == 64
    names = [e["event"] for e in events]
    assert names[0] == "fused.first_dispatch"
    assert names.count("loader.epoch") == 2
    assert names[-1] == "fused.summary"
    assert [e["_t"] for e in events] == sorted(e["_t"] for e in events)
    # the reference's sink format: one JSON object a log record
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert rows and all(set(r) == {"ts", "level", "unit", "message"}
                        for r in rows)
    units = {r["unit"] for r in rows}
    assert {"veles.launcher", "veles.decision"} <= units
    assert any("complete: reached max_epochs=2" in r["message"]
               for r in rows)


def _read_msg(proc):
    while True:
        line = proc.stdout.readline()
        assert line, f"process died rc={proc.poll()}"
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        if "hb" not in msg:
            return msg


def test_fleet_cli_dirs_read_by_fleet_rows(packages, tmp_path):  # noqa: F811
    d = tmp_path / "fm"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(telemetry.ENV_DIR, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--serve-fleet", "2",
         f"alpha={packages['alpha']['port_pkg']}", "-b", "cpu",
         "--max-batch", "8", "--max-wait-ms", "5", "--metrics-dir", str(d)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        bufsize=1, cwd=REPO, env=env)
    try:
        hello = _read_msg(proc)
        assert hello["ready"] and hello["fleet"] == 2
        x = np.ones((1, 6, 6, 1), np.float32)
        for i in range(6):
            proc.stdin.write(json.dumps({"id": i, "model": "alpha",
                                         "rows": x.tolist()}) + "\n")
        proc.stdin.flush()
        got = {_read_msg(proc)["id"] for _ in range(6)}
        assert got == set(range(6))
        proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    rows = obs.fleet_rows(str(d))
    assert [r["replica"] for r in rows] == [0, 1]
    router, _, _, events = obs.load_dir(str(d))
    # a request that outlives the hedge floor on a busy box is copied to
    # the other replica: each hedge the router issued is one more request
    hedges = router.counters.get("fleet.hedge.issued")
    assert sum(r["requests"] for r in rows) == \
        6 + (hedges.value if hedges else 0)
    for r in rows:
        assert r["spawns"] == 1 and r["models_resident"] == 1
        assert r["devices"] == 1 and r["pid"] in hello["replica_pids"]
        assert r["arbiter"]["pools"]["serve"] > 0
        assert r["arbiter"]["resident_bytes"] <= r["arbiter"]["budget_bytes"]
    assert router.counters["fleet.requests"].value == 6
    assert [e["event"] for e in events][-1] == "fleet.shutdown"
    assert obs.arbiter_ledger(router) is None   # the router hosts none


def test_warm_up_before_hello_counts_apart(online_pkg, tmp_path):  # noqa: F811
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.serve.client import HiveClient
    from veles_tpu_torch.serve.hive import load_model_package

    d = str(tmp_path / "hive")
    c = HiveClient({"alpha": online_pkg["port_pkg"]}, backend="cpu",
                   max_batch=8, max_wait_ms=2, heartbeat_every=0,
                   online=True, env=LEARN_ENV, cwd=REPO, metrics_dir=d)
    try:
        st = c.stats()
        assert st["gauges"]["serve.first_dispatch_seconds"] > 0
        assert st["warmup"]["dispatches"] == 1
        assert st["warmup"]["kernel_launches"] == {"lrn_fwd": 0}
        assert st["requests"] == st["dispatches"] == st["rows"] == 0
        assert st["kernel_launches"] == {"lrn_fwd": 0, "lrn_bwd": 0}
        assert "serve.requests" not in st["counters"]
        assert "serve.batches" not in st["counters"]
        assert st["online"]["tapped_rows"] == 0
        assert c.learn()["alpha"]["buffer_rows"] == 0
        xs = online_pkg["xs"][:3]
        got = [np.asarray(c.request("alpha", x[None])["probs"], np.float32)
               for x in xs]
        st = c.stats()
    finally:
        c.close()
    assert st["requests"] == 3 and st["dispatches"] == 3
    assert st["counters"]["serve.requests"] == 3
    assert st["counters"]["serve.batches"] == 3
    assert st["online"]["tapped_rows"] == 3   # the requests' own rows
    model = load_model_package("alpha", online_pkg["port_pkg"],
                               make_device("cpu"), str(tmp_path / "local"),
                               dict(root.__dict__))
    engine = EnsembleEvalEngine(model.forwards, model.member_params,
                                make_device("cpu"))
    for x, g in zip(xs, got):
        xb = np.zeros((8,) + x.shape, np.float32)
        xb[0] = x
        np.testing.assert_array_equal(g, engine.predict_proba(xb)[:1])
    _, _, _, events = obs.load_dir(d)
    names = [e["event"] for e in events]
    assert names.index("serve.first_dispatch") < names.index("serve.ready")
    assert names.count("serve.first_dispatch") == 1
