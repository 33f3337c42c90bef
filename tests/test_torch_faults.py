"""The port's fault helpers and sites, armed as the reference's
``tests/test_faultline.py`` arms them (``$VELES_FAULTS``, or
``faults.arm`` in process), each firing as the reference's does.

Helpers: ``maybe_inject_sigterm`` (a real SIGTERM, only for the armed
attempt), ``maybe_inject_child_crash`` (SIGKILL, only for the armed
generation), ``truncate_file``.  Sites: ``snapshot.torn_write`` (the
lineage fallback resumes the intact predecessor), ``checkpoint.corrupt``
(the GA resumes from ``.prev`` bit-identically), ``device.oom_on_put``
at the streaming upload (drained and retried once), the resident upload
(degraded to streaming) and a GA cohort (raised for the evaluator's
split), ``online.swap_mid_request`` (the promotion waits), the
``online.poison_batch`` labels equal the reference tap's,
``preempt.sigterm`` through the training CLI (the GA's sites are
``tests/test_torch_faults_ga.py``'s).  The knobs this slice reads go
through ``knobs`` with the reference's fallbacks.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from veles_tpu import faults as ref_faults
from veles_tpu_torch import faults, knobs, prng, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    faults.arm("")
    # the GA exports its generation: none leaks between tests
    monkeypatch.delenv(knobs.GA_GENERATION, raising=False)
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    yield
    faults.arm("")
    telemetry.configure(None)
    if saved is not None:
        os.environ[telemetry.ENV_DIR] = saved
    telemetry.reset()


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.path.join(
        REPO, "tests"))
    env.pop(telemetry.ENV_DIR, None)
    env.update(kw)
    return env


# -- knobs --------------------------------------------------------------

SLICE_KNOBS = ["VELES_METRICS_DIR", "VELES_FAULTS", "VELES_FAULTS_SEED",
               "VELES_PREEMPT_GRACE", "VELES_PREEMPT_DISABLE",
               "VELES_SUPERVISE_ATTEMPT", "VELES_SUPERVISE_MAX_CRASHES",
               "VELES_SUPERVISE_CRASH_WINDOW", "VELES_RESUME_MANIFEST",
               "VELES_HBM_BUDGET", "VELES_MAX_RESIDENT_BYTES",
               "VELES_GA_GENERATION", "VELES_SOM_FUSED",
               "VELES_SOM_SUPERSTEP"]


def test_the_slices_knobs_are_declared_and_read_through_knobs(
        monkeypatch):
    from veles_tpu import knobs as ref_knobs
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.supervisor import Supervisor
    assert set(SLICE_KNOBS) <= knobs.names()
    # the port's own knobs (ranks sharing one card over gloo; the
    # reference's virtual devices are an XLA flag) have no counterpart
    assert knobs.PORT_ONLY == {"VELES_MESH_RANKS_PER_CARD"}
    assert knobs.names() - knobs.PORT_ONLY <= ref_knobs.names()
    monkeypatch.setenv("VELES_PREEMPT_GRACE", "7.5")
    monkeypatch.setenv("VELES_SUPERVISE_MAX_CRASHES", "x")
    monkeypatch.setenv("VELES_SUPERVISE_CRASH_WINDOW", "12")
    grace = Launcher.preempt_grace(object.__new__(Launcher))
    sup = Supervisor(["wf.py"])
    assert (grace, sup.max_crashes, sup.crash_window) == (7.5, 5, 12.0)


# -- the helpers ---------------------------------------------------------

SIGTERM_PROBE = """
import signal, sys, time
from veles_tpu_torch import faults
got = []
signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
faults.maybe_inject_sigterm(attempt=int(sys.argv[1]), mode="standalone")
deadline = time.monotonic() + 2
while not got and time.monotonic() < deadline:
    time.sleep(0.01)
print("TERM" if got else "none")
"""

CRASH_PROBE = """
import sys
from veles_tpu_torch import faults
for gen in range(3):
    faults.maybe_inject_child_crash(gen=gen, attempt=0)
    print("survived", gen, flush=True)
"""


def test_maybe_inject_sigterm_only_on_the_armed_attempt():
    env = _env(VELES_FAULTS="preempt.sigterm@attempt=0&after=0.1")
    out = [subprocess.run([sys.executable, "-c", SIGTERM_PROBE, a],
                          env=env, capture_output=True, text=True,
                          timeout=60).stdout.strip() for a in ("0", "1")]
    assert out == ["TERM", "none"]


def test_maybe_inject_child_crash_kills_the_armed_generation():
    p = subprocess.run([sys.executable, "-c", CRASH_PROBE],
                       env=_env(VELES_FAULTS="supervisor.child_crash@gen=1"),
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == -9
    assert p.stdout.split("\n")[:1] == ["survived 0"]
    assert "survived 1" not in p.stdout


def test_truncate_file(tmp_path):
    for size, frac, want in ((100, 0.5, 50), (10, 0.0, 1), (10, 1.0, 9)):
        f = tmp_path / f"f{size}{frac}"
        f.write_bytes(b"x" * size)
        faults.truncate_file(str(f), frac)
        assert f.stat().st_size == want


# -- snapshots and GA checkpoints ----------------------------------------

def test_torn_snapshot_write_falls_back_to_the_intact_one(tmp_path,
                                                          monkeypatch):
    from veles_tpu_torch.snapshotter import (load_workflow, save_workflow,
                                             verify_snapshot)
    good = str(tmp_path / "run_epoch1_5.0pt.pickle")
    torn = str(tmp_path / "run_epoch2_4.0pt.pickle")
    save_workflow({"epoch": 1}, good)
    time.sleep(0.01)
    monkeypatch.setenv(faults.ENV_VAR, "snapshot.torn_write")
    faults.arm(None)
    save_workflow({"epoch": 2}, torn)
    assert verify_snapshot(good) and not verify_snapshot(torn)
    assert load_workflow(torn, fallback=True) == {"epoch": 1}
    c = telemetry.snapshot()["counters"]
    assert c["snapshot.saves"] == 2 and c["snapshot.fallbacks"] == 1
    ev = telemetry.recent_events("snapshot.fallback")[-1]
    assert (ev["corrupt"], ev["used"]) == (torn, good)


def _quad(v):
    return (v["x"] - 2.0) ** 2 + (v["y"] + 1.0) ** 2


def test_corrupt_ga_checkpoint_resumes_from_prev_bit_identically(
        tmp_path):
    from veles_tpu_torch.genetics import GeneticOptimizer, Tune
    tunes = {"x": Tune(0.0, -5.0, 5.0), "y": Tune(0.0, -5.0, 5.0)}
    prng.seed_all(4242)
    _, fit_ref = GeneticOptimizer(_quad, tunes, population=6,
                                  generations=4,
                                  state_path=str(tmp_path / "ref.json")
                                  ).run()
    state = str(tmp_path / "ga.json")
    prng.seed_all(4242)
    faults.arm("checkpoint.corrupt@gen=4")
    GeneticOptimizer(_quad, tunes, population=6, generations=4,
                     state_path=state).run()
    faults.arm("")
    prng.seed_all(999999)   # the resume restores the rng from the file
    _, fit = GeneticOptimizer(_quad, tunes, population=6, generations=4,
                              state_path=state).run()
    assert fit == fit_ref
    assert telemetry.counter("ga.checkpoint_fallbacks").value == 1
    assert telemetry.recent_events("ga.resumed")[-1]["generation"] == 3


# -- device OOM ----------------------------------------------------------

def _workflow(max_resident_bytes=None):
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.datasets import synthetic_classification
    from veles_tpu_torch.loader.fullbatch import ArrayLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow
    prng.seed_all(7)
    train, valid, _ = synthetic_classification(48, 16, (6, 6, 1),
                                               n_classes=3, seed=5)
    gd = {"learning_rate": 0.1, "gradient_moment": 0.9}
    w = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(
            wf, train=train, valid=valid, minibatch_size=8, name="loader",
            max_resident_bytes=max_resident_bytes),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
                 "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": gd}],
        decision_config={"max_epochs": 2}, name="oom_wf")
    return w, make_device("cpu")


def _losses(w):
    return [h["loss"] for h in w.decision.history]


def test_streaming_upload_oom_drains_and_retries_once():
    w, dev = _workflow(max_resident_bytes=0)
    w.initialize(device=dev, train=True)
    w.run()
    want = _losses(w)
    w, dev = _workflow(max_resident_bytes=0)
    w.initialize(device=dev, train=True)
    faults.arm("device.oom_on_put@site=stream")
    w.run()
    assert w.fused.streaming and w.fused.stream_oom_retries == 1
    assert _losses(w) == want
    assert telemetry.counter("fused.stream_oom_retries").value == 1
    assert telemetry.recent_events("device.oom_retry")[-1]["site"] == \
        "stream"
    # a second OOM in a row is not transient: it propagates
    w, dev = _workflow(max_resident_bytes=0)
    w.initialize(device=dev, train=True)
    faults.arm("device.oom_on_put@site=stream&times=2")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        w.run()


def test_resident_upload_oom_degrades_to_streaming():
    w, dev = _workflow()
    faults.arm("device.oom_on_put@site=resident_dataset")
    w.initialize(device=dev, train=True)
    faults.arm("")
    assert not w.loader.device_resident and w.fused.streaming
    assert w.loader.original_data is None and w.loader.host_data is not None
    w.run()
    assert np.isfinite(_losses(w)).all()
    assert telemetry.counter("device.oom_degraded").value == 1


def test_cohort_oom_raises_for_the_evaluators_split():
    from veles_tpu_torch.ops.population import PopulationTrainEngine
    w, dev = _workflow()
    w.initialize(device=dev, train=True)
    rates = np.full((2, 2, 2), 0.1, np.float32)
    engine = PopulationTrainEngine(w, rates, np.zeros_like(rates))
    faults.arm("device.oom_on_put@site=cohort&members=2")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        engine.run()
    assert np.isfinite(engine.run()).all()   # once only
    assert telemetry.counter("ga.cohorts").value == 2
    assert telemetry.counter("ga.cohort_members").value == 4
    assert telemetry.histogram("ga.cohort_train").count == 2
    assert telemetry.recent_events("ga.cohort_train")[-1]["members"] == 2


# -- online --------------------------------------------------------------

class _Engine:
    def notify_next_dispatch(self, cb):
        self.cb = cb


class _Residency:
    def __init__(self):
        self.engine, self.swapped = _Engine(), []

    def swap_params(self, name, stacked):
        self.swapped.append((name, stacked))
        return self.engine


def test_swap_mid_request_stalls_the_promotion():
    from veles_tpu_torch.online.promote import PromotionGate
    res = _Residency()
    gate = PromotionGate("alpha", res, margin=1.0, min_steps=2)
    faults.arm("online.swap_mid_request@model=alpha&seconds=0.3")
    gate.decide(4, 10.0, 20.0)
    gate.last_step_ts = time.monotonic()
    t0 = time.monotonic()
    gate.promote("params", 4)
    assert time.monotonic() - t0 >= 0.3
    assert res.swapped == [("alpha", "params")]
    res.engine.cb()
    assert gate.time_to_serve_ms >= 300
    assert telemetry.gauge("online.time_to_serve").value >= 0.3
    assert telemetry.counter("online.promotions").value == 1
    assert telemetry.recent_events("online.gate")[-1]["verdict"] == \
        "promote"
    gate.promote("again", 8)   # times=1: no second stall
    assert telemetry.counter("online.promotions").value == 2


def test_poisoned_labels_equal_the_reference_taps():
    from veles_tpu.online.buffer import ReplayBuffer as RefBuffer
    from veles_tpu.online.tap import TrafficTap as RefTap
    from veles_tpu_torch.online.buffer import ReplayBuffer
    from veles_tpu_torch.online.tap import TrafficTap
    spec = "online.poison_batch@slot=train&times=*"
    rows = np.random.default_rng(3).standard_normal((24, 4)).astype(
        np.float32)
    got = {}
    for name, tap, buf, f in (("port", TrafficTap, ReplayBuffer, faults),
                              ("ref", RefTap, RefBuffer, ref_faults)):
        f.arm(spec)
        try:
            t, b = tap(1.0), buf(64, seed=1, holdout_every=4)
            t.arm("m", b)
            for i in range(24):
                t.tap("m", i, rows[i:i + 1], [i % 3])
        finally:
            f.arm("")
        got[name] = b.holdout(), b.sample(8, np.random.default_rng(0))
    (ph, ps), (rh, rs) = got["port"], got["ref"]
    np.testing.assert_array_equal(ph[1], rh[1])
    np.testing.assert_array_equal(ps[1], rs[1])
    assert list(ph[1]) == [i % 3 for i in range(3, 24, 4)]   # clean
    assert telemetry.counter("online.labeled_rows").value == 24


# -- preempt.sigterm through the CLIs ------------------------------------

def test_preempt_sigterm_through_the_training_cli(tmp_path):
    m = tmp_path / "m"
    snapdir = tmp_path / "snaps"
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
         "--metrics-dir", str(m),
         os.path.join(REPO, "veles_tpu_torch", "models", "wine.py"),
         "root.wine.decision.max_epochs=3",
         f"root.wine.snapshotter={{'directory': '{snapdir}', "
         f"'compression': ''}}"],
        env=_env(VELES_FAULTS="preempt.sigterm@attempt=0&mode=standalone"),
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 14, p.stderr[-2000:]
    assert [f for f in os.listdir(snapdir) if "_final_preempt-SIGTERM" in f]
    evs = [json.loads(ln)["event"] for f in m.glob("journal-*.jsonl")
           for ln in f.read_text().splitlines()]
    assert evs.index("preempt.requested") < \
        evs.index("preempt.final_snapshot")
    (snap,) = m.glob("metrics-*.json")
    assert json.loads(snap.read_text())["counters"][
        "preempt.final_snapshots"] == 1
