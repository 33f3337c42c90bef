"""The fault matrix: every fault point of the port armed in turn, and the
recovery each one documents checked.

Usage::

    python -m veles_tpu_torch.tools.chaos_drill [-b auto|cuda|cpu]
        [--json] [--only NAME]

The port's counterpart of the reference's ``scripts/chaos_drill.py``,
with its drills under their names.  Each drill arms one fault point (or
a pair) through :mod:`veles_tpu_torch.faults`, runs the real code path
it sits in, and checks the documented recovery and the journal event
that reports it (:mod:`veles_tpu_torch.events`):

- ``snapshot.torn_write``: a torn snapshot is refused and the lineage
  falls back to the intact predecessor;
- ``checkpoint.corrupt``: a torn GA checkpoint resumes from ``.prev``,
  bit-identically;
- ``device.oom_on_put_stream`` / ``device.oom_on_put_resident``: an
  upload that runs out of device memory is drained and retried once
  (streamed) or degrades the data set to streaming (resident), and the
  run completes;
- ``evaluator.hang_and_garbage``: a real evaluator hangs silently and
  tears its protocol; the pool catches the hang within the heartbeat
  deadline and the generation's fitnesses equal an unfaulted pass;
- ``preempt.sigterm_resume``: a SIGTERM mid-training; the final snapshot
  within the grace, exit 14 (:data:`~veles_tpu_torch.supervisor.
  EXIT_PREEMPTED`), the supervisor's resume, and a trajectory equal to
  the uninterrupted run's;
- ``supervisor.sigkill_ga_resume``: a GA run SIGKILLed mid-generation
  resumes from its checkpoint bit-identically;
- ``hive.slow_dispatch`` / ``hive.wedge`` / ``hive.garbage_response``:
  one replica of a real 2-replica fleet goes gray; hedges, the deadline
  or the integrity check keep every answer clean, and the sentinel
  ejects it (and reinstates the slow one);
- ``online.poison_batch`` / ``online.swap_mid_request``: the online
  gate never promotes poisoned labels, and a promotion raced by live
  traffic never tears an answer;
- ``fleet.replica_flap``: a replica that kills itself after every hello
  is respawned with a growing backoff while the autoscaler takes no
  action and every request is answered;
- ``multihost.peer_exit``: one rank of a 2-rank ``--multihost`` run
  dies mid-training; the survivor exits 13 within the liveness deadline
  with a final snapshot that resumes.

One of the reference's drills is not ported and is reported as such
(``"ported": false``): ``stream.corrupt_file`` needs the image-file
loader.

The drills run on the card unless ``-b cpu`` asks for the CPU; without a
card, ``-b auto`` and ``-b cuda`` exit 1 naming the missing card.  The
whole matrix runs under the lock-order witness (every child inherits
``$VELES_LOCK_WITNESS``): the edges it saw must form no cycle, name
only the port's locks and be declared in the port's locking law
(``veles_tpu_torch/analysis/lock_order.json``).  Every ejection, promotion and rollback must have
left its flight-recorder dump.  ``--only`` keeps the drills whose name
holds the substring.  The last stdout line is one JSON object::

    {"fault_drill_ok": bool, "results": [{"fault": ..., "ported": true,
     "ok": bool, "recovery_sec": float, ...}, ...], ...}

Exit code 0 when every drill that ran passed, 1 otherwise (and without a
card), 2 under ``python -O``, which strips the drills' asserts.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np

from veles_tpu_torch import events
from veles_tpu_torch.supervisor import EXIT_MULTIHOST_ABORT, EXIT_PREEMPTED

#: the repo's root: child processes run from it, the port on their path
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the reference's drills the port cannot run yet, and why
NOT_PORTED = {
    "stream.corrupt_file": "needs the image-file loader "
                           "(veles_tpu/loader/image.py), not ported: the "
                           "card's machine has no image decoder",
}


def log(msg: str) -> None:
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


class Matrix:
    """One run of the matrix: the backend every drill uses, and the
    metrics dirs its fleets and hives wrote (the witness and flight
    recorder passes read them at the end)."""

    def __init__(self, backend: str) -> None:
        self.backend = backend
        self.dirs: List[str] = []

    def device(self):
        from veles_tpu_torch.backends import make_device
        return make_device(self.backend)


def assert_journal_event(name: str) -> dict:
    """The newest ``name`` event of this process's journal (its in-memory
    ring): a fault recovered from but not reported leaves the operator
    blind, so every drill checks its event."""
    from veles_tpu_torch import telemetry
    evs = telemetry.recent_events(name)
    assert evs, \
        f"no {name!r} event in the journal (have: " \
        f"{sorted({e['event'] for e in telemetry.recent_events()})})"
    return evs[-1]


def journal_events_from_dir(mdir: str, name: str = None) -> list:
    """The events of every ``journal-*.jsonl`` in ``mdir``, in time order:
    what child processes (the supervisor, its children) reported."""
    from veles_tpu_torch import obs
    return [e for e in obs.load_dir(mdir)[3]
            if name is None or e.get("event") == name]


def fault_name(fn: Callable) -> str:
    return fn.__name__.replace("drill_", "").replace("__", ".")


def drill(fn: Callable, matrix: Matrix) -> dict:
    """Run one drill: its result record (never raises)."""
    name = fault_name(fn)
    t0 = time.monotonic()
    try:
        detail = fn(matrix) or {}
        ok = True
    except KeyboardInterrupt:
        raise
    except BaseException as e:  # noqa: BLE001 — recorded, the matrix goes on
        detail = {"error": f"{type(e).__name__}: {e}"}
        ok = False
    rec = {"fault": name, "ported": True, "ok": ok,
           "recovery_sec": round(time.monotonic() - t0, 2)}
    rec.update(detail)
    log(f"{name}: {'OK' if ok else 'FAILED'} ({rec['recovery_sec']}s) "
        f"{detail}")
    return rec


def _child_env(**extra) -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    for key in ("VELES_FAULTS", "VELES_RESUME_MANIFEST",
                "VELES_SUPERVISE_ATTEMPT"):
        env.pop(key, None)
    env.update(extra)
    return env


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# -- persistence -----------------------------------------------------------

def drill_snapshot__torn_write(matrix: Matrix):
    from veles_tpu_torch import faults
    from veles_tpu_torch.snapshotter import (SnapshotCorruptError,
                                             load_workflow, save_workflow)
    d = tempfile.mkdtemp(prefix="chaos_snap_")
    p1 = os.path.join(d, "snap_epoch1.pickle.gz")
    p2 = os.path.join(d, "snap_epoch2.pickle.gz")
    save_workflow({"marker": 1}, p1)
    faults.arm("snapshot.torn_write")
    try:
        save_workflow({"marker": 2}, p2)
    finally:
        faults.arm("")
    try:
        load_workflow(p2)
        raise AssertionError("a torn snapshot loaded verbatim")
    except SnapshotCorruptError:
        pass
    got = load_workflow(p2, fallback=True)
    assert got == {"marker": 1}, got
    ev = assert_journal_event(events.EV_SNAPSHOT_FALLBACK)
    assert ev["used"] == p1, ev
    return {"fell_back_to": os.path.basename(p1),
            "journal_event": events.EV_SNAPSHOT_FALLBACK}


def drill_checkpoint__corrupt(matrix: Matrix):
    from veles_tpu_torch import faults, prng
    from veles_tpu_torch.genetics import GeneticOptimizer, Tune

    tunes = {"x": Tune(5.0, -10.0, 10.0), "y": Tune(-3.0, -10.0, 10.0)}

    def quad(v):
        return (v["x"] - 2.0) ** 2 + (v["y"] + 1.0) ** 2

    d = tempfile.mkdtemp(prefix="chaos_ckpt_")
    state = os.path.join(d, "ga.json")
    prng.seed_all(4242)
    _, fit_ref = GeneticOptimizer(quad, tunes, population=6, generations=4,
                                  state_path=state + ".ref").run()
    # the final checkpoint's write is torn: the resume falls back to
    # .prev and still finishes bit-identically
    prng.seed_all(4242)
    faults.arm("checkpoint.corrupt@gen=4")
    try:
        GeneticOptimizer(quad, tunes, population=6, generations=4,
                         state_path=state).run()
    finally:
        faults.arm("")
    prng.seed_all(31337)   # irrelevant: the resume restores the rng
    _, fit2 = GeneticOptimizer(quad, tunes, population=6, generations=4,
                               state_path=state).run()
    assert abs(fit2 - fit_ref) < 1e-12, (fit2, fit_ref)
    ev = assert_journal_event(events.EV_GA_CHECKPOINT_FALLBACK)
    assert ev["used"].endswith(".prev"), ev
    return {"bit_identical_resume": True,
            "journal_event": events.EV_GA_CHECKPOINT_FALLBACK}


# -- device memory ---------------------------------------------------------

def _tiny_workflow(streaming: bool):
    from veles_tpu_torch import prng
    from veles_tpu_torch.datasets import synthetic_classification
    from veles_tpu_torch.loader.fullbatch import ArrayLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow
    prng.seed_all(1357)
    train, valid, _ = synthetic_classification(160, 40, (8, 8, 1),
                                               n_classes=4, seed=7)
    kw = {"max_resident_bytes": 0} if streaming else {}
    gd = {"learning_rate": 0.1}
    return StandardWorkflow(
        loader_factory=lambda w: ArrayLoader(
            w, train=train, valid=valid, minibatch_size=20, name="loader",
            **kw),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
                 "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 4},
                 "<-": gd}],
        decision_config={"max_epochs": 2}, name="chaos_wf")


def _finite_validation_loss(w) -> None:
    hist = [h for h in w.decision.history if h["class"] == "validation"]
    assert hist and np.isfinite(hist[-1]["loss"]), w.decision.history


def drill_device__oom_on_put_stream(matrix: Matrix):
    from veles_tpu_torch import faults
    w = _tiny_workflow(streaming=True)
    w.initialize(device=matrix.device(), train=True)
    assert w.fused.streaming
    faults.arm("device.oom_on_put@site=stream")
    try:
        w.run()
    finally:
        faults.arm("")
    assert w.fused.stream_oom_retries == 1, w.fused.stream_oom_retries
    _finite_validation_loss(w)
    ev = assert_journal_event(events.EV_DEVICE_OOM_RETRY)
    assert ev["site"] == "stream", ev
    return {"oom_retries": 1, "run_completed": True,
            "device": str(w.device.device),
            "journal_event": events.EV_DEVICE_OOM_RETRY}


def drill_device__oom_on_put_resident(matrix: Matrix):
    from veles_tpu_torch import faults
    w = _tiny_workflow(streaming=False)
    faults.arm("device.oom_on_put@site=resident_dataset")
    try:
        w.initialize(device=matrix.device(), train=True)
    finally:
        faults.arm("")
    # the budget said resident; the injected OOM degraded to streaming
    assert not w.loader.device_resident
    assert w.fused.streaming
    w.run()
    _finite_validation_loss(w)
    ev = assert_journal_event(events.EV_DEVICE_OOM_DEGRADED)
    assert ev["site"] == "resident_dataset", ev
    return {"degraded_to_streaming": True,
            "device": str(w.device.device),
            "journal_event": events.EV_DEVICE_OOM_DEGRADED}


# -- the GA's evaluators ---------------------------------------------------

_WINE_WF = """
from veles_tpu_torch.models import wine


def run(launcher):
    launcher.create_workflow(wine.create_workflow)
    launcher.initialize()
    launcher.run()
"""

_WINE_CFG = """
from veles_tpu_torch.config import root
from veles_tpu_torch.genetics import Tune

root.wine.decision = {"max_epochs": 3}
root.wine.layers = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": Tune(0.3, 0.01, 1.0)}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.3}},
]
"""


def _wine_ga_files(d):
    wf, cfg = os.path.join(d, "wf.py"), os.path.join(d, "cfg.py")
    for path, text in ((wf, _WINE_WF), (cfg, _WINE_CFG)):
        with open(path, "w") as f:
            f.write(text)
    return wf, cfg


def drill_evaluator__hang_and_garbage(matrix: Matrix):
    """A real evaluator hangs silently mid-genome (its heartbeats stop
    too) and tears its protocol with a garbage line on another genome:
    the pool catches the hang within the heartbeat deadline, replaces the
    evaluator, retries the genome, and the fitnesses equal an unfaulted
    pass's."""
    from veles_tpu_torch.genetics.pool import ChipEvaluatorPool

    d = tempfile.mkdtemp(prefix="chaos_ga_")
    wf, cfg = _wine_ga_files(d)
    lr = "wine.layers[0]['<-']['learning_rate']"
    values = [{lr: 0.1}, {lr: 0.3}, {lr: 0.6}]
    hb_deadline = float(os.environ.get("CHAOS_HB_DEADLINE", "10"))

    def run_pool(fault_env):
        saved = os.environ.get("VELES_FAULTS")
        if fault_env:
            os.environ["VELES_FAULTS"] = fault_env
        else:
            os.environ.pop("VELES_FAULTS", None)
        try:
            pool = ChipEvaluatorPool(
                [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
                 "--serve", wf, cfg, "-b", matrix.backend, "-s", "1234",
                 "--heartbeat-every", "0.5"],
                workers=2, timeout=600, heartbeat_deadline=hb_deadline,
                restart_backoff=0.1)
            with pool:
                fits = pool.evaluate_many(values)
            return pool, fits
        finally:
            if saved is None:
                os.environ.pop("VELES_FAULTS", None)
            else:
                os.environ["VELES_FAULTS"] = saved

    _, fits_ref = run_pool("")
    assert all(np.isfinite(f) for f in fits_ref), fits_ref
    t0 = time.monotonic()
    # job=2&seq=1: the first evaluator hangs on job 2 (its second job),
    # the replacement (where the retried job 2 comes first) does not
    pool, fits = run_pool("evaluator.hang@job=2&seq=1&silent=1&seconds=600,"
                          "evaluator.garbage_line@job=1")
    wall = time.monotonic() - t0
    assert fits == fits_ref, (fits, fits_ref)
    assert pool.hangs_detected >= 1, pool.hangs_detected
    assert pool.last_hang_kind == "heartbeat", pool.last_hang_kind
    assert pool.last_hang_wait <= hb_deadline + 5.0, pool.last_hang_wait
    ev = assert_journal_event(events.EV_GA_HANG_DETECTED)
    assert ev["kind"] == "heartbeat", ev
    assert_journal_event(events.EV_GA_EVALUATOR_RESTART)
    return {"hang_detect_sec": round(pool.last_hang_wait, 2),
            "heartbeat_deadline": hb_deadline, "fitness_parity": True,
            "wall_sec": round(wall, 1),
            "journal_event": events.EV_GA_HANG_DETECTED}


# -- preemption and the supervisor -----------------------------------------

_PHX_WF = """
import json
import os

import numpy as np

from veles_tpu_torch import prng
from veles_tpu_torch.datasets import synthetic_classification
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow


def create_workflow(launcher):
    prng.seed_all(1357)
    train, valid, _ = synthetic_classification(
        2400, 400, (8, 8, 1), n_classes=4, seed=7)
    gd = {"learning_rate": 0.1, "gradient_moment": 0.9}
    return StandardWorkflow(
        loader_factory=lambda w: ArrayLoader(
            w, train=train, valid=valid, minibatch_size=24,
            name="loader"),
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": 24}, "<-": gd},
            {"type": "softmax", "->": {"output_sample_shape": 4},
             "<-": gd},
        ],
        decision_config={"max_epochs": int(os.environ["PHX_EPOCHS"]),
                         "fail_iterations": 10000},
        snapshotter_config={"directory": os.environ["PHX_SNAP_DIR"],
                            "prefix": "phx", "interval": 1000},
        name="phx_wf")


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
    w = launcher.workflow
    hist = [[h["class"], int(h["n_err"]), float(h["loss"])]
            for h in w.decision.history]
    params = w.fused.host_params()
    ws = float(sum(np.abs(a.astype(np.float64)).sum()
                   for a in params[w.forwards[0].name].values()))
    print(json.dumps({
        "epochs": len([h for h in hist if h[0] == "validation"]),
        "hist": hist, "wsum": ws}))
"""

#: the preempted run's epochs (the reference's 200 take minutes on the
#: CPU): the SIGTERM, PHX_AFTER_S after the launcher starts its run,
#: lands mid-training on the CPU and on the card alike
PHX_EPOCHS, PHX_AFTER_S = 6, 0.5


def drill_preempt__sigterm_resume(matrix: Matrix):
    """A real SIGTERM mid-training (the injected preemption notice): the
    run stops at the next firing boundary, writes its final snapshot into
    the lineage within the grace and exits 14; the supervisor resumes it
    from that snapshot, and the finished trajectory equals the
    uninterrupted run's exactly."""
    d = tempfile.mkdtemp(prefix="chaos_preempt_")
    wf = os.path.join(d, "wf.py")
    with open(wf, "w") as f:
        f.write(_PHX_WF)
    grace = 20.0

    def env(metrics, **extra):
        return _child_env(PHX_SNAP_DIR=os.path.join(d, "snaps"),
                          PHX_EPOCHS=str(PHX_EPOCHS),
                          VELES_METRICS_DIR=metrics, **extra)

    cmd = [sys.executable, "-m", "veles_tpu_torch", "-b", matrix.backend,
           wf]
    oracle = subprocess.run(cmd, env=env(os.path.join(d, "m_oracle")),
                            capture_output=True, text=True, timeout=600,
                            cwd=REPO)
    assert oracle.returncode == 0, oracle.stderr[-800:]
    ref = _last_json(oracle.stdout)
    assert ref["epochs"] == PHX_EPOCHS, ref["epochs"]

    mdir = os.path.join(d, "m_supervised")
    res = subprocess.run(
        cmd[:3] + ["--supervise"] + cmd[3:],
        env=env(mdir, VELES_FAULTS=f"preempt.sigterm@attempt=0&after="
                                  f"{PHX_AFTER_S}",
                VELES_PREEMPT_GRACE=str(grace)),
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, \
        f"supervised run rc={res.returncode}: {res.stderr[-800:]}"
    got = _last_json(res.stdout)

    snaps = [f for f in os.listdir(os.path.join(d, "snaps"))
             if f.startswith("phx_final_preempt")]
    assert snaps, os.listdir(os.path.join(d, "snaps"))
    # requested -> final snapshot within the grace -> exit 14 -> resumed
    req = journal_events_from_dir(mdir, events.EV_PREEMPT_REQUESTED)
    fin = journal_events_from_dir(mdir, events.EV_PREEMPT_FINAL_SNAPSHOT)
    assert req and fin, journal_events_from_dir(mdir)
    assert not journal_events_from_dir(
        mdir, events.EV_PREEMPT_DEADLINE_EXCEEDED)
    snapshot_sec = fin[-1]["ts"] - req[-1]["ts"]
    assert 0 <= snapshot_sec <= grace, snapshot_sec
    restarts = journal_events_from_dir(mdir, events.EV_SUPERVISOR_RESTART)
    assert restarts and restarts[0]["rc"] == EXIT_PREEMPTED, restarts
    resumed = journal_events_from_dir(mdir, events.EV_SUPERVISOR_RESUMED)
    assert resumed and resumed[-1]["source"] == "snapshot", resumed
    assert journal_events_from_dir(mdir, events.EV_SUPERVISOR_DONE)
    assert got["wsum"] == ref["wsum"], \
        f"weight checksum diverged: {got['wsum']} != {ref['wsum']}"
    assert got["epochs"] == ref["epochs"], (got["epochs"], ref["epochs"])
    if got["hist"] != ref["hist"]:
        diffs = [(i, g, r) for i, (g, r) in
                 enumerate(zip(got["hist"], ref["hist"])) if g != r]
        first = diffs[0] if diffs else ("?", None, None)
        raise AssertionError(
            f"history diverged in {len(diffs)} of {len(ref['hist'])} rows "
            f"(lengths {len(got['hist'])}/{len(ref['hist'])}); first: row "
            f"{first[0]} got={first[1]} ref={first[2]}")
    return {"journal_event": events.EV_PREEMPT_FINAL_SNAPSHOT,
            "trajectory_match": True, "child_exit": EXIT_PREEMPTED,
            "preempt_snapshot_sec": round(snapshot_sec, 2),
            "resume_downtime_sec": resumed[-1].get("downtime"),
            "final_snapshot": snaps[0]}


#: the peer drill's liveness settings, and the seconds past the deadline
#: the survivor may take to write its final snapshot and exit
MH_HEARTBEAT, MH_DEADLINE, MH_GRACE = 0.5, 5.0, 30.0
#: rank 1 dies this long after joining, mid-training
MH_AFTER_S = 2.0


def drill_multihost__peer_exit(matrix: Matrix):
    """Rank 1 of a 2-rank ``--multihost`` run (torchrun's variables set
    by hand, ``-b`` the matrix's backend; on the card both ranks share it
    over gloo) hard-exits mid-training (17).  Rank 0 must not hang in the
    collective: it aborts cleanly, exit 13, within the deadline plus
    MH_GRACE, with a final snapshot in the lineage and the abort in its
    journal; the snapshot loads and resumes for an epoch."""
    import socket

    from veles_tpu_torch.snapshotter import load_workflow

    d = tempfile.mkdtemp(prefix="chaos_mh_")
    wf = os.path.join(d, "wf.py")
    with open(wf, "w") as f:
        f.write(_PHX_WF)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mdir = os.path.join(d, "m")
    procs = []
    for rank in range(2):
        env = _child_env(
            PHX_SNAP_DIR=os.path.join(d, "snaps"), PHX_EPOCHS="100000",
            VELES_METRICS_DIR=mdir, MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
            LOCAL_RANK=str(rank), VELES_MESH_RANKS_PER_CARD="2",
            VELES_MULTIHOST_HEARTBEAT=str(MH_HEARTBEAT),
            VELES_MULTIHOST_DEADLINE=str(MH_DEADLINE),
            VELES_FAULTS=f"multihost.peer_exit@process=1&after={MH_AFTER_S}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--multihost", "-b",
             matrix.backend, wf], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ended = [None, None]
    try:
        t_stop = time.monotonic() + 300
        while None in ended and time.monotonic() < t_stop:
            for i, p in enumerate(procs):
                if ended[i] is None and p.poll() is not None:
                    ended[i] = time.monotonic()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    err0 = procs[0].communicate()[1]
    procs[1].communicate()
    rc0, rc1 = procs[0].returncode, procs[1].returncode
    assert rc1 == 17, f"the peer did not die as injected (rc {rc1})"
    assert rc0 == EXIT_MULTIHOST_ABORT, \
        f"survivor rc {rc0}, wanted {EXIT_MULTIHOST_ABORT}: {err0[-1500:]}"
    assert "aborting cleanly" in err0, err0[-1500:]
    after_peer = ended[0] - ended[1]
    assert after_peer <= MH_DEADLINE + MH_GRACE, after_peer
    snaps = sorted(glob.glob(os.path.join(
        d, "snaps", "*_final_multihost-abort_pid*")))
    assert len(snaps) == 1, os.listdir(os.path.join(d, "snaps"))
    evs = journal_events_from_dir(mdir,
                                  events.EV_MULTIHOST_EMERGENCY_SNAPSHOT)
    assert evs and evs[-1]["path"] == snaps[0], evs
    # the final snapshot resumes: one more epoch on this process
    w = load_workflow(snaps[0])
    epoch = w.loader.epoch_number
    w.decision.max_epochs = epoch + 1
    w.initialize(device=matrix.device(), train=True)
    w.run()
    assert w.decision.complete and w.loader.epoch_number == epoch + 1
    assert all(np.isfinite(a).all() for ps in w.fused.host_params().values()
               for a in ps.values())
    return {"survivor_exit": rc0, "peer_exit": rc1,
            "survivor_after_peer_sec": round(after_peer, 2),
            "final_snapshot": os.path.basename(snaps[0]),
            "resumed_from_epoch": epoch,
            "journal_event": events.EV_MULTIHOST_EMERGENCY_SNAPSHOT}


def drill_supervisor__sigkill_ga_resume(matrix: Matrix):
    """A GA run SIGKILLed mid-generation (after the generation's
    evaluations, before its checkpoint lands): the supervisor resumes it
    from ``--ga-state``, and the finished run equals the uninterrupted
    one, best genome, fitness and final checkpoint (rng state included)
    alike."""
    d = tempfile.mkdtemp(prefix="chaos_sigkill_ga_")
    wf, cfg = _wine_ga_files(d)

    def run_ga(state, metrics, fault=None):
        env = _child_env(VELES_METRICS_DIR=metrics)
        cmd = [sys.executable, "-m", "veles_tpu_torch"]
        if fault:
            env["VELES_FAULTS"] = fault
            cmd.append("--supervise")
        cmd += ["--optimize", "5:2", "-b", f"{matrix.backend}-evaluator",
                "--ga-workers", "2", "--ga-state", state, wf, cfg]
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600, cwd=REPO)
        assert res.returncode == 0, \
            f"rc={res.returncode}: {res.stderr[-800:]}"
        return _last_json(res.stdout)

    ref = run_ga(os.path.join(d, "oracle.json"), os.path.join(d, "m_oracle"))
    mdir = os.path.join(d, "m_supervised")
    got = run_ga(os.path.join(d, "state.json"), mdir,
                 fault="supervisor.child_crash@attempt=0&gen=2")
    for key in ("best", "fitness"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    with open(os.path.join(d, "oracle.json")) as f:
        st_ref = json.load(f)
    with open(os.path.join(d, "state.json")) as f:
        st_got = json.load(f)
    assert st_got == st_ref, "the resumed GA checkpoint diverged"
    restarts = journal_events_from_dir(mdir, events.EV_SUPERVISOR_RESTART)
    assert restarts and restarts[-1]["kind"] == "crash", restarts
    resumed = journal_events_from_dir(mdir, events.EV_SUPERVISOR_RESUMED)
    assert resumed and resumed[-1]["source"] == "ga_state", resumed
    assert journal_events_from_dir(mdir, events.EV_GA_RESUMED)
    return {"journal_event": events.EV_SUPERVISOR_RESUMED,
            "bit_identical_resume": True,
            "resume_downtime_sec": resumed[-1].get("downtime")}


# -- the fleet's gray failures ---------------------------------------------

_FLEET_WF = """
from veles_tpu_torch import prng
from veles_tpu_torch.datasets import synthetic_classification
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow


def create_workflow(launcher):
    prng.seed_all(4242)
    train, valid, _ = synthetic_classification(
        64, 16, (6, 6, 1), n_classes=3, seed=5)
    return StandardWorkflow(
        loader_factory=lambda w: ArrayLoader(
            w, train=train, valid=valid, minibatch_size=16,
            name="loader"),
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": 12},
             "<-": {"learning_rate": 0.1}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.1}},
        ],
        decision_config={"max_epochs": 2}, name="chaos_fleet_wf")
"""


def build_package(d: str, name: str, wf_text: str, seed: int,
                  members: int):
    """One ensemble package of ``members`` members (the workflow's initial
    params plus gaussian noise from numpy ``seed``) whose entry is
    ``wf_text``, and its host oracle: the port's own engine over the
    package on the CPU.  (package path, oracle(x) -> mean probabilities,
    the workflow)"""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import params_to_jax
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    from veles_tpu_torch.launcher import load_workflow_module
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.serve.hive import load_model_package

    wf_path = os.path.join(d, f"{name}_wf.py")
    with open(wf_path, "w") as f:
        f.write(wf_text)

    class FL:
        workflow = None

    prng.seed_all(seed)
    cpu = make_device("cpu")
    w = load_workflow_module(wf_path).create_workflow(FL())
    w.initialize(device=cpu, train=True)
    base = params_to_jax(w.fused.host_params())
    rng = np.random.default_rng(seed)
    ms = [{"params": {fn: {pn: (a + 0.05 * rng.standard_normal(a.shape)
                                .astype(np.float32))
                           for pn, a in p.items()}
                      for fn, p in base.items()},
           "valid_error": 0.0, "seed": seed,
           "forward_names": [fw.name for fw in w.forwards], "values": None}
          for _ in range(members)]
    pkg = pack_ensemble(os.path.join(d, f"{name}.vpkg"), name, ms, wf_path)
    model = load_model_package(name, pkg, cpu,
                               os.path.join(d, f"{name}_oracle"),
                               dict(root.__dict__))
    engine = EnsembleEvalEngine(model.forwards, model.member_params, cpu)

    def oracle(x):
        return engine.predict_proba(np.asarray(x, np.float32))

    return pkg, oracle, w


def _fleet_pkg(d: str):
    pkg, oracle, _w = build_package(d, "m", _FLEET_WF, 11, 3)
    return pkg, oracle


def _gray_fleet(matrix: Matrix, fault: str, d: str, **kw):
    """A real 2-replica fleet with replica 0 armed through a per-replica
    ``VELES_FAULTS`` (replica 1 disarmed)."""
    from veles_tpu_torch.serve.router import FleetRouter
    pkg, oracle = _fleet_pkg(d)
    defaults = dict(
        n_replicas=2, backend=matrix.backend, max_batch=16, max_wait_ms=5,
        metrics_dir=os.path.join(d, "metrics"), cwd=REPO,
        env={"VELES_FAULTS": ""}, env_overrides={0: {"VELES_FAULTS": fault}})
    defaults.update(kw)
    matrix.dirs.append(defaults["metrics_dir"])
    return FleetRouter({"m": pkg}, **defaults), oracle


def _ctr(name):
    from veles_tpu_torch import telemetry
    return telemetry.counter(name).value


def _close_enough(resp, want) -> bool:
    return float(np.abs(np.asarray(resp["probs"], np.float32)
                        - want).max()) < 1e-4


def drill_hive__slow_dispatch(matrix: Matrix):
    """One replica dispatches at 1.5 s while it stays alive and
    heartbeating: hedges bridge the detection (every answer clean and
    fast), the sentinel ejects it, and once the fault is spent the
    probes reinstate it."""
    d = tempfile.mkdtemp(prefix="chaos_gray_slow_")
    router, oracle = _gray_fleet(
        matrix, "hive.slow_dispatch@label=m&times=6&seconds=1.5", d,
        deadline_ms=8000, hedge_min_ms=60, hedge_budget=1.0,
        probe_interval=0.2, probe_ok=2, probe_backoff_cap=0.4)
    hedges0 = _ctr(events.CTR_FLEET_HEDGES)
    eject0 = _ctr(events.CTR_FLEET_EJECTIONS)
    reinst0 = _ctr(events.CTR_FLEET_REINSTATEMENTS)
    try:
        x = np.ones((1, 6, 6, 1), np.float32)
        want = oracle(x)
        for _ in range(30):
            r = router.request("m", x, timeout=30)
            assert "probs" in r, r
            assert _close_enough(r, want)
            if _ctr(events.CTR_FLEET_EJECTIONS) > eject0:
                break
        assert _ctr(events.CTR_FLEET_HEDGES) > hedges0
        assert _ctr(events.CTR_FLEET_EJECTIONS) == eject0 + 1
        # after the ejection nothing waits out the stall
        post = []
        for _ in range(10):
            t0 = time.monotonic()
            assert "probs" in router.request("m", x, timeout=30)
            post.append(time.monotonic() - t0)
        assert max(post) < 1.0, post
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline \
                and _ctr(events.CTR_FLEET_REINSTATEMENTS) <= reinst0:
            time.sleep(0.25)
        assert _ctr(events.CTR_FLEET_REINSTATEMENTS) == reinst0 + 1
        ev = assert_journal_event(events.EV_FLEET_REPLICA_EJECTED)
        assert ev["replica"] == 0, ev
        assert_journal_event(events.EV_FLEET_REPLICA_REINSTATED)
        return {"hedged": _ctr(events.CTR_FLEET_HEDGES) - hedges0,
                "post_eject_max_ms": round(1000 * max(post), 1),
                "ejected_and_reinstated": True,
                "journal_event": events.EV_FLEET_REPLICA_EJECTED}
    finally:
        router.close(kill=True)


def drill_hive__wedge(matrix: Matrix):
    """A wedged batcher: requests vanish unanswered while heartbeats and
    stats keep flowing, unseen by the heartbeat monitor.  The sentinel
    ejects it with no heartbeat lost, and keeps it out (its probes are
    swallowed too)."""
    d = tempfile.mkdtemp(prefix="chaos_gray_wedge_")
    router, _oracle = _gray_fleet(
        matrix, "hive.wedge@times=*", d, deadline_ms=5000, hedge_min_ms=60,
        hedge_budget=1.0, probe_interval=0.25, probe_ok=2,
        probe_backoff_cap=0.5, heartbeat_every=0.2)
    eject0 = _ctr(events.CTR_FLEET_EJECTIONS)
    probe_fail0 = _ctr(events.CTR_FLEET_PROBES_FAILED)
    try:
        x = np.ones((1, 6, 6, 1), np.float32)
        for _ in range(25):
            assert "probs" in router.request("m", x, timeout=30)
            if _ctr(events.CTR_FLEET_EJECTIONS) > eject0:
                break
        assert _ctr(events.CTR_FLEET_EJECTIONS) == eject0 + 1
        # caught with no heartbeat lost: the monitor saw no death
        assert router.replicas[0].deaths == 0
        assert router.replicas[0].healthy
        assert router.replicas[0].client.heartbeats > 0
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline \
                and _ctr(events.CTR_FLEET_PROBES_FAILED) <= probe_fail0:
            time.sleep(0.1)
        assert _ctr(events.CTR_FLEET_PROBES_FAILED) > probe_fail0
        st = router.sentinel.status(router.replicas[0])
        assert st["state"] in ("ejected", "probing"), st
        ev = assert_journal_event(events.EV_FLEET_REPLICA_EJECTED)
        assert ev["replica"] == 0, ev
        return {"heartbeats_flowed": router.replicas[0].client.heartbeats,
                "deaths": 0, "stays_ejected": True,
                "journal_event": events.EV_FLEET_REPLICA_EJECTED}
    finally:
        router.close(kill=True)


def drill_hive__garbage_response(matrix: Matrix):
    """A replica garbles every payload after its crc was computed from the
    clean one: the router's integrity check strikes and retries on the
    peer, so no corrupt answer reaches a client, and the replica is
    ejected and stays out (its probes read garbage too)."""
    d = tempfile.mkdtemp(prefix="chaos_gray_garbage_")
    router, oracle = _gray_fleet(
        matrix, "hive.garbage_response@times=*", d, deadline_ms=8000,
        hedge_budget=0.0, probe_interval=0.25, probe_ok=2,
        probe_backoff_cap=0.5)
    strikes0 = _ctr(events.CTR_FLEET_INTEGRITY_STRIKES)
    eject0 = _ctr(events.CTR_FLEET_EJECTIONS)
    try:
        x = np.ones((2, 6, 6, 1), np.float32)
        want = oracle(x)
        corrupt_served = 0
        for _ in range(20):
            r = router.request("m", x, timeout=30)
            assert "probs" in r, r
            if not _close_enough(r, want):
                corrupt_served += 1
        assert corrupt_served == 0, \
            f"{corrupt_served} corrupt answers reached a client"
        assert _ctr(events.CTR_FLEET_INTEGRITY_STRIKES) > strikes0
        assert _ctr(events.CTR_FLEET_EJECTIONS) == eject0 + 1
        st = router.sentinel.status(router.replicas[0])
        assert st["state"] in ("ejected", "probing"), st
        assert st["reinstatements"] == 0, st
        ev = assert_journal_event(events.EV_FLEET_REPLICA_EJECTED)
        assert ev["replica"] == 0, ev
        return {"corrupt_served": 0,
                "integrity_strikes":
                    _ctr(events.CTR_FLEET_INTEGRITY_STRIKES) - strikes0,
                "journal_event": events.EV_FLEET_REPLICA_EJECTED}
    finally:
        router.close(kill=True)


# -- online learning -------------------------------------------------------

def _online_hive(matrix: Matrix, d: str, fault_env: str):
    """A real ``--serve-models --online`` hive over the fleet drills'
    package, the learner's knobs tightened for a drill's length."""
    from veles_tpu_torch.serve.client import HiveClient
    pkg, oracle = _fleet_pkg(d)
    mdir = os.path.join(d, "metrics")
    matrix.dirs.append(mdir)
    env = {"VELES_ONLINE_MICRO_BATCH": "8", "VELES_ONLINE_MIN_STEPS": "4",
           "VELES_ONLINE_LR_SCALE": "1.0",
           "VELES_ONLINE_PROMOTE_MARGIN": "5.0",
           "VELES_ONLINE_HOLDOUT_EVERY": "6", "VELES_ONLINE_IDLE_MS": "1",
           "VELES_FAULTS": fault_env}
    client = HiveClient({"m": pkg}, backend=matrix.backend, max_batch=8,
                        max_wait_ms=2, online=True, metrics_dir=mdir,
                        env=env, cwd=REPO)
    return client, oracle, mdir


def _online_rows():
    """The packaged model's own training rows and labels (regenerated:
    ``synthetic_classification`` is deterministic in its seed)."""
    from veles_tpu_torch.datasets import synthetic_classification
    train, _valid, _ = synthetic_classification(64, 16, (6, 6, 1),
                                                n_classes=3, seed=5)
    return train


def drill_online__poison_batch(matrix: Matrix):
    """Corrupted labels in the training slot (the held-out slice stays
    honest) are caught by the gate: on clean traffic the incumbent is
    near-perfect on the held-out slice, the shadow trained on garbage
    cannot beat it, and nothing is promoted."""
    d = tempfile.mkdtemp(prefix="chaos_online_poison_")
    client, oracle, mdir = _online_hive(
        matrix, d, "online.poison_batch@slot=train&times=*")
    try:
        xs, _ys = _online_rows()
        deadline = time.monotonic() + 90
        row = None
        i = 0
        while time.monotonic() < deadline:
            for _ in range(8):
                x = xs[i % len(xs)][None]
                i += 1
                # clean labels: the ensemble's own answer
                lab = [int(np.argmax(oracle(x), axis=-1)[0])]
                r = client.wait_for(client.submit("m", x, label=lab),
                                    timeout=60)
                assert "error" not in r, r
            row = client.learn().get("m")
            if row and row["steps"] >= 12 and \
                    row["shadow_error_pct"] is not None:
                break
            time.sleep(0.05)
        assert row and row["steps"] >= 12, row
        assert row["shadow_error_pct"] is not None, row
        assert row["promotions"] == 0, \
            f"poisoned training labels were promoted: {row}"
        gates = journal_events_from_dir(mdir, events.EV_ONLINE_GATE)
        assert gates, "no online.gate round in the journal"
        assert all(g["verdict"] != "promote" for g in gates), gates
        return {"steps": row["steps"],
                "shadow_error_pct": row["shadow_error_pct"],
                "incumbent_error_pct": row["incumbent_error_pct"],
                "promotions": 0, "journal_event": events.EV_ONLINE_GATE}
    finally:
        client.close()


def drill_online__swap_mid_request(matrix: Matrix):
    """A promotion raced by live dispatches (the injected stall widens the
    swap to 0.5 s while a closed loop hammers the model): every answer
    equals the frozen package's or the one post-promotion answer; a
    third payload would be torn params."""
    d = tempfile.mkdtemp(prefix="chaos_online_swap_")
    client, oracle, mdir = _online_hive(
        matrix, d, "online.swap_mid_request@model=m&seconds=0.5")
    try:
        xs, ys = _online_rows()
        probe = xs[:2]
        want_old = oracle(probe)
        answers = []
        deadline = time.monotonic() + 90
        i = 0
        promoted = False
        while time.monotonic() < deadline:
            for _ in range(6):
                j = i % len(xs)
                i += 1
                # drifted truth: the frozen model is consistently wrong,
                # so the gate has something real to promote
                lab = [int((ys[j] + 1) % 3)]
                r = client.wait_for(
                    client.submit("m", xs[j][None], label=lab), timeout=60)
                assert "error" not in r, r
            r = client.request("m", probe, timeout=60)
            assert "probs" in r, r
            answers.append(np.asarray(r["probs"], np.float32))
            row = client.learn().get("m")
            if row and row["promotions"] >= 1:
                promoted = True
                break
            time.sleep(0.05)
        assert promoted, "no promotion under the stall"
        want_new = np.asarray(client.request("m", probe, timeout=60)["probs"],
                              np.float32)
        assert np.abs(want_new - want_old).max() >= 1e-4, \
            "the promotion did not change the served params"
        torn = [a for a in answers
                if np.abs(a - want_old).max() >= 1e-4
                and np.abs(a - want_new).max() >= 1e-4]
        assert not torn, f"{len(torn)} torn answer(s) mid-swap"
        promos = journal_events_from_dir(mdir, events.EV_ONLINE_PROMOTED)
        assert promos and promos[-1]["model"] == "m", promos
        row = client.learn()["m"]
        return {"answers_checked": len(answers), "torn": 0,
                "time_to_serve_ms": row.get("time_to_serve_ms"),
                "journal_event": events.EV_ONLINE_PROMOTED}
    finally:
        client.close()


def drill_fleet__replica_flap(matrix: Matrix):
    """Replica 0 SIGKILLs itself shortly after every hello (``times=*``:
    each respawn inherits the arming): the respawn backoff grows (no
    spawn storm), the healthy peer answers every request, and the
    autoscaler, watching the healthy replicas' pressure, takes no
    action (a flapping member is a health problem, not a capacity
    signal)."""
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.serve.autoscale import (FleetAutoscaler,
                                                 ScaleController)
    d = tempfile.mkdtemp(prefix="chaos_flap_")
    mdir = os.path.join(d, "metrics")
    router, oracle = _gray_fleet(
        matrix, "fleet.replica_flap@times=*&after=0.6", d,
        respawn_backoff=0.4, heartbeat_every=0.2, heartbeat_deadline=2.0)
    scaler = FleetAutoscaler(
        router,
        controller=ScaleController(
            min_replicas=2, max_replicas=3, up_ms=400.0, down_ms=10.0,
            up_sustain_s=1.0, down_sustain_s=2.0, cooldown_s=3.0),
        interval_s=0.2)
    try:
        x = np.ones((1, 6, 6, 1), np.float32)
        want = oracle(x)
        scaler.start()
        # traffic flows for at least 12 s and until replica 0 has flapped
        # 3 times (a loaded host respawns slowly): the window follows
        # the deaths it checks, within a 180 s cap
        t0 = time.monotonic()
        answered = 0
        flapper = router.replicas[0]
        while time.monotonic() - t0 < 12.0 or (
                flapper.deaths < 3 and time.monotonic() - t0 < 180.0):
            r = router.request("m", x, timeout=30)
            assert "probs" in r, r
            assert _close_enough(r, want)
            answered += 1
            time.sleep(0.05)
        window = time.monotonic() - t0
        telemetry.flush()
        deaths = [e for e in journal_events_from_dir(
            mdir, events.EV_FLEET_REPLICA_DIED) if e.get("replica") == 0]
        assert len(deaths) >= 2, \
            f"replica 0 flapped only {len(deaths)}x in {window:.1f}s"
        # the backoff grows with consecutive deaths: each flap costs at
        # least `after` plus the backoff, so the window bounds the deaths
        backoffs = [e.get("backoff", 0.0) for e in deaths]
        assert backoffs == sorted(backoffs), backoffs
        assert backoffs[-1] > backoffs[0], backoffs
        assert len(deaths) <= int(window / 0.6) + 1, \
            f"{len(deaths)} deaths in {window}s is a spawn hot-loop"
        assert not journal_events_from_dir(mdir, events.EV_FLEET_SCALE_UP)
        assert not journal_events_from_dir(mdir, events.EV_FLEET_SCALE_DOWN)
        assert len(router.replicas) == 2
        assert answered > 0
        return {"answered": answered, "lost": 0,
                "flap_deaths": len(deaths),
                "backoff_first_s": round(backoffs[0], 2),
                "backoff_last_s": round(backoffs[-1], 2),
                "scale_actions": 0,
                "journal_event": events.EV_FLEET_REPLICA_DIED}
    finally:
        scaler.close()
        router.close(kill=True)


#: the matrix, in the reference's order (its two unported drills are in
#: NOT_PORTED)
DRILLS = [
    drill_snapshot__torn_write,
    drill_checkpoint__corrupt,
    drill_device__oom_on_put_stream,
    drill_device__oom_on_put_resident,
    drill_evaluator__hang_and_garbage,
    drill_preempt__sigterm_resume,
    drill_supervisor__sigkill_ga_resume,
    drill_hive__slow_dispatch,
    drill_hive__wedge,
    drill_hive__garbage_response,
    drill_online__poison_batch,
    drill_online__swap_mid_request,
    drill_fleet__replica_flap,
    drill_multihost__peer_exit,
]


def _cyclic(edges) -> bool:
    graph: Dict[str, set] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    state: Dict[str, int] = {}

    def visit(n) -> bool:
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m) == 1 or (m not in state and visit(m)):
                return True
        state[n] = 2
        return False

    return any(n not in state and visit(n) for n in list(graph))


def witness_pass(dirs: List[str]) -> dict:
    """The lock-order witness over the matrix: this process's edges and
    every child's snapshot; they must form no cycle, name only the
    port's locks (``witness.LOCK_NAMES``) and be declared in the port's
    locking law (``veles_tpu_torch/analysis/lock_order.json``)."""
    from veles_tpu_torch.analysis import flow, witness
    observed = set(witness.observed_edges())
    for mdir in dirs:
        if os.path.isdir(mdir):
            observed |= set(witness.read_snapshots(mdir))
    undeclared = sorted({n for e in observed for n in e}
                        - witness.LOCK_NAMES)
    law = flow.load_lock_order(flow.LAW_PATH)
    outside = sorted(observed - flow.declared_edges(law or {}))
    cycle = _cyclic(observed)
    ok = law is not None and not undeclared and not outside and not cycle
    if ok:
        log(f"lock witness: {len(observed)} observed edge(s), no cycle, "
            f"every lock and edge declared in the locking law")
    else:
        log(f"LOCK WITNESS: undeclared locks {undeclared}, edges outside "
            f"the law {outside}, cycle {cycle} in {sorted(observed)}")
    return {"ok": ok, "edges": len(observed)}


def flight_recorder_pass(dirs: List[str]) -> dict:
    """Every ejection, promotion and rollback the matrix provoked left a
    ``flightrec-*.json`` dump next to its journal."""
    reason_of = {events.EV_FLEET_REPLICA_EJECTED: "ejection",
                 events.EV_ONLINE_PROMOTED: "promote",
                 events.EV_ONLINE_ROLLBACK: "rollback"}
    real = []
    for mdir in dirs:
        if os.path.isdir(mdir) and os.path.realpath(mdir) not in real:
            real.append(os.path.realpath(mdir))
    # a dir nested in another is walked with it
    real = [d for d in real if not any(
        d != o and (d + os.sep).startswith(o + os.sep) for o in real)]
    need: Dict[str, int] = {}
    reasons: List[str] = []
    for mdir in real:
        for jf in glob.glob(os.path.join(mdir, "**", "journal-*.jsonl"),
                            recursive=True):
            try:
                with open(jf) as f:
                    for line in f:
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        r = reason_of.get(ev.get("event"))
                        if r:
                            need[r] = need.get(r, 0) + 1
            except OSError:
                continue
        for fp in glob.glob(os.path.join(mdir, "**", "flightrec-*.json"),
                            recursive=True):
            try:
                with open(fp) as f:
                    reasons.append(json.load(f).get("reason"))
            except (OSError, ValueError):
                continue
    missing = {r: n for r, n in sorted(need.items())
               if reasons.count(r) < n}
    if missing:
        log(f"FLIGHT RECORDER: events without a dump {missing} (dumps: "
            f"{sorted(reasons)})")
    else:
        log(f"flight recorder: {len(reasons)} dump(s) cover "
            f"{sum(need.values())} eject/promote/rollback event(s)")
    return {"ok": not missing, "dumps": len(reasons)}


def selected(only: str = None):
    """(the drills to run, the unported ones to list) for ``--only``."""
    todo = [f for f in DRILLS if not only or only in f.__name__
            or only in fault_name(f)]
    skipped = [n for n in NOT_PORTED if not only or only in n]
    return todo, skipped


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chaos_drill")
    p.add_argument("-b", "--backend", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="where the drills run: the card (auto, cuda) or "
                        "the CPU")
    p.add_argument("--json", action="store_true",
                   help="stdout carries only the final JSON record")
    p.add_argument("--only", default=None,
                   help="substring filter on the drills' names")
    args = p.parse_args(argv)

    if not __debug__:
        print("chaos_drill: its checks are assert statements, which python -O "
              "strips: run it without -O", file=sys.stderr)
        return 2
    import torch
    backend = "cpu" if args.backend == "cpu" else "cuda"
    if backend == "cuda" and not torch.cuda.is_available():
        print(f"chaos_drill: -b {args.backend} needs a CUDA card and "
              f"torch.cuda.is_available() is False; pass -b cpu to drill "
              f"on the CPU", file=sys.stderr)
        return 1

    # every drill checks that its fault is reported in the journal: a
    # scratch metrics dir when the caller gave none (children inherit it)
    from veles_tpu_torch import telemetry
    if telemetry.metrics_dir() is None:
        telemetry.configure(tempfile.mkdtemp(prefix="chaos_metrics_"))
    log(f"journal and metrics dir: {telemetry.metrics_dir()}, backend "
        f"{backend}")
    # the whole matrix under the lock-order witness
    os.environ.setdefault("VELES_LOCK_WITNESS", "1")

    matrix = Matrix(backend)
    todo, skipped = selected(args.only)
    results = [drill(f, matrix) for f in todo]
    ok = all(r["ok"] for r in results)
    dirs = [telemetry.metrics_dir()] + matrix.dirs
    wit = witness_pass(dirs)
    rec = flight_recorder_pass(dirs)
    ok = ok and wit["ok"] and rec["ok"]
    record = {
        "fault_drill_ok": ok,
        "backend": backend,
        "fault_drill_journal_verified": bool(results) and all(
            r.get("journal_event") for r in results),
        "lock_witness_ok": wit["ok"],
        "lock_witness_edges": wit["edges"],
        "flight_recorder_ok": rec["ok"],
        "flight_recorder_dumps": rec["dumps"],
        "results": results + [{"fault": n, "ported": False,
                               "why": NOT_PORTED[n]} for n in skipped],
    }
    print(json.dumps(record), flush=True)
    if not args.json:
        log(f"{'ALL OK' if ok else 'FAILURES'} "
            f"({sum(r['ok'] for r in results)}/{len(results)}; "
            f"{len(skipped)} not ported)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
