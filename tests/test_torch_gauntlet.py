"""The port's production day (``veles_tpu_torch/tools/gauntlet.py``)
against the reference's ``scripts/gauntlet.py``, without a fleet:

- the day's spec from the same ``GAUNTLET_*`` knobs, with the same
  defaults, and the determinism pin's trace file bitwise the
  reference's;
- :func:`accountability_check` on a scripted dir and ledger: a balanced
  day is accounted, with the reference's verdict on the same journals;
  an arrival with no outcome, an error, a crc mismatch, an uncaused
  scale event, an orphan retirement, an uncaused ejection and an
  unexplained death each fail it.
"""

import importlib.util
import json
import os
import zlib

import numpy as np
import pytest

from veles_tpu_torch.serve.traffic import Arrival
from veles_tpu_torch.tools import gauntlet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "ref_gauntlet", os.path.join(REPO, "scripts", "gauntlet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("knobs", [{}, {"GAUNTLET_DURATION": "30",
                                        "GAUNTLET_PEAK_RPS": "8",
                                        "GAUNTLET_SWING": "1",
                                        "GAUNTLET_BURST_MULT": "10",
                                        "GAUNTLET_SEED": "5"}])
def test_the_spec_and_its_trace_are_the_references(ref, knobs, tmp_path,
                                                   monkeypatch):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    spec, ref_spec = gauntlet._spec(), ref._spec()
    assert spec.to_dict() == ref_spec.to_dict()
    assert gauntlet._determinism_pin(spec, str(tmp_path))
    from veles_tpu.serve.traffic import generate as ref_generate
    from veles_tpu.serve.traffic import write_trace as ref_write
    from veles_tpu_torch.serve.traffic import generate, write_trace
    write_trace(str(tmp_path / "port.jsonl"), spec, generate(spec))
    ref_write(str(tmp_path / "ref.jsonl"), ref_spec, ref_generate(ref_spec))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


def _journal(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


#: a balanced day's journals: the router's and one replica's
ROUTER = [
    {"ts": 1.0, "event": "fleet.ready", "replicas": 1},
    {"ts": 2.0, "event": "fleet.replica_spawned", "replica": 1},
    {"ts": 2.0, "event": "fleet.scale.up", "replica": 1,
     "cause": "pressure", "n_replicas": 2},
    {"ts": 3.0, "event": "fleet.degrade.engage", "rung": "learner",
     "cause": "pressure"},
    {"ts": 4.0, "event": "fleet.degrade.release", "rung": "learner",
     "cause": "idle"},
    {"ts": 5.0, "event": "fleet.eject.replica", "replica": 0,
     "score": 4.2, "strikes": {"hedge_loss": 3}, "state": "ejected"},
    {"ts": 6.0, "event": "fleet.eject.reinstated", "replica": 0,
     "probes_ok": 2, "state": "healthy"},
    {"ts": 7.0, "event": "fleet.replica_died", "replica": 2},
    {"ts": 8.0, "event": "fleet.replica_spawned", "replica": 2},
    {"ts": 9.0, "event": "fleet.replica_retired", "replica": 1},
    {"ts": 9.0, "event": "fleet.scale.down", "replica": 1,
     "cause": "idle", "n_replicas": 1},
    {"ts": 9.5, "event": "fleet.replica_died", "replica": 1},
    {"ts": 9.8, "event": "fleet.replica_died", "replica": 3},
]
REPLICA = [{"ts": 5.5, "event": "online.promoted", "model": "hot",
            "shadow_error_pct": 1.0, "incumbent_error_pct": 9.0}]
#: replica 3 was the day's preemption
PREEMPTIONS = [{"replica": 3, "t": 4.0, "pid": 1}]


def _day(tmp_path, router=ROUTER, replica=REPLICA):
    mdir = str(tmp_path / "m")
    _journal(os.path.join(mdir, "journal-100.jsonl"), router)
    _journal(os.path.join(mdir, "replica-0", "journal-200.jsonl"), replica)
    arrivals = [Arrival(i, 0.1 * i, "hot", 1000 + i, False)
                for i in range(6)]
    results = []
    for a in arrivals:
        probs = np.random.default_rng(a.row_seed).random((8, 3)).astype(
            np.float32)
        results.append({"i": a.i, "t": a.t, "status": "ok",
                        "response": {"probs": probs.tolist(),
                                     "crc": zlib.crc32(probs.tobytes()),
                                     "rows_n": 8}})
    results[-1] = {"i": 5, "t": 0.5, "status": "shed",
                   "response": {"error": "overloaded", "overloaded": True}}
    return mdir, arrivals, results


def test_a_balanced_day_is_accounted_as_the_reference_accounts_it(
        ref, tmp_path):
    mdir, arrivals, results = _day(tmp_path)
    got = gauntlet.accountability_check(mdir, PREEMPTIONS, arrivals,
                                        results)
    assert got["accounted"] and got["unexplained"] == []
    assert (got["lost"], got["errors"], got["corrupt"],
            got["crc_checked"]) == (0, 0, 0, 5)
    want = ref.accountability_check(mdir, PREEMPTIONS)
    assert want["accounted"]
    assert got["explained"] == want["explained"] == 11


def _unexplained(tmp_path, **kw):
    mdir, arrivals, results = _day(tmp_path, **{
        k: v for k, v in kw.items() if k in ("router", "replica")})
    if "edit" in kw:
        arrivals, results = kw["edit"](arrivals, results)
    got = gauntlet.accountability_check(mdir, PREEMPTIONS, arrivals,
                                        results)
    assert not got["accounted"]
    return got, [u["event"] for u in got["unexplained"]]


def test_an_arrival_with_no_outcome_fails_the_day(tmp_path):
    got, why = _unexplained(
        tmp_path, edit=lambda a, r: (a, [x for x in r if x["i"] != 2]))
    assert why == ["arrival without one outcome"] and got["lost"] == 1


def test_an_error_is_a_lost_answer(tmp_path):
    def edit(a, r):
        r[1] = dict(r[1], status="error", response={"error": "boom"})
        return a, r
    got, why = _unexplained(tmp_path, edit=edit)
    assert why == ["lost answer"] and got["errors"] == 1


def test_a_crc_mismatch_fails_the_day(tmp_path):
    def edit(a, r):
        resp = dict(r[3]["response"])
        resp["probs"] = [[0.5, 0.25, 0.25]] + resp["probs"][1:]
        r[3] = dict(r[3], response=resp)
        return a, r
    got, why = _unexplained(tmp_path, edit=edit)
    assert why == ["crc mismatch"] and got["corrupt"] == 1


def test_an_uncaused_scale_event_fails_the_day(ref, tmp_path):
    router = [dict(e) for e in ROUTER]
    del router[2]["cause"]
    got, why = _unexplained(tmp_path, router=router)
    assert why == ["fleet.scale.up"]
    want = ref.accountability_check(str(tmp_path / "m"), PREEMPTIONS)
    assert [u["event"] for u in want["unexplained"]] == why


@pytest.mark.parametrize("index,field,why", [
    (10, "cause", "fleet.scale.down"),
    (5, "score", "uncaused ejection"),
    (6, "probes_ok", "uncaused reinstatement")])
def test_each_uncaused_fleet_change_fails_the_day(tmp_path, index, field,
                                                  why):
    router = [dict(e) for e in ROUTER]
    del router[index][field]
    _got, got_why = _unexplained(tmp_path, router=router)
    assert got_why == [why]


def test_an_orphan_retirement_and_an_unexplained_death(tmp_path):
    router = [dict(e) for e in ROUTER] + [
        {"ts": 10.0, "event": "fleet.replica_retired", "replica": 7},
        {"ts": 11.0, "event": "fleet.replica_died", "replica": 8}]
    _got, why = _unexplained(tmp_path, router=router)
    assert why == ["orphan retirement", "unexplained death"]


def test_an_uncaused_promotion_fails_the_day(tmp_path):
    _got, why = _unexplained(tmp_path, replica=[
        {"ts": 5.5, "event": "online.promoted", "model": "hot"}])
    assert why == ["online.promoted"]
