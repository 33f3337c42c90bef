"""Traces across the port's fleet on the CPU, against the reference's
drills (``tests/test_flightline.py`` ``TestHedgedTraceAssembly`` and
``TestFailoverTraceAssembly``): a real router and two ``-b cpu``
replicas of the tiny model, with a metrics dir.

- One replica armed with ``hive.slow_dispatch``: a hedged request
  assembles into one trace across the router's and the replicas'
  processes, with both legs, one winner, the legs parented on the root
  span and the winner's ``trace.serve`` and ``trace.batch``; the slow
  replica's ejection leaves the router's ``flightrec-*-ejection.json``
  with a ``sentinel.eject`` entry; every request of the run assembles,
  and the port's reader (``veles_tpu_torch/obs.py``) and the
  reference's agree on the whole dir.
- A replica SIGKILLed under load: a retried request keeps its trace id,
  with the died leg and the winning leg on two replicas.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest

from tests.test_torch_fleet import REPO, port_packages
from veles_tpu import obs as ref_obs
from veles_tpu_torch import obs, telemetry

COMPONENTS = ("pre_route_s", "wire_s", "batch_wait_s", "dispatch_s")


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_trace_pkgs"))
    return port_packages(d, {"alpha": 11})["alpha"]["port_pkg"]


def _ctr(name):
    return telemetry.counter(name).value


def _assembled(mdir):
    telemetry.flush()
    reg, merged = obs.load_tree(mdir)
    return reg, merged, obs.assemble_traces(merged)


def test_hedged_request_assembles_into_one_trace(package, tmp_path):
    from veles_tpu_torch.serve.router import FleetRouter
    mdir = str(tmp_path / "m")
    # the router's snapshot in mdir is this process's whole registry: a
    # clean slate, so its exemplars and counters are this router's alone
    # and not those of a test that ran before in the same worker
    telemetry.reset()
    router = FleetRouter(
        {"alpha": package}, n_replicas=2, backend="cpu", max_batch=16,
        max_wait_ms=5, metrics_dir=mdir, cwd=REPO, deadline_ms=8000,
        hedge_min_ms=60, hedge_budget=1.0, eject_threshold=4,
        env_overrides={0: {"VELES_FAULTS": "hive.slow_dispatch@label=alpha"
                                           "&times=8&seconds=1.5"}})
    pids = {str(r.client.pid) for r in router.replicas}
    sent = 0
    try:
        x = np.ones((1, 6, 6, 1), np.float32)
        hedges0 = _ctr("fleet.hedge.issued")
        wins0 = _ctr("fleet.hedge.wins")
        eject0 = _ctr("fleet.eject.total")
        for _ in range(24):
            assert "probs" in router.request("alpha", x, timeout=60)
            sent += 1
            if _ctr("fleet.hedge.issued") > hedges0:
                break
        assert _ctr("fleet.hedge.issued") > hedges0
        # strikes accrue to an ejection; the losers' answers drain
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline \
                and _ctr("fleet.eject.total") == eject0:
            assert "probs" in router.request("alpha", x, timeout=60)
            sent += 1
            time.sleep(0.05)
        assert _ctr("fleet.eject.total") == eject0 + 1
    finally:
        router.close()
    hedges = _ctr("fleet.hedge.issued") - hedges0
    wins = _ctr("fleet.hedge.wins") - wins0
    reg, merged, traces = _assembled(mdir)

    roots = [e for e in merged if e.get("event") == "trace.request"]
    assert len(roots) == sent == len(traces)
    hedged = [evs for evs in traces.values()
              if any(e.get("event") == "trace.leg" and e.get("hedge")
                     for e in evs)]
    assert hedged, "no hedged trace assembled"
    evs = hedged[0]
    legs = [e for e in evs if e.get("event") == "trace.leg"]
    assert len(legs) == 2 and {e["replica"] for e in legs} == {0, 1}
    assert len([e for e in legs if e.get("winner")]) == 1
    # one trace id (a trace.batch joins by its links instead)
    assert len({e.get("trace") for e in evs
                if e.get("event") != "trace.batch"}) == 1
    root = [e for e in evs if e.get("event") == "trace.request"]
    assert len(root) == 1
    assert all(leg["parent"] == root[0]["span"] for leg in legs)
    assert len({e["_pid"] for e in evs}) >= 2
    assert {e["_pid"] for e in evs} - {root[0]["_pid"]} <= pids
    cp = obs.critical_path(evs)
    assert cp["hedged"] and cp["legs"] == 2 and cp["outcome"] == "ok"
    assert all(cp[k] is not None for k in COMPONENTS), cp
    text = obs.render_trace(evs)
    assert "trace.request" in text and "critical path" in text

    # every request: its root, one winning leg (a busy box can hedge
    # more than the first request: each hedge adds a leg, its loser
    # cancelled), the winner's serve and a batch that links it, from at
    # least two processes; one hedged trace a hedge the router issued,
    # and one trace won by its hedge a win it counted
    hedged_legs = won_by_hedge = 0
    for tid, tevs in traces.items():
        names = [e.get("event") for e in tevs]
        assert names.count("trace.request") == 1, tid
        tlegs = [e for e in tevs if e.get("event") == "trace.leg"]
        winners = [e for e in tlegs if e.get("winner")]
        assert len(winners) == 1, tlegs
        assert len(tlegs) == 1 + sum(bool(e.get("hedge")) for e in tlegs)
        hedged_legs += sum(bool(e.get("hedge")) for e in tlegs)
        won_by_hedge += bool(winners[0].get("hedge"))
        assert "trace.serve" in names, names
        assert any(e.get("event") == "trace.batch" and tid in
                   [lk["trace"] for lk in e["links"]] for e in tevs)
        assert len({e["_pid"] for e in tevs}) >= 2
        assert all(obs.critical_path(tevs)[k] is not None
                   for k in COMPONENTS), tid
    assert hedged_legs == hedges and won_by_hedge == wins

    # the exemplars name traces that assemble
    ex = obs.tail_exemplars(reg, "fleet.request_seconds")
    assert ex and {t for _, t in ex} <= set(traces)

    # the ejection's dump, in the router's own dir
    dumps = glob.glob(os.path.join(mdir, f"flightrec-{os.getpid()}-*-"
                                         f"ejection.json"))
    assert dumps, "the ejection left no dump"
    payload = json.load(open(dumps[0]))
    assert payload["reason"] == "ejection"
    assert any(e.get("ev") == "sentinel.eject" and e.get("replica") == 0
               for e in payload["ring"])
    assert any(e.get("ev") == "fleet.hedge" for e in payload["ring"])

    # the reference's reader agrees on the whole dir
    ref_reg, ref_merged = ref_obs.load_tree(mdir)
    assert merged == ref_merged
    ref_traces = ref_obs.assemble_traces(ref_merged)
    assert traces == ref_traces
    for tid, tevs in traces.items():
        assert obs.critical_path(tevs) == ref_obs.critical_path(tevs)
    assert ex == ref_obs.tail_exemplars(ref_reg, "fleet.request_seconds")
    assert obs.render_traces(mdir, reg) == \
        ref_obs.render_traces(mdir, ref_reg)


def test_failover_retry_shares_the_trace_id(package, tmp_path):
    from veles_tpu_torch.serve.router import FleetRouter
    mdir = str(tmp_path / "m")
    router = FleetRouter({"alpha": package}, n_replicas=2, backend="cpu",
                         max_batch=16, max_wait_ms=5, metrics_dir=mdir,
                         cwd=REPO, respawn_backoff=0.25)
    try:
        x = np.ones((2, 6, 6, 1), np.float32)
        assert "probs" in router.request("alpha", x)
        retries0 = _ctr("fleet.retries")
        results, errs = [], []

        def worker(i):
            try:
                for k in range(12):
                    if i == 0 and k == 2:
                        router.replicas[0].client.proc.kill()
                    results.append(router.request("alpha", x, timeout=60))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        assert all("probs" in r for r in results)
        assert _ctr("fleet.retries") > retries0
    finally:
        router.close(kill=True)
    _reg, merged, traces = _assembled(mdir)
    retried = []
    for evs in traces.values():
        legs = [e for e in evs if e.get("event") == "trace.leg"
                and not e.get("hedge")]
        if len(legs) >= 2 and any(e["verdict"] == "died" for e in legs):
            retried.append((evs, legs))
    assert retried, "no trace carries both the died leg and its retry"
    for evs, legs in retried:
        assert len({e.get("trace") for e in evs
                    if e.get("event") != "trace.batch"}) == 1
        winners = [e for e in legs if e.get("winner")]
        assert len(winners) == 1 and winners[0]["verdict"] == "ok"
        died = [e for e in legs if e["verdict"] == "died"]
        assert {e["replica"] for e in died} == {0}
        assert winners[0]["replica"] != 0
        cp = obs.critical_path(evs)
        assert cp["retried"] and cp["replica"] == winners[0]["replica"]
        assert cp == ref_obs.critical_path(evs)
