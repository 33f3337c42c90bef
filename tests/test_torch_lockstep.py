"""The port's lock-order witness (``veles_tpu_torch/analysis/witness.py``)
against the port's law (``veles_tpu_torch/analysis/lock_order.json``,
which the port's veleslint derives from the port's tree) and the
reference's (``veles_tpu/analysis/lock_order.json``).

The ``TestWitnessUnit`` scenarios of ``tests/test_lockstep.py`` run
through the port's witness: switched off, a factory returns the bare
primitive; edges record and unwind last in, first out; a condition's
wait releases; the snapshot round trip.  Every lock of the port is made
through the factories under a name the port declares
(:data:`witness.LOCK_NAMES`): the reference's, or one of the port's own
three below.  The port's law names exactly those locks, and its edges
are the reference's law's, together with :data:`PORT_ONLY_EDGES`.  Then
real execution under the witness, an in-process batcher and sentinel
and an armed ``-b cpu`` hive subprocess, observes only edges the port's
law declares.
"""

import ast
import json
import os
import threading
import time

import numpy as np

from veles_tpu.analysis import flow as ref_flow
from veles_tpu_torch.analysis import flow, witness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "veles_tpu_torch")
LAW_PATH = flow.LAW_PATH
REF_LAW_PATH = os.path.join(REPO, "veles_tpu", "analysis",
                            "lock_order.json")

#: locks only the port has, and why
PORT_ONLY_LOCKS = {
    # the CUDA kernels' build and launch counts: the reference has no
    # build step (XLA compiles its Pallas kernels); nothing is taken
    # under it
    "lrn_cuda.build": "ops/lrn_cuda.py",
    # the serving engine's dispatch counts and next-dispatch hook: the
    # reference counts in its jitted path's wrapper without a lock;
    # telemetry is called after it is released
    "fused.count": "ops/fused.py",
    # the hive's own request counts (op=stats): the reference counts
    # through telemetry alone; a leaf
    "hive.stats": "serve/hive.py",
}

#: edges only the port takes (none: each port-only lock is a leaf, and
#: the other locks nest as the reference's do)
PORT_ONLY_EDGES = set()

#: the reference's locks the port does not have (none: its web status
#: page's came with the port's web_status.py)
NOT_PORTED_LOCKS = set()


def _law():
    return flow.load_lock_order(LAW_PATH)


def _ref_law():
    return ref_flow.load_lock_order(REF_LAW_PATH)


def _allowed_edges():
    return flow.declared_edges(_law())


def _factory_calls():
    """[(name, kind, path:line)] of every witness factory call in the
    port, and [path:line] of every bare threading lock it makes."""
    calls, bare = [], []
    for d, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(d, fn)
            rel = os.path.relpath(path, PKG)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)):
                    continue
                owner, attr = node.func.value.id, node.func.attr
                where = f"{rel}:{node.lineno}"
                if owner == "witness" and attr in ("lock", "rlock",
                                                   "condition"):
                    assert isinstance(node.args[0], ast.Constant), where
                    calls.append((node.args[0].value, attr, where))
                elif owner == "threading" and attr in (
                        "Lock", "RLock", "Condition"):
                    bare.append(where)
    return calls, bare


def test_every_port_lock_is_named_through_the_factories():
    calls, bare = _factory_calls()
    # the witness's own table lock is a leaf, deliberately unwitnessed,
    # as are the primitives its factories return
    assert all(w.startswith("analysis/witness.py") for w in bare), bare
    names = [n for n, _, _ in calls]
    assert len(names) == len(set(names)) == 27, sorted(names)
    assert set(names) == witness.LOCK_NAMES
    assert {n["name"] for n in _law()["nodes"]} == witness.LOCK_NAMES
    ref_nodes = {n["name"]: n["kind"] for n in _ref_law()["nodes"]}
    assert set(ref_nodes) - NOT_PORTED_LOCKS | set(PORT_ONLY_LOCKS) == \
        witness.LOCK_NAMES
    # the same primitive kind as the reference's
    for name, kind, where in calls:
        if name in ref_nodes:
            want = "condition" if ref_nodes[name] == "condition" \
                else "lock"
            assert kind == want, (name, where)
        else:
            assert where.startswith(PORT_ONLY_LOCKS[name]), where


def test_the_law_with_the_port_edges_is_acyclic():
    graph = {}
    for a, b in _allowed_edges():
        graph.setdefault(a, set()).add(b)
    assert not _cycle(graph)
    assert _cycle({"a": {"b"}, "b": {"a"}})
    # the port nests its locks as the reference does
    assert _allowed_edges() <= \
        ref_flow.declared_edges(_ref_law()) | PORT_ONLY_EDGES


def _cycle(graph) -> bool:
    state = {}

    def visit(n):
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m) == 1 or (m not in state and visit(m)):
                return True
        state[n] = 2
        return False

    return any(n not in state and visit(n) for n in list(graph))


# -- the witness's units ---------------------------------------------------

def test_off_by_default_the_factories_return_bare_primitives():
    assert not witness.enabled()
    assert type(witness.lock("x")) is type(threading.Lock())
    assert type(witness.rlock("x")) is type(threading.RLock())
    assert type(witness.condition("x")) is type(threading.Condition())
    assert witness.enabled({"VELES_LOCK_WITNESS": "1"})
    assert not witness.enabled({"VELES_LOCK_WITNESS": "0"})


def test_edge_recording_and_lifo_release(monkeypatch):
    monkeypatch.setenv(witness.ENV_VAR, "1")
    witness.reset()
    a = witness.lock("t.a")
    b = witness.lock("t.b")
    c = witness.rlock("t.c")
    with a:
        with b:
            with c:
                with c:   # re-entrant: no self edge
                    pass
    assert witness.observed_edges() == [
        ("t.a", "t.b"), ("t.a", "t.c"), ("t.b", "t.c")]
    assert witness.acquire_count() == 4
    # the releases unwound: a fresh acquisition records no stale edge
    witness.reset()
    with b:
        pass
    assert witness.observed_edges() == []
    assert not a.locked()


def test_condition_wait_releases_for_the_wait(monkeypatch):
    monkeypatch.setenv(witness.ENV_VAR, "1")
    witness.reset()
    cond = witness.condition("t.cond")
    hits = []

    def waiter():
        with cond:
            hits.append("waiting")
            cond.wait(2.0)
            hits.append("woke")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    for _ in range(200):
        if hits:
            break
        time.sleep(0.01)
    with cond:           # acquirable only because the wait released
        cond.notify_all()
    t.join(timeout=5.0)
    assert hits == ["waiting", "woke"]
    assert witness.observed_edges() == []


def test_snapshot_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setenv(witness.ENV_VAR, "1")
    witness.reset()
    a, b = witness.lock("t.outer"), witness.lock("t.inner")
    with a:
        with b:
            pass
    path = witness.write_snapshot(str(tmp_path))
    assert os.path.basename(path) == f"lockwitness-{os.getpid()}.json"
    with open(path) as f:
        data = json.load(f)
    assert data["edges"] == [
        {"from": "t.outer", "to": "t.inner", "count": 1}]
    assert witness.read_snapshots(str(tmp_path)) == [
        ("t.outer", "t.inner")]
    # the reference reads the port's snapshot alike
    from veles_tpu.analysis import witness as ref_witness
    assert ref_witness.read_snapshots(str(tmp_path)) == [
        ("t.outer", "t.inner")]
    witness.reset()
    assert witness.write_snapshot(str(tmp_path / "empty")) is None


# -- real execution under the witness -------------------------------------

def test_in_process_serving_edges_lie_within_the_law(monkeypatch):
    from veles_tpu_torch import telemetry, trace
    from veles_tpu_torch.serve.batcher import MicroBatcher
    from veles_tpu_torch.serve.sentinel import Sentinel
    monkeypatch.setenv(witness.ENV_VAR, "1")
    witness.reset()

    mb = MicroBatcher(lambda xb: xb.sum(axis=1), max_batch=8,
                      max_wait_s=0.002, label="lockstep")
    futs = [mb.submit(np.ones((2, 4), np.float32),
                      ctx=trace.mint({"VELES_TRACE_SAMPLE": "1"}))
            for _ in range(16)]
    for f in futs:
        f.result(timeout=10)
    mb.close()

    class FakeReplica:
        def __init__(self, i):
            self.idx = i
            self.healthy = True
            self.client = None

    s = Sentinel([FakeReplica(0), FakeReplica(1)],
                 probe_fn=lambda r, m, rows: (True, "ok"))
    # a model name of its own, so its histogram (and that histogram's
    # witnessed lock) is made after arming
    model = f"lockstep_m{os.getpid()}"
    h = telemetry.histogram(f"fleet.model.{model}.request_seconds")
    for _ in range(40):
        h.record(0.01)
    s.hedge_threshold_ms(model)
    time.sleep(0.6)
    s.hedge_threshold_ms(model)
    s.close()

    observed = set(witness.observed_edges())
    assert observed, "the witness recorded nothing"
    assert observed <= _allowed_edges(), sorted(observed - _allowed_edges())
    assert ("sentinel.health", "telemetry.histogram") in observed
    assert {n for e in observed for n in e} <= witness.LOCK_NAMES


def test_an_armed_hive_stays_within_the_law(tmp_path_factory):
    """A real ``--serve-models -b cpu`` subprocess, armed through its
    environment (module-level locks are made at import): its
    ``lockwitness-<pid>.json`` exists and stays within the law."""
    from tests.test_torch_fleet import port_packages
    from veles_tpu_torch.serve.client import HiveClient
    d = str(tmp_path_factory.mktemp("lockstep_pkgs"))
    pkg = port_packages(d, {"alpha": 77})["alpha"]["port_pkg"]
    mdir = os.path.join(d, "metrics")
    c = HiveClient({"alpha": pkg}, backend="cpu", max_batch=8,
                   max_wait_ms=2.0, heartbeat_every=0.5, metrics_dir=mdir,
                   env={"VELES_LOCK_WITNESS": "1"}, cwd=REPO,
                   start_timeout=300.0)
    try:
        rows = np.random.default_rng(0).standard_normal(
            (4, 6, 6, 1)).astype(np.float32)
        errs = []

        def one():
            try:
                r = c.request("alpha", rows, timeout=60.0)
                assert "probs" in r, r
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=one) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errs, errs
    finally:
        c.close()
    snaps = [f for f in os.listdir(mdir) if f.startswith("lockwitness-")]
    assert snaps == [f"lockwitness-{c.pid}.json"]
    observed = set(witness.read_snapshots(mdir))
    assert observed <= _allowed_edges(), sorted(observed - _allowed_edges())
    assert ("batcher.queue", "telemetry.histogram") in observed
    assert ("batcher.queue", "telemetry.registry") in observed
    assert {n for e in observed for n in e} <= witness.LOCK_NAMES
    # its snapshot carries the witness's gauges
    with open(os.path.join(mdir, f"metrics-{c.pid}.json")) as f:
        gauges = json.load(f)["gauges"]
    assert gauges["lockstep.edges_observed"] >= 2
    assert gauges["lockstep.acquires"] > 0
