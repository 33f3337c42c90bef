"""The serving fleet's in-process pieces, each against the reference's
(``veles_tpu/``) on the same inputs.  Exact equality unless a line says
otherwise:

- ``telemetry.Histogram``: quantiles, ``snapshot_buckets`` /
  ``delta_quantile`` windows and ``to_dict`` / ``merge_dict`` on one
  seeded sample stream;
- ``faults.parse`` and ``fire`` on the same ``VELES_FAULTS`` strings;
- every ported knob's name, default, type and parser;
- ``PlacementPolicy.assign`` on ``tests/test_fleet.py``'s cases;
- ``traffic.generate`` and ``write_trace``: byte-identical trace files
  for three specs; ``read_trace`` round trip and the torn-file refusal;
- ``OpenLoopDriver``: one outcome per arrival, the same classification;
- ``ScaleController`` and ``DegradationLadder``: the same action
  sequence on ``tests/test_gauntlet.py``'s scripts;
- ``Sentinel``: the same states, scores, strikes, ejections, probe
  backoff and reinstatements on one scripted sequence of outcomes, with
  stub replicas, a stub ``probe_fn`` and a scripted clock; the same
  hedge threshold from the same latencies;
- the batcher's adaptive wait window: ``tests/test_serve_mesh.py``'s
  scenarios on the port's ``MicroBatcher``;
- ``HiveClient``: ``cancel`` (answer dropped now, or its late arrival
  counted ``fleet.stale_response``), ``collect_async`` and death, against
  a ``-b cpu`` hive; its default backend is ``auto``;
- the hive's dequantization: a learning model over uint8 pixels stores a
  uint8-exact row as uint8, bitwise the reference's buffer.
"""

import filecmp
import inspect
import os
import time

import numpy as np
import pytest

from tests.test_fleet import _build_package
from tests.test_torch_fleet import REPO, port_packages

import veles_tpu_torch.knobs as port_knobs


# -- telemetry ----------------------------------------------------------

def _samples():
    rng = np.random.default_rng(20261017)
    xs = np.concatenate([
        rng.lognormal(-4.0, 1.5, 400),   # latencies, seconds
        rng.integers(1, 65, 100).astype(np.float64),   # batch rows
        [0.0, -1.0, 1e-9, 1e8, 3e-3, 3e-3]])
    rng.shuffle(xs)
    return [float(x) for x in xs]


def _both_histograms():
    from veles_tpu.telemetry import Histogram as Ref
    from veles_tpu_torch.telemetry import Histogram as Port
    return Ref("h"), Port("h")


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99,
                               1.0])
def test_histogram_quantiles_equal_the_reference(q):
    ref, port = _both_histograms()
    for x in _samples():
        ref.record(x)
        port.record(x)
    assert port.quantile(q) == ref.quantile(q)
    assert port.buckets == ref.buckets
    assert (port.count, port.sum, port.min, port.max, port.mean) == \
        (ref.count, ref.sum, ref.min, ref.max, ref.mean)


@pytest.mark.parametrize("cut", [0, 100, 253, 499])
def test_histogram_windows_equal_the_reference(cut):
    ref, port = _both_histograms()
    xs = _samples()
    for x in xs[:cut]:
        ref.record(x)
        port.record(x)
    base_r, base_p = ref.snapshot_buckets(), port.snapshot_buckets()
    assert base_p == base_r
    for x in xs[cut:]:
        ref.record(x)
        port.record(x)
    for q in (0.5, 0.95):
        for min_count in (1, 20, 10 ** 6):
            assert port.delta_quantile(base_p, q, min_count) == \
                ref.delta_quantile(base_r, q, min_count)


def test_histogram_dicts_merge_as_the_reference():
    ref, port = _both_histograms()
    xs = _samples()
    for i, x in enumerate(xs):
        ref.record(x, exemplar=f"t{i % 7}")
        port.record(x, exemplar=f"t{i % 7}")
    assert port.to_dict() == ref.to_dict()
    ref2, port2 = _both_histograms()
    ref2.record(0.5)
    port2.record(0.5)
    ref2.merge_dict(ref.to_dict())
    port2.merge_dict(port.to_dict())
    assert port2.to_dict() == ref2.to_dict()
    from veles_tpu.telemetry import Registry as RefReg
    from veles_tpu_torch.telemetry import Registry as PortReg
    snaps = []
    for reg in (RefReg(), PortReg()):
        reg.counter("c").inc(3)
        reg.gauge("g").set(1.5)
        reg.histogram("h").merge_dict(ref.to_dict())
        other = {"counters": {"c": 2}, "gauges": {"g": 9.0, "g2": 4.0},
                 "histograms": {"h": ref2.to_dict()}}
        reg.merge_snapshot(other)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]


def test_events_ring_and_reset():
    from veles_tpu_torch import events, telemetry
    telemetry.event(events.EV_FLEET_SCALE_UP, replica=7, cause="unit")
    rec = telemetry.recent_events(events.EV_FLEET_SCALE_UP)[-1]
    assert rec["replica"] == 7 and rec["cause"] == "unit"
    assert {"ts", "mono", "event"} <= set(rec)
    import veles_tpu.events as ref_events
    assert events.all_names() == ref_events.all_names()


# -- faults -------------------------------------------------------------

FAULT_STRINGS = [
    "hive.slow_dispatch@label=alpha&times=6&seconds=1.5",
    "hive.wedge@times=*",
    "hive.garbage_response@model=beta&times=2,hive.wedge@model=alpha",
    "fleet.replica_flap@after=0.5&times=inf",
    "hive.slow_dispatch@label=alpha&seconds=0.1, hive.slow_dispatch"
    "@label=beta&times=3&seconds=2",
]

FIRE_CALLS = [("hive.slow_dispatch", {"label": "alpha"}),
              ("hive.slow_dispatch", {"label": "beta"}),
              ("hive.wedge", {"model": "alpha"}),
              ("hive.wedge", {}),
              ("hive.garbage_response", {"model": "beta"}),
              ("fleet.replica_flap", {}),
              ("hive.wedge", {"model": "beta"})] * 4


@pytest.mark.parametrize("spec", FAULT_STRINGS)
def test_faults_parse_and_fire_as_the_reference(spec):
    from veles_tpu import faults as ref
    from veles_tpu_torch import faults as port

    def flat(specs):
        return {p: [(s.quals, s.remaining) for s in ss]
                for p, ss in specs.items()}

    assert flat(port.parse(spec)) == flat(ref.parse(spec))
    try:
        ref.arm(spec)
        port.arm(spec)
        assert port.active() and ref.active()
        for point, ctx in FIRE_CALLS:
            assert port.fire(point, **ctx) == ref.fire(point, **ctx)
    finally:
        ref.arm("")
        port.arm("")
    assert not port.active() and port.fire("hive.wedge") is None
    assert port.garbage(32, "hive.garbage_response") == \
        ref.garbage(32, "hive.garbage_response")
    assert port.garbage_text(24, "x") == ref.garbage_text(24, "x")
    np.testing.assert_array_equal(
        port.rng("hive.garbage_response").standard_normal(5),
        ref.rng("hive.garbage_response").standard_normal(5))


@pytest.mark.parametrize("bad", ["hive.nope", "hive.wedge@model"])
def test_faults_refuse_what_the_reference_refuses(bad):
    from veles_tpu import faults as ref
    from veles_tpu_torch import faults as port
    with pytest.raises(ValueError):
        ref.parse(bad)
    with pytest.raises(ValueError):
        port.parse(bad)


# -- knobs --------------------------------------------------------------

FLEET_KNOBS = sorted(n for n in port_knobs.KNOBS
                     if not n.startswith("VELES_ONLINE")
                     and n not in port_knobs.PORT_ONLY)


@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_fleet_knobs_equal_the_reference(name):
    from veles_tpu import knobs as ref
    mine, theirs = port_knobs.KNOBS[name], ref.KNOBS[name]
    assert mine.default == theirs.default
    assert type(mine.default) is type(theirs.default)
    assert mine.parser.__name__ == theirs.parser.__name__
    assert mine.doc
    for raw in ("3", "0", "x", ""):
        assert mine.read({name: raw}) == theirs.read({name: raw})


def test_every_serve_and_fleet_knob_is_ported():
    from veles_tpu import knobs as ref
    want = {n for n in ref.KNOBS
            if n.startswith(("VELES_FLEET_", "VELES_TRAFFIC_"))}
    want |= {"VELES_HEARTBEAT_EVERY", "VELES_SERVE_MAX_WAIT_MS",
             "VELES_SERVE_MAX_BATCH", "VELES_SERVE_HBM_BUDGET",
             "VELES_SERVE_ADAPTIVE_WAIT", "VELES_SERVE_WAIT_STRETCH",
             "VELES_SERVE_MESH", "VELES_SERVE_MESH_SHARD"}
    # the port's other knobs (faults, supervision, metrics, budgets)
    # are held to the reference by the test above
    assert want == {n for n in FLEET_KNOBS
                    if n.startswith(("VELES_FLEET_", "VELES_TRAFFIC_",
                                     "VELES_SERVE_"))
                    or n == "VELES_HEARTBEAT_EVERY"}


# -- placement ----------------------------------------------------------

PLACEMENT_CASES = [
    ({"budget_bytes": 100}, {"a": 40, "b": 40, "c": 40, "d": 10}, 2, None),
    ({"budget_bytes": 100, "hot": {"c"}}, {"a": 40, "b": 40, "c": 40}, 3,
     None),
    ({"budget_bytes": 1 << 30}, {"a": 10, "b": 10}, 4, None),
    ({"budget_bytes": 50}, {"a": 40, "b": 40}, 1, None),
    ({"budget_bytes": 100}, {"a": 60, "b": 30, "c": 50, "d": 20}, 3,
     [200, None, 80]),
]


@pytest.mark.parametrize("kw,sizes,n,caps", PLACEMENT_CASES)
def test_placement_equals_the_reference(kw, sizes, n, caps):
    from veles_tpu.serve.fleet import PlacementPolicy as Ref
    from veles_tpu_torch.serve.fleet import PlacementPolicy as Port
    assert Port(**kw).assign(sizes, n, capacities=caps) == \
        Ref(**kw).assign(sizes, n, capacities=caps)


# -- traffic ------------------------------------------------------------

TRAFFIC_SPECS = [
    dict(seed=7, duration_s=30.0, peak_rps=40.0, swing=10.0,
         burst_every_s=8.0, burst_len_s=2.0, burst_mult=2.0,
         models=["hot", "warm", "tail"], zipf_s=1.1),
    dict(seed=1, duration_s=60.0, peak_rps=50.0, swing=10.0,
         burst_mult=1.0, models=["m"]),
    dict(seed=20261017, duration_s=20.0, peak_rps=12.0, swing=4.0,
         period_s=10.0, burst_every_s=6.0, burst_len_s=3.0,
         burst_mult=3.0, models=["a", "b", "c", "d"], zipf_s=1.5),
]


@pytest.mark.parametrize("kw", TRAFFIC_SPECS)
def test_traces_are_bitwise_the_reference(kw, tmp_path):
    from veles_tpu.serve import traffic as ref
    from veles_tpu_torch.serve import traffic as port
    a, b = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    ref.write_trace(a, ref.TrafficSpec(**kw), ref.generate(
        ref.TrafficSpec(**kw)))
    arrivals = port.generate(port.TrafficSpec(**kw))
    port.write_trace(b, port.TrafficSpec(**kw), arrivals)
    assert os.path.getsize(a) > 0
    assert filecmp.cmp(a, b, shallow=False)
    spec2, back = port.read_trace(b)
    assert spec2.to_dict() == port.TrafficSpec(**kw).to_dict()
    assert [x.to_dict() for x in back] == [x.to_dict() for x in arrivals]
    w_ref = ref._burst_windows(ref.TrafficSpec(**kw),
                               np.random.default_rng(kw["seed"]))
    w_port = port._burst_windows(port.TrafficSpec(**kw),
                                 np.random.default_rng(kw["seed"]))
    assert w_port == w_ref


def test_torn_trace_fails_loudly(tmp_path):
    from veles_tpu_torch.serve import traffic
    path = str(tmp_path / "torn.jsonl")
    spec = traffic.TrafficSpec(**TRAFFIC_SPECS[0])
    traffic.write_trace(path, spec, traffic.generate(spec))
    lines = open(path).readlines()
    open(path, "w").writelines(lines[:len(lines) // 2])
    with pytest.raises(ValueError, match="torn"):
        traffic.read_trace(path)


def _responder(a):
    if a.i % 4 == 0:
        return {"error": "overloaded", "overloaded": True}
    if a.i % 4 == 1:
        raise RuntimeError("boom")
    if a.i % 4 == 2:
        return {"error": "deadline exceeded", "timeout": True}
    return {"probs": [[0.1]], "pred": [0]}


def test_open_loop_driver_classifies_as_the_reference():
    from veles_tpu.serve import traffic as ref
    from veles_tpu_torch.serve import traffic as port
    arr = [port.Arrival(i, i * 0.002, "m", 123 + i, False)
           for i in range(40)]
    rarr = [ref.Arrival(a.i, a.t, a.model, a.row_seed, a.burst)
            for a in arr]
    mine = port.OpenLoopDriver(_responder, workers=4).run(arr)
    theirs = ref.OpenLoopDriver(_responder, workers=4).run(rarr)
    assert [r["i"] for r in mine] == list(range(40))
    assert [r["status"] for r in mine] == [r["status"] for r in theirs]
    assert {r["status"] for r in mine} == {"ok", "shed", "error"}


def test_open_loop_latency_counts_from_the_schedule():
    from veles_tpu_torch.serve.traffic import Arrival, OpenLoopDriver

    def slow(a):
        time.sleep(0.05)
        return {"probs": [1.0]}
    res = OpenLoopDriver(slow, workers=2).run(
        [Arrival(i, i * 0.001, "m", i, False) for i in range(4)])
    assert all(r["latency_s"] >= 0.05 for r in res)
    assert max(r["queue_delay_s"] for r in res) >= 0.04


# -- the scale controller and the ladder --------------------------------

CTL = dict(min_replicas=1, max_replicas=4, up_ms=200.0, down_ms=25.0,
           up_sustain_s=1.0, down_sustain_s=2.0, cooldown_s=5.0)

#: tests/test_gauntlet.py's scripts: (controller overrides, [(pressure,
#: n_replicas, now)])
SCRIPTS = [
    ({}, [(500.0, 2, 0.0), (500.0, 2, 0.5), (500.0, 2, 1.0)]),
    ({}, [(500.0, 2, 0.0), (100.0, 2, 0.5), (500.0, 2, 0.9),
          (500.0, 2, 1.8), (500.0, 2, 1.95)]),
    ({}, [(500.0, 2, 1.0), (500.0, 2, 2.0), (500.0, 3, 3.5),
          (500.0, 3, 6.9), (500.0, 3, 7.1)]),
    ({"max_replicas": 2}, [(500.0, 2, 0.0), (500.0, 2, 1.0)]),
    ({}, [(5.0, 3, 0.0), (5.0, 3, 1.0), (5.0, 3, 2.0)]),
    ({"min_replicas": 2}, [(5.0, 2, 0.0), (5.0, 2, 2.0)]),
    ({}, [(5.0, 3, 0.0), (100.0, 3, 1.0), (5.0, 3, 2.5), (5.0, 3, 4.6)]),
    ({}, [(500.0, 2, 0.0), (500.0, 2, 1.0), (5.0, 3, 1.5), (5.0, 3, 3.5),
          (5.0, 3, 6.5)]),
    ({}, [(float("inf"), 1, t * 0.25) for t in range(40)]),
]


@pytest.mark.parametrize("over,script", SCRIPTS)
def test_scale_controller_acts_as_the_reference(over, script):
    from veles_tpu.serve.autoscale import ScaleController as Ref
    from veles_tpu_torch.serve.autoscale import ScaleController as Port
    kw = dict(CTL, **over)
    ref, port = Ref(**kw), Port(**kw)
    acts = [port.observe(*step) for step in script]
    assert acts == [ref.observe(*step) for step in script]
    assert any(a is not None for a in acts)


def test_scale_controller_validates_and_reads_knobs_as_the_reference():
    from veles_tpu.serve import autoscale as ref
    from veles_tpu_torch.serve import autoscale as port
    for bad in ({"down_ms": 300.0}, {"min_replicas": 0},
                {"min_replicas": 3, "max_replicas": 2}):
        with pytest.raises(ValueError):
            port.ScaleController(**dict(CTL, **bad))
    env = {"VELES_FLEET_SCALE_MIN": "2", "VELES_FLEET_SCALE_MAX": "8",
           "VELES_FLEET_SCALE_UP_MS": "150",
           "VELES_FLEET_SCALE_COOLDOWN": "9"}
    assert vars(port.ScaleController.from_knobs(environ=env)) == \
        vars(ref.ScaleController.from_knobs(environ=env))
    assert port.RUNGS == ref.RUNGS
    assert (port.ACT_UP, port.ACT_DOWN, port.ACT_SATURATED,
            port.ACT_RELAX) == (ref.ACT_UP, ref.ACT_DOWN,
                                ref.ACT_SATURATED, ref.ACT_RELAX)


def _full_day(mod):
    c = mod.ScaleController(min_replicas=1, max_replicas=2, up_ms=200.0,
                            down_ms=25.0, up_sustain_s=1.0,
                            down_sustain_s=1.0, cooldown_s=2.0)
    lad = mod.DegradationLadder()
    n, log = 1, []
    script = [(0.0, 500.0), (1.0, 500.0), (3.0, 500.0), (4.0, 500.0),
              (6.0, 500.0), (7.0, 500.0), (9.0, 10.0), (10.0, 10.0),
              (12.0, 10.0), (13.0, 10.0), (15.0, 10.0), (16.0, 10.0),
              (18.0, 10.0), (19.0, 10.0)]
    for t, p in script:
        act = c.observe(p, n, t)
        if act == mod.ACT_UP:
            n += 1
            log.append("up")
        elif act == mod.ACT_SATURATED:
            r = lad.engage()
            if r:
                log.append(f"engage:{r}")
        elif act == mod.ACT_DOWN:
            if lad.depth:
                log.append(f"release:{lad.release()}")
            else:
                n -= 1
                log.append("down")
        elif act == mod.ACT_RELAX and lad.depth:
            log.append(f"release:{lad.release()}")
    return log, n, lad.depth


def test_controller_and_ladder_compose_as_the_reference():
    from veles_tpu.serve import autoscale as ref
    from veles_tpu_torch.serve import autoscale as port
    mine = _full_day(port)
    assert mine == _full_day(ref)
    assert mine == (["up", "engage:learner", "engage:hedge",
                     "release:hedge", "release:learner", "down"], 1, 0)
    lad = port.DegradationLadder()
    assert [lad.engage() for _ in range(4)] == list(port.RUNGS) + [None]
    lad2 = port.DegradationLadder()
    lad2.engage(), lad2.engage()
    assert [lad2.release(), lad2.engage(), lad2.engage()] == \
        ["hedge", "hedge", "shed_tail"]


# -- the sentinel -------------------------------------------------------

class _Clock:
    """A scripted monotonic clock (sleep stays real)."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        time.sleep(s)

    def perf_counter(self) -> float:
        return time.perf_counter()


class _Stub:
    def __init__(self, idx):
        self.idx, self.healthy = idx, True


def _scripted_sentinel(mod, telemetry, monkeypatch):
    """One scripted run; returns every observation, in order."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    reps = [_Stub(0), _Stub(1), _Stub(2)]
    verdicts = iter([False, False, True, True, True, False, True, True])
    calls = []

    def probe_fn(replica, model, rows):
        calls.append((replica.idx, model, np.asarray(rows).shape))
        ok = next(verdicts)
        return ok, "clean" if ok else "scripted failure"

    s = mod.Sentinel(reps, probe_fn, hedge_min_ms=25.0, hedge_budget=0.2,
                     eject_threshold=3.0, probe_ok=3, probe_interval=0.5,
                     probe_backoff_cap=2.0)
    s.close()   # the probe loop stops; probes run by hand below
    out = []

    def observe(tag):
        out.append((tag, [s.status(r) for r in reps],
                    [s.eligible(r) for r in reps], s.ejected_count(),
                    round(s.hedge_rate(), 12)))

    x = np.ones((2, 6, 6, 1), np.float32)
    for _ in range(10):
        s.note_request("alpha", x)
    out.append(("hedges", [s.allow_hedge() for _ in range(5)]))
    for k in range(6):
        clock.t += 0.2
        for r, lat in zip(reps, (0.010, 0.011, 0.012)):
            s.record_ok(r, "alpha", lat + 0.0005 * k)
    observe("warm")
    for k in range(4):
        clock.t += 1.1
        s.record_ok(reps[0], "alpha", 0.9)   # a latency outlier
    observe("slow")
    clock.t += 3.0
    s.record_timeout(reps[0])
    observe("timeout")
    s.record_hedge_win(reps[1], reps[0])
    observe("hedge loss")
    s.record_integrity(reps[0])
    observe("integrity")
    clock.t += 0.1
    s.record_died(reps[1])
    s.record_timeout(reps[1])
    s.record_timeout(reps[1])
    observe("second replica struck out")
    for _ in range(3):
        s.record_timeout(reps[2])
    observe("third replica capped at N-1")
    for step in range(8):
        clock.t += 2.5
        for r in reps:
            h = s.health[r.idx]
            if h.state == "ejected" and clock.t >= h.next_probe_at:
                s._probe_once(r)
        observe(f"probe round {step}")
    s.remove_replica(reps[2])
    reps.pop()
    s.add_replica(_Stub(5))
    reps.append(_Stub(5))
    observe("membership")
    out.append(("probes", calls))
    # the hedge threshold: the same latencies, a cumulative read, then a
    # windowed one 0.6 s later
    h = telemetry.histogram("fleet.model.unitm.request_seconds")
    h._reset()
    rng = np.random.default_rng(5)
    for v in rng.lognormal(-3.0, 0.5, 40):
        h.record(float(v))
    thr = [s.hedge_threshold_ms("unitm")]
    clock.t += 0.6
    for v in rng.lognormal(-1.5, 0.2, 30):
        h.record(float(v))
    thr.append(s.hedge_threshold_ms("unitm"))
    clock.t += 0.1
    thr.append(s.hedge_threshold_ms("unitm"))   # cached
    out.append(("threshold", thr))
    return out


def test_sentinel_decides_as_the_reference(monkeypatch):
    from veles_tpu import telemetry as ref_tel
    from veles_tpu.serve import sentinel as ref
    from veles_tpu_torch import telemetry as port_tel
    from veles_tpu_torch.serve import sentinel as port
    theirs = _scripted_sentinel(ref, ref_tel, monkeypatch)
    mine = _scripted_sentinel(port, port_tel, monkeypatch)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a == b, (a[0], a, b)
    states = {tag: st for tag, *rest in mine if rest
              for st in [rest[0]] if isinstance(st, list)
              and st and isinstance(st[0], dict)}
    # what the script exercises: one ejection, the N-1 cap, probes that
    # fail, back off and then reinstate
    assert states["integrity"][0]["state"] == "ejected"
    assert states["third replica capped at N-1"][2]["state"] == "healthy"
    assert any(st[0]["reinstatements"] >= 1 for st in states.values())


# -- the adaptive wait window -------------------------------------------

def _batcher(**kw):
    from veles_tpu_torch.serve.batcher import MicroBatcher
    kw.setdefault("max_batch", 64)
    kw.setdefault("max_wait_s", 0.02)
    return MicroBatcher(lambda xb: xb.sum(axis=(1,)), **kw)


def test_adaptive_cold_start_is_static():
    b = _batcher()
    try:
        assert b._adaptive and b._gap_hist is not None
        now = time.perf_counter()
        with b._cond:
            left = b._wait_left(now, now - 0.005)
        assert abs(left - (0.02 - 0.005)) < 1e-9
    finally:
        b.close()


def test_adaptive_stall_collapses_stretched_window():
    from veles_tpu_torch import telemetry
    b = _batcher(max_batch=8)
    try:
        for _ in range(12):
            b._gap_hist.record(0.002)
        now = time.perf_counter()
        with b._cond:
            b._last_arrival = now - 1.0
            c0 = telemetry.counter("serve.wait_collapsed").value
            left = b._wait_left(now, now - 0.001)
            assert abs(left - (b.max_wait_s - 0.001)) < 1e-9
            assert b._wait_left(now, now - b.max_wait_s - 0.001) == 0.0
            assert telemetry.counter("serve.wait_collapsed").value == \
                c0 + 1
    finally:
        b.close()


def test_adaptive_filling_batch_stretches_window():
    b = _batcher(max_batch=8)
    try:
        for _ in range(12):
            b._gap_hist.record(0.001)
        now = time.perf_counter()
        with b._cond:
            assert b._gap_estimate(now) is not None
            b._last_arrival = now
            left = b._wait_left(now, now - 1.5 * b.max_wait_s)
        assert 0.0 < left <= b._stretch * b.max_wait_s
    finally:
        b.close()


def test_adaptive_trickle_that_cannot_fill_stays_static():
    b = _batcher(max_batch=64)
    try:
        for _ in range(12):
            b._gap_hist.record(0.002)
        now = time.perf_counter()
        with b._cond:
            assert b._gap_estimate(now) is not None
            b._last_arrival = now
            left = b._wait_left(now, now - 1.5 * b.max_wait_s)
        assert left <= 0.0
    finally:
        b.close()


def test_adaptive_stretch_cap_still_flushes():
    b = _batcher(max_batch=8)
    try:
        for _ in range(12):
            b._gap_hist.record(0.001)
        now = time.perf_counter()
        with b._cond:
            b._gap_estimate(now)
            b._last_arrival = now
            left = b._wait_left(now, now - b._stretch * b.max_wait_s
                                - 0.001)
        assert left <= 0.0
    finally:
        b.close()


def test_adaptive_sparse_traffic_never_waits_past_static():
    b = _batcher()
    try:
        for _ in range(12):
            b._gap_hist.record(0.5)
        now = time.perf_counter()
        with b._cond:
            assert b._gap_estimate(now) is not None
            b._last_arrival = now - b.max_wait_s - 0.001
            assert b._wait_left(now, now - b.max_wait_s - 0.001) <= 0.0
    finally:
        b.close()


def test_adaptive_full_batch_does_not_stretch():
    b = _batcher(max_batch=4)
    try:
        for _ in range(12):
            b._gap_hist.record(0.002)
        now = time.perf_counter()
        with b._cond:
            assert b._gap_estimate(now) is not None
            b._last_arrival = now
            b._queued_rows = 4
            left = b._wait_left(now, now - 0.001)
            b._queued_rows = 0
        assert 0.0 < left <= b.max_wait_s - 0.001 + 1e-9
    finally:
        b.close()


def test_adaptive_knob_off_disables_estimator(monkeypatch):
    monkeypatch.setenv("VELES_SERVE_ADAPTIVE_WAIT", "0")
    b = _batcher()
    try:
        assert not b._adaptive and b._gap_hist is None
        now = time.perf_counter()
        with b._cond:
            left = b._wait_left(now, now - 0.001)
        assert abs(left - (0.02 - 0.001)) < 1e-9
    finally:
        b.close()


def test_the_batcher_records_the_reference_telemetry():
    from veles_tpu_torch import telemetry
    b = _batcher(max_batch=4, max_wait_s=0.005)
    batches0 = telemetry.counter("serve.batches").value
    rows0 = telemetry.histogram("serve.batch_rows").count
    req0 = telemetry.histogram("serve.request_seconds").count
    try:
        futs = [b.submit(np.ones((1, 3), np.float32)) for _ in range(6)]
        for f in futs:
            assert f.result(timeout=10).shape == (1,)
    finally:
        b.close()
    d_batches = telemetry.counter("serve.batches").value - batches0
    assert d_batches == b.dispatches >= 2
    assert telemetry.histogram("serve.batch_rows").count - rows0 == \
        d_batches
    assert telemetry.histogram("serve.request_seconds").count - req0 == 6


# -- the client ---------------------------------------------------------

def test_the_client_defaults_to_the_card():
    from veles_tpu_torch.serve.client import HiveClient, hive_command
    from veles_tpu_torch.serve.fleet import Replica
    from veles_tpu_torch.serve.router import FleetRouter
    for cls in (HiveClient, Replica, FleetRouter):
        assert inspect.signature(cls).parameters["backend"].default == \
            "auto", cls
    cmd = hive_command({"m": "/p/m.vpkg"})
    assert cmd[cmd.index("-b") + 1] == "auto"
    cmd = hive_command({"m": "/p/m.vpkg"}, backend="cpu", hbm_budget=7,
                       online=True)
    assert cmd[cmd.index("-b") + 1] == "cpu" and "--online" in cmd
    assert cmd[cmd.index("--hbm-budget") + 1] == "7"


@pytest.fixture(scope="module")
def tiny_pkg(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_units_pkgs"))
    return port_packages(d, {"alpha": 11})["alpha"]


def test_client_cancel_stale_drop_and_collect_async(tiny_pkg):
    import threading

    from veles_tpu_torch import telemetry
    from veles_tpu_torch.serve.client import HiveClient, ReplicaDied
    x = np.ones((1, 6, 6, 1), np.float32)
    c = HiveClient({"alpha": tiny_pkg["port_pkg"]}, backend="cpu",
                   max_batch=8, max_wait_ms=300, heartbeat_every=0,
                   cwd=REPO)
    try:
        # cancelled while pending: the late answer is dropped as stale
        stale0 = telemetry.counter("fleet.stale_response").value
        jid = c.submit("alpha", x)
        assert c.cancel(jid) is False
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and \
                telemetry.counter("fleet.stale_response").value == stale0:
            time.sleep(0.05)
        assert telemetry.counter("fleet.stale_response").value == \
            stale0 + 1
        assert jid not in c._results
        # cancelled after it arrived: dropped at once
        jid = c.submit("alpha", x)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and jid not in c._results:
            time.sleep(0.02)
        assert c.cancel(jid) is True and jid not in c._results
        # an asynchronous collector gets the answer on the reader thread
        got = []
        done = threading.Event()
        jid = c.submit("alpha", x, deadline_ms=time.time() * 1000 + 30e3)
        c.collect_async(jid, lambda m, e: (got.append((m, e)),
                                           done.set()))
        assert done.wait(20)
        assert got[0][1] is None and got[0][0]["id"] == jid
        assert "probs" in got[0][0]
        # an expired deadline is answered expired, not computed
        msg = c.wait_for(c.submit("alpha", x,
                                  deadline_ms=time.time() * 1000 - 1))
        assert msg.get("expired") is True
        # death fails a pending collector with ReplicaDied
        died = threading.Event()
        errs = []
        jid = c.submit("alpha", x)
        c.collect_async(jid, lambda m, e: (errs.append(e), died.set()))
        c.kill()
        assert died.wait(20)
        assert isinstance(errs[0], ReplicaDied) or errs[0] is None
        assert c.dead and c.wait(10) != 0
    finally:
        c.close(kill=True)


# -- the hive's dequantization (the replay buffer of a quantized model) --

REF_Q_WF = """
import numpy as np
from veles_tpu import prng
from veles_tpu.loader import ArrayLoader
from veles_tpu.ops.standard_workflow import StandardWorkflow


def create_workflow(launcher):
    prng.seed_all(4242)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (48, 6, 6, 1)).astype(np.uint8)
    y = rng.integers(0, 3, 48).astype(np.int32)
    return StandardWorkflow(
        loader_factory=lambda w: ArrayLoader(
            w, train=(x[:32], y[:32]), valid=(x[32:], y[32:]),
            minibatch_size=16, normalization_type="linear",
            name="loader"),
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 12},
             "<-": {"learning_rate": 0.1}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.1}},
        ],
        decision_config={"max_epochs": 2}, name="q_wf")
"""


def test_a_quantized_model_buffers_uint8_as_the_reference(tmp_path):
    from veles_tpu.backends import JaxDevice
    from veles_tpu.config import root as ref_root
    from veles_tpu.ensemble.packaging import pack_ensemble as ref_pack
    from veles_tpu.online.buffer import ReplayBuffer as RefBuffer
    from veles_tpu.serve.hive import load_model_package as ref_load
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    from veles_tpu_torch.online import OnlineLearner
    from veles_tpu_torch.serve.hive import attach_dequant, \
        load_model_package
    from veles_tpu_torch.serve.residency import ResidencyManager
    d = str(tmp_path)
    ref_wf = os.path.join(d, "ref_q.py")
    with open(ref_wf, "w") as f:
        f.write(REF_Q_WF)
    port_wf = os.path.join(d, "port_q.py")
    with open(port_wf, "w") as f:
        f.write(REF_Q_WF.replace("from veles_tpu import", "from "
                                 "veles_tpu_torch import")
                .replace("from veles_tpu.loader import",
                         "from veles_tpu_torch.loader.fullbatch import")
                .replace("from veles_tpu.ops.", "from veles_tpu_torch.ops."))
    members = _build_package(d, "q", 11)["members"]
    saved, ref_saved = dict(root.__dict__), dict(ref_root.__dict__)
    try:
        ref = ref_load("q", ref_pack(os.path.join(d, "ref_q.vpkg"), "q",
                                     members, ref_wf),
                       JaxDevice(platform="cpu"),
                       os.path.join(d, "ref_install"), {})
        cpu = make_device("cpu")
        mine = load_model_package("q", pack_ensemble(
            os.path.join(d, "port_q.vpkg"), "q", members, port_wf), cpu,
            os.path.join(d, "port_install"), {})
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)
        ref_root.__dict__.clear()
        ref_root.__dict__.update(ref_saved)
    ref_dq = ref.meta["workflow"].loader.dequant
    assert ref_dq is not None
    # serving alone loads no data; the learner's arming does
    assert mine.meta["workflow"].loader.dequant is None
    dq = attach_dequant(mine.meta["workflow"])
    np.testing.assert_array_equal(dq.scale, ref_dq.scale)
    np.testing.assert_array_equal(dq.bias, ref_dq.bias)
    assert mine.meta["workflow"].loader.host_data is None
    residency = ResidencyManager(cpu, max_batch=8, max_wait_s=0.002)
    residency.register(mine)
    learner = OnlineLearner(residency)
    try:
        assert learner.arm_model("q")
        buf = learner.tap.buffers["q"]
        assert buf.dequant is dq
        q8 = np.random.default_rng(3).integers(0, 256, (4, 6, 6, 1)) \
            .astype(np.uint8)
        rows = dq.apply_host(q8)
        labels = np.array([0, 1, 2, 0])
        # through the hive's tap, as a labeled request
        learner.tap.tap("q", 1, rows, labels)
        rbuf = RefBuffer(buf.capacity, seed=11,
                         holdout_every=buf.holdout_every, dequant=ref_dq)
        rbuf.add(rows, labels)
        assert len(buf._rows) == 4 and buf._rows[0].dtype == np.uint8
        for a, b in zip(buf._rows, rbuf._rows):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert buf.nbytes == rbuf.nbytes == 4 * 36
    finally:
        learner.stop()
        residency.close()
