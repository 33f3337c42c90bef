"""The port's tracing (``veles_tpu_torch/trace.py``) and its trace reader
(``veles_tpu_torch/obs.py``) against the reference's.

The unit scenarios of ``tests/test_flightline.py`` run through the
port's modules: exact error-diffusion sampling and its rate bounds,
``child``, the wire round trip, an unsampled context adding no wire
bytes, ``use`` restoring the previous context and events carrying the
trace, the ring without I/O, an atomic dump and a dump without a metrics
dir, skew correction, tail exemplars across a snapshot merge, the
critical path, the logger's ring entry and the crash helper's dump.  The
port's wire fields equal the reference's and are registered in the
port's protocol.  Last, the port's reader and the reference's read the
same merged journals of several processes and agree on every trace.
"""

import glob
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from veles_tpu import obs as ref_obs
from veles_tpu import telemetry as ref_telemetry
from veles_tpu import trace as ref_trace
from veles_tpu_torch import events, obs, telemetry, trace
from veles_tpu_torch.serve import protocol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    # another file's teardown may have cleared the seam
    telemetry.set_trace_provider(trace._provider)
    yield
    telemetry.configure(None)
    if saved is not None:
        os.environ[telemetry.ENV_DIR] = saved
    telemetry.reset()


# -- the context ---------------------------------------------------------

def test_mint_samples_exact_fraction_by_error_diffusion():
    env = {"VELES_TRACE_SAMPLE": "0.25"}
    hits = sum(trace.mint(env).sampled for _ in range(400))
    # error diffusion: exact, but for the accumulator's remainder
    assert abs(hits - 100) <= 1


@pytest.mark.parametrize("raw,sampled", [("0", False), ("1", True),
                                         ("bogus", True), ("7", True),
                                         ("-1", False)])
def test_mint_rate_bounds(raw, sampled):
    assert trace.mint({"VELES_TRACE_SAMPLE": raw}).sampled is sampled
    assert ref_trace.mint({"VELES_TRACE_SAMPLE": raw}).sampled is sampled


def test_a_forked_child_draws_ids_of_its_own():
    """The ids' generator is seeded again in a forked child (no system
    call an id to notice the fork): the child's next id is not the one
    its parent draws next."""
    code = ("import os\n"
            "from veles_tpu_torch import trace\n"
            "trace.new_span_id()\n"
            "r, w = os.pipe()\n"
            "pid = os.fork()\n"
            "if pid == 0:\n"
            "    os.write(w, trace.new_span_id().encode())\n"
            "    os._exit(0)\n"
            "os.waitpid(pid, 0)\n"
            "print(os.read(r, 64).decode(), trace.new_span_id())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    child, parent = proc.stdout.split()
    assert len(child) == len(parent) == 8 and child != parent


def test_child_keeps_trace_parents_span():
    root = trace.TraceContext("aa" * 8)
    kid = root.child()
    assert kid.trace_id == root.trace_id
    assert kid.parent_id == root.span_id
    assert kid.span_id != root.span_id
    assert kid.sampled == root.sampled
    assert kid.fields() == {"trace": root.trace_id, "span": kid.span_id,
                            "parent": root.span_id}


def test_wire_round_trip_matches_the_reference():
    ctx = trace.TraceContext("ab" * 8, "cd" * 4, "ef" * 4)
    msg = trace.to_wire({"cmd": "request"}, ctx)
    ref_msg = ref_trace.to_wire(
        {"cmd": "request"}, ref_trace.TraceContext("ab" * 8, "cd" * 4,
                                                   "ef" * 4))
    assert msg == ref_msg
    back = trace.from_wire(msg)
    assert (back.trace_id, back.span_id, back.parent_id) == \
        (ctx.trace_id, ctx.span_id, ctx.parent_id)
    assert back.sampled
    # the reference reads the port's message and the port the reference's
    ref_back = ref_trace.from_wire(msg)
    assert (ref_back.trace_id, ref_back.span_id) == \
        (ctx.trace_id, ctx.span_id)


def test_unsampled_context_never_rides_the_wire():
    ctx = trace.TraceContext("ab" * 8, sampled=False)
    msg = trace.to_wire({"cmd": "request"}, ctx)
    assert set(msg) == {"cmd"}       # rate 0 adds no bytes
    assert trace.from_wire(msg) is None
    assert trace.from_wire({"cmd": "x"}) is None
    assert trace.to_wire({"cmd": "y"}, None) == {"cmd": "y"}


def test_wire_fields_equal_the_reference_and_are_registered():
    assert trace.WIRE_FIELDS == ref_trace.WIRE_FIELDS
    assert (trace.K_TRACE, trace.K_SPAN, trace.K_PARENT,
            trace.K_SAMPLED) == trace.WIRE_FIELDS
    for key in trace.WIRE_FIELDS:
        assert protocol.known(key), key


def test_use_parks_thread_locally_and_restores():
    outer = trace.TraceContext("ab" * 8)
    inner = outer.child()
    assert trace.current() is None
    with trace.use(outer):
        assert trace.current() is outer
        with trace.use(inner):
            assert trace.current() is inner
        assert trace.current() is outer
        seen = []
        t = threading.Thread(target=lambda: seen.append(trace.current()))
        t.start()
        t.join()
        assert seen == [None]        # thread-local, not global
    assert trace.current() is None


def test_journaled_events_carry_the_current_trace():
    ctx = trace.TraceContext("ab" * 8)
    with trace.use(ctx):
        telemetry.event("flightline.probe", detail=1)
    ev = telemetry.recent_events("flightline.probe")[-1]
    assert (ev["trace"], ev["span"]) == (ctx.trace_id, ctx.span_id)
    # the caller's fields win over the provider
    with trace.use(ctx):
        telemetry.event("flightline.probe2", trace="override")
    assert telemetry.recent_events(
        "flightline.probe2")[-1]["trace"] == "override"
    # an unsampled context stamps nothing
    with trace.use(trace.TraceContext("cd" * 8, sampled=False)):
        telemetry.event("flightline.probe3")
    assert "trace" not in telemetry.recent_events("flightline.probe3")[-1]


# -- the flight recorder -------------------------------------------------

def test_ring_records_without_io_and_dump_is_atomic(tmp_path):
    telemetry.configure(str(tmp_path))
    ctx = trace.TraceContext("ab" * 8)
    before = set(os.listdir(tmp_path))
    trace.record("probe.hop", ctx=ctx, replica=3)
    assert set(os.listdir(tmp_path)) == before     # no I/O
    entries = trace.ring_entries()
    assert entries[-1]["ev"] == "probe.hop"
    assert entries[-1]["trace"] == ctx.trace_id
    assert entries[-1]["replica"] == 3
    path = trace.dump("unit test/../reason")
    assert path and os.path.isfile(path)
    name = os.path.basename(path)
    # the reason is sanitized into the name, which carries the pid and
    # the sequence number
    assert "unit_test_.._reason" in name
    assert name.startswith(f"flightrec-{os.getpid()}-")
    payload = json.load(open(path))
    assert payload["pid"] == os.getpid()
    assert any(e["ev"] == "probe.hop" for e in payload["ring"])
    assert "journal_tail" in payload
    assert not glob.glob(str(tmp_path / "flightrec-*.tmp"))
    assert telemetry.recent_events(events.EV_FLIGHTREC_DUMP)
    second = trace.dump("unit test/../reason")
    assert second != path and os.path.isfile(second)


def test_ring_is_bounded_by_the_knob():
    code = ("from veles_tpu_torch import trace\n"
            "for i in range(100):\n"
            "    trace.record('x', i=i)\n"
            "print(len(trace.ring_entries()), "
            "trace.ring_entries()[0]['i'])\n")
    env = dict(os.environ, VELES_FLIGHTREC_CAP="40")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["40", "60"]


def test_dump_without_metrics_dir_is_a_noop():
    assert telemetry.metrics_dir() is None
    assert trace.dump("nowhere") is None


def test_warnings_land_in_the_ring():
    from veles_tpu_torch.logger import Logger, setup_logging
    setup_logging()

    class Unit(Logger):
        pass

    Unit().warning("flightline probe %d", 7)
    assert any(e["ev"] == "log.warning"
               and e["message"] == "flightline probe 7"
               for e in trace.ring_entries())


def test_injected_child_crash_dumps_before_the_kill(tmp_path):
    code = ("from veles_tpu_torch import faults, trace\n"
            "trace.record('before.crash', step=4)\n"
            "faults.maybe_inject_child_crash(attempt=1)\n"
            "print('survived')\n")
    env = dict(os.environ, VELES_METRICS_DIR=str(tmp_path),
               VELES_FAULTS="supervisor.child_crash@attempt=1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -9 and "survived" not in out.stdout
    dumps = glob.glob(str(tmp_path / "flightrec-*-sigkill.json"))
    assert len(dumps) == 1
    payload = json.load(open(dumps[0]))
    assert payload["reason"] == "sigkill"
    assert any(e["ev"] == "before.crash" for e in payload["ring"])


# -- the reader ----------------------------------------------------------

def test_interleaving_follows_monotonic_not_wall_clock(tmp_path):
    """Two processes whose wall clocks disagree by 10 s: the timeline
    orders by the skew-corrected monotonic stamp."""
    a = [{"ts": 1000.0 + i, "mono": 5.0 + i, "event": f"a{i}"}
         for i in range(3)]
    b = [{"ts": 1010.5, "mono": 5.5, "event": "b0"},
         {"ts": 1011.5, "mono": 6.5, "event": "b1"}]
    with open(tmp_path / "journal-111.jsonl", "w") as f:
        f.writelines(json.dumps(e) + "\n" for e in a)
    with open(tmp_path / "journal-222.jsonl", "w") as f:
        f.writelines(json.dumps(e) + "\n" for e in b)
    _reg, _snaps, _journals, evs = obs.load_dir(str(tmp_path))
    assert [e["event"] for e in evs] == ["a0", "b0", "a1", "b1", "a2"]
    _r, _s, _j, ref_evs = ref_obs.load_dir(str(tmp_path))
    assert evs == ref_evs


def test_exemplars_survive_snapshot_merge_and_name_the_tail():
    h = telemetry.histogram("probe.seconds")
    for _ in range(200):
        h.record(0.001)
    h.record(0.5, exemplar="feedbeef" * 2)     # the p99 tail
    h.record(0.0001, exemplar="aa" * 8)        # deep in the body
    merged = telemetry.Registry()
    merged.merge_snapshot(telemetry.snapshot())
    tail = obs.tail_exemplars(merged, "probe.seconds", q=0.99)
    assert ("feedbeef" * 2) in [t for _, t in tail]
    assert ("aa" * 8) not in [t for _, t in tail]
    ref_merged = ref_telemetry.Registry()
    ref_merged.merge_snapshot(telemetry.snapshot())
    assert tail == ref_obs.tail_exemplars(ref_merged, "probe.seconds",
                                          q=0.99)


def test_unsampled_records_leave_no_exemplar():
    h = telemetry.histogram("probe2.seconds")
    h.record(0.1, exemplar=None)
    assert h.exemplars == {}
    assert obs.tail_exemplars(telemetry._registry, "probe2.seconds") == []


def _trace_events():
    tid = "ab" * 8
    return [
        {"event": "trace.request", "trace": tid, "span": "r1",
         "model": "m", "outcome": "ok", "seconds": 0.010,
         "_t": 1.0, "_pid": "1"},
        {"event": "trace.leg", "trace": tid, "span": "l1",
         "parent": "r1", "replica": 1, "verdict": "ok",
         "seconds": 0.009, "hedge": False, "winner": True,
         "_t": 1.001, "_pid": "1"},
        {"event": "trace.serve", "trace": tid, "span": "s1",
         "parent": "l1", "label": "m", "rows": 1,
         "wait_s": 0.002, "dispatch_s": 0.004, "total_s": 0.007,
         "_t": 1.002, "_pid": "2", "_replica": 1},
    ]


def test_critical_path_decomposition():
    cp = obs.critical_path(_trace_events())
    assert cp["outcome"] == "ok"
    assert cp["legs"] == 1 and not cp["hedged"] and not cp["retried"]
    assert cp["replica"] == 1
    assert cp["pre_route_s"] == pytest.approx(0.001)
    assert cp["wire_s"] == pytest.approx(0.002)
    assert cp["batch_wait_s"] == pytest.approx(0.002)
    assert cp["dispatch_s"] == pytest.approx(0.004)
    assert cp == ref_obs.critical_path(_trace_events())


def test_render_trace_names_the_dominant_hop():
    text = obs.render_trace(_trace_events())
    assert "ab" * 8 in text and "trace.serve" in text
    assert "critical path" in text and "dispatch dominates" in text
    assert text == ref_obs.render_trace(_trace_events())
    assert obs.render_trace([]) == "(empty trace)"


def _write_fleet_dir(d):
    """A router and two replicas' journals and snapshots, written by the
    port's own events: one plain request, one hedged, one retried, a
    batch that coalesced two of them, and an exemplar a request."""
    rng = np.random.default_rng(3)
    router, reps = [], {0: [], 1: []}
    exemplars = {}
    mono = 100.0
    for k, kind in enumerate(("plain", "hedged", "retried")):
        root = trace.TraceContext(f"{k:02d}" * 8)
        legs = [(root.child(), 0, False, "ok")]
        if kind == "hedged":
            legs = [(root.child(), 0, False, "cancelled"),
                    (root.child(), 1, True, "ok")]
        elif kind == "retried":
            legs = [(root.child(), 0, False, "died"),
                    (root.child(), 1, False, "ok")]
        total = 0.0
        for lctx, rep, hedge, verdict in legs:
            leg_s = float(rng.uniform(0.005, 0.05))
            total += leg_s
            mono += leg_s
            router.append({"ts": 5000.0 + mono, "mono": mono,
                           "event": "trace.leg", **lctx.fields(),
                           "replica": rep, "verdict": verdict,
                           "seconds": round(leg_s, 6), "hedge": hedge,
                           "winner": verdict == "ok"})
            if verdict in ("ok", "cancelled"):
                sctx = lctx.child()
                wait, disp = float(rng.uniform(0, 0.002)), \
                    float(rng.uniform(0.001, 0.003))
                reps[rep].append({
                    "ts": 5000.2 + mono, "mono": mono - 0.001,
                    "event": "trace.serve", **sctx.fields(),
                    "label": "m", "rows": 1, "wait_s": round(wait, 6),
                    "dispatch_s": round(disp, 6),
                    "total_s": round(wait + disp, 6), "error": None})
                reps[rep].append({
                    "ts": 5000.2 + mono, "mono": mono - 0.0015,
                    "event": "trace.batch", "span": trace.new_span_id(),
                    "label": "m", "rows": 1, "dispatch_s": round(disp, 6),
                    "links": [{"trace": sctx.trace_id,
                               "span": sctx.span_id}]})
        router.append({"ts": 5000.0 + mono, "mono": mono + 0.0005,
                       "event": "trace.request", **root.fields(),
                       "model": "m", "rows": 1, "outcome": "ok",
                       "seconds": round(total + 0.0005, 6)})
        exemplars[root.trace_id] = total + 0.0005
    # a batch that coalesced the plain and the retried request's serves
    serves = [e for e in reps[1] + reps[0] if e["event"] == "trace.serve"]
    reps[1].append({"ts": 5001.0 + mono, "mono": mono + 0.01,
                    "event": "trace.batch", "span": "bb" * 4, "rows": 2,
                    "label": "m", "dispatch_s": 0.002,
                    "links": [{"trace": e["trace"], "span": e["span"]}
                              for e in serves[:2]]})
    for pid, evs, sub in ((1000, router, ""), (2000, reps[0], "replica-0"),
                          (3000, reps[1], "replica-1")):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        with open(os.path.join(d, sub, f"journal-{pid}.jsonl"), "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in evs)
            f.write('{"torn": ')            # a killed process's tail
    reg = telemetry.Registry()
    h = reg.histogram(events.HIST_FLEET_REQUEST_SECONDS)
    for _ in range(100):
        h.record(0.004)
    for tid, secs in exemplars.items():
        h.record(secs, exemplar=tid)
    with open(os.path.join(d, "metrics-1000.json"), "w") as f:
        json.dump(reg.snapshot(), f)
    return set(exemplars)


def test_the_port_reader_agrees_with_the_reference(tmp_path):
    d = str(tmp_path)
    tids = _write_fleet_dir(d)
    reg, merged = obs.load_tree(d)
    ref_reg, ref_merged = ref_obs.load_tree(d)
    assert merged == ref_merged
    assert reg.snapshot() == ref_reg.snapshot()
    traces = obs.assemble_traces(merged)
    assert traces == ref_obs.assemble_traces(ref_merged)
    assert set(traces) == tids
    for tid, evs in traces.items():
        cp = obs.critical_path(evs)
        assert cp == ref_obs.critical_path(evs)
        assert obs.render_trace(evs) == ref_obs.render_trace(evs)
        assert all(cp[k] is not None for k in (
            "pre_route_s", "wire_s", "batch_wait_s", "dispatch_s")), cp
        assert {e["_pid"] for e in evs} >= {"1000"} and len(
            {e["_pid"] for e in evs}) >= 2
    kinds = {obs.critical_path(evs)["trace"]: obs.critical_path(evs)
             for evs in traces.values()}
    assert kinds["01" * 8]["hedged"] and kinds["02" * 8]["retried"]
    ex = obs.tail_exemplars(reg, events.HIST_FLEET_REQUEST_SECONDS)
    assert ex and ex == ref_obs.tail_exemplars(
        ref_reg, events.HIST_FLEET_REQUEST_SECONDS)
    assert {t for _, t in ex} <= tids
    panel = obs.render_traces(d, reg)
    assert panel == ref_obs.render_traces(d, ref_reg)
    assert "3 assembled" in panel and "p99 exemplars" in panel


def test_ga_jobs_carry_their_trace_into_the_evaluator(tmp_path,
                                                      monkeypatch):
    """The pool mints a root for each genome job and puts it on the
    wire; a cohort job carries its first member's; the evaluator runs
    each job under a child span, so its journaled job span carries the
    job's trace."""
    from torch_ga_fixtures import LR, WIDTH, write_files
    from veles_tpu_torch.genetics.pool import ChipEvaluatorPool
    wf, cfg = write_files(tmp_path)
    minted = []
    real_mint = trace.mint

    def recording_mint(environ=None):
        ctx = real_mint(environ)
        minted.append(ctx.trace_id)
        return ctx

    monkeypatch.setattr(trace, "mint", recording_mint)
    mdir = str(tmp_path / "m")
    telemetry.configure(mdir)
    cmd = [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
           "--serve", wf, cfg, "-b", "cpu", "-s", "1234",
           "--heartbeat-every", "1"]
    genomes = [{WIDTH: 8, LR: 0.3}, {WIDTH: 8, LR: 0.05}]
    with ChipEvaluatorPool(cmd, workers=2, timeout=300) as pool:
        pid = pool._proc.pid
        assert all(np.isfinite(pool.evaluate_many(genomes)))
        assert all(np.isfinite(pool.evaluate_cohort(genomes)))
    assert len(minted) == 4
    evs = [json.loads(ln) for ln in
           open(os.path.join(mdir, f"journal-{pid}.jsonl"))]
    jobs = [e for e in evs if e["event"] == "evaluator.job_seconds"]
    assert len(jobs) == 3
    # two genome jobs under their own roots, then the cohort under its
    # first member's
    assert [e["trace"] for e in jobs] == minted[:2] + minted[2:3]
    assert len({e["span"] for e in jobs}) == 3
