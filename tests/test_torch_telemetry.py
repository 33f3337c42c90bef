"""The port's telemetry core against the reference's.

The scenarios of ``tests/test_telemetry.py`` run through
``veles_tpu_torch/telemetry.py``: registry semantics and the kill
switch, quantiles against numpy, merge equivalence, span nesting and
journal lineage, the flushed snapshot and journal (read back with the
reference's ``veles_tpu/obs.py``), a torn-write reader loop, the child
snapshot merge, ``reset`` re-reading the environment, the background
``maybe_flush`` and the trace-provider seam.  The histogram is held to
the reference's bucket for bucket on the same samples.
"""

import glob
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from veles_tpu import obs
from veles_tpu import telemetry as ref_telemetry
from veles_tpu_torch import telemetry


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    telemetry.set_enabled(True)
    yield
    telemetry.configure(None)
    telemetry.set_trace_provider(None)
    telemetry.set_enabled(True)
    if saved is not None:
        os.environ[telemetry.ENV_DIR] = saved
    telemetry.reset()


# -- registry semantics ------------------------------------------------

def test_get_or_create_identity():
    c = telemetry.counter("t.c")
    assert telemetry.counter("t.c") is c
    assert telemetry.histogram("t.h") is telemetry.histogram("t.h")
    assert telemetry.gauge("t.g") is telemetry.gauge("t.g")


def test_counter_and_gauge():
    c = telemetry.counter("t.c2")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = telemetry.gauge("t.g2")
    assert g.value is None
    g.set(7)
    g.set(3)
    assert g.value == 3


def test_disabled_is_noop():
    telemetry.set_enabled(False)
    try:
        assert not telemetry.enabled()
        telemetry.counter("t.off").inc()
        telemetry.gauge("t.off").set(1)
        telemetry.histogram("t.off").record(1.0)
        telemetry.event("t.off_event")
        with telemetry.span("t.off_span"):
            assert telemetry.span_stack() == []
    finally:
        telemetry.set_enabled(True)
    assert telemetry.counter("t.off").value == 0
    assert telemetry.gauge("t.off").value is None
    assert telemetry.histogram("t.off").count == 0
    assert telemetry.recent_events("t.off_event") == []
    assert telemetry.histogram("t.off_span").count == 0


def test_reset_zeroes_in_place_and_rereads_the_environment(tmp_path):
    c = telemetry.counter("t.r")
    h = telemetry.histogram("t.rh")
    c.inc(9)
    h.record(1.0)
    telemetry.event("t.r_event")
    os.environ[telemetry.ENV_DIR] = str(tmp_path)
    telemetry.reset()
    assert telemetry.counter("t.r") is c and c.value == 0
    assert h.count == 0 and telemetry.recent_events() == []
    assert telemetry.metrics_dir() == str(tmp_path)
    os.environ.pop(telemetry.ENV_DIR)
    telemetry.reset()
    assert telemetry.metrics_dir() is None


def test_snapshot_shape_and_merge():
    telemetry.counter("t.s").inc(4)
    telemetry.gauge("t.sg").set(2.0)
    telemetry.histogram("t.sh").record(0.5)
    snap = telemetry.snapshot()
    assert snap["pid"] == os.getpid()
    assert snap["counters"]["t.s"] == 4
    assert snap["gauges"]["t.sg"] == 2.0
    assert snap["histograms"]["t.sh"]["count"] == 1
    telemetry.gauge("t.sg").set(9.0)
    telemetry.merge_snapshot(snap)
    assert telemetry.counter("t.s").value == 8
    assert telemetry.histogram("t.sh").count == 2
    assert telemetry.gauge("t.sg").value == 9.0    # a live level kept


# -- histogram quantiles -------------------------------------------------

@pytest.mark.parametrize("dist,kw", [
    ("lognormal", {"mean": 0.0, "sigma": 1.0}),
    ("uniform", {"low": 0.001, "high": 10.0}),
    ("exponential", {"scale": 0.05}),
])
def test_quantiles_match_numpy_and_the_reference(dist, kw):
    xs = getattr(np.random.default_rng(7), dist)(size=20000, **kw)
    h = telemetry.Histogram(dist)
    r = ref_telemetry.Histogram(dist)
    for x in xs:
        h.record(x)
        r.record(x)
    for q in (0.5, 0.9, 0.99):
        want = float(np.quantile(xs, q))
        assert abs(h.quantile(q) - want) / want < 0.08, (q, want)
    assert h.count == len(xs)
    assert h.min == xs.min() and h.max == xs.max()
    # bucket for bucket the reference's, so every quantile is equal
    assert h.to_dict() == r.to_dict()


def test_merge_equals_combined_distribution():
    rng = np.random.default_rng(3)
    a = rng.lognormal(0, 0.5, 5000)
    b = rng.lognormal(1.0, 0.5, 5000)
    ha, hb, hall = (telemetry.Histogram(n) for n in "ab3")
    for x in a:
        ha.record(x)
    for x in b:
        hb.record(x)
    for x in np.concatenate([a, b]):
        hall.record(x)
    merged = telemetry.Histogram("m")
    merged.merge_dict(ha.to_dict())
    merged.merge_dict(hb.to_dict())
    assert merged.count == hall.count
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == pytest.approx(hall.quantile(q),
                                                   rel=1e-12)


def test_edge_cases():
    h = telemetry.Histogram("e")
    assert h.quantile(0.5) is None
    h.record(0.0)
    h.record(1e12)
    assert h.quantile(0.0) == 0.0
    assert h.quantile(1.0) == 1e12


# -- spans ---------------------------------------------------------------

def test_span_nesting_and_histogram_feed():
    with telemetry.span("t.outer", journal=True):
        assert telemetry.span_stack() == ["t.outer"]
        with telemetry.span("t.inner", journal=True):
            assert telemetry.span_stack() == ["t.outer", "t.inner"]
            time.sleep(0.01)
        assert telemetry.span_stack() == ["t.outer"]
    assert telemetry.span_stack() == []
    assert telemetry.histogram("t.inner").count == 1
    assert telemetry.histogram("t.inner").min >= 0.01
    assert telemetry.histogram("t.outer").min >= \
        telemetry.histogram("t.inner").min


def test_span_journal_lineage():
    with telemetry.span("t.a", journal=True, tag="x"):
        with telemetry.span("t.b", journal=True):
            pass
    ev_b = telemetry.recent_events("t.b")[-1]
    ev_a = telemetry.recent_events("t.a")[-1]
    assert ev_b["parent"] == "t.a" and ev_b["depth"] == 1
    assert ev_a["parent"] is None and ev_a["depth"] == 0
    assert ev_a["tag"] == "x"
    assert ev_a["seconds"] >= ev_b["seconds"]


def test_span_stacks_are_per_thread():
    seen = []

    def other():
        seen.append(telemetry.span_stack())

    with telemetry.span("t.main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
    assert seen == [[]]


# -- persistence ---------------------------------------------------------

def test_flush_writes_what_the_reference_reader_reads(tmp_path):
    d = str(tmp_path)
    assert telemetry.flush() is None        # no dir: nothing written
    telemetry.configure(d)
    assert os.environ[telemetry.ENV_DIR] == d   # children inherit it
    telemetry.counter("t.f").inc(3)
    telemetry.histogram("t.fh").record(0.25)
    telemetry.event("t.flush_probe", k=1)
    path = telemetry.flush()
    assert os.path.basename(path) == f"metrics-{os.getpid()}.json"
    jf = os.path.join(d, f"journal-{os.getpid()}.jsonl")
    lines = [json.loads(ln) for ln in open(jf)]
    assert [e["event"] for e in lines] == ["t.flush_probe"]
    assert set(lines[0]) == {"ts", "mono", "event", "k"}
    reg, snaps, journals, events = obs.load_dir(d)
    assert snaps == [path] and journals == [jf]
    assert reg.counters["t.f"].value == 3
    assert reg.histograms["t.fh"].count == 1
    assert [e["event"] for e in events] == ["t.flush_probe"]
    telemetry.configure(None)
    assert telemetry.ENV_DIR not in os.environ
    assert telemetry.metrics_dir() is None


@pytest.mark.parametrize("overtake", ["reset", "configure"])
def test_a_flush_overtaken_by_a_reset_writes_nothing(tmp_path, monkeypatch,
                                                    overtake):
    """The throttled flush runs on a thread of its own: one whose
    snapshot is taken after a ``reset`` (or a ``configure``) must not
    replace the last snapshot written into the dir with the reset
    registry's (a snapshot leaves zero counters out, so a reader would
    not find them at all)."""
    d = str(tmp_path)
    telemetry.configure(d)
    telemetry.counter("t.kept").inc(2)
    path = telemetry.flush()
    before = open(path).read()
    real = telemetry.snapshot

    def overtaken():
        if overtake == "reset":
            telemetry.reset()
        else:
            telemetry.configure(str(tmp_path / "other"))
        return real()
    monkeypatch.setattr(telemetry, "snapshot", overtaken)
    assert telemetry.flush() is None
    assert open(path).read() == before
    assert json.loads(before)["counters"]["t.kept"] == 2
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_trace_family_rides_the_buffer_until_a_notable_event(tmp_path):
    d = str(tmp_path)
    telemetry.configure(d)
    # the throttle window starts now: no background flush can push the
    # buffer out between the two events below
    telemetry.flush()
    jf = os.path.join(d, f"journal-{os.getpid()}.jsonl")
    telemetry.event("trace.hop", n=1)
    assert not os.path.exists(jf) or open(jf).read() == ""
    telemetry.event("t.notable")
    assert [json.loads(ln)["event"] for ln in open(jf)] == \
        ["trace.hop", "t.notable"]


def test_trace_lines_wait_off_the_emitting_thread_in_order(tmp_path,
                                                           monkeypatch):
    """A traced request's lines are not encoded by the thread that emits
    them: they wait, in order, for a notable event, a flush, or the
    emitter that finds more than ``TRACE_PENDING_MAX`` waiting."""
    d = str(tmp_path)
    telemetry.configure(d)
    telemetry.flush()
    jf = os.path.join(d, f"journal-{os.getpid()}.jsonl")

    def lines():
        return [json.loads(ln)["n"] for ln in open(jf)] \
            if os.path.exists(jf) else []

    monkeypatch.setattr(telemetry, "TRACE_PENDING_MAX", 3)
    monkeypatch.setattr(telemetry, "TRACE_WRITE_CHUNK", 2)
    for n in range(3):
        telemetry.event("trace.hop", n=n)
    assert len(telemetry._trace_pending) == 3 and lines() == []
    telemetry.event("trace.hop", n=3)   # the fourth: written by its emitter
    assert len(telemetry._trace_pending) == 0
    telemetry.event("trace.hop", n=4)
    telemetry.flush()
    assert lines() == [0, 1, 2, 3, 4]
    # every record is in the ring at once, whatever reached the journal
    assert [e["n"] for e in telemetry.recent_events("trace.hop")] == \
        [0, 1, 2, 3, 4]


def test_trace_lines_waiting_at_reset_reach_the_old_journal(tmp_path):
    """``reset`` closes the journal: the ``trace.*`` lines still waiting
    are written to it first, none dropped.  An event that names its own
    trace and span does not ask the provider; one that names none gets
    the provider's."""
    d = str(tmp_path)
    telemetry.configure(d)
    asked = []
    telemetry.set_trace_provider(
        lambda: asked.append(1) or ("tr9", "sp9"))
    telemetry.event("trace.hop", trace="t1", span="s1", n=1)
    telemetry.event("trace.hop", n=2)
    assert len(asked) == 1 and len(telemetry._trace_pending) == 2
    os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    assert not telemetry._trace_pending and telemetry.metrics_dir() is None
    jf = os.path.join(d, f"journal-{os.getpid()}.jsonl")
    assert [(r["n"], r["trace"], r["span"])
            for r in map(json.loads, open(jf))] == \
        [(1, "t1", "s1"), (2, "tr9", "sp9")]


def test_concurrent_writer_torture(tmp_path):
    """Writers flush in a loop while readers parse: a reader never sees
    a torn snapshot, and no temp file survives."""
    telemetry.configure(str(tmp_path))
    c = telemetry.counter("t.torture")
    path = os.path.join(str(tmp_path), f"metrics-{os.getpid()}.json")
    stop = threading.Event()
    errors, reads = [], []

    def writer():
        while not stop.is_set():
            c.inc()
            telemetry.histogram("t.torture_h").record(0.01)
            telemetry.flush()

    def reader():
        while not stop.is_set():
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    snap = json.load(f)
            except ValueError as e:
                errors.append(repr(e))
                return
            reads.append("counters" in snap)

    threads = [threading.Thread(target=writer) for _ in range(3)] + \
        [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert reads and all(reads)
    assert json.load(open(path))["counters"]["t.torture"] > 0
    assert not glob.glob(os.path.join(str(tmp_path), "*.tmp"))


def test_adopt_child_snapshot(tmp_path):
    assert not telemetry.adopt_child_snapshot(99999)   # no dir
    telemetry.configure(str(tmp_path))
    child = {"pid": 99999, "counters": {"t.child": 7},
             "histograms": {"t.ch": {"count": 1, "sum": 0.5, "min": 0.5,
                                     "max": 0.5, "buckets": {"1": 1}}}}
    cpath = os.path.join(str(tmp_path), "metrics-99999.json")
    json.dump(child, open(cpath, "w"))
    assert telemetry.adopt_child_snapshot(99999)
    assert telemetry.counter("t.child").value == 7
    assert telemetry.histogram("t.ch").count == 1
    assert not os.path.exists(cpath) and os.path.exists(cpath + ".merged")
    assert not telemetry.adopt_child_snapshot(99999)
    # the reader skips the merged file: nothing is counted twice
    telemetry.flush()
    reg, snaps, _, _ = obs.load_dir(str(tmp_path))
    assert len(snaps) == 1 and reg.counters["t.child"].value == 7


def test_maybe_flush_writes_off_the_calling_thread(tmp_path):
    telemetry.configure(str(tmp_path))
    telemetry.counter("t.bg").inc()
    path = os.path.join(str(tmp_path), f"metrics-{os.getpid()}.json")
    telemetry.maybe_flush()
    deadline = time.monotonic() + 10
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert json.load(open(path))["counters"]["t.bg"] == 1
    # throttled: a second call inside FLUSH_EVERY writes nothing new
    telemetry.counter("t.bg").inc()
    telemetry.maybe_flush()
    time.sleep(0.2)
    assert json.load(open(path))["counters"]["t.bg"] == 1


def test_trace_provider_stamps_events():
    telemetry.set_trace_provider(lambda: ("tr1", "sp1"))
    telemetry.event("t.traced")
    telemetry.event("t.own", trace="mine")
    telemetry.set_trace_provider(lambda: 1 / 0)
    telemetry.event("t.broken_provider")
    telemetry.set_trace_provider(None)
    ev = telemetry.recent_events("t.traced")[-1]
    assert ev["trace"] == "tr1" and ev["span"] == "sp1"
    assert telemetry.recent_events("t.own")[-1]["trace"] == "mine"
    assert "trace" not in telemetry.recent_events("t.broken_provider")[-1]


def test_a_vanished_dir_drops_the_sink_and_keeps_counting(tmp_path):
    d = tmp_path / "gone"
    telemetry.configure(str(d))
    telemetry.flush()   # the throttle then starts no background write
    telemetry.event("t.first")
    shutil.rmtree(d)
    (tmp_path / "gone").write_text("a file where the dir was")
    telemetry.counter("t.after").inc()
    telemetry.event("t.second")
    assert telemetry.flush() is None
    assert telemetry.counter("t.after").value == 1
    assert [e["event"] for e in telemetry.recent_events()] == \
        ["t.first", "t.second"]
