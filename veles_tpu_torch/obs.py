"""Reading a metrics dir's traces (the port's copy of the trace half of
``veles_tpu/obs.py``).

:func:`load_dir` reads every per-process snapshot (``metrics-*.json``,
skipping ``*.merged`` files: a parent already folded those in) into one
merged :class:`veles_tpu_torch.telemetry.Registry`, and every journal
(``journal-*.jsonl``) into one timeline, ordered by a skew-corrected
clock (:func:`_skew_correct`).  :func:`load_tree` adds a fleet's
``replica-<i>/`` dirs.  Over that timeline :func:`assemble_traces` groups
the events of each trace, :func:`critical_path` splits one request's
latency into pre-route, wire, batch wait and dispatch,
:func:`render_trace` and :func:`render_traces` print them, and
:func:`tail_exemplars` names the traces behind a histogram's tail.

The run and fleet views of the reference's module (the counter and
histogram tables, ``fleet_rows``) come with a later slice.
"""

from __future__ import annotations

import glob
import json
import math
import os
import sys

from veles_tpu_torch.telemetry import LOG_LO, NBUCKETS, PER_DECADE, \
    Registry

#: per-pid ``ts - mono`` offsets within this window of the shared offset
#: are the same monotonic epoch (one machine, one boot); beyond it a pid
#: keeps its own offset (another machine: its monotonic stamps do not
#: compare, and the wall clock is the best ordering there is)
_SKEW_EPOCH_WINDOW_S = 120.0


def _skew_correct(events) -> None:
    """Stamp each event with ``_t``, one timeline across processes.  The
    wall clock (``ts``) compares across processes but steps (NTP slews,
    coarse rounding); ``mono`` is smooth and, for every process on one
    machine, counts from the same epoch.  So the median ``ts - mono``
    over all events is the machine's offset, and events order by
    ``offset + mono``: per-process wall-clock disagreement cancels out.
    A pid whose own offset sits far from the shared one (another
    machine) keeps its own.  Events without ``mono`` use ``ts``."""
    by_pid = {}
    all_deltas = []
    for ev in events:
        if isinstance(ev.get("mono"), (int, float)) \
                and isinstance(ev.get("ts"), (int, float)):
            d = ev["ts"] - ev["mono"]
            by_pid.setdefault(ev.get("_pid"), []).append(d)
            all_deltas.append(d)
    if not all_deltas:
        for ev in events:
            ev["_t"] = ev.get("ts", 0.0)
        return
    all_deltas.sort()
    shared = all_deltas[len(all_deltas) // 2]
    offsets = {}
    for pid, deltas in by_pid.items():
        deltas.sort()
        own = deltas[len(deltas) // 2]
        offsets[pid] = shared if abs(own - shared) \
            <= _SKEW_EPOCH_WINDOW_S else own
    for ev in events:
        off = offsets.get(ev.get("_pid"))
        if off is not None and isinstance(ev.get("mono"), (int, float)):
            ev["_t"] = off + ev["mono"]
        else:
            ev["_t"] = ev.get("ts", 0.0)


def load_dir(metrics_dir: str):
    """(merged Registry, [snapshot paths], [journal paths], [journal
    events sorted by the skew-corrected time]) of a metrics dir."""
    reg = Registry()
    snaps = []
    for path in sorted(glob.glob(os.path.join(metrics_dir,
                                              "metrics-*.json"))):
        if path.endswith(".merged") or path.endswith(".tmp"):
            continue
        try:
            with open(path) as f:
                reg.merge_snapshot(json.load(f))
            snaps.append(path)
        except (OSError, ValueError) as e:
            print(f"obs: skipping unreadable {path}: {e}",
                  file=sys.stderr)
    events = []
    journals = sorted(glob.glob(os.path.join(metrics_dir,
                                             "journal-*.jsonl")))
    for path in journals:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue   # a killed process's torn last line
                    ev["_pid"] = os.path.basename(path).split("-")[-1] \
                        .split(".")[0]
                    events.append(ev)
        except OSError:
            continue
    _skew_correct(events)
    events.sort(key=lambda e: e["_t"])
    return reg, snaps, journals, events


def fleet_replica_dirs(metrics_dir: str):
    """[(replica index, child dir)]: the per-replica metrics dirs a
    ``FleetRouter`` gives its hives (``replica-<i>/``)."""
    out = []
    try:
        names = sorted(os.listdir(metrics_dir))
    except OSError:
        return out
    for fn in names:
        if not fn.startswith("replica-"):
            continue
        path = os.path.join(metrics_dir, fn)
        if not os.path.isdir(path):
            continue
        try:
            idx = int(fn.split("-")[-1])
        except ValueError:
            continue
        out.append((idx, path))
    return sorted(out)


def load_tree(metrics_dir: str):
    """(root Registry, [all events]) with every ``replica-<i>/`` child
    journal merged in: the cross-process view trace assembly needs.
    Replica events carry ``_replica``; the whole list sorts on the
    skew-corrected ``_t``, so a hop that happened second never shows
    first because its process's wall clock was behind."""
    reg, _snaps, _journals, events = load_dir(metrics_dir)
    merged = list(events)
    for idx, path in fleet_replica_dirs(metrics_dir):
        _reg, _s, _j, evs = load_dir(path)
        for ev in evs:
            ev["_replica"] = idx
        merged.extend(evs)
    merged.sort(key=lambda e: e.get("_t", e.get("ts", 0.0)))
    return reg, merged


# -- trace assembly ------------------------------------------------------

def assemble_traces(events):
    """{trace_id: [its events, time-ordered]} over a merged event list.
    Membership is by the ``trace`` field (stamped by the trace.* events
    and by telemetry's provider seam); a ``trace.batch`` event joins
    every trace it links: the coalesced dispatch belongs to each request
    it carried."""
    traces = {}
    for ev in events:
        tid = ev.get("trace")
        if tid:
            traces.setdefault(tid, []).append(ev)
        if ev.get("event") == "trace.batch":
            for link in ev.get("links") or ():
                lt = link.get("trace")
                if lt and lt != tid:
                    traces.setdefault(lt, []).append(ev)
    for evs in traces.values():
        evs.sort(key=lambda e: e.get("_t", e.get("ts", 0.0)))
    return traces


def critical_path(trace_events):
    """Split one assembled trace's winning leg into the four places its
    latency can hide: the router's pre-route (failed legs, the hedge's
    delay), the wire and process hop, the batcher's queue wait, and the
    device dispatch.  A dict of components in seconds (None where the
    hop's event is missing) and the legs' bookkeeping."""
    root = next((e for e in trace_events
                 if e.get("event") == "trace.request"), None)
    legs = [e for e in trace_events if e.get("event") == "trace.leg"]
    serves = {e.get("parent"): e for e in trace_events
              if e.get("event") == "trace.serve"}
    win = next((e for e in legs if e.get("winner")), None)
    out = {
        "trace": trace_events[0].get("trace") if trace_events else None,
        "model": root.get("model") if root else None,
        "outcome": root.get("outcome") if root else None,
        "total_s": root.get("seconds") if root else None,
        "legs": len(legs),
        "hedged": any(e.get("hedge") for e in legs),
        "retried": sum(1 for e in legs if not e.get("hedge")) > 1,
        "replica": win.get("replica") if win else None,
        "pre_route_s": None, "wire_s": None,
        "batch_wait_s": None, "dispatch_s": None,
    }
    if root is not None and win is not None \
            and isinstance(root.get("seconds"), (int, float)) \
            and isinstance(win.get("seconds"), (int, float)):
        out["pre_route_s"] = round(
            max(0.0, root["seconds"] - win["seconds"]), 6)
    serve = serves.get(win.get("span")) if win else None
    if serve is not None:
        out["batch_wait_s"] = serve.get("wait_s")
        out["dispatch_s"] = serve.get("dispatch_s")
        if isinstance(win.get("seconds"), (int, float)) \
                and isinstance(serve.get("total_s"), (int, float)):
            out["wire_s"] = round(
                max(0.0, win["seconds"] - serve["total_s"]), 6)
    return out


def render_trace(trace_events) -> str:
    """One assembled trace as an indented hop timeline and its critical
    path."""
    if not trace_events:
        return "(empty trace)"
    tid = trace_events[0].get("trace")
    t0 = trace_events[0].get("_t", trace_events[0].get("ts", 0.0))
    depth = {}
    for ev in trace_events:
        par = ev.get("parent")
        depth[ev.get("span")] = depth.get(par, 0) + 1 \
            if par is not None else 0
    out = [f"trace {tid}"]
    for ev in trace_events:
        dt_ms = 1000.0 * (ev.get("_t", ev.get("ts", 0.0)) - t0)
        pad = "  " * (1 + depth.get(ev.get("span"), 0))
        who = ev.get("_pid", "?")
        rep = ev.get("_replica")
        if rep is not None:
            who = f"r{rep}/{who}"
        fields = " ".join(
            f"{k}={v}" for k, v in ev.items()
            if k not in ("ts", "mono", "event", "trace", "span",
                         "parent", "_pid", "_t", "_replica", "links")
            and v is not None)
        out.append(f"  +{dt_ms:8.1f}ms {pad}[{who}] "
                   f"{ev.get('event', '?')} {fields}".rstrip())
    cp = critical_path(trace_events)
    parts = [(k, cp[k]) for k in ("pre_route_s", "wire_s",
                                  "batch_wait_s", "dispatch_s")
             if isinstance(cp.get(k), (int, float))]
    if parts:
        hot = max(parts, key=lambda kv: kv[1])
        out.append("  critical path: " + "  ".join(
            f"{k[:-2]}={1000.0 * v:.1f}ms" for k, v in parts)
            + f"  <- {hot[0][:-2]} dominates")
    return "\n".join(out)


def tail_exemplars(reg: Registry, name: str, q: float = 0.99):
    """Trace ids kept in ``name``'s histogram buckets at or above its
    q-quantile: from "p99 is high" straight to the traces that made it
    so.  [(bucket lower edge in seconds, trace_id)], slowest last; empty
    when the histogram has no exemplars (tracing off)."""
    h = reg.histograms.get(name)
    if h is None or not h.count or not h.exemplars:
        return []
    thr = h.quantile(q)
    out = []
    for i, tid in sorted(h.exemplars.items()):
        i = int(i)
        if i <= 0:
            edge, upper = 0.0, 10.0 ** LOG_LO
        elif i >= NBUCKETS + 1:
            edge = 10.0 ** (LOG_LO + NBUCKETS / PER_DECADE)
            upper = math.inf
        else:
            edge = 10.0 ** (LOG_LO + (i - 1) / PER_DECADE)
            upper = 10.0 ** (LOG_LO + i / PER_DECADE)
        # a bucket whose upper edge clears the quantile may hold the
        # quantile's sample itself: include it
        if thr is None or upper >= thr:
            out.append((edge, tid))
    return out


def render_traces(metrics_dir: str, reg: Registry,
                  max_rows: int = 8) -> str:
    """The traces panel: critical-path rows of the slowest assembled
    traces and the tail exemplars of the fleet's request histogram.  An
    empty string when the dir holds no trace events."""
    _root_reg, merged = load_tree(metrics_dir)
    traces = assemble_traces(merged)
    if not traces:
        return ""
    rows = []
    for _tid, evs in traces.items():
        cp = critical_path(evs)
        if cp.get("total_s") is not None:
            rows.append(cp)
    rows.sort(key=lambda c: c["total_s"], reverse=True)
    out = [f"-- flightline traces ({len(traces)} assembled; "
           f"slowest first) --",
           f"  {'trace':<16} {'model':<12} {'outcome':>7} "
           f"{'total ms':>9} {'preroute':>9} {'wire':>8} "
           f"{'batchwait':>9} {'dispatch':>9} {'legs':>4} "
           f"{'hedged':>6}"]
    for cp in rows[:max_rows]:
        def ms(v):
            return _fmt(round(1000.0 * v, 2)) \
                if isinstance(v, (int, float)) else "-"
        out.append(
            f"  {cp['trace'] or '-':<16} {cp['model'] or '-':<12} "
            f"{cp['outcome'] or '-':>7} {ms(cp['total_s']):>9} "
            f"{ms(cp['pre_route_s']):>9} {ms(cp['wire_s']):>8} "
            f"{ms(cp['batch_wait_s']):>9} {ms(cp['dispatch_s']):>9} "
            f"{cp['legs']:>4} {'y' if cp['hedged'] else '-':>6}")
    ex = tail_exemplars(reg, "fleet.request_seconds")
    if ex:
        out.append("  p99 exemplars (fleet.request_seconds): "
                   + " ".join(t for _e, t in ex[-4:]))
    return "\n".join(out)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:.3e}"
        return f"{v:,.4f}".rstrip("0").rstrip(".")
    return f"{v:,}"
