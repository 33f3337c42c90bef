"""Reading a metrics dir (the port's copy of ``veles_tpu/obs.py``):
the run view, the fleet view and the traces, behind the port's report
CLI ``python -m veles_tpu_torch.tools.obs_report``.

:func:`load_dir` reads every per-process snapshot (``metrics-*.json``,
skipping ``*.merged`` files: a parent already folded those in) into one
merged :class:`veles_tpu_torch.telemetry.Registry`, and every journal
(``journal-*.jsonl``) into one timeline, ordered by a skew-corrected
clock (:func:`_skew_correct`).  :func:`load_tree` adds a fleet's
``replica-<i>/`` dirs.

- The run view: :func:`render` prints the counter and gauge tables, a
  quantile table per histogram, the derived throughput
  (:data:`THROUGHPUT_ROWS`), the residency ledger
  (:func:`arbiter_ledger`), the online learner (:func:`learner_rows`),
  the traces and the journal's tail.
- The fleet view: :func:`fleet_rows` gives one row per replica dir
  (newest pid, spawns, resident models, queue, requests, qps, p99, and
  the sentinel's state from the router's own journal),
  :func:`scale_timeline` the autoscaler's actions with their causes,
  :func:`fleet_model_rows` the per-model split and canaries;
  :func:`render_fleet` prints them.
- The traces: :func:`assemble_traces` groups the events of each trace,
  :func:`critical_path` splits one request's latency into pre-route,
  wire, batch wait and dispatch, :func:`render_trace` and
  :func:`render_traces` print them, and :func:`tail_exemplars` names the
  traces behind a histogram's tail.

The formats are the reference's, so either package's reader reads
either package's dirs, and for the same dir returns the same rows.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import sys
import time

from veles_tpu_torch.telemetry import LOG_LO, NBUCKETS, PER_DECADE, \
    Registry

#: (label, images counter, seconds counter, unit) rows of the derived
#: throughput table; only pairs present in the merged registry print
THROUGHPUT_ROWS = (
    ("fused train", "fused.train_images", "fused.train_seconds",
     "img/s"),
    ("fused eval", "fused.eval_images", "fused.eval_seconds", "img/s"),
    ("ensemble", "ensemble.member_images", "ensemble.seconds",
     "member-img/s"),
    ("ga", "ga.evaluations", "ga.eval_seconds", "genomes/s"),
    ("serve", "serve.rows", "serve.dispatch_seconds", "rows/s"),
    ("online learner", "online.step_rows", "online.step_seconds",
     "rows/s"),
)

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


# -- the fleet view ------------------------------------------------------

def _sentinel_overlay(metrics_dir: str):
    """{replica index: (state, health score, hedge wins)} from the
    router's own registry and journal: the sentinel's eject, probe and
    reinstate events carry a ``state``, the ``fleet.replica.<i>.*``
    family the score and the hedge wins.  Why a replica is out of
    rotation."""
    reg, _snaps, _journals, events = load_dir(metrics_dir)
    states = {}
    for ev in events:
        if ev.get("event") in ("fleet.eject.replica",
                               "fleet.eject.reinstated",
                               "fleet.probe.result") \
                and ev.get("replica") is not None and ev.get("state"):
            states[int(ev["replica"])] = ev["state"]
    out = {}
    for idx in set(states) | {
            int(m.group(1)) for m in
            (re.match(r"fleet\.replica\.(\d+)\.health_score$", n)
             for n in reg.gauges) if m}:
        g = reg.gauges.get(f"fleet.replica.{idx}.health_score")
        c = reg.counters.get(f"fleet.replica.{idx}.hedge_wins")
        out[idx] = (states.get(idx, "healthy"),
                    g.value if g else None,
                    int(c.value) if c else 0)
    return out


def fleet_rows(metrics_dir: str):
    """One row per replica dir, from its merged snapshots: the pid of the
    newest snapshot (a respawn leaves the older pids behind), spawns,
    resident models, devices and resident MiB per device, live queue
    depth, requests, lifetime qps (requests over the ready-to-last-flush
    wall), request p99, the sentinel's overlay (state, health score,
    hedge wins) and the residency ledger."""
    rows = []
    overlay = _sentinel_overlay(metrics_dir)
    for idx, path in fleet_replica_dirs(metrics_dir):
        reg, snaps, _journals, events = load_dir(path)
        pid = None
        last_ts = None
        newest = max(snaps, key=os.path.getmtime, default=None)
        if newest is not None:
            stem = os.path.basename(newest)
            try:
                pid = int(stem.split("-")[-1].split(".")[0])
            except ValueError:
                pid = None
            try:
                with open(newest) as f:
                    last_ts = json.load(f).get("ts")
            except (OSError, ValueError):
                last_ts = None
        readies = [e for e in events if e.get("event") == "serve.ready"]
        requests = reg.counters.get("serve.requests")
        requests = requests.value if requests else 0
        qps = None
        if readies and last_ts and last_ts > readies[0].get("ts", 0):
            qps = requests / (last_ts - readies[0]["ts"])
        g_res = reg.gauges.get("serve.models_resident")
        g_q = reg.gauges.get("serve.queue_depth")
        g_dev = reg.gauges.get("serve.mesh_devices")
        g_pd = reg.gauges.get("serve.resident_bytes_per_device")
        h = reg.histograms.get("serve.request_seconds")
        state, score, hedge_wins = overlay.get(idx, ("healthy", None, 0))
        rows.append({
            "replica": idx,
            "pid": pid,
            "spawns": len(readies),
            "models_resident": g_res.value if g_res else None,
            "devices": int(g_dev.value) if g_dev else 1,
            "resident_mib_per_device": round(
                g_pd.value / (1 << 20), 2) if g_pd else None,
            "queue_depth": g_q.value if g_q else None,
            "requests": requests,
            "qps": round(qps, 1) if qps is not None else None,
            "p99_ms": round(1000 * h.quantile(0.99), 3)
            if h and h.count else None,
            "state": state,
            "health_score": score,
            "hedge_wins": hedge_wins,
            "arbiter": arbiter_ledger(reg),
        })
    return rows


#: the journal events that change the fleet's shape, each a row of the
#: scale timeline, with the name the row gives it
_SCALE_EVENTS = {
    "fleet.scale.up": "scale-up",
    "fleet.scale.down": "scale-down",
    "fleet.replica_retired": "retired",
    "fleet.degrade.engage": "degrade",
    "fleet.degrade.release": "recover",
}


def scale_timeline(metrics_dir: str):
    """The elastic fleet's timeline from the router's journal: one row a
    scale or degradation event, ``{t_s, kind, replica, rung, cause,
    n_replicas}``, ``t_s`` from the fleet's ready event: a day's replica
    count and why each step happened, read after the fact."""
    _reg, _snaps, _journals, events = load_dir(metrics_dir)
    t0 = None
    for ev in events:
        if ev.get("event") == "fleet.ready":
            t0 = ev.get("ts")
            break
    rows = []
    for ev in events:
        kind = _SCALE_EVENTS.get(ev.get("event"))
        if not kind:
            continue
        ts = ev.get("ts")
        rows.append({
            "t_s": round(ts - t0, 1)
            if ts is not None and t0 is not None else None,
            "kind": kind,
            "replica": ev.get("replica"),
            "rung": ev.get("rung"),
            "cause": ev.get("cause"),
            "n_replicas": ev.get("n_replicas"),
        })
    return rows


def fleet_model_rows(reg: Registry, events):
    """The per-model traffic split from the router's registry: one row a
    ``fleet.model.<name>.*`` family, with its canary registration from
    the last ``fleet.ready`` event."""
    models = {}
    for n, c in reg.counters.items():
        m = re.match(r"fleet\.model\.(.+)\.(requests|errors|shed|"
                     r"mirrored)$", n)
        if m:
            models.setdefault(m.group(1), {})[m.group(2)] = c.value
    canaries = {}
    for ev in events:
        if ev.get("event") == "fleet.ready" and ev.get("canaries"):
            canaries = ev["canaries"]
    total = sum(d.get("requests", 0) for d in models.values()) or 1
    rows = []
    for name in sorted(models):
        d = models[name]
        h = reg.histograms.get(f"fleet.model.{name}.request_seconds")
        c = canaries.get(name)
        rows.append({
            "model": name,
            "requests": d.get("requests", 0),
            "share": round(d.get("requests", 0) / total, 4),
            "errors": d.get("errors", 0),
            "shed": d.get("shed", 0),
            "mirrored": d.get("mirrored", 0),
            "p50_ms": round(1000 * h.quantile(0.5), 3)
            if h and h.count else None,
            "p99_ms": round(1000 * h.quantile(0.99), 3)
            if h and h.count else None,
            "canary_of": c.get("of") if c else None,
            "canary_fraction": c.get("fraction") if c else None,
        })
    return rows


def arbiter_ledger(reg: Registry):
    """The process's residency ledger from its gauges
    (``arbiter.budget_bytes``, ``arbiter.resident_bytes``,
    ``arbiter.pool.<pool>.resident_bytes``): budget, resident bytes,
    utilization and the split by pool.  None when the process charged
    no budget (a training run, the router)."""
    budget = reg.gauges.get("arbiter.budget_bytes")
    if budget is None or budget.value is None:
        return None
    pools = {}
    for n, g in reg.gauges.items():
        m = re.match(r"arbiter\.pool\.(.+)\.resident_bytes$", n)
        if m and g.value is not None:
            pools[m.group(1)] = int(g.value)
    total = reg.gauges.get("arbiter.resident_bytes")
    resident = int(total.value) if total and total.value is not None \
        else sum(pools.values())
    return {
        "budget_bytes": int(budget.value),
        "resident_bytes": resident,
        "utilization": round(resident / budget.value, 4)
        if budget.value else None,
        "pools": pools,
    }


def render_arbiter(reg: Registry, label: str = "") -> str:
    """The residency panel: one budget line and the resident bytes by
    pool, in MiB; an empty string when the process charged no budget."""
    led = arbiter_ledger(reg)
    if led is None:
        return ""
    mib = 1 << 20

    def as_mib(v):
        return _fmt(round(v / mib, 2))

    head = "-- hbm arbiter" + (f" ({label})" if label else "") + " --"
    util = f" ({100.0 * led['utilization']:.1f}%)" \
        if led.get("utilization") is not None else ""
    out = [head,
           f"  resident {as_mib(led['resident_bytes'])} MiB of "
           f"{as_mib(led['budget_bytes'])} MiB budget{util}"]
    pools = led["pools"]
    if pools:
        out.append("  " + "  ".join(
            f"{pool}={as_mib(pools[pool])} MiB"
            for pool in sorted(pools, key=lambda p: -pools[p])))
    return "\n".join(out)


def learner_rows(reg: Registry, events):
    """The online learner's rows, one a learning model: its buffer fill,
    steps and gate state from the ``online.model.<name>.*`` gauges, the
    gate's last scored round and the promotions and rollbacks from the
    journal."""
    models = {}
    for n, g in reg.gauges.items():
        m = re.match(r"online\.model\.(.+)\.(buffer_rows|steps|"
                     r"gate_state)$", n)
        if m:
            models.setdefault(m.group(1), {})[m.group(2)] = g.value
    last_gate = {}
    counts = {}
    for ev in events:
        name = ev.get("model")
        if not name:
            continue
        kind = ev.get("event")
        if kind == "online.gate":
            last_gate[name] = ev
        elif kind in ("online.promoted", "online.rollback"):
            key = "promotions" if kind == "online.promoted" \
                else "rollbacks"
            counts.setdefault(name, {"promotions": 0,
                                     "rollbacks": 0})[key] += 1
            if kind == "online.promoted":
                counts[name]["last_promote_ts"] = ev.get("ts")
            else:
                counts[name]["last_rollback_ts"] = ev.get("ts")
    names = sorted(set(models) | set(last_gate) | set(counts))
    if not names:
        return []
    # imported only where a model learns: the package loads torch
    from veles_tpu_torch.online.promote import GATE_STATES
    rows = []
    for name in names:
        d = models.get(name, {})
        ev = last_gate.get(name, {})
        c = counts.get(name, {})
        code = d.get("gate_state")
        state = GATE_STATES[int(code)] \
            if code is not None and 0 <= int(code) < len(GATE_STATES) \
            else None
        rows.append({
            "model": name,
            "state": state,
            "buffer_rows": d.get("buffer_rows"),
            "steps": d.get("steps"),
            "shadow_error_pct": ev.get("shadow_error_pct"),
            "incumbent_error_pct": ev.get("incumbent_error_pct"),
            "promotions": c.get("promotions", 0),
            "rollbacks": c.get("rollbacks", 0),
            "last_promote_ts": c.get("last_promote_ts"),
            "last_rollback_ts": c.get("last_rollback_ts"),
        })
    return rows


def render_learner(reg: Registry, events) -> str:
    """The learner panel (an empty string when nothing learns)."""
    rows = learner_rows(reg, events)
    if not rows:
        return ""
    out = ["-- online learner (Evergreen) --",
           f"  {'model':<16} {'state':>11} {'buffer':>7} "
           f"{'steps':>7} {'shadow%':>8} {'incumb%':>8} "
           f"{'promo':>5} {'rollb':>5}"]
    for r in rows:
        out.append(
            f"  {r['model']:<16} {r['state'] or '-':>11} "
            f"{_fmt(r['buffer_rows']):>7} {_fmt(r['steps']):>7} "
            f"{_fmt(r['shadow_error_pct']):>8} "
            f"{_fmt(r['incumbent_error_pct']):>8} "
            f"{_fmt(r['promotions']):>5} {_fmt(r['rollbacks']):>5}")
    return "\n".join(out)


def render_fleet(metrics_dir: str) -> str:
    """The fleet view: the replica rows, their residency, the scale
    timeline and the per-model split.  An empty string when
    ``metrics_dir`` holds no ``replica-*`` dir (not a fleet's)."""
    rows = fleet_rows(metrics_dir)
    if not rows:
        return ""
    reg, _snaps, _journals, events = load_dir(metrics_dir)
    out = ["-- fleet replicas --",
           f"  {'replica':>7} {'pid':>8} {'spawns':>6} "
           f"{'resident':>8} {'devs':>4} {'MiB/dev':>8} "
           f"{'queue':>6} {'requests':>9} "
           f"{'qps':>9} {'p99 ms':>9} {'state':>8} {'health':>7} "
           f"{'hedge_w':>7}"]
    for r in rows:
        pid = "-" if r["pid"] is None else str(r["pid"])
        out.append(
            f"  {r['replica']:>7} {pid:>8} "
            f"{r['spawns']:>6} {_fmt(r['models_resident']):>8} "
            f"{_fmt(r.get('devices', 1)):>4} "
            f"{_fmt(r.get('resident_mib_per_device')):>8} "
            f"{_fmt(r['queue_depth']):>6} {_fmt(r['requests']):>9} "
            f"{_fmt(r['qps']):>9} {_fmt(r['p99_ms']):>9} "
            f"{r.get('state', 'healthy'):>8} "
            f"{_fmt(r.get('health_score')):>7} "
            f"{_fmt(r.get('hedge_wins', 0)):>7}")
    arb = [(r["replica"], r["arbiter"]) for r in rows if r.get("arbiter")]
    if arb:
        out.append("")
        out.append("-- hbm arbiter (per-replica resident MiB) --")
        out.append(f"  {'replica':>7} {'budget':>9} {'resident':>9} "
                   f"{'util%':>6} {'serve':>9} {'train':>9} "
                   f"{'cohort':>9} {'scratch':>9}")
        mib = 1 << 20
        for idx, led in arb:
            pools = led["pools"]
            util = f"{100.0 * led['utilization']:.1f}" \
                if led.get("utilization") is not None else "-"
            out.append(
                f"  {idx:>7} "
                f"{_fmt(round(led['budget_bytes'] / mib, 1)):>9} "
                f"{_fmt(round(led['resident_bytes'] / mib, 2)):>9} "
                f"{util:>6} " + " ".join(
                    f"{_fmt(round(pools.get(p, 0) / mib, 2)):>9}"
                    for p in ("serve", "train", "cohort", "scratch")))
    tl = scale_timeline(metrics_dir)
    if tl:
        out.append("")
        out.append("-- fleet scale timeline --")
        out.append(f"  {'t+s':>8} {'event':<10} {'replica':>7} "
                   f"{'n':>3} {'rung':<10} cause")
        for r in tl:
            out.append(
                f"  {_fmt(r['t_s']):>8} {r['kind']:<10} "
                f"{_fmt(r['replica']):>7} {_fmt(r['n_replicas']):>3} "
                f"{(r['rung'] or '-'):<10} "
                f"{r['cause'] or '-'}".rstrip())
    mrows = fleet_model_rows(reg, events)
    if mrows:
        out.append("")
        out.append("-- fleet per-model split --")
        out.append(f"  {'model':<16} {'requests':>9} {'share':>7} "
                   f"{'p50 ms':>9} {'p99 ms':>9} {'errors':>7} "
                   f"{'shed':>6} {'mirrored':>8}  note")
        for m in mrows:
            note = ""
            if m["canary_of"]:
                note = f"canary-of:{m['canary_of']} " \
                       f"@{m['canary_fraction']}"
            out.append(
                f"  {m['model']:<16} {_fmt(m['requests']):>9} "
                f"{_fmt(m['share']):>7} {_fmt(m['p50_ms']):>9} "
                f"{_fmt(m['p99_ms']):>9} {_fmt(m['errors']):>7} "
                f"{_fmt(m['shed']):>6} {_fmt(m['mirrored']):>8}  "
                f"{note}".rstrip())
    return "\n".join(out)


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


# -- the run view --------------------------------------------------------

def render(metrics_dir: str, reg: Registry, snaps, journals, events,
           max_events: int = 40) -> str:
    """The run view of a loaded dir (:func:`load_dir`'s four values):
    counters, gauges, histogram quantiles, derived throughput, the
    residency and learner panels, the traces and the journal's last
    ``max_events`` events."""
    out = [f"== Sightline report: {metrics_dir} ==",
           f"{len(snaps)} process snapshot(s), {len(journals)} "
           f"journal(s), {len(events)} event(s)", ""]

    counters = {n: c.value for n, c in sorted(reg.counters.items())
                if c.value}
    if counters:
        w = max(len(n) for n in counters)
        out.append("-- counters --")
        out += [f"  {n:<{w}}  {_fmt(v)}" for n, v in counters.items()]
        out.append("")

    gauges = {n: g.value for n, g in sorted(reg.gauges.items())
              if g.value is not None}
    if gauges:
        w = max(len(n) for n in gauges)
        out.append("-- gauges --")
        out += [f"  {n:<{w}}  {_fmt(v)}" for n, v in gauges.items()]
        out.append("")

    hists = {n: h for n, h in sorted(reg.histograms.items()) if h.count}
    if hists:
        w = max(len(n) for n in hists)
        out.append("-- histograms (p50/p90/p99 from log buckets) --")
        out.append(f"  {'name':<{w}}  {'count':>8} {'mean':>11} "
                   f"{'p50':>11} {'p90':>11} {'p99':>11} {'max':>11}")
        for n, h in hists.items():
            out.append(
                f"  {n:<{w}}  {h.count:>8} {_fmt(h.mean):>11} "
                f"{_fmt(h.quantile(0.5)):>11} "
                f"{_fmt(h.quantile(0.9)):>11} "
                f"{_fmt(h.quantile(0.99)):>11} {_fmt(h.max):>11}")
        out.append("")

    rows = []
    for label, num, den, unit in THROUGHPUT_ROWS:
        n = counters.get(num)
        d = counters.get(den)
        if n and d:
            rows.append(f"  {label}: {_fmt(n)} over {_fmt(d)} engine-s "
                        f"-> {_fmt(n / d)} {unit}")
    if rows:
        out.append("-- derived throughput (per engine-second) --")
        out += rows
        out.append("")

    for panel in (render_arbiter(reg), render_learner(reg, events),
                  render_traces(metrics_dir, reg)):
        if panel:
            out.append(panel)
            out.append("")

    if events:
        shown = events[-max_events:]
        out.append(f"-- journal timeline (last {len(shown)} of "
                   f"{len(events)}) --")
        for ev in shown:
            ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
            fields = " ".join(
                f"{k}={_fmt(v) if isinstance(v, (int, float)) else v}"
                for k, v in ev.items() if k not in ("ts", "event", "_pid"))
            out.append(f"  {ts} [{ev.get('_pid', '?')}] "
                       f"{ev.get('event', '?')} {fields}".rstrip())
    return "\n".join(out)
