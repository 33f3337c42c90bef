"""One accountable production day for the elastic fleet.

Usage::

    python -m veles_tpu_torch.tools.gauntlet [-b auto|cuda|cpu] [--json]
        [--duration S] [--trace FILE]

The port's counterpart of the reference's ``scripts/gauntlet.py``.  A
seeded open-loop day of traffic (a diurnal swing, Poisson bursts, a Zipf
model mix: :mod:`veles_tpu_torch.serve.traffic`) is fired at a
:class:`~veles_tpu_torch.serve.router.FleetRouter` whose replica count
the :class:`~veles_tpu_torch.serve.autoscale.FleetAutoscaler` owns, with
the online learner armed on every replica and chaos injected mid-day: a
gray slow-dispatch blip on the founding replica and a SIGTERM on the
youngest one in the middle of a burst.  The fleet must track the load
(scale up on the morning ramp, down through the evening trough), hold
its p99 outside the degraded windows, and lose no answer.

Then :func:`accountability_check` balances the books from the outcome
ledger and the merged journals (the router's dir and every
``replica-*/``): every arrival has exactly one outcome and none is an
error (a shed is honest, an error is a lost answer); every answer's
crc32 matches its echo; every scale, degradation, retirement, ejection,
reinstatement, promotion, rollback and replica death carries its
recorded cause.  A sample of answers is held against the host oracle:
the port's own engine over the same package on the CPU.

The sizing knobs are the reference's ``GAUNTLET_*`` variables with its
defaults (a 150 s day).  The day runs on the card unless ``-b cpu`` asks
for the CPU; without a card, ``-b auto`` and ``-b cuda`` exit 1 naming
the missing card.  The last stdout line is one JSON object with
``gauntlet_ok``; the exit code is 0 when it is true, 1 when it is false
(or without a card), 2 under ``python -O`` (which strips its asserts).
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import sys
import tempfile
import textwrap
import threading
import time
import zlib

import numpy as np

from veles_tpu_torch import events
from veles_tpu_torch.tools.chaos_drill import REPO, build_package


def log(msg: str) -> None:
    print(f"[gauntlet] {msg}", file=sys.stderr, flush=True)


def _env_f(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def _env_i(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# -- the workload ----------------------------------------------------------

#: fixed rows a request: one dispatch shape a replica
ROWS_PER_REQUEST = 8
INPUT_SHAPE = (6, 6, 1)

WF_TEXT = textwrap.dedent(f"""
    from veles_tpu_torch import prng
    from veles_tpu_torch.datasets import synthetic_classification
    from veles_tpu_torch.loader.fullbatch import ArrayLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

    def create_workflow(launcher):
        prng.seed_all(2020)
        train, valid, _ = synthetic_classification(
            64, 16, {INPUT_SHAPE}, n_classes=3, seed=9)
        return StandardWorkflow(
            loader_factory=lambda w: ArrayLoader(
                w, train=train, valid=valid, minibatch_size=16,
                name="loader"),
            layers=[
                {{"type": "all2all_tanh",
                  "->": {{"output_sample_shape": 64}},
                  "<-": {{"learning_rate": 0.1}}}},
                {{"type": "softmax", "->": {{"output_sample_shape": 3}},
                  "<-": {{"learning_rate": 0.1}}}},
            ],
            decision_config={{"max_epochs": 2}}, name="gauntlet_wf")
""")


def _row_for(arrival) -> np.ndarray:
    """The arrival's input rows, regenerated from its trace seed: every
    oracle check can be replayed after the fact."""
    rng = np.random.default_rng(arrival.row_seed)
    return rng.standard_normal(
        (ROWS_PER_REQUEST,) + INPUT_SHAPE).astype(np.float32)


# -- the books -------------------------------------------------------------

class _Journals:
    """The events of every journal in a fleet's dir and its
    ``replica-<i>/`` dirs (what the whole process tree reported), by
    name, in time order."""

    def __init__(self, mdir: str) -> None:
        from veles_tpu_torch import obs
        self.events = obs.load_tree(mdir)[1]

    def __call__(self, name: str) -> list:
        return [e for e in self.events if e.get("event") == name]


def _ledger_check(arrivals, results, unexplained: list) -> dict:
    """The outcome ledger: one outcome an arrival, none an error, every
    answer's crc32 its echo."""
    counts = {}
    for r in results:
        counts[r["i"]] = counts.get(r["i"], 0) + 1
    for a in arrivals:
        n = counts.get(a.i, 0)
        if n != 1:
            unexplained.append({"event": "arrival without one outcome",
                                "record": {"i": a.i, "outcomes": n}})
    known = {a.i for a in arrivals}
    for i in sorted(set(counts) - known):
        unexplained.append({"event": "outcome of no arrival",
                            "record": {"i": i}})
    errors = crc_checked = corrupt = 0
    for r in results:
        if r["status"] == "error":
            errors += 1
            unexplained.append({"event": "lost answer",
                                "record": {"i": r["i"],
                                           "response": r["response"]}})
            continue
        resp = r["response"]
        if r["status"] == "ok" and resp.get("crc") is not None \
                and "probs" in resp:
            crc_checked += 1
            probs = np.asarray(resp["probs"], np.float32)
            if zlib.crc32(probs.tobytes()) != int(resp["crc"]):
                corrupt += 1
                unexplained.append({"event": "crc mismatch",
                                    "record": {"i": r["i"]}})
    return {"lost": sum(1 for a in arrivals if counts.get(a.i, 0) == 0),
            "errors": errors, "crc_checked": crc_checked,
            "corrupt": corrupt}


def accountability_check(mdir: str, preemptions: list, arrivals,
                         results) -> dict:
    """Balance the day's books.  ``arrivals`` and ``results`` are the
    schedule and :class:`~veles_tpu_torch.serve.traffic.OpenLoopDriver`'s
    outcomes; ``preemptions`` the replicas the day SIGTERMed
    (``{"replica": i, ...}``).  Every arrival must have one outcome and
    none an error, every answer's crc must match, and every fleet change
    in the merged journals of ``mdir`` must carry its recorded cause.
    The verdict: ``{"explained", "unexplained", "accounted", "lost",
    "errors", "crc_checked", "corrupt"}``; ``unexplained`` non-empty
    fails the day."""
    unexplained = []
    ledger = _ledger_check(arrivals, results, unexplained)
    explained = 0
    journals = _Journals(mdir)

    # the events whose contract is an explicit cause field
    for name in (events.EV_FLEET_SCALE_UP, events.EV_FLEET_SCALE_DOWN,
                 events.EV_FLEET_DEGRADE_ENGAGE,
                 events.EV_FLEET_DEGRADE_RELEASE):
        for e in journals(name):
            if e.get("cause"):
                explained += 1
            else:
                unexplained.append({"event": name, "record": e})

    # a retirement ties back to a scale-down of the same replica
    downs = {e.get("replica")
             for e in journals(events.EV_FLEET_SCALE_DOWN)}
    for e in journals(events.EV_FLEET_REPLICA_RETIRED):
        if e.get("replica") in downs:
            explained += 1
        else:
            unexplained.append({"event": "orphan retirement", "record": e})

    # an ejection's cause is its score and strikes, a reinstatement's
    # its clean probes
    for e in journals(events.EV_FLEET_REPLICA_EJECTED):
        if e.get("score") is not None and e.get("strikes") is not None:
            explained += 1
        else:
            unexplained.append({"event": "uncaused ejection", "record": e})
    for e in journals(events.EV_FLEET_REPLICA_REINSTATED):
        if e.get("probes_ok"):
            explained += 1
        else:
            unexplained.append({"event": "uncaused reinstatement",
                                "record": e})

    # a promotion or rollback carries the gate's standings
    for name in (events.EV_ONLINE_PROMOTED, events.EV_ONLINE_ROLLBACK):
        for e in journals(name):
            if e.get("shadow_error_pct") is not None:
                explained += 1
            else:
                unexplained.append({"event": name, "record": e})

    # a replica's death is a retirement, a preemption the day injected,
    # or a crash the monitor answered with a respawn of the same slot
    retired = {e.get("replica")
               for e in journals(events.EV_FLEET_REPLICA_RETIRED)}
    preempted = {p["replica"] for p in preemptions}
    spawns = journals(events.EV_FLEET_REPLICA_SPAWNED)
    for e in journals(events.EV_FLEET_REPLICA_DIED):
        idx = e.get("replica")
        if idx in retired or idx in preempted:
            explained += 1
        elif any(s.get("replica") == idx and s.get("ts", 0) >= e.get("ts", 0)
                 for s in spawns):
            explained += 1
        else:
            unexplained.append({"event": "unexplained death", "record": e})

    return dict(ledger, explained=explained, unexplained=unexplained,
                accounted=not unexplained)


# -- the day ---------------------------------------------------------------

def _spec():
    """The CI-sized day (every figure a ``GAUNTLET_*`` knob): a 12x
    diurnal swing with 2.5x bursts over 150 s."""
    from veles_tpu_torch.serve.traffic import TrafficSpec
    duration = _env_f("GAUNTLET_DURATION", 150.0)
    return TrafficSpec(
        seed=_env_i("GAUNTLET_SEED", 20),
        duration_s=duration,
        peak_rps=_env_f("GAUNTLET_PEAK_RPS", 30.0),
        swing=_env_f("GAUNTLET_SWING", 12.0),
        period_s=duration,
        burst_every_s=_env_f("GAUNTLET_BURST_EVERY", 25.0),
        burst_len_s=_env_f("GAUNTLET_BURST_LEN", 5.0),
        burst_mult=_env_f("GAUNTLET_BURST_MULT", 2.5),
        models=["hot", "warm", "tail"],
        zipf_s=_env_f("GAUNTLET_ZIPF_S", 1.1))


def _determinism_pin(spec, d: str) -> bool:
    """The replay contract, pinned on every run: one seeded spec writes a
    byte-identical trace file twice."""
    from veles_tpu_torch.serve.traffic import generate, write_trace
    p1, p2 = os.path.join(d, "day_a.jsonl"), os.path.join(d, "day_b.jsonl")
    write_trace(p1, spec, generate(spec))
    write_trace(p2, spec, generate(spec))
    return filecmp.cmp(p1, p2, shallow=False)


def run_gauntlet(backend: str, trace_path: str = None) -> dict:
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.serve.autoscale import (FleetAutoscaler,
                                                 ScaleController)
    from veles_tpu_torch.serve.router import FleetRouter
    from veles_tpu_torch.serve.traffic import (OpenLoopDriver,
                                               _burst_windows, generate,
                                               read_trace, write_trace)

    t_start = time.perf_counter()
    d = tempfile.mkdtemp(prefix="gauntlet_")
    mdir = os.path.join(d, "metrics")

    spec = _spec()
    log(f"day: {spec.duration_s:.0f}s, peak {spec.peak_rps:.0f} rps, "
        f"swing {spec.swing:.0f}x, bursts {spec.burst_mult:.1f}x, "
        f"backend {backend}")
    deterministic = _determinism_pin(spec, d)
    log(f"determinism pin: trace bitwise-equal={deterministic}")
    if trace_path:
        spec, arrivals = read_trace(trace_path)
        log(f"replaying {trace_path}: {len(arrivals)} arrivals")
    else:
        arrivals = generate(spec)
        trace_path = os.path.join(d, "day.jsonl")
        write_trace(trace_path, spec, arrivals)
        log(f"generated {len(arrivals)} arrivals -> {trace_path}")

    log("packing the ensemble (one package, three Zipf names)")
    pkg, oracle, _w = build_package(d, "gauntlet", WF_TEXT, 33,
                                    _env_i("GAUNTLET_MEMBERS", 2))
    specs = {name: pkg for name in spec.models}

    # chaos, leg 1 (the gray blip): the founding replica dispatches slowly
    # a few times mid-morning (label=warm: the warm-up drives "hot", so
    # the blip spends its firings on live traffic)
    gray = os.environ.get(
        "GAUNTLET_GRAY_FAULTS",
        "hive.slow_dispatch@label=warm&times=3&seconds=0.6")
    router = FleetRouter(
        specs, n_replicas=1, backend=backend,
        max_batch=_env_i("GAUNTLET_MAX_BATCH", 16),
        max_wait_ms=_env_f("GAUNTLET_MAX_WAIT_MS", 40.0),
        metrics_dir=mdir, cwd=REPO,
        env={"VELES_ONLINE": "1"},        # the learner armed fleet-wide
        env_overrides={0: {"VELES_FAULTS": gray}} if gray else None,
        deadline_ms=60000.0)
    controller = ScaleController(
        min_replicas=_env_i("GAUNTLET_SCALE_MIN", 1),
        max_replicas=_env_i("GAUNTLET_SCALE_MAX", 3),
        up_ms=_env_f("GAUNTLET_UP_MS", 150.0),
        down_ms=_env_f("GAUNTLET_DOWN_MS", 60.0),
        up_sustain_s=_env_f("GAUNTLET_UP_SUSTAIN", 2.0),
        down_sustain_s=_env_f("GAUNTLET_DOWN_SUSTAIN", 4.0),
        cooldown_s=_env_f("GAUNTLET_COOLDOWN", 10.0))
    scaler = FleetAutoscaler(router, controller=controller, interval_s=0.25)

    preemptions = []
    results = []
    try:
        log("warming the founding replica")
        warm_lat = []
        row = _row_for(arrivals[0])
        for _ in range(12):
            t0 = time.perf_counter()
            resp = router.request("hot", row, timeout=180)
            if "probs" in resp:
                warm_lat.append(time.perf_counter() - t0)
        assert warm_lat, "the warm-up never produced an answer"
        warm_p50 = 1000 * float(np.percentile(warm_lat, 50))
        oracle_diff = float(np.abs(np.asarray(resp["probs"])
                                   - oracle(row)).max())
        assert oracle_diff < 1e-3, oracle_diff
        log(f"warm p50 {warm_p50:.1f}ms, oracle diff {oracle_diff:.2e}")

        # chaos, leg 2 (a preemption): a SIGTERM on the youngest replica
        # in the middle of a burst, when losing its queue would hurt most;
        # the drain, the respawn and the retry on a peer hide it
        day_wall0 = [None]
        stop_chaos = threading.Event()
        windows = _burst_windows(spec, np.random.default_rng(spec.seed))

        def _preempt_loop():
            fired = 0
            want = _env_i("GAUNTLET_PREEMPTIONS", 1)
            while not stop_chaos.is_set() and fired < want:
                if day_wall0[0] is None:
                    time.sleep(0.1)
                    continue
                t = time.monotonic() - day_wall0[0]
                mid_burst = any(a + 0.5 <= t < b for a, b in windows)
                live = [r for r in list(router.replicas)
                        if r.healthy and not r.retiring]
                if mid_burst and len(live) >= 2:
                    victim = max(live, key=lambda r: r.idx)
                    log(f"chaos: SIGTERM replica {victim.idx} (pid "
                        f"{victim.pid}) at t={t:.1f}s mid-burst")
                    preemptions.append({"replica": victim.idx,
                                        "t": round(t, 1),
                                        "pid": victim.pid})
                    try:
                        victim.client.sigterm()
                    except OSError:
                        pass
                    fired += 1
                stop_chaos.wait(0.25)

        chaos_thread = threading.Thread(target=_preempt_loop,
                                        name="gauntlet-chaos", daemon=True)
        chaos_thread.start()

        def request_fn(a):
            return router.request(a.model, _row_for(a), timeout=120)

        scaler.start()
        log("the day begins")
        driver = OpenLoopDriver(request_fn,
                                workers=_env_i("GAUNTLET_WORKERS", 64))
        wall0_unix = time.time()
        day_wall0[0] = time.monotonic()
        results = driver.run(arrivals)
        day_sec = time.monotonic() - day_wall0[0]
        stop_chaos.set()
        chaos_thread.join(timeout=5)
        log(f"the day ends: {len(results)} outcomes in {day_sec:.0f}s")
        # the epilogue: the day is not done until the fleet walks back
        # down to its floor, every spawned replica retired (journaled,
        # drained, its install dir pooled), as in the quiet hours
        epilogue = _env_f("GAUNTLET_EPILOGUE", 60.0)
        t_ep = time.monotonic()
        while time.monotonic() - t_ep < epilogue:
            live = [r for r in router.replicas if not r.retiring]
            if len(live) <= scaler.controller.min_replicas \
                    and not scaler.ladder.engaged:
                break
            time.sleep(0.25)
        log(f"epilogue: the fleet at "
            f"{len([r for r in router.replicas if not r.retiring])} after "
            f"{time.monotonic() - t_ep:.0f}s")
    finally:
        scaler.close()
        router.close(kill=True)
        telemetry.flush()

    by_status = {}
    for r in results:
        by_status[r["status"]] = by_status.get(r["status"], 0) + 1
    acct = accountability_check(mdir, preemptions, arrivals, results)

    # oracle spot checks: a sample of answered arrivals replayed from
    # their trace seeds against the host oracle
    oks = [r for r in results if r["status"] == "ok"]
    arr_by_i = {a.i: a for a in arrivals}
    sample = oks[:: max(1, len(oks) // 24)][:24]
    oracle_max = 0.0
    for r in sample:
        want = oracle(_row_for(arr_by_i[r["i"]]))
        got = np.asarray(r["response"]["probs"], np.float32)
        oracle_max = max(oracle_max, float(np.abs(got - want).max()))
    oracle_ok = bool(sample) and oracle_max < 1e-3

    # p99 outside the degraded windows (engage .. release)
    journals = _Journals(mdir)
    opens = journals(events.EV_FLEET_DEGRADE_ENGAGE)
    closes = journals(events.EV_FLEET_DEGRADE_RELEASE)
    degraded_spans, open_ts = [], None
    for e in sorted(opens + closes, key=lambda e: e.get("ts", 0)):
        if e.get("event") == events.EV_FLEET_DEGRADE_ENGAGE \
                and open_ts is None:
            open_ts = e["ts"]
        elif e.get("event") == events.EV_FLEET_DEGRADE_RELEASE \
                and open_ts is not None:
            degraded_spans.append((open_ts, e["ts"]))
            open_ts = None
    if open_ts is not None:
        degraded_spans.append((open_ts, wall0_unix + spec.duration_s))

    def _degraded(r):
        w = wall0_unix + r["t"]
        return any(a <= w <= b for a, b in degraded_spans)

    lat_clear = [r["latency_s"] for r in oks if not _degraded(r)]
    lat_all = [r["latency_s"] for r in oks]
    p99_clear_ms = 1000 * float(np.percentile(lat_clear, 99)) \
        if lat_clear else None
    p99_bar_ms = _env_f("GAUNTLET_P99_BAR_MS", 5000.0)

    ups = journals(events.EV_FLEET_SCALE_UP)
    dns = journals(events.EV_FLEET_SCALE_DOWN)
    swing_x = spec.peak_rps / spec.trough_rps
    ok = (deterministic and acct["lost"] == 0 and acct["errors"] == 0
          and acct["corrupt"] == 0 and oracle_ok
          and len(ups) >= 2 and len(dns) >= 2
          and (p99_clear_ms is None or p99_clear_ms <= p99_bar_ms)
          and acct["accounted"])
    record = {
        "gauntlet_ok": ok,
        "backend": backend,
        "gauntlet_sec": round(time.perf_counter() - t_start, 1),
        "day_sec": round(spec.duration_s, 1),
        "arrivals": len(arrivals),
        "answered": by_status.get("ok", 0),
        "shed": by_status.get("shed", 0),
        "errors": acct["errors"],
        "lost": acct["lost"],
        "corrupt": acct["corrupt"],
        "crc_checked": acct["crc_checked"],
        "oracle_spot_checks": len(sample),
        "oracle_max_abs_diff": oracle_max,
        "diurnal_swing_x": round(swing_x, 1),
        "burst_swing_x": round(swing_x * spec.burst_mult, 1),
        "trace_deterministic": deterministic,
        "scale_ups": len(ups),
        "scale_downs": len(dns),
        "scale_causes": sorted({e.get("cause") for e in ups + dns}),
        "degraded_spans": len(degraded_spans),
        "degraded_sec": round(sum(b - a for a, b in degraded_spans), 1),
        "preemptions": preemptions,
        "warm_p50_ms": round(warm_p50, 1),
        "p99_nondegraded_ms": p99_clear_ms and round(p99_clear_ms, 1),
        "p99_all_ms": lat_all
        and round(1000 * float(np.percentile(lat_all, 99)), 1),
        "p99_bar_ms": p99_bar_ms,
        "late_sends": telemetry.counter(events.CTR_TRAFFIC_LATE).value,
        "accountability": {"explained": acct["explained"],
                           "unexplained": acct["unexplained"][:8],
                           "accounted": acct["accounted"]},
    }
    log(f"verdict: ok={ok} answered={record['answered']} "
        f"shed={record['shed']} lost={acct['lost']} "
        f"errors={acct['errors']} corrupt={acct['corrupt']} "
        f"ups={len(ups)} downs={len(dns)} "
        f"p99_clear={p99_clear_ms and round(p99_clear_ms)}ms "
        f"accounted={acct['accounted']}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gauntlet",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-b", "--backend", default="auto",
                    choices=["auto", "cuda", "cpu"],
                    help="where the replicas run: the card (auto, cuda) "
                         "or the CPU")
    ap.add_argument("--json", action="store_true",
                    help="print only the final JSON record on stdout")
    ap.add_argument("--duration", type=float, default=None,
                    help="the day's length in seconds "
                         "($GAUNTLET_DURATION)")
    ap.add_argument("--trace", default=None,
                    help="replay this trace file instead of generating "
                         "the day")
    args = ap.parse_args(argv)
    if not __debug__:
        print("gauntlet: its checks are assert statements, which python -O "
              "strips: run it without -O", file=sys.stderr)
        return 2
    import torch
    backend = "cpu" if args.backend == "cpu" else "cuda"
    if backend == "cuda" and not torch.cuda.is_available():
        print(f"gauntlet: -b {args.backend} needs a CUDA card and "
              f"torch.cuda.is_available() is False; pass -b cpu for the "
              f"day on the CPU", file=sys.stderr)
        return 1
    if args.duration:
        os.environ["GAUNTLET_DURATION"] = str(args.duration)
    record = run_gauntlet(backend, trace_path=args.trace)
    print(json.dumps(record), flush=True)
    return 0 if record.get("gauntlet_ok") else 1


if __name__ == "__main__":
    sys.exit(main())
