"""What a traced request costs the host, against an untraced one.

Usage::

    python -m veles_tpu_torch.tools.trace_cost [-b cpu|auto|cuda]
        [--pairs N] [--stage-calls N] [--json]

Two readings, on the tier-1 fleet model (6x6x1 -> 12 tanh -> 3 softmax,
3 members: ``chaos_drill``'s fleet model) served by a
:class:`~veles_tpu_torch.serve.router.FleetRouter` of 2 replicas with a
metrics dir, as ``chip_smoke.py``'s tracing pair serves it:

- **End to end**: one one-row request at a time, ``$VELES_TRACE_SAMPLE``
  1 and 0 interleaved request by request (each two consecutive requests
  one at each rate, in a seeded random order), ``--pairs`` of each after
  a warm-up and a burn-in at rate 0; each side's p50 and p99 and the
  traced-over-untraced ratios.  Only the router's public ``request`` is
  called.
- **Stages**: each piece of work a traced request adds, timed alone in
  this process over ``--stage-calls`` calls (the best of 5 rounds, in
  microseconds a call), with the journal configured as the router's and
  the replicas' are: on the router, minting, the leg's span, the wire
  fields' encoding, ``trace.leg`` and ``trace.request`` and the flight
  recorder, the histogram's exemplar; on a
  replica, the longer line's decoding, the context off the wire, its
  span parked on the thread, the flight recorder, ``trace.serve`` and
  ``trace.batch``; and a journal line's encoding (``journal_line``, the
  flush thread's).  Each stage's cost is the traced call's less the
  untraced call's where both exist.

The replicas run on the card unless ``-b cpu`` asks for the CPU.  The
last stdout line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict

import numpy as np

from veles_tpu_torch import events, knobs, telemetry, trace
from veles_tpu_torch.tools.chaos_drill import REPO, _FLEET_WF, build_package

ROW = np.random.default_rng(600).standard_normal((1, 6, 6, 1)) \
    .astype(np.float32)


def _best_us(fn: Callable[[], object], calls: int) -> float:
    """Microseconds a call of ``fn``: the best of 5 rounds of ``calls``
    calls.  Between rounds (outside the timing) the journal's waiting
    trace lines are written, so no round pays for their encoding: that
    is timed apart (``journal_line``)."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        telemetry.flush()
    return 1e6 * best / calls


def stage_costs(calls: int) -> Dict[str, float]:
    """Microseconds a call of each stage a traced request adds (traced
    less untraced where the untraced request runs the same call)."""
    env = {knobs.TRACE_SAMPLE: "1"}
    env0 = {knobs.TRACE_SAMPLE: "0"}
    root = trace.mint(env)
    leg = root.child()
    msg = {"id": 7, "model": "alpha", "rows": ROW.tolist(),
           "deadline_ms": time.time() * 1000.0 + 8000.0}
    traced_line = json.dumps(trace.to_wire(dict(msg), leg))
    plain_line = json.dumps(msg)
    wire = json.loads(traced_line)
    sctx = trace.from_wire(wire).child()
    hist = telemetry.histogram("trace_cost.request_seconds")
    out: Dict[str, float] = {}
    # -- the router
    out["mint"] = _best_us(lambda: trace.mint(env), calls) \
        - _best_us(lambda: trace.mint(env0), calls)
    out["leg_span"] = _best_us(root.child, calls)
    out["wire_encode"] = _best_us(
        lambda: json.dumps(trace.to_wire(dict(msg), leg)), calls) \
        - _best_us(lambda: json.dumps(trace.to_wire(dict(msg), None)),
                   calls)

    def leg_event():
        telemetry.event(
            events.EV_TRACE_LEG, trace=leg.trace_id, span=leg.span_id,
            parent=leg.parent_id, replica=0, verdict="ok",
            seconds=0.001234, hedge=False, winner=True)
    out["trace_leg"] = _best_us(leg_event, calls)

    def request_event():
        telemetry.event(
            events.EV_TRACE_REQUEST, trace=root.trace_id, span=root.span_id,
            model="alpha", rows=1, outcome="ok", seconds=0.001234)
        trace.record("fleet.request", ctx=root, model="alpha",
                           outcome="ok")
    out["trace_request"] = _best_us(request_event, calls)
    out["exemplar"] = _best_us(
        lambda: hist.record(0.001, exemplar=root.trace_id), calls) \
        - _best_us(lambda: hist.record(0.001, exemplar=None), calls)
    # -- a replica
    out["wire_decode"] = _best_us(lambda: json.loads(traced_line), calls) \
        - _best_us(lambda: json.loads(plain_line), calls)
    out["from_wire_span"] = _best_us(
        lambda: trace.from_wire(wire).child(), calls) \
        - _best_us(lambda: trace.from_wire(msg), calls)

    def use(ctx):
        with trace.use(ctx):
            pass
    out["use"] = _best_us(lambda: use(sctx), calls) \
        - _best_us(lambda: use(None), calls)
    out["hive_record"] = _best_us(lambda: trace.record(
        "hive.request", ctx=sctx, model="alpha", rows=1), calls)
    out["trace_serve"] = _best_us(lambda: telemetry.event(
        events.EV_TRACE_SERVE, trace=sctx.trace_id, span=sctx.span_id,
        parent=sctx.parent_id, label="alpha", rows=1, wait_s=0.000123,
        dispatch_s=0.000456, total_s=0.000789, error=None), calls)

    def batch_event():
        telemetry.event(events.EV_TRACE_BATCH, span=trace.new_span_id(),
                        label="alpha", rows=1, dispatch_s=0.000456,
                        links=[{"trace": sctx.trace_id,
                                "span": sctx.span_id}])
        trace.record("serve.batch", label="alpha", rows=1,
                     dispatch_s=0.000456)
    out["trace_batch"] = _best_us(batch_event, calls)
    # the deferred part: encoding and writing the waiting trace lines
    # (the flush thread's work, under the GIL the serving threads share)
    for _ in range(calls):
        telemetry.event(events.EV_TRACE_SERVE, trace=sctx.trace_id,
                        span=sctx.span_id, parent=sctx.parent_id,
                        label="alpha", rows=1, wait_s=0.000123,
                        dispatch_s=0.000456, total_s=0.000789, error=None)
    t0 = time.perf_counter()
    telemetry.flush()
    out["journal_line"] = 1e6 * (time.perf_counter() - t0) / calls
    out["router_sum"] = sum(out[k] for k in (
        "mint", "leg_span", "wire_encode", "trace_leg", "trace_request",
        "exemplar"))
    out["replica_on_path_sum"] = sum(out[k] for k in (
        "wire_decode", "from_wire_span", "use", "hive_record"))
    out["replica_after_answer_sum"] = out["trace_serve"] \
        + out["trace_batch"]
    return out


def end_to_end(router, pairs: int, seed: int = 600) -> Dict[str, object]:
    """``pairs`` one-row requests at each rate, interleaved request by
    request after 16 warm requests and 200 at rate 0; each side's p50
    and p99."""
    gen = np.random.default_rng(seed)
    prev = os.environ.get(knobs.TRACE_SAMPLE)

    def one(rate) -> float:
        os.environ[knobs.TRACE_SAMPLE] = str(rate)
        t0 = time.perf_counter()
        a = router.request("alpha", ROW, timeout=30)
        t1 = time.perf_counter()
        if "probs" not in a:
            raise RuntimeError(f"trace cost: a request failed: {a}")
        return t1 - t0

    try:
        for _ in range(16 + 200):
            one(0)
        lats: Dict[int, list] = {1: [], 0: []}
        for _ in range(pairs):
            for rate in gen.permutation([1, 0]):
                lats[int(rate)].append(one(int(rate)))
    finally:
        if prev is None:
            os.environ.pop(knobs.TRACE_SAMPLE, None)
        else:
            os.environ[knobs.TRACE_SAMPLE] = prev
    on, off = (1e3 * np.asarray(lats[1]), 1e3 * np.asarray(lats[0]))
    res = {"requests_each": pairs,
           "traced_ms": {"p50": float(np.median(on)),
                         "p99": float(np.percentile(on, 99))},
           "untraced_ms": {"p50": float(np.median(off)),
                           "p99": float(np.percentile(off, 99))}}
    res["p50_ratio"] = res["traced_ms"]["p50"] / res["untraced_ms"]["p50"]
    res["p99_ratio"] = res["traced_ms"]["p99"] / res["untraced_ms"]["p99"]
    res["p50_delta_us"] = 1e3 * (res["traced_ms"]["p50"]
                                 - res["untraced_ms"]["p50"])
    return res


def run(backend: str, pairs: int, stage_calls: int) -> Dict[str, object]:
    from veles_tpu_torch.serve.router import FleetRouter
    d = tempfile.mkdtemp(prefix="trace_cost_")
    try:
        pkg, _oracle, _w = build_package(d, "alpha", _FLEET_WF, 11, 3)
        mdir = os.path.join(d, "metrics")
        telemetry.reset()
        telemetry.configure(mdir)
        stages = stage_costs(stage_calls)
        telemetry.reset()
        telemetry.configure(mdir)
        router = FleetRouter({"alpha": pkg}, 2, backend=backend,
                             max_batch=16, max_wait_ms=5, cwd=REPO,
                             metrics_dir=mdir)
        try:
            e2e = end_to_end(router, pairs)
        finally:
            router.close()
        telemetry.configure(None)
        return {"backend": backend, "replicas": 2, "stages_us": stages,
                "end_to_end": e2e}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trace_cost",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-b", "--backend", default="auto",
                    choices=["auto", "cuda", "cpu"],
                    help="where the replicas run: the card (auto, cuda) "
                         "or the CPU")
    ap.add_argument("--pairs", type=int, default=2000,
                    help="requests at each rate (default 2000)")
    ap.add_argument("--stage-calls", type=int, default=1000,
                    help="calls a round of each stage's timing")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON record")
    args = ap.parse_args(argv)
    import torch
    backend = "cpu" if args.backend == "cpu" else "cuda"
    if backend == "cuda" and not torch.cuda.is_available():
        print(f"trace_cost: -b {args.backend} needs a CUDA card and "
              f"torch.cuda.is_available() is False; pass -b cpu",
              file=sys.stderr)
        return 1
    rec = run(backend, args.pairs, args.stage_calls)
    if not args.json:
        for k, v in rec["stages_us"].items():
            print(f"stage {k}: {v:.2f} us")
        e = rec["end_to_end"]
        print(f"traced p50 {e['traced_ms']['p50']:.4f} / p99 "
              f"{e['traced_ms']['p99']:.4f} ms, untraced p50 "
              f"{e['untraced_ms']['p50']:.4f} / p99 "
              f"{e['untraced_ms']['p99']:.4f} ms: ratios p50 "
              f"{e['p50_ratio']:.4f}, p99 {e['p99_ratio']:.4f}")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
