"""The report CLI: a metrics dir rendered for its operator.

Usage::

    python -m veles_tpu_torch.tools.obs_report DIR [--json] [--fleet]
        [--trace ID] [--traces] [--events N]

The port's counterpart of the reference's ``scripts/obs_report.py``,
over :mod:`veles_tpu_torch.obs`: without a flag the run view (counters,
gauges, a quantile table per histogram, derived throughput, the
residency and learner panels, the traces and the journal's last
``--events`` events); ``--fleet`` puts the fleet view before it (one row
a replica dir, the scale timeline, the per-model split); ``--json``
prints the merged snapshot with the snapshot and event counts (with
``--fleet`` the replica and model rows too, and the learner rows where
a model learns) as one JSON object; ``--trace ID`` prints one assembled
trace and its critical path, ``--traces`` every trace, slowest first.
It reads files only, and reads the reference's dirs as well as the
port's.  Exit codes: 0, 1 when the dir holds nothing to report (or no
such trace, or no replica dir with ``--fleet``), 2 when DIR is not a
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from veles_tpu_torch.obs import (assemble_traces, critical_path,
                                 fleet_model_rows, fleet_rows,
                                 learner_rows, load_dir, load_tree, render,
                                 render_fleet, render_trace)


def _print_traces(traces) -> None:
    rows = sorted((critical_path(evs) for evs in traces.values()),
                  key=lambda c: c.get("total_s") or 0.0, reverse=True)
    for cp in rows:
        total = cp.get("total_s")
        print(f"{cp.get('trace')}  {cp.get('model') or '-':<12} "
              f"{cp.get('outcome') or '-':<8} "
              f"{1000.0 * total:9.2f}ms  legs={cp['legs']}"
              f"{' hedged' if cp['hedged'] else ''}"
              f"{' retried' if cp['retried'] else ''}"
              if total is not None else
              f"{cp.get('trace')}  (no root event)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="obs_report")
    p.add_argument("metrics_dir")
    p.add_argument("--json", action="store_true",
                   help="print the merged snapshot as one JSON object")
    p.add_argument("--fleet", action="store_true",
                   help="the fleet view: a row per replica-* dir (pid, "
                        "resident models, queue, requests, qps, p99, "
                        "sentinel state), the scale timeline and the "
                        "per-model split")
    p.add_argument("--trace", metavar="TRACE_ID", default=None,
                   help="one assembled trace (its hops and critical "
                        "path), the replica-* journals merged in")
    p.add_argument("--traces", action="store_true",
                   help="every assembled trace with its outcome and "
                        "total latency, slowest first")
    p.add_argument("--events", type=int, default=40,
                   help="the journal timeline's length (default 40)")
    args = p.parse_args(argv)

    if not os.path.isdir(args.metrics_dir):
        print(f"obs_report: {args.metrics_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    if args.trace or args.traces:
        _reg, merged = load_tree(args.metrics_dir)
        traces = assemble_traces(merged)
        if args.trace:
            evs = traces.get(args.trace)
            if not evs:
                print(f"obs_report: no events for trace {args.trace!r} "
                      f"(have {len(traces)} traces)", file=sys.stderr)
                return 1
            print(render_trace(evs))
        else:
            _print_traces(traces)
        return 0
    reg, snaps, journals, events = load_dir(args.metrics_dir)
    if not snaps and not events and not fleet_rows(args.metrics_dir):
        print(f"obs_report: no metrics-*.json or journal-*.jsonl in "
              f"{args.metrics_dir} (run with --metrics-dir DIR or "
              f"$VELES_METRICS_DIR)", file=sys.stderr)
        return 1
    if args.json:
        merged = reg.snapshot()
        merged["snapshots"] = len(snaps)
        merged["journal_events"] = len(events)
        if args.fleet:
            merged["fleet"] = {"replicas": fleet_rows(args.metrics_dir),
                               "models": fleet_model_rows(reg, events)}
        learners = learner_rows(reg, events)
        if learners:
            merged["learner"] = learners
        print(json.dumps(merged))
        return 0
    if args.fleet:
        fleet = render_fleet(args.metrics_dir)
        if not fleet:
            print(f"obs_report: no replica-* dirs in {args.metrics_dir}: "
                  f"not a fleet's metrics dir (spawn with --serve-fleet N "
                  f"--metrics-dir DIR)", file=sys.stderr)
            return 1
        print(fleet)
        print()
    print(render(args.metrics_dir, reg, snaps, journals, events,
                 max_events=args.events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
