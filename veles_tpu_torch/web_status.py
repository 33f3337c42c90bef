"""The web status page (the port's copy of ``veles_tpu/web_status.py``).

Two feeds:

- **Telemetry (the main one).** ``python -m veles_tpu_torch.web_status
  --metrics-dir DIR [port]`` renders the live telemetry of whatever
  runs in that metrics dir (training, the GA, a hive, a fleet):
  counters, gauges, each histogram's p50 / p90 / p99, throughput and
  the journal, read again at every refresh through the port's
  :mod:`veles_tpu_torch.obs` (the same reader as ``tools/obs_report``).
  ``GET /api/metrics`` returns the merged snapshot as JSON,
  ``GET /api/traces`` every assembled trace's critical path and
  ``GET /api/traces?id=T`` one trace's events.
- **The legacy push feed.** Each run POSTs its status after every
  epoch (``--status-server URL`` on the training command line attaches
  a :class:`StatusReporter`); ``GET /api/status`` returns the runs as
  JSON, ``POST /api/update`` takes one, and ``GET /`` (``/runs`` where
  a metrics dir owns ``/``) renders them as a table.

The runs table lives in a :class:`StatusStore` under the witnessed lock
``web_status.state``, a leaf: nothing is taken under it.

    python -m veles_tpu_torch.web_status [port] [--metrics-dir D] [--host H]
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from veles_tpu_torch.analysis import witness
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.plotting_units import Plotter

_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch status</title>
<meta http-equiv="refresh" content="2">
<style>
 body {{ font-family: monospace; background: #111; color: #ddd; }}
 table {{ border-collapse: collapse; width: 100%; }}
 th, td {{ border: 1px solid #444; padding: 6px 10px; text-align: left; }}
 th {{ background: #222; }}
 .stale {{ color: #777; }}
</style></head>
<body><h2>veles_tpu_torch — running workflows</h2>
<table><tr><th>workflow</th><th>mode</th><th>epoch</th>
<th>train err%</th><th>valid err%</th><th>min valid err</th>
<th>updated</th></tr>
{rows}
</table></body></html>
"""


class StatusStore:
    def __init__(self) -> None:
        self._lock = witness.lock("web_status.state")
        self._runs: Dict[str, Dict[str, Any]] = {}

    def update(self, run_id: str, data: Dict[str, Any]) -> None:
        with self._lock:
            data = dict(data)
            data["updated_at"] = time.time()
            self._runs[run_id] = data

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._runs.items()}


_METRICS_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch telemetry</title>
<meta http-equiv="refresh" content="2">
<style>
 body {{ font-family: monospace; background: #111; color: #ddd; }}
 pre {{ font-size: 13px; line-height: 1.35; }}
 h2 {{ color: #9c6; }}
</style></head>
<body><h2>veles_tpu_torch — live telemetry ({mdir})</h2>
<pre>{report}</pre></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    store: StatusStore = None  # type: ignore  # set by server
    metrics_dir: Optional[str] = None  # set by server

    def log_message(self, fmt, *args):  # silence per-request stderr
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "text/html") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_metrics_json(self) -> None:
        from veles_tpu_torch.obs import (arbiter_ledger,
                                         fleet_model_rows, fleet_rows,
                                         learner_rows, load_dir,
                                         scale_timeline)
        reg, snaps, journals, events = load_dir(self.metrics_dir)
        merged = reg.snapshot()
        merged["snapshots"] = len(snaps)
        merged["journal_events"] = len(events)
        arbiter = arbiter_ledger(reg)
        if arbiter:
            merged["arbiter"] = arbiter
        replicas = fleet_rows(self.metrics_dir)
        if replicas:
            merged["fleet"] = {
                "replicas": replicas,
                "models": fleet_model_rows(reg, events),
                "scale_timeline": scale_timeline(self.metrics_dir)}
        learners = learner_rows(reg, events)
        if learners:
            merged["learner"] = learners
        self._send(200, json.dumps(merged).encode(),
                   "application/json")

    def _send_trace(self, trace_id: Optional[str]) -> None:
        """``/api/traces`` (all assembled traces' critical paths) and
        ``/api/traces?id=<trace_id>`` (one trace's events + path) —
        the dashboard's jump from a p99 exemplar to the hops behind
        it."""
        from veles_tpu_torch.obs import (assemble_traces,
                                         critical_path, load_tree)
        _reg, merged = load_tree(self.metrics_dir)
        traces = assemble_traces(merged)
        if trace_id:
            evs = traces.get(trace_id)
            if not evs:
                self._send(404, json.dumps(
                    {"error": f"unknown trace {trace_id}"}).encode(),
                    "application/json")
                return
            self._send(200, json.dumps(
                {"trace": trace_id,
                 "critical_path": critical_path(evs),
                 "events": evs}).encode(), "application/json")
            return
        rows = sorted((critical_path(evs)
                       for evs in traces.values()),
                      key=lambda c: c.get("total_s") or 0.0,
                      reverse=True)
        self._send(200, json.dumps({"traces": rows}).encode(),
                   "application/json")

    def _send_metrics_page(self) -> None:
        import html

        from veles_tpu_torch.obs import load_dir, render, render_fleet
        reg, snaps, journals, events = load_dir(self.metrics_dir)
        report = render(self.metrics_dir, reg, snaps, journals,
                        events)
        # a fleet dir (replica-* child dirs) gets the per-replica /
        # per-model console on top — the dashboard IS the fleet view
        fleet = render_fleet(self.metrics_dir)
        if fleet:
            report = fleet + "\n\n" + report
        self._send(200, _METRICS_PAGE.format(
            mdir=html.escape(self.metrics_dir),
            report=html.escape(report)).encode())

    def do_GET(self) -> None:
        import html

        if self.metrics_dir and self.path.startswith("/api/metrics"):
            return self._send_metrics_json()
        if self.metrics_dir and self.path.startswith("/api/traces"):
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(self.path).query)
            return self._send_trace((q.get("id") or [None])[0])
        if self.metrics_dir and not self.path.startswith("/api/") \
                and not self.path.startswith("/runs"):
            # the telemetry feed owns the dashboard; the legacy push-feed
            # table stays reachable at /runs for mixed deployments
            return self._send_metrics_page()
        runs = self.store.snapshot()
        if self.path.startswith("/api/status"):
            self._send(200, json.dumps(runs).encode(),
                       "application/json")
            return
        now = time.time()
        rows = []

        def esc(v) -> str:
            # /api/update is open to the network — escape EVERYTHING
            return html.escape(str(v), quote=True)

        for rid, r in sorted(runs.items()):
            age = now - r.get("updated_at", 0)
            cls = ' class="stale"' if age > 30 else ""
            rows.append(
                f"<tr{cls}><td>{esc(r.get('name', rid))}</td>"
                f"<td>{esc(r.get('mode', '?'))}</td>"
                f"<td>{esc(r.get('epoch', '?'))}</td>"
                f"<td>{esc(r.get('train_error_pct', ''))}</td>"
                f"<td>{esc(r.get('valid_error_pct', ''))}</td>"
                f"<td>{esc(r.get('min_valid_error', ''))}</td>"
                f"<td>{int(age)}s ago</td></tr>")
        self._send(200, _PAGE.format(rows="\n".join(rows)).encode())

    def do_POST(self) -> None:
        if not self.path.startswith("/api/update"):
            self._send(404, b"not found", "text/plain")
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            data = json.loads(self.rfile.read(length))
            if not isinstance(data, dict):
                raise ValueError("update must be a JSON object")
            self.store.update(str(data["id"]), data)
            self._send(200, b'{"ok": true}', "application/json")
        except (ValueError, KeyError, TypeError) as e:
            self._send(400, json.dumps({"error": str(e)}).encode(),
                       "application/json")


class WebStatusServer(Logger):
    def __init__(self, port: int = 8090, host: str = "0.0.0.0",
                 metrics_dir: Optional[str] = None) -> None:
        self.store = StatusStore()
        self.metrics_dir = metrics_dir
        handler = type("Handler", (_Handler,),
                       {"store": self.store,
                        "metrics_dir": metrics_dir})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self) -> None:
        self.info("web status on http://0.0.0.0:%d%s", self.port,
                  f" (telemetry dir {self.metrics_dir})"
                  if self.metrics_dir else "")
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever,
                             daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class StatusReporter(Plotter):
    """Fires after Decision once per epoch (the Plotter gate); POSTs
    workflow status to a web-status server (reference: workflows POST
    periodic updates)."""

    def __init__(self, workflow=None, url: str = "",
                 mode: str = "standalone", **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.url = url.rstrip("/")
        self.mode = mode
        self.run_id = f"{workflow.name if workflow else 'run'}-{id(self):x}"
        self.failures = 0

    def payload(self) -> Dict[str, Any]:
        d = self.decision
        return {"id": self.run_id,
                "name": self.workflow.name,
                "mode": self.mode,
                "epoch": d.loader.epoch_number,
                "train_error_pct": round(d.epoch_error_pct[2], 2),
                "valid_error_pct": round(d.epoch_error_pct[1], 2),
                "min_valid_error": d.min_valid_error
                if d.min_valid_error != float("inf") else None,
                "complete": bool(d.complete)}

    def run(self) -> None:
        import urllib.request

        body = json.dumps(self.payload()).encode()
        req = urllib.request.Request(
            f"{self.url}/api/update", data=body,
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=2).read()
        except OSError as e:
            self.failures += 1
            if self.failures <= 3:  # don't spam a dead dashboard
                self.warning("status POST failed: %s", e)


def main(argv=None) -> int:
    import argparse

    from veles_tpu_torch.logger import setup_logging

    setup_logging()
    p = argparse.ArgumentParser(prog="veles_tpu_torch.web_status")
    p.add_argument("port", nargs="?", type=int, default=8090)
    p.add_argument("--metrics-dir", default=None,
                   help="render the live telemetry of this "
                        "metrics dir (the obs_report view, "
                        "auto-refreshing) instead of the legacy "
                        "push feed")
    p.add_argument("--host", default="0.0.0.0")
    args = p.parse_args(argv)
    WebStatusServer(port=args.port, host=args.host,
                    metrics_dir=args.metrics_dir).serve_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
