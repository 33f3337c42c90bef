"""Seeded, deterministic, open-loop traffic.

Counterpart of ``veles_tpu/serve/traffic.py``: the same draws in the
same order from one ``numpy.random.default_rng(seed)``, so a trace
generated here is bitwise the reference's.

- :class:`TrafficSpec` + :func:`generate`: a pure function from (spec,
  seed) to an arrival schedule: a diurnal raised cosine from trough to
  peak (``swing`` = peak/trough), Poisson-placed burst windows that
  multiply the rate by ``burst_mult``, and a Zipf model mix.  Arrivals
  are drawn by thinning a homogeneous Poisson process at ``peak_rps *
  burst_mult``.
- :func:`write_trace` / :func:`read_trace`: the schedule as a JSONL file
  (a header line with the spec, then one line per arrival) in canonical
  JSON, so two generations of one spec are byte-identical files.
- :class:`OpenLoopDriver`: fires each arrival at ``t0 + arrival.t``
  whether or not earlier ones have answered (a bounded worker pool), and
  records one outcome per arrival with its latency counted from the
  scheduled time.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from veles_tpu_torch import events, knobs, snapshotter, telemetry
from veles_tpu_torch.analysis import witness

TRACE_FORMAT = "veles-traffic-v1"


class TrafficSpec:
    """The production day's shape — a value object; every field
    participates in generation, so equal specs + equal seeds mean
    byte-equal traces."""

    FIELDS = ("seed", "duration_s", "peak_rps", "swing", "period_s",
              "burst_every_s", "burst_len_s", "burst_mult", "models",
              "zipf_s")

    def __init__(self, seed: int = 0, duration_s: float = 60.0,
                 peak_rps: float = 60.0, swing: float = 10.0,
                 period_s: Optional[float] = None,
                 burst_every_s: float = 20.0,
                 burst_len_s: float = 3.0, burst_mult: float = 2.0,
                 models: Optional[List[str]] = None,
                 zipf_s: float = 1.1) -> None:
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.peak_rps = float(peak_rps)
        self.swing = max(1.0, float(swing))
        #: one full trough→peak→trough sweep; defaults to the whole
        #: day so a short CI run still sees the full swing
        self.period_s = float(period_s if period_s is not None
                              else duration_s)
        self.burst_every_s = float(burst_every_s)
        self.burst_len_s = float(burst_len_s)
        self.burst_mult = max(1.0, float(burst_mult))
        self.models = list(models or ["default"])
        self.zipf_s = float(zipf_s)

    @classmethod
    def from_knobs(cls, models: List[str],
                   environ=None) -> "TrafficSpec":
        g = lambda k: knobs.get(k, environ=environ)  # noqa: E731
        return cls(seed=g(knobs.TRAFFIC_SEED),
                   duration_s=g(knobs.TRAFFIC_DURATION_S),
                   peak_rps=g(knobs.TRAFFIC_PEAK_RPS),
                   swing=g(knobs.TRAFFIC_SWING),
                   burst_mult=g(knobs.TRAFFIC_BURST_MULT),
                   models=models, zipf_s=g(knobs.TRAFFIC_ZIPF_S))

    def to_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrafficSpec":
        return cls(**{f: d[f] for f in cls.FIELDS if f in d})

    # -- the instantaneous arrival rate --------------------------------

    @property
    def trough_rps(self) -> float:
        return self.peak_rps / self.swing

    def diurnal_rate(self, t: float) -> float:
        """rate(t) WITHOUT bursts: raised cosine from trough to peak,
        peaking at period_s/2 (mid-day)."""
        lo = self.trough_rps
        phase = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * (t % self.period_s) / self.period_s))
        return lo + (self.peak_rps - lo) * float(phase)

    def model_weights(self) -> np.ndarray:
        """Zipf popularity over ``models`` in registration order:
        rank 1 is the hot prefix, the rest are the long tail."""
        ranks = np.arange(1, len(self.models) + 1, dtype=np.float64)
        w = 1.0 / ranks ** self.zipf_s
        return w / w.sum()


class Arrival:
    """One scheduled request: fire at ``t`` seconds into the day,
    against ``model``, with rows derived from ``row_seed``."""

    __slots__ = ("i", "t", "model", "row_seed", "burst")

    def __init__(self, i: int, t: float, model: str, row_seed: int,
                 burst: bool) -> None:
        self.i = i
        self.t = t
        self.model = model
        self.row_seed = row_seed
        self.burst = burst

    def to_dict(self) -> Dict[str, Any]:
        return {"i": self.i, "t": self.t, "model": self.model,
                "row_seed": self.row_seed,
                "burst": int(self.burst)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Arrival":
        return cls(int(d["i"]), float(d["t"]), str(d["model"]),
                   int(d["row_seed"]), bool(d.get("burst", 0)))


def _burst_windows(spec: TrafficSpec, rng) -> List[Any]:
    """Poisson-placed burst windows [(start, end), ...] covering the
    day.  Drawn FIRST from the rng so the window layout is independent
    of how many arrivals thinning accepts."""
    wins = []
    if spec.burst_every_s <= 0 or spec.burst_len_s <= 0 \
            or spec.burst_mult <= 1.0:
        return wins
    t = float(rng.exponential(spec.burst_every_s))
    while t < spec.duration_s:
        wins.append((t, min(t + spec.burst_len_s, spec.duration_s)))
        t += spec.burst_len_s + float(
            rng.exponential(spec.burst_every_s))
    return wins


def generate(spec: TrafficSpec) -> List[Arrival]:
    """The whole day as a list of arrivals — pure in (spec, seed)."""
    rng = np.random.default_rng(spec.seed)
    windows = _burst_windows(spec, rng)

    def in_burst(t: float) -> bool:
        return any(a <= t < b for a, b in windows)

    def rate(t: float) -> float:
        r = spec.diurnal_rate(t)
        return r * spec.burst_mult if in_burst(t) else r

    lam_max = spec.peak_rps * spec.burst_mult
    weights = spec.model_weights()
    arrivals: List[Arrival] = []
    t = 0.0
    while True:
        # thinning: candidate gap at lam_max, accept at rate(t)/lam_max
        t += float(rng.exponential(1.0 / lam_max))
        if t >= spec.duration_s:
            break
        accept = float(rng.random())
        if accept >= rate(t) / lam_max:
            continue
        m = int(rng.choice(len(weights), p=weights))
        arrivals.append(Arrival(
            i=len(arrivals), t=t, model=spec.models[m],
            row_seed=int(rng.integers(0, 2 ** 31 - 1)),
            burst=in_burst(t)))
    return arrivals


def _canon(obj: Dict[str, Any]) -> str:
    # canonical JSON: sorted keys, no spaces, repr floats — the
    # byte-equality contract of the determinism pin
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def write_trace(path: str, spec: TrafficSpec,
                arrivals: List[Arrival]) -> None:
    """Serialize the day: header line (format + spec + count), then
    one line per arrival, canonical JSON throughout."""
    with snapshotter.atomic_write(path, "w") as f:
        f.write(_canon({"format": TRACE_FORMAT,
                        "spec": spec.to_dict(),
                        "n": len(arrivals)}) + "\n")
        for a in arrivals:
            f.write(_canon(a.to_dict()) + "\n")


def read_trace(path: str):
    """-> (spec, arrivals); validates the header format and count so a
    torn trace file fails loudly instead of replaying a partial day."""
    with open(path, "r", encoding="utf-8") as f:
        header = json.loads(f.readline())
        if header.get("format") != TRACE_FORMAT:
            raise ValueError(
                f"{path}: not a {TRACE_FORMAT} trace "
                f"(format={header.get('format')!r})")
        spec = TrafficSpec.from_dict(header["spec"])
        arrivals = [Arrival.from_dict(json.loads(line))
                    for line in f if line.strip()]
    if len(arrivals) != header["n"]:
        raise ValueError(
            f"{path}: torn trace — header says {header['n']} "
            f"arrivals, file holds {len(arrivals)}")
    return spec, arrivals


class OpenLoopDriver:
    """Fire a schedule at a request function on the schedule's clock.

    ``request_fn(arrival) -> response dict`` runs on one of
    ``workers`` pool threads; the scheduler thread NEVER waits for an
    answer before releasing the next arrival.  Every arrival gets
    exactly one outcome record::

        {"i", "t", "model", "burst", "status", "latency_s",
         "queue_delay_s", "response"}

    where ``status`` is ``ok`` / ``shed`` / ``error`` and
    ``latency_s`` counts from the SCHEDULED arrival time (t0 + t) —
    if the pool was saturated and the send went out late, that delay
    is part of the measured latency, exactly as a queued user would
    experience it.
    """

    def __init__(self, request_fn: Callable[[Arrival], Dict[str, Any]],
                 workers: int = 64) -> None:
        self.request_fn = request_fn
        self.workers = workers
        self._lock = witness.lock("traffic.results")
        self.results: List[Dict[str, Any]] = []

    def _classify(self, resp: Dict[str, Any]) -> str:
        if resp.get("overloaded"):
            return "shed"
        if resp.get("error"):
            return "error"
        return "ok" if "probs" in resp or "pred" in resp else "error"

    def run(self, arrivals: List[Arrival],
            stop: Optional[threading.Event] = None) -> List[Dict[str, Any]]:
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.monotonic()
        pool = ThreadPoolExecutor(
            max_workers=self.workers,
            thread_name_prefix="traffic-worker")

        def _fire(a: Arrival, sched: float) -> None:
            start = time.monotonic()
            try:
                resp = self.request_fn(a)
            except Exception as e:  # noqa: BLE001 — the outcome ledger
                resp = {"error": f"{type(e).__name__}: {e}"}
            done = time.monotonic()
            rec = {"i": a.i, "t": a.t, "model": a.model,
                   "burst": a.burst,
                   "status": self._classify(resp),
                   "latency_s": done - sched,
                   "queue_delay_s": start - sched,
                   "response": resp}
            with self._lock:
                self.results.append(rec)

        sent = late = 0
        futures = []
        try:
            for a in arrivals:
                if stop is not None and stop.is_set():
                    break
                sched = t0 + a.t
                delay = sched - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                elif delay < -0.05:
                    # open-loop honesty: we are behind the schedule's
                    # clock (scheduler starvation, not server queueing)
                    late += 1
                futures.append(pool.submit(_fire, a, sched))
                sent += 1
        finally:
            pool.shutdown(wait=True)
            for fut in futures:
                fut.result()  # _fire never raises; surface if it does
        telemetry.counter(events.CTR_TRAFFIC_SENT).inc(sent)
        if late:
            telemetry.counter(events.CTR_TRAFFIC_LATE).inc(late)
        telemetry.event(events.EV_TRAFFIC_DONE, sent=sent, late=late,
                        results=len(self.results))
        with self._lock:
            return sorted(self.results, key=lambda r: r["i"])
