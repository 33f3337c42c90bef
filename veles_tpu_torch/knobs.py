"""Declared ``VELES_*`` environment knobs (the port's own copy).

Counterpart of ``veles_tpu/knobs.py``: every knob is declared once,
with its name, default, parser and a one-line doc, and read through
:func:`get`.  ``flag`` knobs are on for any non-empty value but
``"0"``; the others parse with their declared type and fall back to the
default on a malformed value, so an env typo degrades instead of taking
down a run.

This copy holds the knobs the port reads, with the reference's names,
defaults and types: fault injection and supervision (``FAULTS*``,
``PREEMPT_*``, ``SUPERVISE_*``, ``RESUME_MANIFEST``), data
parallelism's (``MULTIHOST_*``, ``MESH_SHARD_DATA``,
``MESH_RANKS_PER_CARD``), member sharding's ``MESH_SHARD_MEMBERS``, the
mesh replica's ``SERVE_MESH`` / ``SERVE_MESH_SHARD``, the GA's
``GA_GENERATION``, the observability core's ``METRICS_DIR``, tracing's
``TRACE_SAMPLE``, ``FLIGHTREC_CAP`` and ``LOCK_WITNESS``, the graphics
server's ``PLOTS_DIR``, the
device budgets (``HBM_BUDGET``, ``MAX_RESIDENT_BYTES``), the SOM's
``SOM_FUSED`` / ``SOM_SUPERSTEP``, the online-learning tier's, and the
serving fleet's (the hive's ``SERVE_*``, ``FLEET_*`` and
``TRAFFIC_*``, and ``HEARTBEAT_EVERY``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


def flag(raw: str) -> bool:
    """Set and not ``"0"`` means on."""
    return bool(raw) and raw != "0"


class Knob:
    """One declared environment knob."""

    __slots__ = ("name", "default", "parser", "doc")

    def __init__(self, name: str, default: Any,
                 parser: Callable[[str], Any], doc: str) -> None:
        self.name = name
        self.default = default
        self.parser = parser
        self.doc = doc

    @property
    def type_name(self) -> str:
        return self.parser.__name__

    def read(self, environ: Optional[Dict[str, str]] = None) -> Any:
        env = os.environ if environ is None else environ
        raw = env.get(self.name)
        if raw is None or raw == "":
            return self.default
        try:
            return self.parser(raw)
        except (TypeError, ValueError):
            return self.default


#: every declared knob, by name
KNOBS: Dict[str, Knob] = {}


def _knob(name: str, default: Any, parser: Callable[[str], Any],
          doc: str) -> str:
    assert name.startswith("VELES_"), name
    assert name not in KNOBS, f"duplicate knob {name}"
    KNOBS[name] = Knob(name, default, parser, doc)
    return name


def names() -> frozenset:
    """Every declared knob name."""
    return frozenset(KNOBS)


def get(name: str, environ: Optional[Dict[str, str]] = None) -> Any:
    """The parsed value of a declared knob (its default when unset or
    malformed).  KeyError for an undeclared name."""
    return KNOBS[name].read(environ)


def render_table() -> str:
    """The knob table (markdown, sorted by name).  ``python -m
    veles_tpu_torch.tools.veleslint --sync-docs`` writes it between the
    ``veleslint:knobs`` markers of README.md's port section, and the
    env-registry rule fails when that copy drifts."""
    rows = ["| Knob | Default | Type | Meaning |",
            "| --- | --- | --- | --- |"]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        default = ("on" if k.default else "off") \
            if k.parser is flag else \
            ("(unset)" if k.default == "" else repr(k.default))
        rows.append(f"| `{name}` | {default} | {k.type_name} | "
                    f"{k.doc} |")
    return "\n".join(rows) + "\n"


# -- robustness and supervision --------------------------------------------

FAULTS = _knob(
    "VELES_FAULTS", "", str,
    "Arm fault injection points: `point[@qual=v[&qual=v...]]`, "
    "comma-separated; inherited by child processes (faults.py).")
FAULTS_SEED = _knob(
    "VELES_FAULTS_SEED", 0, int,
    "Seed for the deterministic garbage and rng of injected faults.")
PREEMPT_GRACE = _knob(
    "VELES_PREEMPT_GRACE", 25.0, float,
    "Seconds a graceful stop may take before the watchdog "
    "hard-snapshots and exits 14.")
PREEMPT_DISABLE = _knob(
    "VELES_PREEMPT_DISABLE", False, flag,
    "Opt this process out of SIGTERM/SIGINT graceful-stop handlers "
    "(set for GA evaluator children).")
SUPERVISE_ATTEMPT = _knob(
    "VELES_SUPERVISE_ATTEMPT", 0, int,
    "Exported by the supervisor to each child: 0 first launch, "
    "incrementing per restart (fault qualifiers target one attempt).")
SUPERVISE_MAX_CRASHES = _knob(
    "VELES_SUPERVISE_MAX_CRASHES", 5, int,
    "Genuine crashes inside the crash window before --supervise "
    "gives up loudly.")
SUPERVISE_CRASH_WINDOW = _knob(
    "VELES_SUPERVISE_CRASH_WINDOW", 300.0, float,
    "Seconds of sliding window the supervisor counts crashes in.")
RESUME_MANIFEST = _knob(
    "VELES_RESUME_MANIFEST", "", str,
    "Extra path every snapshot writer merge-updates the resume "
    "manifest at (the supervisor exports it).")

# -- multihost and data parallelism ------------------------------------------

MULTIHOST_HEARTBEAT = _knob(
    "VELES_MULTIHOST_HEARTBEAT", 2.0, float,
    "Seconds between a --multihost rank's liveness heartbeats in the "
    "group's store.")
MULTIHOST_DEADLINE = _knob(
    "VELES_MULTIHOST_DEADLINE", 15.0, float,
    "Seconds without a peer's heartbeat before the watchdog declares it "
    "dead (final snapshot + exit 13).")
MULTIHOST_ALLOW_SOLO = _knob(
    "VELES_MULTIHOST_ALLOW_SOLO", False, flag,
    "Accept single-process semantics when a --multihost launch finds no "
    "torchrun layout (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).")
MESH_SHARD_DATA = _knob(
    "VELES_MESH_SHARD_DATA", "auto", str,
    "Row-shard the resident data set over the data-parallel ranks, or "
    "an ensemble's attached split over a mesh's places (each holds 1/N "
    "of the rows): `auto` only when it exceeds one device's residency "
    "budget but fits sharded, `always` whenever there are N > 1, "
    "`never`/`0` keeps a whole copy on every rank or the head place.")
MESH_SHARD_MEMBERS = _knob(
    "VELES_MESH_SHARD_MEMBERS", "auto", str,
    "Shard the stacked member axis of population-batched GA cohorts "
    "over the mesh (P/N members a place, raising the cohort cap by the "
    "place count): `auto`/`always` shard whenever the engine is handed "
    "a mesh, `never`/`0` keeps every member on one device.")
MESH_RANKS_PER_CARD = _knob(
    "VELES_MESH_RANKS_PER_CARD", 1, int,
    "Mesh places a CUDA card holds: data-parallel ranks that may share "
    "one card (the group then runs over gloo: NCCL refuses two ranks on "
    "one card), and the places of one process's mesh (--mesh, the GA "
    "worker's --dp) on one card, which split its memory budget; 1 "
    "refuses N ranks or places with fewer than N cards.")

#: the knobs of the port's own, which the reference does not declare
PORT_ONLY = frozenset({MESH_RANKS_PER_CARD})

# -- genetic search --------------------------------------------------------

GA_GENERATION = _knob(
    "VELES_GA_GENERATION", 0, int,
    "Exported by the GA parent so evaluator jobs and fault "
    "qualifiers (`@gen=N`) can target one generation.")

# -- observability ---------------------------------------------------------

METRICS_DIR = _knob(
    "VELES_METRICS_DIR", "", str,
    "Arm telemetry persistence: journal-<pid>.jsonl and atomic "
    "metrics-<pid>.json snapshots under this directory; inherited by "
    "children.")
LOCK_WITNESS = _knob(
    "VELES_LOCK_WITNESS", False, flag,
    "Arm the lock-order witness: locks created through "
    "analysis/witness.py record (holder -> acquired) pairs, flushed "
    "as lockwitness-<pid>.json next to the telemetry snapshot; a "
    "tier-1 test asserts every observed edge is declared in the "
    "port's veles_tpu_torch/analysis/lock_order.json.  "
    "Off (the default) the factories return bare threading "
    "primitives: zero overhead.")
PLOTS_DIR = _knob(
    "VELES_PLOTS_DIR", "plots", str,
    "Output directory of the graphics server's rendered plot "
    "artifacts.")
TRACE_SAMPLE = _knob(
    "VELES_TRACE_SAMPLE", 1.0, float,
    "Head-based trace sampling rate in [0, 1]: the fraction of fleet "
    "requests minted with the sampled bit set (error diffusion, so "
    "the rate is exact, not a coin flip).  A sampled request carries "
    "trace/span/parent wire keys on every hop and journals trace.* "
    "events for cross-process assembly; 0 disables causal tracing "
    "(the overhead baseline).")
FLIGHTREC_CAP = _knob(
    "VELES_FLIGHTREC_CAP", 512, int,
    "Entries the per-process flight-recorder ring retains (recent "
    "spans and events, in memory, always armed).  The ring dumps to "
    "flightrec-<pid>-<n>-<reason>.json in the metrics dir on "
    "SIGTERM, injected SIGKILL, sentinel ejection, and promotion-"
    "gate verdicts, so every ejection and rollback ships with the "
    "trace tail that explains it.")

# -- device budgets and the SOM ---------------------------------------------

HBM_BUDGET = _knob(
    "VELES_HBM_BUDGET", 0, int,
    "Device-memory byte budget of the process-wide arbiter (the "
    "residency ledger a hive and the online tier charge): non-zero "
    "overrides half the card's memory; 0 keeps that default.")
MAX_RESIDENT_BYTES = _knob(
    "VELES_MAX_RESIDENT_BYTES", 8 << 30, int,
    "Device byte budget for device-resident datasets; over budget "
    "the loader streams from the host.")
SOM_FUSED = _knob(
    "VELES_SOM_FUSED", True, flag,
    "Train Kohonen SOM workflows a superstep group per dispatch; `0` "
    "falls back to one dispatch per minibatch.")
SOM_SUPERSTEP = _knob(
    "VELES_SOM_SUPERSTEP", 0, int,
    "Minibatches per SOM dispatch group (the SOM loader's "
    "superstep); 0 groups the whole class per firing.")

# -- online learning ------------------------------------------------------

ONLINE = _knob(
    "VELES_ONLINE", False, flag,
    "Arm the online-learning tier inside a hive (--serve-models): "
    "tapped traffic fills a replay buffer, a scavenger trains shadow "
    "params in serving idle gaps, and the promotion gate swaps them in "
    "on the device when the held-out slice improves by "
    "$VELES_ONLINE_PROMOTE_MARGIN.")
ONLINE_TAP_FRAC = _knob(
    "VELES_ONLINE_TAP_FRAC", 1.0, float,
    "Deterministic fraction of admitted requests the tap mirrors into "
    "the replay buffer (an error-diffusion accumulator, not a coin "
    "flip).")
ONLINE_BUFFER_ROWS = _knob(
    "VELES_ONLINE_BUFFER_ROWS", 4096, int,
    "Replay-buffer capacity in sample rows per learning model "
    "(reservoir-sampled once full); rows store as uint8 when the "
    "model's ingest codec round-trips them.")
ONLINE_HOLDOUT_EVERY = _knob(
    "VELES_ONLINE_HOLDOUT_EVERY", 8, int,
    "Every Nth labeled tapped request lands in the held-out slice the "
    "promotion gate scores (never trained on).")
ONLINE_MICRO_BATCH = _knob(
    "VELES_ONLINE_MICRO_BATCH", 32, int,
    "Rows per scavenged fine-tune step: the one fixed train shape.")
ONLINE_MIN_STEPS = _knob(
    "VELES_ONLINE_MIN_STEPS", 8, int,
    "Fine-tune steps between promotion-gate rounds (and before the "
    "first one).")
ONLINE_PROMOTE_MARGIN = _knob(
    "VELES_ONLINE_PROMOTE_MARGIN", 1.0, float,
    "Held-out error-% margin the shadow must beat the incumbent by to "
    "be promoted; a shadow worse by this margin rolls back to the "
    "incumbent's params.")
ONLINE_IDLE_MS = _knob(
    "VELES_ONLINE_IDLE_MS", 2.0, float,
    "Milliseconds every serving batcher must have been idle (empty "
    "queue, nothing in flight) before the scavenger takes a step.")
ONLINE_SLO_P99_MS = _knob(
    "VELES_ONLINE_SLO_P99_MS", 0.0, float,
    "The scavenger skips steps while its EMA step cost exceeds this "
    "many milliseconds (a step that long would set the p99 of a "
    "request arriving under it); 0 disables the check.")
ONLINE_LR_SCALE = _knob(
    "VELES_ONLINE_LR_SCALE", 0.1, float,
    "Fine-tune learning-rate scale applied to each gradient unit's "
    "packaged rate.")
ONLINE_DUTY = _knob(
    "VELES_ONLINE_DUTY", 0.5, float,
    "Ceiling on the scavenger's duty cycle (0..1): after each step it "
    "rests cost*(1-duty)/duty, so host cores and the GIL stay mostly "
    "free for the serving threads.")


# -- serving (Hive) --------------------------------------------------------

HEARTBEAT_EVERY = _knob(
    "VELES_HEARTBEAT_EVERY", 5.0, float,
    "Seconds between heartbeat lines of a serving process (the fleet "
    "router's default --heartbeat-every; 0 disables).")
SERVE_MAX_WAIT_MS = _knob(
    "VELES_SERVE_MAX_WAIT_MS", 5.0, float,
    "Longest a queued serving request may wait for co-batchable "
    "traffic before its micro-batch dispatches anyway (the "
    "latency/throughput tradeoff knob of the serving tier).")
SERVE_MAX_BATCH = _knob(
    "VELES_SERVE_MAX_BATCH", 64, int,
    "Rows per serving micro-batch: the batcher flushes as soon as "
    "this many rows coalesce (also the one fixed dispatch shape).")
SERVE_HBM_BUDGET = _knob(
    "VELES_SERVE_HBM_BUDGET", 8 << 30, int,
    "Device-memory byte budget the fleet's placement policy assumes "
    "for a replica whose hello advertises none; over budget a "
    "replica's LRU model spills to the host.")
SERVE_MESH = _knob(
    "VELES_SERVE_MESH", 0, int,
    "Places a hive replica owns (--serve-models --mesh): >1 binds an "
    "N-place mesh instead of one device, so the fleet topology becomes "
    "replicas x mesh and residency budgets are charged per place (0/1 "
    "keeps the one-device replica).")
SERVE_MESH_SHARD = _knob(
    "VELES_SERVE_MESH_SHARD", "auto", str,
    "Shard the stacked member axis of a served ensemble over the "
    "replica's mesh (P/N members a place, request rows copied to every "
    "place): `auto` shards only a model over ONE place's residency "
    "budget, so it serves member-sharded and resident instead of LRU "
    "spilling, `always` shards every model on a mesh replica, "
    "`never`/`0` keeps every model on the head place.")
SERVE_ADAPTIVE_WAIT = _knob(
    "VELES_SERVE_ADAPTIVE_WAIT", True, flag,
    "Let the serving micro-batcher track the windowed arrival rate "
    "(the fleet sentinel's delta-quantile estimator) and adapt its "
    "flush "
    "wait: stretch past the static deadline only while the cadence "
    "predicts the batch fills, collapse a stalled stretch back to "
    "it.  Strictly additive — no window flushes before the static "
    "$VELES_SERVE_MAX_WAIT_MS deadline; off disables stretching.")
SERVE_WAIT_STRETCH = _knob(
    "VELES_SERVE_WAIT_STRETCH", 2.0, float,
    "Upper bound of the adaptive batching wait as a multiple of "
    "$VELES_SERVE_MAX_WAIT_MS: the oldest queued request never "
    "waits longer than stretch x the static window even when "
    "arrivals keep trickling in.  2x keeps the stretched tail "
    "inside ~1.1x the static p99 on a busy box; raise it when "
    "batch fill matters more than tail latency.")

# -- fleet serving -------------------------------------------------------

FLEET_SLO_P99_MS = _knob(
    "VELES_FLEET_SLO_P99_MS", 0.0, float,
    "Fleet admission-control SLO target: when a request's estimated "
    "completion (queue depth x observed per-dispatch time + batching "
    "window) would exceed this many milliseconds on EVERY candidate "
    "replica, the router sheds it with an explicit `overloaded` "
    "response instead of letting p99 run away (0 disables shedding).")
FLEET_MAX_INFLIGHT = _knob(
    "VELES_FLEET_MAX_INFLIGHT", 64, int,
    "Hard per-replica bound on router-side in-flight requests (the "
    "bounded router queue); a request that finds every candidate "
    "replica at the bound is shed `overloaded`.")
FLEET_HEARTBEAT_DEADLINE = _knob(
    "VELES_FLEET_HEARTBEAT_DEADLINE", 30.0, float,
    "Seconds of replica stdout silence (no heartbeat, no response) "
    "before the fleet monitor declares the replica hung, kills it, "
    "and respawns (0 disables).")
FLEET_CANARY_FRACTION = _knob(
    "VELES_FLEET_CANARY_FRACTION", 0.1, float,
    "Default traffic fraction mirrored to a `canary-of:NAME` model "
    "when its registration does not carry an explicit split.")
FLEET_RESPAWN_BACKOFF = _knob(
    "VELES_FLEET_RESPAWN_BACKOFF", 0.5, float,
    "Initial seconds the fleet monitor backs off before respawning a "
    "dead replica (doubles per consecutive death, capped at 30s).")

# -- elastic fleet -------------------------------------------------------

FLEET_SCALE_MIN = _knob(
    "VELES_FLEET_SCALE_MIN", 1, int,
    "Floor of the elastic fleet's replica count: the scale "
    "controller never retires below this many replicas.")
FLEET_SCALE_MAX = _knob(
    "VELES_FLEET_SCALE_MAX", 4, int,
    "Ceiling of the elastic fleet's replica count: once the fleet is "
    "at the ceiling, sustained pressure engages the graceful-"
    "degradation ladder instead of spawning.")
FLEET_SCALE_UP_MS = _knob(
    "VELES_FLEET_SCALE_UP_MS", 200.0, float,
    "Scale-up pressure threshold: when the BEST candidate replica's "
    "estimated completion (queue depth x observed dispatch cadence) "
    "stays above this many milliseconds for "
    "$VELES_FLEET_SCALE_UP_SUSTAIN seconds, the controller spawns a "
    "replica into a warm install dir.")
FLEET_SCALE_DOWN_MS = _knob(
    "VELES_FLEET_SCALE_DOWN_MS", 25.0, float,
    "Scale-down idle threshold: when fleet pressure stays below this "
    "many milliseconds for $VELES_FLEET_SCALE_DOWN_SUSTAIN seconds, "
    "the controller retires the youngest replica (drain its router "
    "queue, re-place its exclusive tail models, then SIGTERM).")
FLEET_SCALE_UP_SUSTAIN = _knob(
    "VELES_FLEET_SCALE_UP_SUSTAIN", 1.0, float,
    "Seconds the scale-up pressure must be SUSTAINED before the "
    "controller acts (the hysteresis half that keeps one burst from "
    "spawning a replica).")
FLEET_SCALE_DOWN_SUSTAIN = _knob(
    "VELES_FLEET_SCALE_DOWN_SUSTAIN", 3.0, float,
    "Seconds the fleet must stay idle below the scale-down threshold "
    "before the controller retires a replica (longer than the up "
    "sustain on purpose: spawning is slow, flapping is worse).")
FLEET_SCALE_COOLDOWN = _knob(
    "VELES_FLEET_SCALE_COOLDOWN", 5.0, float,
    "Seconds between ANY two scale/degradation actions — the "
    "controller's refractory period, which also keeps a respawn-"
    "backoff storm (fleet.replica_flap) from compounding into a "
    "spawn hot-loop.")
FLEET_SCALE_INTERVAL = _knob(
    "VELES_FLEET_SCALE_INTERVAL", 0.25, float,
    "Seconds between autoscaler signal polls (the controller "
    "observes fleet pressure on this cadence).")

# -- traffic replay ------------------------------------------------------

TRAFFIC_SEED = _knob(
    "VELES_TRAFFIC_SEED", 0, int,
    "Seed of the open-loop traffic generator: the whole arrival "
    "schedule (times, model mix, burst placement) is a pure function "
    "of the spec + this seed, so a logged trace replays bit-"
    "identically.")
TRAFFIC_DURATION_S = _knob(
    "VELES_TRAFFIC_DURATION_S", 60.0, float,
    "Length of the generated production day in seconds.")
TRAFFIC_PEAK_RPS = _knob(
    "VELES_TRAFFIC_PEAK_RPS", 60.0, float,
    "Arrival rate at the top of the diurnal sine (requests/second); "
    "the trough is peak / $VELES_TRAFFIC_SWING.")
TRAFFIC_SWING = _knob(
    "VELES_TRAFFIC_SWING", 10.0, float,
    "Peak-to-trough ratio of the diurnal arrival curve (>= 10x is "
    "the production-day acceptance bar).")
TRAFFIC_BURST_MULT = _knob(
    "VELES_TRAFFIC_BURST_MULT", 2.0, float,
    "Rate multiplier inside a Poisson-placed burst window (bursts "
    "ride ON TOP of the diurnal curve).")
TRAFFIC_ZIPF_S = _knob(
    "VELES_TRAFFIC_ZIPF_S", 1.1, float,
    "Zipf exponent of the multi-model popularity skew: model rank k "
    "draws traffic proportional to 1/k^s — the long tail that makes "
    "shed-tail-before-hot-prefix degradation mean something.")

# -- gray-failure defense ------------------------------------------------

FLEET_DEADLINE_MS = _knob(
    "VELES_FLEET_DEADLINE_MS", 10000.0, float,
    "Default per-request deadline the fleet router stamps onto every "
    "request; it rides the JSONL protocol end-to-end so a hive "
    "batcher drops already-expired rows before dispatch and a waiter "
    "never burns more than this against a wedged replica.")
FLEET_HEDGE_MIN_MS = _knob(
    "VELES_FLEET_HEDGE_MIN_MS", 25.0, float,
    "Floor of the adaptive hedge threshold: a request older than "
    "max(this, the model's measured p95 latency) is hedged on a "
    "second replica and the first answer wins.")
FLEET_HEDGE_BUDGET = _knob(
    "VELES_FLEET_HEDGE_BUDGET", 0.05, float,
    "Cap on hedged requests as a fraction of admitted fleet traffic "
    "(0 disables hedging) — hedges fight tail latency, the budget "
    "keeps them from melting an already-overloaded fleet.")
FLEET_EJECT_THRESHOLD = _knob(
    "VELES_FLEET_EJECT_THRESHOLD", 3.0, float,
    "Health-score level (decaying weighted strikes: deadline misses, "
    "deaths, integrity failures, hedge losses, latency outliers) at "
    "which the sentinel ejects a replica from routing; ejection is "
    "capped at N-1 replicas so the fleet degrades, never "
    "self-destructs.")
FLEET_PROBE_OK = _knob(
    "VELES_FLEET_PROBE_OK", 3, int,
    "Consecutive clean synthetic probes an ejected replica must "
    "answer before the sentinel reinstates it into routing.")
FLEET_PROBE_INTERVAL = _knob(
    "VELES_FLEET_PROBE_INTERVAL", 0.5, float,
    "Initial seconds between synthetic canary probes of an ejected "
    "replica (a failed probe doubles it, capped at 10s; a clean one "
    "resets it).")
