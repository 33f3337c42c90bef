"""The central registry of telemetry names (the port's copy).

Counterpart of ``veles_tpu/events.py``, copied whole: every journal
event, counter, gauge, histogram and span name is declared here as an
importable constant, and call sites use the constants
(``telemetry.counter(events.CTR_FLEET_SHED).inc()``), so an emitter and
a reader can never disagree on a name.  The port's telemetry
(``veles_tpu_torch/telemetry.py``) emits the fleet's and the serving
path's names; the rest wait for the sites that use them.

A few hot-path names are *families* keyed by the fused step kind and
are built dynamically (``fused.<kind>_dispatch_seconds`` histograms,
``fused.first_<kind>_dispatch_seconds`` gauges, ``fused.<kind>_seconds``
/ ``fused.<kind>_images`` counters), as are the fleet's per-model and
per-replica names (``fleet.model.<name>.*``, ``fleet.replica.<i>.*``).
"""
from __future__ import annotations

from typing import Set

EVENTS: Set[str] = set()
COUNTERS: Set[str] = set()
GAUGES: Set[str] = set()
HISTOGRAMS: Set[str] = set()
SPANS: Set[str] = set()


def _ev(name: str) -> str:
    EVENTS.add(name)
    return name


def _ctr(name: str) -> str:
    COUNTERS.add(name)
    return name


def _gauge(name: str) -> str:
    GAUGES.add(name)
    return name


def _hist(name: str) -> str:
    HISTOGRAMS.add(name)
    return name


def _span(name: str) -> str:
    # a journaled span emits an event AND feeds the histogram of the
    # same name — it lives in every namespace it touches
    SPANS.add(name)
    EVENTS.add(name)
    HISTOGRAMS.add(name)
    return name


# -- journal events ----------------------------------------------------

EV_FUSED_FIRST_DISPATCH = _ev("fused.first_dispatch")
EV_FUSED_SUMMARY = _ev("fused.summary")

EV_DEVICE_OOM_RETRY = _ev("device.oom_retry")
EV_DEVICE_OOM_DEGRADED = _ev("device.oom_degraded")

EV_SNAPSHOT_SAVE = _ev("snapshot.save")
EV_SNAPSHOT_FALLBACK = _ev("snapshot.fallback")
EV_SNAPSHOT_UNRECOVERABLE = _ev("snapshot.unrecoverable")

EV_LOADER_EPOCH = _ev("loader.epoch")
EV_LOADER_SHARD_RESIDENT = _ev("loader.shard_resident")
EV_LOADER_CORRUPT_FILE = _ev("loader.corrupt_file")
EV_LOADER_CORRUPT_OVER_TOLERANCE = _ev("loader.corrupt_over_tolerance")

EV_GA_GENERATION = _ev("ga.generation")
EV_GA_GENERATION_EVALUATED = _ev("ga.generation_evaluated")
EV_GA_HANG_DETECTED = _ev("ga.hang_detected")
EV_GA_EVALUATOR_RESTART = _ev("ga.evaluator_restart")
EV_GA_GENOME_LOST = _ev("ga.genome_lost")
EV_GA_GENOME_RETRY = _ev("ga.genome_retry")
EV_GA_CHECKPOINT_FALLBACK = _ev("ga.checkpoint_fallback")
EV_GA_CHECKPOINT_UNRECOVERABLE = _ev("ga.checkpoint_unrecoverable")
EV_GA_RESUMED = _ev("ga.resumed")
EV_GA_HANDOFF = _ev("ga.handoff")

EV_DBN_STAGE_HANDOFF = _ev("dbn.stage_handoff")

EV_PREEMPT_REQUESTED = _ev("preempt.requested")
EV_PREEMPT_DEADLINE_EXCEEDED = _ev("preempt.deadline_exceeded")
EV_PREEMPT_FINAL_SNAPSHOT = _ev("preempt.final_snapshot")
EV_PREEMPT_PEER_BROADCAST = _ev("preempt.peer_broadcast")
EV_PREEMPT_GA_STOP = _ev("preempt.ga_stop")
EV_PREEMPT_GA_EXIT = _ev("preempt.ga_exit")

EV_MULTIHOST_EMERGENCY_SNAPSHOT = _ev("multihost.emergency_snapshot")
EV_MULTIHOST_COLLECTIVE_FAILED = _ev("multihost.collective_failed")
EV_MULTIHOST_PEER_DEATH = _ev("multihost.peer_death")
EV_MULTIHOST_INIT_REFUSED = _ev("multihost.init_refused")

EV_SERVE_READY = _ev("serve.ready")
EV_SERVE_MODEL_LOADED = _ev("serve.model_loaded")
EV_SERVE_MODEL_SPILLED = _ev("serve.model_spilled")
EV_SERVE_MODEL_RESTORED = _ev("serve.model_restored")
EV_SERVE_MODEL_SHARDED = _ev("serve.model_sharded_resident")
EV_SERVE_FIRST_DISPATCH = _ev("serve.first_dispatch")
EV_SERVE_DRAIN = _ev("serve.drain")
EV_SERVE_SHUTDOWN = _ev("serve.shutdown")

EV_FLEET_READY = _ev("fleet.ready")
EV_FLEET_PLACEMENT = _ev("fleet.placement")
EV_FLEET_REPLICA_SPAWNED = _ev("fleet.replica_spawned")
EV_FLEET_REPLICA_DIED = _ev("fleet.replica_died")
EV_FLEET_REPLICA_RESPAWNED = _ev("fleet.replica_respawned")
EV_FLEET_DRAIN = _ev("fleet.drain")
EV_FLEET_SHUTDOWN = _ev("fleet.shutdown")
EV_FLEET_REPLICA_EJECTED = _ev("fleet.eject.replica")
EV_FLEET_REPLICA_REINSTATED = _ev("fleet.eject.reinstated")
EV_FLEET_PROBE_RESULT = _ev("fleet.probe.result")
EV_FLEET_SCALE_UP = _ev("fleet.scale.up")
EV_FLEET_SCALE_DOWN = _ev("fleet.scale.down")
EV_FLEET_REPLICA_RETIRED = _ev("fleet.replica_retired")
EV_FLEET_DEGRADE_ENGAGE = _ev("fleet.degrade.engage")
EV_FLEET_DEGRADE_RELEASE = _ev("fleet.degrade.release")

EV_TRAFFIC_TRACE = _ev("traffic.trace")
EV_TRAFFIC_DONE = _ev("traffic.done")

EV_ONLINE_ARMED = _ev("online.armed")
EV_ONLINE_GATE = _ev("online.gate")
EV_ONLINE_PROMOTED = _ev("online.promoted")
EV_ONLINE_ROLLBACK = _ev("online.rollback")

EV_TRACE_REQUEST = _ev("trace.request")
EV_TRACE_LEG = _ev("trace.leg")
EV_TRACE_SERVE = _ev("trace.serve")
EV_TRACE_BATCH = _ev("trace.batch")
EV_FLIGHTREC_DUMP = _ev("flightrec.dump")
EV_LOG_RECORD = _ev("log.record")

EV_SUPERVISOR_RESTART = _ev("supervisor.restart")
EV_SUPERVISOR_RESUMED = _ev("supervisor.resumed")
EV_SUPERVISOR_SHUTDOWN = _ev("supervisor.shutdown")
EV_SUPERVISOR_DONE = _ev("supervisor.done")
EV_SUPERVISOR_GIVEUP = _ev("supervisor.giveup")

# -- counters ----------------------------------------------------------

CTR_FUSED_DISPATCHES = _ctr("fused.dispatches")
CTR_FUSED_MINIBATCHES = _ctr("fused.minibatches")
CTR_FUSED_STREAM_TRANSFER_BYTES = _ctr("fused.stream_transfer_bytes")
CTR_FUSED_STREAM_TRANSFER_SECONDS = _ctr(
    "fused.stream_transfer_seconds")
CTR_FUSED_STREAM_OOM_RETRIES = _ctr("fused.stream_oom_retries")

CTR_ENSEMBLE_CHUNKS = _ctr("ensemble.chunks")
CTR_ENSEMBLE_SECONDS = _ctr("ensemble.seconds")
CTR_ENSEMBLE_IMAGES = _ctr("ensemble.images")
CTR_ENSEMBLE_MEMBER_IMAGES = _ctr("ensemble.member_images")

CTR_GA_COHORTS = _ctr("ga.cohorts")
CTR_GA_COHORT_MEMBERS = _ctr("ga.cohort_members")
CTR_GA_EVALUATIONS = _ctr("ga.evaluations")
CTR_GA_EVAL_SECONDS = _ctr("ga.eval_seconds")
CTR_GA_HANGS_DETECTED = _ctr("ga.hangs_detected")
CTR_GA_EVALUATOR_RESTARTS = _ctr("ga.evaluator_restarts")
CTR_GA_GENOMES_LOST = _ctr("ga.genomes_lost")
CTR_GA_GENOME_RETRIES = _ctr("ga.genome_retries")
CTR_GA_CHECKPOINT_FALLBACKS = _ctr("ga.checkpoint_fallbacks")

CTR_SERVE_REQUESTS = _ctr("serve.requests")
CTR_SERVE_REQUEST_ERRORS = _ctr("serve.request_errors")
CTR_SERVE_ROWS = _ctr("serve.rows")
CTR_SERVE_MEMBER_ROWS = _ctr("serve.member_rows")
CTR_SERVE_BATCHES = _ctr("serve.batches")
CTR_SERVE_BATCH_SLOTS = _ctr("serve.batch_slots")
CTR_SERVE_COMPILES = _ctr("serve.compiles")
CTR_SERVE_SPILLS = _ctr("serve.spills")
CTR_SERVE_DEADLINE_DROPPED = _ctr("serve.deadline_dropped")
CTR_SERVE_WAIT_COLLAPSED = _ctr("serve.wait_collapsed")
CTR_SERVE_WAIT_STRETCHED = _ctr("serve.wait_stretched")

CTR_FLEET_REQUESTS = _ctr("fleet.requests")
CTR_FLEET_REQUEST_ERRORS = _ctr("fleet.request_errors")
CTR_FLEET_SHED = _ctr("fleet.shed")
CTR_FLEET_RETRIES = _ctr("fleet.retries")
CTR_FLEET_MIRRORED = _ctr("fleet.mirrored")
CTR_FLEET_REPLICA_DEATHS = _ctr("fleet.replica_deaths")
CTR_FLEET_REPLICA_RESPAWNS = _ctr("fleet.replica_respawns")
CTR_FLEET_HEDGES = _ctr("fleet.hedge.issued")
CTR_FLEET_HEDGE_WINS = _ctr("fleet.hedge.wins")
CTR_FLEET_HEDGE_DENIED = _ctr("fleet.hedge.denied")
CTR_FLEET_STALE_RESPONSES = _ctr("fleet.stale_response")
CTR_FLEET_DEADLINE_MISSES = _ctr("fleet.deadline_misses")
CTR_FLEET_INTEGRITY_STRIKES = _ctr("fleet.integrity_strikes")
CTR_FLEET_EJECTIONS = _ctr("fleet.eject.total")
CTR_FLEET_REINSTATEMENTS = _ctr("fleet.eject.reinstated_total")
CTR_FLEET_PROBES = _ctr("fleet.probe.sent")
CTR_FLEET_PROBES_OK = _ctr("fleet.probe.ok")
CTR_FLEET_PROBES_FAILED = _ctr("fleet.probe.fail")
CTR_FLEET_SCALE_UPS = _ctr("fleet.scale.ups")
CTR_FLEET_SCALE_DOWNS = _ctr("fleet.scale.downs")
CTR_FLEET_RETIRED = _ctr("fleet.replicas_retired")
CTR_TRAFFIC_SENT = _ctr("traffic.sent")
CTR_TRAFFIC_LATE = _ctr("traffic.late")

CTR_ONLINE_TAPPED_ROWS = _ctr("online.tapped_rows")
CTR_ONLINE_LABELED_ROWS = _ctr("online.labeled_rows")
CTR_ONLINE_LABEL_ORPHANS = _ctr("online.label_orphans")
CTR_ONLINE_STEPS = _ctr("online.steps")
CTR_ONLINE_STEP_ROWS = _ctr("online.step_rows")
CTR_ONLINE_STEP_SECONDS = _ctr("online.step_seconds")
CTR_ONLINE_STEPS_SKIPPED_BUSY = _ctr("online.steps_skipped_busy")
CTR_ONLINE_PROMOTIONS = _ctr("online.promotions")
CTR_ONLINE_ROLLBACKS = _ctr("online.rollbacks")

CTR_SOM_FUSED_DISPATCHES = _ctr("som.fused_dispatches")
CTR_SOM_FUSED_IMAGES = _ctr("som.fused_images")
CTR_SOM_COHORTS = _ctr("som.cohorts")
CTR_SOM_COHORT_MEMBERS = _ctr("som.cohort_members")

CTR_EVALUATOR_JOBS = _ctr("evaluator.jobs")
CTR_EVALUATOR_JOB_ERRORS = _ctr("evaluator.job_errors")

CTR_LOADER_EPOCHS = _ctr("loader.epochs")
CTR_LOADER_IMAGES_DECODED = _ctr("loader.images_decoded")
CTR_LOADER_CORRUPT_SKIPPED = _ctr("loader.corrupt_skipped")

CTR_SNAPSHOT_SAVES = _ctr("snapshot.saves")
CTR_SNAPSHOT_FALLBACKS = _ctr("snapshot.fallbacks")

CTR_DEVICE_OOM_DEGRADED = _ctr("device.oom_degraded")
CTR_MULTIHOST_EMERGENCY_SNAPSHOTS = _ctr(
    "multihost.emergency_snapshots")
CTR_PREEMPT_FINAL_SNAPSHOTS = _ctr("preempt.final_snapshots")
CTR_SUPERVISOR_RESTARTS = _ctr("supervisor.restarts")

# -- gauges ------------------------------------------------------------

GAUGE_FUSED_MFU = _gauge("fused.mfu")
GAUGE_FUSED_TRAIN_GFLOPS_PER_IMAGE = _gauge(
    "fused.train_gflops_per_image")
GAUGE_FUSED_TRAIN_IMAGES_PER_SEC_WALL = _gauge(
    "fused.train_images_per_sec_wall")
GAUGE_SERVE_QUEUE_DEPTH = _gauge("serve.queue_depth")
GAUGE_SERVE_MODELS_RESIDENT = _gauge("serve.models_resident")
GAUGE_SERVE_RESIDENT_BYTES = _gauge("serve.resident_bytes")
GAUGE_SERVE_RESIDENT_BYTES_PER_DEVICE = _gauge(
    "serve.resident_bytes_per_device")
GAUGE_SERVE_MESH_DEVICES = _gauge("serve.mesh_devices")
GAUGE_ARBITER_BUDGET_BYTES = _gauge("arbiter.budget_bytes")
GAUGE_ARBITER_RESIDENT_BYTES = _gauge("arbiter.resident_bytes")
GAUGE_SERVE_EFFECTIVE_WAIT_MS = _gauge("serve.effective_wait_ms")
GAUGE_SERVE_FIRST_DISPATCH_SECONDS = _gauge(
    "serve.first_dispatch_seconds")

GAUGE_FLEET_REPLICAS_HEALTHY = _gauge("fleet.replicas_healthy")
GAUGE_FLEET_INFLIGHT = _gauge("fleet.inflight")
GAUGE_FLEET_EST_WAIT_MS = _gauge("fleet.est_wait_ms")
GAUGE_FLEET_DISPATCH_EMA_MS = _gauge("fleet.dispatch_ema_ms")
GAUGE_FLEET_HEDGE_THRESHOLD_MS = _gauge("fleet.hedge.threshold_ms")
GAUGE_FLEET_REPLICAS_EJECTED = _gauge("fleet.eject.current")
GAUGE_FLEET_REPLICAS_TOTAL = _gauge("fleet.replicas_total")
GAUGE_FLEET_DEGRADE_RUNGS = _gauge("fleet.degrade.rungs")
GAUGE_FLEET_SCALE_PRESSURE_MS = _gauge("fleet.scale.pressure_ms")
GAUGE_TRAFFIC_RATE_RPS = _gauge("traffic.rate_rps")

GAUGE_ONLINE_BUFFER_ROWS = _gauge("online.buffer_rows")
GAUGE_ONLINE_BUFFER_BYTES = _gauge("online.buffer_bytes")
GAUGE_ONLINE_TIME_TO_SERVE = _gauge("online.time_to_serve")

GAUGE_LOCKSTEP_EDGES = _gauge("lockstep.edges_observed")
GAUGE_LOCKSTEP_ACQUIRES = _gauge("lockstep.acquires")

GAUGE_GA_LAST_HANG_WAIT = _gauge("ga.last_hang_wait")
GAUGE_PREEMPT_SNAPSHOT_SECONDS = _gauge("preempt.snapshot_seconds")
GAUGE_MULTIHOST_PEER_HEARTBEAT_AGE = _gauge(
    "multihost.peer_heartbeat_age")

# -- histograms --------------------------------------------------------

HIST_SNAPSHOT_SAVE_SECONDS = _hist("snapshot.save_seconds")
HIST_SNAPSHOT_LOAD_SECONDS = _hist("snapshot.load_seconds")
HIST_GA_GENOME_SECONDS = _hist("ga.genome_seconds")
HIST_GA_GENERATION_SECONDS = _hist("ga.generation_seconds")
HIST_LOADER_DECODE_SECONDS = _hist("loader.decode_seconds")
HIST_LOADER_EPOCH_SECONDS = _hist("loader.epoch_seconds")
HIST_ENSEMBLE_DISPATCH_SECONDS = _hist("ensemble.dispatch_seconds")
HIST_ENSEMBLE_SCORE_SECONDS = _hist("ensemble.score_seconds")
HIST_SUPERVISOR_DOWNTIME_SECONDS = _hist(
    "supervisor.downtime_seconds")
HIST_FLEET_REQUEST_SECONDS = _hist("fleet.request_seconds")
HIST_SERVE_REQUEST_SECONDS = _hist("serve.request_seconds")
HIST_SERVE_DISPATCH_SECONDS = _hist("serve.dispatch_seconds")
HIST_SERVE_BATCH_ROWS = _hist("serve.batch_rows")
HIST_SERVE_WAIT_SECONDS = _hist("serve.wait_seconds")
HIST_ONLINE_STEP_DISPATCH_SECONDS = _hist(
    "online.step_dispatch_seconds")
HIST_ONLINE_GATE_SECONDS = _hist("online.gate_seconds")

# -- journaled spans (event + histogram of the same name) --------------

SPAN_GA_COHORT_TRAIN = _span("ga.cohort_train")
SPAN_SOM_COHORT_TRAIN = _span("som.cohort_train")
SPAN_EVALUATOR_JOB_SECONDS = _span("evaluator.job_seconds")

#: dynamic name families (built with f-strings at the call site; the
#: lint rule checks literals only): ``fused.<kind>_dispatch_seconds``
#: histograms, ``fused.first_<kind>_dispatch_seconds`` gauges, and
#: ``fused.<kind>_seconds`` / ``fused.<kind>_images`` counters, where
#: <kind> is the fused step kind (train/eval/...)
#: ...plus the fleet router's per-model traffic split (the canary A/B
#: read): ``fleet.model.<name>.requests`` / ``.errors`` / ``.shed`` /
#: ``.mirrored`` counters and a ``fleet.model.<name>.request_seconds``
#: histogram, where <name> is the served model's registered name
#: ...plus the sentinel's per-replica health split (the fleet_rows
#: health column): a ``fleet.replica.<i>.health_score`` gauge and a
#: ``fleet.replica.<i>.hedge_wins`` counter, where <i> is the replica
#: index
DYNAMIC_FAMILIES = (
    "fused.<kind>_dispatch_seconds",
    "fused.first_<kind>_dispatch_seconds",
    "fused.<kind>_seconds",
    "fused.<kind>_images",
    "fleet.model.<name>.requests",
    "fleet.model.<name>.errors",
    "fleet.model.<name>.shed",
    "fleet.model.<name>.mirrored",
    "fleet.model.<name>.request_seconds",
    "fleet.replica.<i>.health_score",
    "fleet.replica.<i>.hedge_wins",
    "online.model.<name>.buffer_rows",
    "online.model.<name>.steps",
    "online.model.<name>.gate_state",
    "arbiter.pool.<pool>.resident_bytes",
)


def known(name: str) -> bool:
    """Is ``name`` declared in any telemetry namespace?"""
    return name in EVENTS or name in COUNTERS or name in GAUGES \
        or name in HISTOGRAMS or name in SPANS


def all_names() -> frozenset:
    return frozenset(EVENTS | COUNTERS | GAUGES | HISTOGRAMS | SPANS)
