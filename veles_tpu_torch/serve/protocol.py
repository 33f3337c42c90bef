"""The registry of JSONL wire-protocol keys (the port's own copy).

Counterpart of ``veles_tpu/serve/protocol.py``, key for key, with the
port's learner counters besides: every field name that crosses a
serving pipe (hello lines, heartbeats, requests, responses, the
introspection ops) is declared here, so this file is the one place the
protocol is enumerated for a reader, and the ``wire-protocol`` lint rule
(``veles_tpu_torch/analysis``) flags a key sent undeclared.  Call sites keep
writing ``{"id": jid, ...}`` literals; the registry declares, it does
not route.  Some keys belong to parts of the reference the port does
not have yet (the fleet router, traffic traces): the protocol is one.
"""

from __future__ import annotations

from typing import Set

WIRE_KEYS: Set[str] = set()


def _k(name: str) -> str:
    WIRE_KEYS.add(name)
    return name


# -- envelope (every message) ------------------------------------------

K_ID = _k("id")                  #: wire id drawn by the client
K_OP = _k("op")                  #: stats / fleet / shutdown
K_ERROR = _k("error")            #: error text (terminal per-request)

# -- requests ----------------------------------------------------------

K_MODEL = _k("model")            #: registered model name
K_ROWS = _k("rows")              #: f32 sample rows, nested lists
K_DEADLINE_MS = _k("deadline_ms")  #: absolute unix-epoch deadline

K_LABEL = _k("label")            #: optional ground-truth (per row or
#: one scalar for the whole request) — feeds the online-learning tap
K_LABEL_OF = _k("label_of")      #: late label join: the wire id of
#: the earlier request these labels belong to

# -- responses ---------------------------------------------------------

K_PRED = _k("pred")              #: argmax per row
K_PROBS = _k("probs")            #: f32 probability payload
K_ROWS_N = _k("rows_n")          #: integrity echo: payload row count
K_CRC = _k("crc")                #: integrity echo: crc32 of clean f32
K_EXPIRED = _k("expired")        #: dropped past deadline_ms, unanswered
K_OVERLOADED = _k("overloaded")  #: admission-control shed
K_EST_MS = _k("est_ms")          #: estimated completion behind a shed
K_TIMEOUT = _k("timeout")        #: router-side deadline exceeded

# -- hello lines -------------------------------------------------------

K_READY = _k("ready")
K_PID = _k("pid")
K_BACKEND = _k("backend")
K_PLATFORM = _k("platform")
K_MODELS = _k("models")
K_MAX_BATCH = _k("max_batch")
K_MAX_WAIT_MS = _k("max_wait_ms")
K_MEMBERS = _k("members")        #: per-model: ensemble member count
K_PARAM_BYTES = _k("param_bytes")
K_RESIDENT = _k("resident")
K_VERSION = _k("version")
K_SHARDED = _k("sharded")        #: per-model: member-sharded placement
# hello extras: a replica advertises its real capacity so the
# placement policy can mix 1-device and N-device replicas
K_DEVICES = _k("devices")        #: devices the replica's mesh owns
K_DEVICE_BUDGET = _k("device_budget")  #: residency budget PER device
# fleet hello extras
K_FLEET = _k("fleet")            #: replica count (hello) / status (op)
K_REPLICA_PIDS = _k("replica_pids")
K_PLACEMENT = _k("placement")
K_CANARIES = _k("canaries")
K_OF = _k("of")                  #: canary: primary model name
K_FRACTION = _k("fraction")      #: canary: mirrored traffic fraction
K_SLO_P99_MS = _k("slo_p99_ms")
K_MAX_INFLIGHT = _k("max_inflight")

K_ONLINE = _k("online")          #: hello: the learning tier is armed

# -- trace context -------------------------------------------------------
# minted at the fleet router and propagated on every wire hop (requests,
# hedge copies, failover retries, GA cohort jobs)

K_TRACE = _k("trace")            #: 16-hex trace id (one request tree)
K_SPAN = _k("span")              #: 8-hex span id of the sending hop
K_PARENT = _k("parent")          #: span id of the causing hop
K_SAMPLED = _k("sampled")        #: head-based sampling bit

# -- heartbeats --------------------------------------------------------

K_HB = _k("hb")                  #: heartbeat sequence number

# -- introspection (op=stats / op=fleet) -------------------------------

K_STATS = _k("stats")
K_REPLICAS = _k("replicas")
K_REPLICA = _k("replica")
K_HEALTHY = _k("healthy")
K_INFLIGHT = _k("inflight")
K_ROUTED = _k("routed")
K_DEATHS = _k("deaths")
K_EMA_DISPATCH_MS = _k("ema_dispatch_ms")
K_DEADLINE_MS_CFG = _k("deadline_ms")  # shared with requests
K_HEDGE_RATE = _k("hedge_rate")
K_SENTINEL = _k("sentinel")
# the sentinel's per-replica health row (router op=fleet)
K_STATE = _k("state")
K_HEALTH_SCORE = _k("health_score")
K_STRIKES = _k("strikes")
K_HEDGE_WINS = _k("hedge_wins")
K_HEDGE_LOSSES = _k("hedge_losses")
K_PROBE_OK_STREAK = _k("probe_ok_streak")
K_PROBE_FAILS = _k("probe_fails")
K_EJECTIONS = _k("ejections")
K_REINSTATEMENTS = _k("reinstatements")
K_LATENCY_EMA_MS = _k("latency_ema_ms")
# the learner's per-model introspection row (hive op=learn) — buffer
# fill, scavenged steps, and the promotion gate's live standing
K_LEARN = _k("learn")            #: op=learn: {model: learner row}
K_BUFFER_ROWS = _k("buffer_rows")
K_HOLDOUT_ROWS = _k("holdout_rows")
K_BUFFER_BYTES = _k("buffer_bytes")
K_TAPPED_ROWS = _k("tapped_rows")
K_LABELED_ROWS = _k("labeled_rows")
K_STEPS = _k("steps")
K_PROMOTIONS = _k("promotions")
K_ROLLBACKS = _k("rollbacks")
K_SHADOW_ERROR_PCT = _k("shadow_error_pct")
K_INCUMBENT_ERROR_PCT = _k("incumbent_error_pct")
K_MARGIN = _k("margin")          #: promote margin the gate holds
K_TIME_TO_SERVE_MS = _k("time_to_serve_ms")
# the port's learner counters (the hive's op=stats "online" entry)
K_STEPS_SKIPPED_BUSY = _k("steps_skipped_busy")
K_GATE_ROUNDS = _k("gate_rounds")
K_GATE_ABORTS = _k("gate_aborts")
K_STEP_SECONDS = _k("step_seconds")
K_STEP_EMA_MS = _k("step_ema_ms")
K_LABEL_ORPHANS = _k("label_orphans")
K_LAST_PROMOTION = _k("last_promotion")

# -- the elastic fleet and its degradation ladder ----------------------

K_LEARNER_CTL = _k("learner_ctl")  #: op=learner_suspend/resume ack
K_SUSPENDED = _k("suspended")    #: learner_ctl: the learner's state
K_DEGRADED = _k("degraded")      #: shed carried a ladder rung's mark
K_RETIRING = _k("retiring")      #: fleet row: replica is draining out
K_N_REPLICAS = _k("n_replicas")  #: fleet status: live member count
K_HEDGING_ENABLED = _k("hedging_enabled")  #: ladder rung 2 lever
K_SHED_TAIL = _k("shed_tail")    #: ladder rung 3 lever
K_WARM_DIRS = _k("warm_dirs")    #: retained install dirs for respawn

# -- the traffic trace file (veles-traffic-v1 JSONL) -------------------
# one header line {format, spec, n} then one line per arrival — the
# byte-identical replay contract shares the wire-key registry

K_I = _k("i")                    #: arrival index (dense, 0-based)
K_T = _k("t")                    #: scheduled offset secs from day start
K_ROW_SEED = _k("row_seed")      #: per-arrival input row generator seed
K_BURST = _k("burst")            #: arrival fell in a burst window
K_FORMAT = _k("format")          #: trace header: format tag
K_SPEC = _k("spec")              #: trace header: TrafficSpec dict
K_N = _k("n")                    #: trace header: arrival count


def known(key: str) -> bool:
    """Is ``key`` a declared wire-protocol field?"""
    return key in WIRE_KEYS


def all_keys() -> frozenset:
    return frozenset(WIRE_KEYS)
