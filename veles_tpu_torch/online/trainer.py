"""The scavenger trainer: fine-tune in the serving idle gaps (the port's
counterpart of ``veles_tpu/online/trainer.py``).

One thread inside the hive process drives, per learning model, a
fine-tune micro-step: the fused step's train body (forward with
residuals, the evaluator's gradient, the backward and SGD chain of
``engine/core.py``'s ``build_forward`` / ``build_backward``, rates
only) under ``torch.func.vmap`` over the ensemble's stacked MEMBER
axis, with ``randomness="same"``, so one step advances every member on
the same replay micro-batch, as ``ops/population.py`` does for a GA
cohort.  On the card the LRN kernels fold the member axis into their
rows (``ops/lrn_cuda.py``'s member rule): one launch a layer for all
members.  The gate's scoring runs the members' inference chain under
the same ``vmap``.

Scheduling is parasitic: a step fires only when EVERY serving batcher
has been idle (empty queue, nothing in flight) for
``$VELES_ONLINE_IDLE_MS``, when the EMA step cost fits under
``$VELES_ONLINE_SLO_P99_MS``, and when the duty throttle
(``$VELES_ONLINE_DUTY``) is not resting.  The host fetch of a step's
metrics is the step's barrier, so the step's measured cost is the
device's too; a gate round synchronises the device after every scored
chunk, so traffic that arrives mid-round aborts it before more chunks
queue ahead of the serving dispatch.

The step produces new tensors and writes none in place
(``GradientUnit.update_params``); :meth:`ShadowTrainer.take_params`
still hands off the current tree and continues on a copy, as the
reference does, so nothing the shadow does later can reach what
serving reads.

Determinism: step k samples its micro-batch with a numpy generator
seeded from ``(model seed, k)`` against the buffer state at a recorded
``buffer.version``, and its dropout draws are keyed on ``(model seed,
k, layer)`` (``prng.torch_generator``): replaying the ``(step,
version)`` history over the same tapped rows reproduces the online
param trajectory exactly (on the card under deterministic cuDNN).

Counters stand in for the reference's telemetry: :meth:`OnlineLearner.
counters` (``op=stats``) and :meth:`OnlineLearner.status` (``op=learn``,
the reference's row keys).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import events, knobs, telemetry
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.engine import core as engine_core
from veles_tpu_torch.online.buffer import ReplayBuffer
from veles_tpu_torch.online.promote import PromotionGate
from veles_tpu_torch.online.tap import TrafficTap
from veles_tpu_torch.ops import batching

log = logging.getLogger("veles_tpu_torch.online")

Tree = Dict[str, Dict[str, torch.Tensor]]


def _copy(tree: Tree) -> Tree:
    """A device-to-device copy of a stacked param tree."""
    return {f: {p: t.clone() for p, t in ps.items()}
            for f, ps in tree.items()}


class ShadowTrainer:
    """One model's fine-tune state: the vmapped step and score, and the
    device-resident shadow params they advance.

    Free of hive plumbing, so a test or an offline replay can drive it
    directly: construct it from the hosted workflow's unit chain and
    call :meth:`step` with explicit batches."""

    def __init__(self, forwards: List[Any], gds: List[Any],
                 evaluator: Any, device: Any, stacked_params: Tree,
                 seed: int, lr_scale: float, micro_batch: int) -> None:
        self.forwards = list(forwards)
        self.gds = list(gds)
        self.evaluator = evaluator
        self.device = device
        self.seed = int(seed)
        self.micro_batch = int(micro_batch)
        self.n_members = int(next(
            t for ps in stacked_params.values() for t in ps.values()
        ).shape[0])
        #: the shadow's working params: a device copy of the
        #: incumbent's stacked tree (the incumbent keeps serving its own)
        self._params = _copy(stacked_params)
        self._opt = self._fresh_opt()
        #: (n_gd, 2) fine-tune rates, rounded to f32 as the reference's
        #: array holds them: the packaged rates scaled down
        self._lr = np.asarray(
            [[gd.learning_rate * lr_scale,
              gd.learning_rate_bias * lr_scale]
             if gd is not None else [0.0, 0.0] for gd in self.gds],
            np.float32).tolist()
        self.steps = 0
        #: (step index, buffer version) per step: the replay log
        self.history: List[Tuple[int, int]] = []
        self._build()

    def _fresh_opt(self) -> Tree:
        """Zero momentum buffers for every gradient unit with momentum."""
        return {gd.name: {pn: torch.zeros_like(t)
                          for pn, t in self._params[f.name].items()}
                for f, gd in zip(self.forwards, self.gds)
                if gd is not None and gd.gradient_moment}

    @property
    def nbytes(self) -> int:
        """Device bytes of the shadow's params and momentum."""
        return sum(t.numel() * t.element_size()
                   for tree in (self._params, self._opt)
                   for ps in tree.values() for t in ps.values())

    def _build(self) -> None:
        cd = batching.resolve_compute_dtype(None, self.device)
        cast = batching.make_caster(cd)
        forward_pass = engine_core.build_forward(self.forwards, self.seed,
                                                 cd)
        backward_update = engine_core.build_backward(self.forwards,
                                                     self.gds, cd)
        member_fwd = engine_core.build_member_forward(self.forwards, cd)
        metrics_fn = self.evaluator.metrics_fn
        lr = self._lr

        def member_step(params, opt, x, labels, mask, rc):
            # the fused train body on one micro-batch; vmap lifts it
            # over the leading member axis of params and opt
            cparams = cast(params)
            out, residuals = forward_pass(cparams, x, rc, True)
            m = metrics_fn(out.float(), labels, mask)
            new_params, new_opt = backward_update(
                cparams, params, opt, residuals, m["err_output"], lr)
            return new_params, new_opt, torch.stack(
                [m["n_err"], m["loss_sum"], m["count"]])

        def step(params, opt, x, labels, mask, rc):
            return torch.func.vmap(
                functools.partial(member_step, rc=rc),
                in_dims=(0, 0, None, None, None),
                randomness="same")(params, opt, x, labels, mask)

        def score(params, acc, x, labels, mask):
            probs = torch.func.vmap(member_fwd, in_dims=(0, None))(
                cast(params), x)
            # the mean over members here is the gate's own contract,
            # not the serving dispatcher's fixed add chain
            pred = probs.mean(0).argmax(-1)
            wrong = ((pred != labels).to(torch.float32) * mask).sum()
            return acc + torch.stack([wrong, mask.sum()])

        self._step = step
        self._score = score

    # -- the two dispatch kinds ---------------------------------------

    @torch.no_grad()
    def step(self, x: np.ndarray, labels: np.ndarray,
             version: int) -> np.ndarray:
        """One fine-tune micro-step over exactly ``micro_batch`` rows;
        returns the fetched (P, 3) [n_err, loss_sum, count] metrics (the
        fetch is the step's barrier)."""
        if len(x) != self.micro_batch:
            raise ValueError(
                f"step batch is {len(x)} rows, the fixed shape is "
                f"{self.micro_batch}")
        dev = self.device
        self.history.append((self.steps, int(version)))
        self._params, self._opt, met = self._step(
            self._params, self._opt, dev.put(np.asarray(x, np.float32)),
            dev.put(np.asarray(labels, np.int64)),
            dev.put(np.ones(self.micro_batch, np.float32)), self.steps)
        self.steps += 1
        return dev.get(met)

    def sample_rng(self, step: Optional[int] = None) -> np.random.Generator:
        """The per-step generator of the buffer draw: a pure function of
        (model seed, step index)."""
        k = self.steps if step is None else int(step)
        return np.random.default_rng([self.seed, k])

    @torch.no_grad()
    def error_pct(self, params: Tree, x: np.ndarray, labels: np.ndarray,
                  abort=None) -> Optional[float]:
        """Held-out error % of any stacked tree of this model (shadow or
        incumbent), in ``micro_batch``-row chunks with a [wrong, count]
        carry on the device.  ``abort`` is checked before every chunk,
        and the device is synchronised after every chunk when it is
        given: None is returned the moment traffic arrives."""
        chunk = self.micro_batch
        dev = self.device
        x = np.asarray(x, np.float32)
        labels = np.asarray(labels, np.int64)
        acc = dev.zeros(2)
        for i in range(0, len(x), chunk):
            if abort is not None and abort():
                return None
            xb, lb, mask = batching.pad_chunk(x[i:i + chunk],
                                              labels[i:i + chunk], chunk)
            acc = self._score(params, acc, dev.put(xb), dev.put(lb),
                              dev.put(mask))
            if abort is not None:
                dev.synchronize()
        acc = dev.get(acc)
        return 100.0 * float(acc[0]) / max(float(acc[1]), 1.0)

    def reset_from(self, stacked_params: Tree) -> None:
        """Rollback: restart from a device copy of the given
        (incumbent's) tree, momentum cleared."""
        self._params = _copy(stacked_params)
        self._opt = self._fresh_opt()

    def take_params(self) -> Tree:
        """The promotion handoff: the current shadow tree, which the
        trainer stops referencing; training continues on a copy."""
        promoted = self._params
        self._params = _copy(promoted)
        return promoted

    def host_members(self) -> List[Dict[str, Dict[str, np.ndarray]]]:
        """The current shadow params as host member trees (port
        layout): what the residency manager restores a spill from.
        One fetch a leaf, off the promotion's critical path."""
        host = {fn: {pn: self.device.get(t) for pn, t in ps.items()}
                for fn, ps in self._params.items()}
        return [{fn: {pn: a[i] for pn, a in ps.items()}
                 for fn, ps in host.items()}
                for i in range(self.n_members)]


class OnlineLearner:
    """The hive's learning tier: tap, buffers, the scavenger thread and
    each model's promotion gate."""

    def __init__(self, residency: Any,
                 environ: Optional[Dict[str, str]] = None) -> None:
        self.residency = residency
        self.tap = TrafficTap(knobs.get(knobs.ONLINE_TAP_FRAC, environ))
        self.buffer_rows = int(knobs.get(knobs.ONLINE_BUFFER_ROWS, environ))
        self.holdout_every = int(knobs.get(knobs.ONLINE_HOLDOUT_EVERY,
                                           environ))
        self.micro_batch = int(knobs.get(knobs.ONLINE_MICRO_BATCH, environ))
        self.min_steps = int(knobs.get(knobs.ONLINE_MIN_STEPS, environ))
        self.margin = float(knobs.get(knobs.ONLINE_PROMOTE_MARGIN, environ))
        self.idle_s = max(0.0, float(knobs.get(knobs.ONLINE_IDLE_MS,
                                               environ))) / 1000.0
        self.slo_p99_ms = float(knobs.get(knobs.ONLINE_SLO_P99_MS, environ))
        self.lr_scale = float(knobs.get(knobs.ONLINE_LR_SCALE, environ))
        self.duty = min(1.0, max(0.01, float(
            knobs.get(knobs.ONLINE_DUTY, environ))))
        #: monotonic time before which the duty throttle vetoes a step
        self._rest_until = 0.0
        self._lock = witness.lock("online.learner")
        self._trainers: Dict[str, ShadowTrainer] = {}
        self._gates: Dict[str, PromotionGate] = {}
        #: EMA of the fetched step's wall ms: the SLO headroom input
        self._step_ema_ms: Optional[float] = None
        #: completed gate rounds and rounds aborted by traffic (skipped
        #: opportunities and step seconds count in the online.*
        #: telemetry counters)
        self.gate_rounds = 0
        self.gate_aborts = 0
        self._stop = threading.Event()
        #: a suspended learner stays armed (taps keep filling the
        #: buffers) but takes no steps
        self._suspended = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- arming --------------------------------------------------------

    def arm_model(self, name: str) -> bool:
        """Arm learning for one hosted model; False (and a warning) when
        its packaged workflow has no trainable chain."""
        m = self.residency.models[name]
        w = m.meta.get("workflow")
        gds = list(getattr(w, "gds", []) or [])
        evaluator = getattr(w, "evaluator", None)
        if w is None or evaluator is None or \
                not any(gd is not None for gd in gds):
            log.warning("online: model %r has no trainable chain; not "
                        "armed", name)
            return False
        engine = self.residency.ensure(name)
        # the package seed the hive recorded, else a stable digest of
        # the name (never hash(): it is salted per process)
        seed = int(m.meta.get("seed")
                   or (zlib.crc32(name.encode()) & 0x7FFFFFFF))
        buf = ReplayBuffer(self.buffer_rows, seed=seed,
                           holdout_every=self.holdout_every,
                           dequant=getattr(w.loader, "dequant", None))
        trainer = ShadowTrainer(
            m.forwards, gds, evaluator, self.residency.device,
            engine.stacked_params, seed=seed, lr_scale=self.lr_scale,
            micro_batch=self.micro_batch)
        gate = PromotionGate(name, self.residency, self.margin,
                             self.min_steps)
        with self._lock:
            self._trainers[name] = trainer
            self._gates[name] = gate
        self.tap.arm(name, buf)
        # the shadow's params and momentum are device memory the LRU
        # budget must see
        self.residency.reserve(f"{name}@shadow", trainer.nbytes,
                               pool="train")
        telemetry.event(events.EV_ONLINE_ARMED, model=name,
                        members=trainer.n_members,
                        micro_batch=self.micro_batch,
                        buffer_rows=self.buffer_rows)
        log.info("online: armed %r (%d members, micro_batch=%d, "
                 "buffer=%d rows)", name, trainer.n_members,
                 self.micro_batch, self.buffer_rows)
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="online-scavenger")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def suspend(self) -> None:
        """Park the scavenger: tapping continues, steps and gate rounds
        stop until :meth:`resume`."""
        if not self._suspended.is_set():
            self._suspended.set()
            log.info("online: learner suspended")

    def resume(self) -> None:
        if self._suspended.is_set():
            self._suspended.clear()
            log.info("online: learner resumed")

    @property
    def suspended(self) -> bool:
        return self._suspended.is_set()

    # -- the scavenger loop -------------------------------------------

    def _serving_idle(self) -> bool:
        """True when every engine's batcher is empty, quiet for
        ``idle_s``, and has nothing in flight (plain reads, no lock)."""
        now = time.monotonic()
        for m in list(self.residency.models.values()):
            b = getattr(m.engine, "batcher", None)
            if b is None:
                continue
            if b.pending_rows > 0 or now - b.last_activity < self.idle_s:
                return False
        return True

    def _rest_for(self, cost_s: float) -> float:
        """Duty-cycle rest after ``cost_s`` of scavenged work, capped at
        1 s (the first step's set-up must not park the learner)."""
        return min(1.0, cost_s * (1.0 - self.duty) / self.duty)

    def _headroom(self) -> bool:
        """A step whose EMA cost exceeds the target p99 would become
        the p99 of a request landing under it."""
        if self.slo_p99_ms <= 0 or self._step_ema_ms is None:
            return True
        return self._step_ema_ms <= self.slo_p99_ms

    def _loop(self) -> None:
        poll = max(0.001, self.idle_s / 2.0 if self.idle_s else 0.001)
        while not self._stop.wait(poll):
            if self._suspended.is_set():
                continue
            with self._lock:
                items = list(self._trainers.items())
            for name, trainer in items:
                if self._stop.is_set():
                    return
                buf = self.tap.buffers.get(name)
                gate = self._gates.get(name)
                if buf is None or gate is None:
                    continue
                if buf.train_rows < self.micro_batch:
                    gate.state = "filling"
                    continue
                if time.monotonic() < self._rest_until:
                    continue   # the duty throttle rests; not busy
                if not self._serving_idle() or not self._headroom():
                    telemetry.counter(
                        events.CTR_ONLINE_STEPS_SKIPPED_BUSY).inc()
                    continue
                try:
                    self._step_one(name, trainer, buf, gate)
                except Exception as e:  # noqa: BLE001 — the learner
                    # must never take down the process it scavenges
                    log.error("online: step failed for %r (disarming "
                              "it): %s: %s", name, type(e).__name__, e)
                    with self._lock:
                        self._trainers.pop(name, None)

    def _step_one(self, name: str, trainer: ShadowTrainer,
                  buf: ReplayBuffer, gate: PromotionGate) -> None:
        if gate.state == "filling":
            gate.state = "training"
        rng = trainer.sample_rng()
        t0 = time.perf_counter()
        x, labels = buf.sample(trainer.micro_batch, rng)
        trainer.step(x, labels, buf.version)
        dt = time.perf_counter() - t0
        gate.last_step_ts = time.monotonic()
        # the rest covers the whole step (host sample and decode too:
        # the GIL the decode holds is serving capacity as well)
        self._rest_until = gate.last_step_ts + self._rest_for(dt)
        ms = 1000.0 * dt
        self._step_ema_ms = ms if self._step_ema_ms is None else \
            0.8 * self._step_ema_ms + 0.2 * ms
        telemetry.counter(events.CTR_ONLINE_STEPS).inc()
        telemetry.counter(events.CTR_ONLINE_STEP_ROWS).inc(
            trainer.micro_batch)
        telemetry.counter(events.CTR_ONLINE_STEP_SECONDS).inc(dt)
        telemetry.histogram(events.HIST_ONLINE_STEP_DISPATCH_SECONDS).record(
            dt)
        self._publish_gauges(name, trainer, buf, gate)
        if gate.due(trainer.steps):
            self._gate_round(name, trainer, buf, gate)

    def _gate_round(self, name: str, trainer: ShadowTrainer,
                    buf: ReplayBuffer, gate: PromotionGate) -> None:
        # a gate round is several steps' worth of device and host time:
        # traffic that arrived during the step defers it (last_gate_step
        # stays, so it re-arms after the next idle step)
        if not self._serving_idle():
            telemetry.counter(events.CTR_ONLINE_STEPS_SKIPPED_BUSY).inc()
            return
        # the newest rows only: the round's cost stays fixed however
        # full the holdout partition is
        hx, hl = buf.holdout(limit=8 * self.micro_batch)
        if len(hx) < max(4, self.micro_batch // 8):
            gate.last_gate_step = trainer.steps   # wait a full round
            return
        t0 = time.perf_counter()
        m = self.residency.models[name]
        engine = m.engine
        if engine is None or not m.resident:
            return   # spilled: re-arms after the restore

        def _busy() -> bool:
            return not self._serving_idle()

        shadow_err = trainer.error_pct(trainer._params, hx, hl,
                                       abort=_busy)
        incumbent_err = None if shadow_err is None else \
            trainer.error_pct(engine.stacked_params, hx, hl, abort=_busy)
        if shadow_err is None or incumbent_err is None:
            self.gate_aborts += 1
            telemetry.counter(events.CTR_ONLINE_STEPS_SKIPPED_BUSY).inc()
            return
        telemetry.histogram(events.HIST_ONLINE_GATE_SECONDS).record(
            time.perf_counter() - t0)
        self.gate_rounds += 1
        verdict = gate.decide(trainer.steps, shadow_err, incumbent_err)
        log.info("online: gate round for %r at step %d: shadow %.2f%% "
                 "incumbent %.2f%% -> %s", name, trainer.steps,
                 shadow_err, incumbent_err, verdict)
        # the tap's trace-id tail: the verdict journals with the lineage
        # of the traffic that produced these params
        lineage = self.tap.lineage_sample(name)
        if verdict == "promote":
            gate.promote(trainer.take_params(), trainer.steps,
                         lineage=lineage)
            # the host copies a spill restores from, off the swap path
            self.residency.refresh_host_params(name,
                                               trainer.host_members())
        elif verdict == "rollback":
            trainer.reset_from(engine.stacked_params)
            gate.rollback(trainer.steps, lineage=lineage)
        # the whole round is scavenged work: it pays duty rest
        self._rest_until = time.monotonic() + \
            self._rest_for(time.perf_counter() - t0)
        self._publish_gauges(name, trainer, buf, gate)

    def _publish_gauges(self, name: str, trainer: ShadowTrainer,
                        buf: ReplayBuffer, gate: PromotionGate) -> None:
        nbytes = buf.nbytes
        self.residency.reserve(f"{name}@buffer", nbytes, pool="scratch")
        telemetry.gauge(events.GAUGE_ONLINE_BUFFER_ROWS).set(
            buf.train_rows + buf.holdout_rows)
        telemetry.gauge(events.GAUGE_ONLINE_BUFFER_BYTES).set(nbytes)
        telemetry.gauge(f"online.model.{name}.buffer_rows").set(
            buf.train_rows)
        telemetry.gauge(f"online.model.{name}.steps").set(trainer.steps)
        telemetry.gauge(f"online.model.{name}.gate_state").set(
            gate.state_code())

    # -- introspection -------------------------------------------------

    def status(self) -> Dict[str, Dict[str, Any]]:
        """{model: learner row} with the reference's keys: the hive's
        ``op=learn`` payload."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            items = list(self._trainers.items())
            gates = dict(self._gates)
        for name, trainer in items:
            buf = self.tap.buffers.get(name)
            gate = gates.get(name)
            if buf is None or gate is None:
                continue
            out[name] = {
                "state": gate.state,
                "steps": trainer.steps,
                "buffer_rows": buf.train_rows,
                "holdout_rows": buf.holdout_rows,
                "buffer_bytes": buf.nbytes,
                "promotions": gate.promotions,
                "rollbacks": gate.rollbacks,
                "shadow_error_pct": gate.shadow_error_pct,
                "incumbent_error_pct": gate.incumbent_error_pct,
                "margin": gate.margin,
                "time_to_serve_ms": gate.time_to_serve_ms,
            }
        return out

    def counters(self) -> Dict[str, Any]:
        """The learner's counters (the hive's ``op=stats`` ``online``
        entry): the process's ``online.*`` telemetry counters (a hive
        holds one learner) beside the learner's own."""
        with self._lock:
            trainers = list(self._trainers.values())
            gates = dict(self._gates)

        def ctr(name: str):
            return telemetry.counter(name).value

        return {"steps": sum(t.steps for t in trainers),
                "steps_skipped_busy": ctr(
                    events.CTR_ONLINE_STEPS_SKIPPED_BUSY),
                "gate_rounds": self.gate_rounds,
                "gate_aborts": self.gate_aborts,
                "step_seconds": ctr(events.CTR_ONLINE_STEP_SECONDS),
                "step_ema_ms": self._step_ema_ms,
                "suspended": self.suspended,
                "tapped_rows": ctr(events.CTR_ONLINE_TAPPED_ROWS),
                "labeled_rows": ctr(events.CTR_ONLINE_LABELED_ROWS),
                "label_orphans": ctr(events.CTR_ONLINE_LABEL_ORPHANS),
                "last_promotion": {name: g.last_promotion
                                   for name, g in gates.items()}}
