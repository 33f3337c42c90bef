"""The promotion gate: shadow params -> the serving engine, on the
device (the port's counterpart of ``veles_tpu/online/promote.py``).

Fine-tuned params are worth serving only when they are measurably
better on data the trainer never touched: the tap's held-out slice.
Each gate round scores shadow and incumbent on that slice through the
same forward chain and applies a symmetric margin
(``$VELES_ONLINE_PROMOTE_MARGIN``, in error-% points):

- shadow better by >= margin -> **promote**: the shadow's stacked
  device tree is handed to the serving engine in one attribute store
  under the residency lock (``ResidencyManager.swap_params``).  The
  params never visit the host, and a dispatch in flight keeps the tree
  it read while later ones read the new one, so no answer is torn;
- shadow worse by >= margin -> **rollback**: the shadow restarts from a
  device copy of the incumbent's params, momentum cleared;
- within the margin -> keep training.

After a verdict that moved params the gate rests 4 full rounds
(``cooldown_until_step``).  ``time_to_serve_ms``, from the shadow's last
step to the first request served on the promoted params, is armed at
swap time through the engine's next-dispatch hook.

Telemetry: each round journals ``online.gate``; a promotion and a
rollback count and journal (``online.promoted`` with the swap's ms, both
with the tap's lineage of trace ids), record ``gate.promote`` /
``gate.rollback`` with ``lineage_n`` in the flight recorder's ring and
dump it (``promote`` / ``rollback``);
the first request served on promoted params sets
``online.time_to_serve``.  Fault point ``online.swap_mid_request``
(``model``) stalls the promotion ``seconds`` (0.25) before its swap,
so a drill lands the swap among requests in flight.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from veles_tpu_torch import events, faults, telemetry, trace

#: gate lifecycle states
GATE_STATES = ("filling", "training", "promoted", "rolled_back")


class PromotionGate:
    """One model's gate bookkeeping and the swap itself."""

    def __init__(self, model: str, residency: Any, margin: float,
                 min_steps: int) -> None:
        self.model = model
        self.residency = residency
        self.margin = float(margin)
        self.min_steps = max(1, int(min_steps))
        self.state = "filling"
        self.last_gate_step = 0
        self.cooldown_until_step = 0
        self.promotions = 0
        self.rollbacks = 0
        self.shadow_error_pct = None
        self.incumbent_error_pct = None
        #: monotonic time of the shadow's last step: the time-to-serve
        #: clock starts here
        self.last_step_ts = None
        self.time_to_serve_ms = None
        #: the last promotion's round (steps, both error %s) and the
        #: swap's host ms: what the reference journals
        self.last_promotion = None

    def due(self, steps: int) -> bool:
        """Is a gate round due after ``steps`` steps in all?"""
        return steps - self.last_gate_step >= self.min_steps \
            and steps >= self.cooldown_until_step

    def decide(self, steps: int, shadow_err: float,
               incumbent_err: float) -> str:
        """Record one gate round: "promote", "rollback" or
        "continue"."""
        self.last_gate_step = steps
        self.shadow_error_pct = shadow_err
        self.incumbent_error_pct = incumbent_err
        if incumbent_err - shadow_err >= self.margin:
            verdict = "promote"
        elif shadow_err - incumbent_err >= self.margin:
            verdict = "rollback"
        else:
            verdict = "continue"
        telemetry.event(events.EV_ONLINE_GATE, model=self.model,
                        steps=steps, shadow_error_pct=round(shadow_err, 4),
                        incumbent_error_pct=round(incumbent_err, 4),
                        margin=self.margin, verdict=verdict)
        return verdict

    def state_code(self) -> int:
        """The state's index in :data:`GATE_STATES` (a gauge's value)."""
        return GATE_STATES.index(self.state)

    def promote(self, stacked_params: Any, steps: int,
                lineage: Optional[List[str]] = None) -> None:
        """Hand the shadow's device tree to the serving engine.
        ``lineage`` (the tap's recent trace ids) journals with the
        promotion, so it traces back to the traffic that trained it."""
        f = faults.fire("online.swap_mid_request", model=self.model)
        if f:
            time.sleep(float(f.get("seconds", 0.25)))
        t0 = time.perf_counter()
        engine = self.residency.swap_params(self.model, stacked_params)
        self.last_promotion = {
            "steps": steps, "shadow_error_pct": self.shadow_error_pct,
            "incumbent_error_pct": self.incumbent_error_pct,
            "swap_ms": 1000.0 * (time.perf_counter() - t0)}
        last_step = self.last_step_ts

        def _first_served() -> None:
            if last_step is not None:
                dt = time.monotonic() - last_step
                self.time_to_serve_ms = round(1000.0 * dt, 3)
                telemetry.gauge(events.GAUGE_ONLINE_TIME_TO_SERVE).set(
                    round(dt, 6))

        engine.notify_next_dispatch(_first_served)
        self.promotions += 1
        self.state = "promoted"
        self.cooldown_until_step = steps + 4 * self.min_steps
        telemetry.counter(events.CTR_ONLINE_PROMOTIONS).inc()
        telemetry.event(events.EV_ONLINE_PROMOTED, model=self.model,
                        steps=steps, shadow_error_pct=self.shadow_error_pct,
                        incumbent_error_pct=self.incumbent_error_pct,
                        swap_ms=round(self.last_promotion["swap_ms"], 3),
                        lineage=list(lineage) if lineage else None)
        trace.record("gate.promote", model=self.model, steps=steps,
                     lineage_n=len(lineage) if lineage else 0)
        trace.dump("promote")

    def rollback(self, steps: int,
                 lineage: Optional[List[str]] = None) -> None:
        self.rollbacks += 1
        self.state = "rolled_back"
        self.cooldown_until_step = steps + 4 * self.min_steps
        telemetry.counter(events.CTR_ONLINE_ROLLBACKS).inc()
        telemetry.event(events.EV_ONLINE_ROLLBACK, model=self.model,
                        steps=steps, shadow_error_pct=self.shadow_error_pct,
                        incumbent_error_pct=self.incumbent_error_pct,
                        lineage=list(lineage) if lineage else None)
        trace.record("gate.rollback", model=self.model, steps=steps,
                     lineage_n=len(lineage) if lineage else 0)
        trace.dump("rollback")
