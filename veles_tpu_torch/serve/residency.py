"""Multi-model device residency: budget accounting + LRU spill to host.

Counterpart of ``veles_tpu/serve/residency.py`` (``HostedModel`` and
the admission half of ``ResidencyManager``).  Each model's device cost
is known before upload (``batching.stacked_param_bytes``).  The budget
is half the card's memory (the other half is left to activations and
micro-batches), 8 GiB on the CPU, or an explicit ``budget_bytes``.
When admitting a model would overflow it, the least-recently-used
resident model that is not busy spills: its engine drops the stacked
params and the manager keeps the immutable host copies, so a later
request restores it with one upload.

Left out here: the process-wide arbiter ledger (reserve/release
pools), mesh placement, the online tier's param swap, and telemetry.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from veles_tpu_torch.ops import batching

#: residency budget where the device reports no memory size (the CPU)
DEFAULT_BUDGET = 8 << 30

log = logging.getLogger("veles_tpu_torch.residency")


class HostedModel:
    """One servable model: the forward chain, the immutable host member
    params (port layout), and its engine once admitted."""

    def __init__(self, name: str, forwards: List[Any],
                 member_params: List[Dict[str, Dict[str, Any]]],
                 meta: Optional[Dict[str, Any]] = None,
                 sample_shape=None) -> None:
        self.name = name
        self.forwards = list(forwards)
        self.member_params = member_params
        self.meta = dict(meta or {})
        self.sample_shape = tuple(sample_shape) if sample_shape \
            else None
        self.engine = None
        self.param_bytes = batching.stacked_param_bytes(member_params)
        self.last_used = 0.0

    @property
    def resident(self) -> bool:
        return self.engine is not None and self.engine.resident


class ResidencyManager:
    """Admit models under the device budget; spill the LRU one over it."""

    def __init__(self, device: Any, budget_bytes: Optional[int] = None,
                 max_batch: int = 64, max_wait_s: float = 0.005) -> None:
        self.device = device
        self.budget_bytes = int(budget_bytes) if budget_bytes else (
            (device.total_memory() or 2 * DEFAULT_BUDGET) // 2)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.models: Dict[str, HostedModel] = {}
        #: guards the registry and victim selection; blocking work
        #: (drain, upload) stays outside it
        self._lock = threading.Lock()
        self.spills = 0

    def register(self, model: HostedModel) -> None:
        with self._lock:
            if model.name in self.models:
                raise ValueError(f"duplicate model name {model.name!r}")
            self.models[model.name] = model

    def resident_bytes(self) -> int:
        return sum(m.param_bytes for m in list(self.models.values())
                   if m.resident)

    def ensure(self, name: str):
        """Return ``name``'s ready engine, admitting (or restoring) it
        under the budget first.  KeyError for an unknown name."""
        wait_deadline = None
        while True:
            with self._lock:
                m = self.models[name]
                m.last_used = time.monotonic()
                if m.resident:
                    return m.engine
                victim, blocked = self._pick_victim(m)
            if victim is not None:
                self._spill(victim)
                continue
            if not blocked:
                break
            # over budget but every candidate is mid-flight: wait a
            # little for one to go quiet, then admit over budget
            now = time.monotonic()
            if wait_deadline is None:
                wait_deadline = now + 2.0
            if now >= wait_deadline:
                break
            time.sleep(0.002)
        if m.engine is None:
            from veles_tpu_torch.ops.fused import EnsembleEvalEngine
            engine = EnsembleEvalEngine(m.forwards, m.member_params,
                                        self.device)
            engine.attach_batcher(self.max_batch, self.max_wait_s,
                                  label=name,
                                  sample_shape=m.sample_shape)
            with self._lock:
                if m.engine is None:
                    m.engine = engine
            log.info("model %r loaded: %d members, %.2f MiB stacked",
                     name, engine.n_members, m.param_bytes / (1 << 20))
        elif not m.resident:
            m.engine.restore_params(m.member_params)
            log.info("model %r restored from host spill (%.2f MiB)",
                     name, m.param_bytes / (1 << 20))
        return m.engine

    def _pick_victim(self, incoming: HostedModel) -> tuple:
        """Under the lock: ``(victim, blocked)``, the least-recently-
        used resident, non-busy model to spill for ``incoming``.  A
        busy engine is never a victim: its flush thread still reads the
        params.  A model alone over the budget is admitted anyway."""
        need = incoming.param_bytes
        if need > self.budget_bytes:
            log.warning("model %r needs %d bytes, over the residency "
                        "budget (%d): admitting it alone",
                        incoming.name, need, self.budget_bytes)
        if self.resident_bytes() + need <= self.budget_bytes:
            return None, False
        candidates = [m for m in self.models.values()
                      if m.resident and m is not incoming]
        victims = [m for m in candidates if not m.engine.busy]
        if not victims:
            return None, bool(candidates)
        return min(victims, key=lambda m: m.last_used), False

    def _spill(self, m: HostedModel) -> None:
        # queued micro-batches dispatch while the params are still here
        m.engine.drain()
        m.engine.spill_params()
        self.spills += 1
        log.info("model %r spilled to host (LRU, freeing %.2f MiB)",
                 m.name, m.param_bytes / (1 << 20))

    def drain_all(self, timeout: float = 30.0) -> bool:
        """Drain every model's batcher (the SIGTERM path)."""
        ok = True
        for m in self.models.values():
            if m.engine is not None:
                ok = m.engine.drain(timeout) and ok
        return ok

    def close(self) -> None:
        for m in self.models.values():
            if m.engine is not None:
                m.engine.release()
                m.engine = None
