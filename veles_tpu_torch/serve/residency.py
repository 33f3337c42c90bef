"""Multi-model device residency: budget accounting + LRU spill to host.

Counterpart of ``veles_tpu/serve/residency.py`` (``HostedModel`` and
the admission half of ``ResidencyManager``).  Each model's device cost
is known before upload (``batching.stacked_param_bytes``).  The budget
is ``budget_bytes``, else ``$VELES_HBM_BUDGET``, else half the card's
memory (the other half is left to activations and micro-batches), 8 GiB
on the CPU.
When admitting a model would overflow it, the least-recently-used
resident model that is not busy spills: its engine drops the stacked
params and the manager keeps the immutable host copies, so a later
request restores it with one upload.

The manager is also the process's device-memory ledger: named side
charges (:meth:`ResidencyManager.reserve`, each tagged with one of
:data:`POOLS`) count against the same budget the LRU reads: the online
tier's shadow params and its replay buffer.  A hive installs its
manager as the process arbiter (:func:`install_process_arbiter`).

The online promotion swaps a model's served params on the device
(:meth:`ResidencyManager.swap_params`) under the same lock the spill
decision takes, so a swap and a spill never interleave.

Telemetry, as the reference's: the ledger is published as the
``arbiter.*`` gauges (budget, resident bytes, one per pool: what
``veles_tpu/obs.py`` ``arbiter_ledger`` reads) and, for a manager that
hosts models, the ``serve.models_resident`` / ``serve.resident_bytes*``
gauges; loads, restores and spills journal, and spills count.

On a mesh replica (a ``MeshDevice``, ``--serve-models --mesh N``) the
budget is one place's and every charge is per place (the reference's
``residency.py:181-230``): a model is admitted member-sharded when
``$VELES_SERVE_MESH_SHARD`` says ``always``, or ``auto`` and its stack
is over one place's budget (:meth:`ResidencyManager._shard_members`),
and then costs its padded stack over N a place
(``EnsembleEvalEngine.param_bytes_per_device``), so a model that would
spill on one device serves resident.  The decision is taken once, at the
model's first admission, and a restore lands on the same placement.
``serve.mesh_devices`` is the replica's place count, and a sharded load
journals ``serve.model_sharded_resident`` and logs "member-sharded over
N devices".
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from veles_tpu_torch import events, knobs, telemetry
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.ops import batching

#: residency budget where the device reports no memory size (the CPU)
DEFAULT_BUDGET = 8 << 30

log = logging.getLogger("veles_tpu_torch.residency")

#: the ledger's pools: served model stacks (``serve``), training and
#: online-shadow state (``train``), GA cohort stacks (``cohort``), and
#: everything else (replay buffers: ``scratch``)
POOLS = ("serve", "train", "cohort", "scratch")


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
        #: places the replica's device owns (1 off a mesh): budgets and
        #: charges are per place, and ``total_memory`` is one place's
        self.n_devices = int(getattr(device, "n_devices", 1))
        self.budget_bytes = int(budget_bytes) if budget_bytes else (
            int(knobs.get(knobs.HBM_BUDGET)) or
            ((device is not None and device.total_memory())
             or 2 * DEFAULT_BUDGET) // 2)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.models: Dict[str, HostedModel] = {}
        #: guards the registry, victim selection and the promotion
        #: swap; blocking work (drain, upload) stays outside it
        self._lock = witness.lock("residency.state")
        #: side charges against the budget: name -> (bytes, pool)
        self.reserved: Dict[str, Tuple[int, str]] = {}
        self.spills = 0

    def register(self, model: HostedModel) -> None:
        with self._lock:
            if model.name in self.models:
                raise ValueError(f"duplicate model name {model.name!r}")
            self.models[model.name] = model

    def reserve(self, name: str, nbytes: int,
                pool: str = "scratch") -> None:
        """Charge (or re-charge) a named side allocation against the
        budget, tagged with its ledger ``pool``."""
        if pool not in POOLS:
            raise ValueError(f"unknown arbiter pool {pool!r} "
                             f"(declared: {POOLS})")
        with self._lock:
            self.reserved[name] = (int(nbytes), pool)
        self._update_gauges()

    def release(self, name: str) -> None:
        """Drop a named charge; an unknown name is a no-op."""
        with self._lock:
            self.reserved.pop(name, None)
        self._update_gauges()

    def ledger(self) -> Dict[str, int]:
        """Bytes per pool: ``serve`` holds the resident stacked models
        plus any serve-tagged charge, the others their charges."""
        with self._lock:
            reserved = list(self.reserved.values())
            model_bytes = sum(self._charge(m) for m in self.models.values()
                              if m.resident)
        out = {pool: 0 for pool in POOLS}
        out["serve"] = model_bytes
        for nbytes, pool in reserved:
            out[pool] += nbytes
        return out

    def _shard_members(self, m: HostedModel) -> bool:
        """The placement of ``m``'s stacked member axis: on a mesh
        replica ``$VELES_SERVE_MESH_SHARD`` ``always`` shards every
        model, ``never`` none, and ``auto`` exactly the models over ONE
        place's budget (what would spill, or be admitted over budget, on
        one device).  A built engine's placement is fixed."""
        live = getattr(m.engine, "member_sharded", None)
        if live is not None:
            return bool(live)
        if getattr(self.device, "mesh", None) is None or \
                self.n_devices < 2:
            return False
        from veles_tpu_torch.parallel.mesh import shard_mode
        mode = shard_mode(knobs.get(knobs.SERVE_MESH_SHARD))
        if mode == "never":
            return False
        return mode == "always" or m.param_bytes > self.budget_bytes

    def _charge(self, m: HostedModel) -> int:
        """``m``'s residency cost a place under its (decided or live)
        placement: the whole stack, or the padded stack over N when
        member-sharded."""
        live = getattr(m.engine, "param_bytes_per_device", None)
        if live is not None:
            return int(live)
        if self._shard_members(m):
            n, p = self.n_devices, len(m.member_params)
            return m.param_bytes // p * (-(-p // n) * n) // n
        return m.param_bytes

    def resident_bytes(self) -> int:
        """Resident stacked models (their charge a place) plus every side
        charge."""
        return sum(self._charge(m) for m in list(self.models.values())
                   if m.resident) + sum(
            v[0] for v in tuple(self.reserved.values()))

    def resident_count(self) -> int:
        return sum(1 for m in list(self.models.values()) if m.resident)

    def _update_gauges(self) -> None:
        led = self.ledger()
        telemetry.gauge(events.GAUGE_ARBITER_BUDGET_BYTES).set(
            self.budget_bytes)
        telemetry.gauge(events.GAUGE_ARBITER_RESIDENT_BYTES).set(
            sum(led.values()))
        for pool, nbytes in led.items():
            telemetry.gauge(f"arbiter.pool.{pool}.resident_bytes").set(
                nbytes)
        if not self.models:
            # a model-less arbiter: serve.* gauges from it would read as
            # a replica serving nothing
            return
        resident = self.resident_bytes()
        telemetry.gauge(events.GAUGE_SERVE_MODELS_RESIDENT).set(
            self.resident_count())
        telemetry.gauge(events.GAUGE_SERVE_RESIDENT_BYTES).set(resident)
        telemetry.gauge(events.GAUGE_SERVE_RESIDENT_BYTES_PER_DEVICE).set(
            resident)
        telemetry.gauge(events.GAUGE_SERVE_MESH_DEVICES).set(self.n_devices)

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
        t0 = time.perf_counter()
        if m.engine is None:
            from veles_tpu_torch.ops.fused import EnsembleEvalEngine
            engine = EnsembleEvalEngine(m.forwards, m.member_params,
                                        self.device,
                                        shard_members=self._shard_members(m))
            engine.attach_batcher(self.max_batch, self.max_wait_s,
                                  label=name,
                                  sample_shape=m.sample_shape)
            with self._lock:
                if m.engine is None:
                    m.engine = engine
            telemetry.event(events.EV_SERVE_MODEL_LOADED, model=name,
                            members=m.engine.n_members,
                            param_bytes=m.param_bytes,
                            seconds=round(time.perf_counter() - t0, 4))
            if m.engine.member_sharded:
                telemetry.event(
                    events.EV_SERVE_MODEL_SHARDED, model=name,
                    devices=self.n_devices, param_bytes=m.param_bytes,
                    per_device=m.engine.param_bytes_per_device)
                log.info("model %r member-sharded over %d devices: %.2f "
                         "MiB total, %.2f MiB/device, resident where a "
                         "single device would spill", name, self.n_devices,
                         m.param_bytes / (1 << 20),
                         m.engine.param_bytes_per_device / (1 << 20))
            log.info("model %r loaded: %d members, %.2f MiB stacked",
                     name, engine.n_members, m.param_bytes / (1 << 20))
        elif not m.resident:
            m.engine.restore_params(m.member_params)
            telemetry.event(events.EV_SERVE_MODEL_RESTORED, model=name,
                            param_bytes=m.param_bytes,
                            seconds=round(time.perf_counter() - t0, 4))
            log.info("model %r restored from host spill (%.2f MiB)",
                     name, m.param_bytes / (1 << 20))
        self._update_gauges()
        return m.engine

    def _pick_victim(self, incoming: HostedModel) -> tuple:
        """Under the lock: ``(victim, blocked)``, the least-recently-
        used resident, non-busy model to spill for ``incoming``.  A
        busy engine is never a victim: its flush thread still reads the
        params.  A model alone over the budget is admitted anyway.  The
        charge is taken after the placement decision: a member-sharded
        model needs its padded stack over N a place."""
        need = self._charge(incoming)
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

    def swap_params(self, name: str, stacked_params: Any):
        """The online promotion's swap: ``name``'s engine serves
        ``stacked_params`` (a device tree of its shapes) from its next
        dispatch on, under the lock spill decisions take: a concurrent
        :meth:`ensure` sees the model resident and leaves it alone, or
        picks its victim after the swap.  Returns the engine.
        RuntimeError when the model is not resident."""
        with self._lock:
            m = self.models[name]
            if m.engine is None or not m.resident:
                raise RuntimeError(
                    f"model {name!r} is not resident; cannot swap "
                    f"promoted params into a spilled engine")
            m.engine.adopt_stacked_params(stacked_params)
            m.last_used = time.monotonic()
            return m.engine

    def refresh_host_params(self, name: str,
                            member_params: List[Dict[str, Dict[
                                str, Any]]]) -> None:
        """Adopt new host member copies (port layout) after a
        promotion: what a later spill restores from."""
        with self._lock:
            self.models[name].member_params = member_params

    def _spill(self, m: HostedModel) -> None:
        # queued micro-batches dispatch while the params are still here
        m.engine.drain()
        m.engine.spill_params()
        self.spills += 1
        telemetry.counter(events.CTR_SERVE_SPILLS).inc()
        telemetry.event(events.EV_SERVE_MODEL_SPILLED, model=m.name,
                        param_bytes=m.param_bytes)
        self._update_gauges()
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


# -- the process-wide arbiter ----------------------------------------------
# One ResidencyManager per process is the device-memory ledger: a hive
# installs its model-hosting manager at startup; any other process gets
# a model-less one on first use.

_process_arbiter: Optional[ResidencyManager] = None
_arbiter_lock = witness.lock("residency.arbiter")


def tree_nbytes(tree: Any) -> int:
    """Bytes of the tensors in a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())


def charge(device: Any, key: str, nbytes: int, pool: str) -> None:
    """Charge ``nbytes`` under ``key`` to the process arbiter's ``pool``
    (a training runner's params and velocities, a GA cohort's stack), as
    the reference's engine cores do."""
    process_arbiter(device).reserve(f"{pool}:{key}", nbytes, pool=pool)


def install_process_arbiter(manager: ResidencyManager
                            ) -> ResidencyManager:
    """Make ``manager`` the process arbiter."""
    global _process_arbiter
    with _arbiter_lock:
        _process_arbiter = manager
    return manager


def process_arbiter(device: Any = None) -> ResidencyManager:
    """The process arbiter, created (model-less, on ``device``) on
    first use when none was installed."""
    global _process_arbiter
    with _arbiter_lock:
        if _process_arbiter is None:
            _process_arbiter = ResidencyManager(device)
        return _process_arbiter
