"""Device-resident multi-member inference: the serving engine.

Counterpart of the serving half of ``veles_tpu/ops/fused.py:
EnsembleEvalEngine``.  Every member's params are stacked along a
leading member axis and uploaded once; a prediction runs each member's
forward in the device's compute dtype (bf16 on CUDA) against the f32
stacked params and averages the member probabilities on the device in
f32, in a fixed order (``engine/core.py``).  The request-level API
(:meth:`attach_batcher` / :meth:`submit`) coalesces concurrent
requests into fixed-shape micro-batches; the residency manager spills
and restores the stacked params (:meth:`spill_params` /
:meth:`restore_params`).

Left for later slices: the resident-dataset scoring paths
(``attach_dataset``, ``error_pct*``), member sharding over a mesh, and
the online tier's param adoption.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch.engine import core as engine_core
from veles_tpu_torch.ops import batching


class EnsembleEvalEngine:
    def __init__(self, forwards: List[Any],
                 member_params: List[Dict[str, Dict[str, Any]]],
                 device: Any, compute_dtype: Optional[torch.dtype] = None
                 ) -> None:
        if not member_params:
            raise ValueError("empty ensemble")
        self.forwards = list(forwards)
        self.device = device
        self.n_members = len(member_params)
        self._check_members(member_params)
        self.compute_dtype = batching.resolve_compute_dtype(
            compute_dtype, device)
        self._params = batching.stack_member_params(
            self.forwards, member_params, device)
        #: device bytes of the stacked f32 params (the residency charge)
        self.param_bytes = batching.stacked_param_bytes(member_params)
        self._mean_probs = engine_core.build_mean_probs(
            self.forwards, self.n_members, self.compute_dtype)
        self._batcher = None
        self._count_lock = threading.Lock()
        #: serving dispatches answered (micro-batches, not requests)
        self.dispatches = 0

    def _check_members(self, member_params) -> None:
        """Every member must carry exactly the port-layout param shapes
        the (initialized) forward chain expects: a layout mix-up fails
        here, at load, not as a wrong answer."""
        for i, m in enumerate(member_params):
            for f in self.forwards:
                if f.input_shape is None:
                    continue
                want = {p: tuple(s) for p, s in
                        f.param_shapes(f.input_shape).items()}
                got = {p: tuple(np.shape(a))
                       for p, a in m.get(f.name, {}).items()}
                if got != want:
                    raise ValueError(
                        f"member {i}, {f.name}: params {got} do not "
                        f"match the forward chain's {want}")

    # -- streaming path ------------------------------------------------

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Mean member probabilities (f32) of a device batch."""
        params = self._params   # one read: a spill may land after it
        if params is None:
            raise RuntimeError("params are spilled; restore_params()")
        return self._mean_probs(params, x)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Mean member probabilities for a host batch."""
        xb = self.device.put(np.asarray(x, np.float32))
        return self.device.get(self.predict(xb))

    # -- request-level serving -----------------------------------------

    def attach_batcher(self, max_batch: int, max_wait_s: float,
                       label: str = "ensemble", sample_shape=None):
        """Arm :meth:`submit`: concurrent requests coalesce into ONE
        zero-padded dispatch of ``max_batch`` rows, flushed after
        ``max_wait_s`` at the latest."""
        from veles_tpu_torch.serve.batcher import MicroBatcher
        if self._batcher is None:
            self._batcher = MicroBatcher(
                self._serve_dispatch, max_batch=max_batch,
                max_wait_s=max_wait_s, label=label,
                sample_shape=sample_shape)
        return self._batcher

    @property
    def batcher(self):
        return self._batcher

    def submit(self, rows: np.ndarray, deadline_ms=None):
        """Enqueue one request; returns a Future of the mean member
        probabilities for exactly its rows."""
        if self._batcher is None:
            raise RuntimeError("attach_batcher() first")
        return self._batcher.submit(rows, deadline_ms=deadline_ms)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted request has resolved."""
        return self._batcher is None or self._batcher.drain(timeout)

    def _serve_dispatch(self, xb: np.ndarray) -> np.ndarray:
        """One fixed-shape dispatch (the batcher's flush callback)."""
        out = self.predict_proba(xb)
        with self._count_lock:
            self.dispatches += 1
        return out

    # -- residency -----------------------------------------------------

    def spill_params(self) -> None:
        """Drop the stacked device params (LRU spill); the host copies
        stay with the residency manager."""
        self._params = None

    def restore_params(self, member_params) -> None:
        self._params = batching.stack_member_params(
            self.forwards, member_params, self.device)

    @property
    def resident(self) -> bool:
        return self._params is not None

    @property
    def busy(self) -> bool:
        """Rows queued or in flight: such an engine is never spilled."""
        b = self._batcher
        return b is not None and b.pending_rows > 0

    def release(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        self._params = None
