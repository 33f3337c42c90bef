"""The fused training step and device-resident multi-member inference.

Counterpart of ``veles_tpu/ops/fused.py``:

- :class:`FusedStepRunner` (resident single-device path): the whole
  training iteration per minibatch, gather the rows from the
  device-resident data set, forward in the compute dtype (bf16 on CUDA)
  against f32 master params, the evaluator's metrics on the f32 output,
  and on TRAIN the reverse walk of gradient units with the SGD update.
  One firing runs the loader's superstep of k same-class minibatches;
  ``[n_err, loss_sum, count]`` accumulate on the device and reach the
  host once per class end (:meth:`~FusedStepRunner.take_class_metrics`).
  The reference's ``lax.scan`` is a Python loop here.  Not ported:
  streaming, mesh and data-sharded placement, the confusion matrix,
  telemetry.
- :class:`EnsembleEvalEngine`, the serving half of the reference's
  class.  Every member's params are stacked along a leading member axis
  and uploaded once; a prediction runs each member's forward in the
  device's compute dtype against the f32 stacked params and averages
  the member probabilities on the device in f32, in a fixed order
  (``engine/core.py``).  The request-level API (:meth:`attach_batcher`
  / :meth:`submit`) coalesces concurrent requests into fixed-shape
  micro-batches; the residency manager spills and restores the stacked
  params (:meth:`spill_params` / :meth:`restore_params`).  Left for
  later slices: the resident-data set scoring paths (``attach_dataset``,
  ``error_pct*``), member sharding over a mesh, and the online tier's
  param adoption.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.engine import core as engine_core
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.ops import batching

#: the ``prng`` stream whose seed keys the per-layer dropout draws
RNG_STREAM = "fused"


class FusedStepRunner:
    def __init__(self, workflow: Any = None, loader: Any = None,
                 forwards: Optional[List[Any]] = None,
                 evaluator: Any = None, gds: Optional[List[Any]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 name: str = "fused_step") -> None:
        self.workflow = workflow
        self.name = name
        self.loader = loader
        self.forwards: List[Any] = forwards or []
        self.evaluator = evaluator
        #: gds[i] is the gradient unit of forwards[i] (None: frozen)
        self.gds: List[Any] = gds or []
        #: None = the device's policy (bf16 on CUDA, f32 on the CPU)
        self.compute_dtype = compute_dtype
        self.device = None
        self._host_params: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._opt: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._rng_counter = 0
        #: on-device [n_err, loss_sum, count] since the last class end
        self._acc: Optional[torch.Tensor] = None
        #: per-minibatch ABSOLUTE (weights, bias) rates, (k, n_gd, 2),
        #: written by LearningRateAdjust; None = the units' own rates
        self.lr_rates = None
        #: samples dispatched (mask sums), train and eval apart
        self.processed_images = 0.0
        self.processed_eval_images = 0.0

    def initialize(self, device: Any,
                   params: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Bind the device and the initial host params (port layout);
        they are uploaded at the first firing."""
        self.device = device
        self.compute_dtype = batching.resolve_compute_dtype(
            self.compute_dtype, device)
        self._host_params = params
        self._params = self._opt = None
        seed = prng.get(RNG_STREAM).seed
        self._ingest = engine_core.build_ingest(
            getattr(self.loader, "dequant", None))
        self._forward = engine_core.build_forward(
            self.forwards, seed, self.compute_dtype)
        self._backward = engine_core.build_backward(
            self.forwards, self.gds, self.compute_dtype)
        self._cast = batching.make_caster(self.compute_dtype)

    def _ensure_params(self) -> None:
        """f32 master params and zero velocities on the device."""
        if self._params is not None:
            return
        self._params = {fn: {pn: self.device.put(
            np.asarray(a, np.float32)) for pn, a in ps.items()}
            for fn, ps in self._host_params.items()}
        self._opt = {}
        for f, gd in zip(self.forwards, self.gds):
            if gd is not None and gd.gradient_moment:
                self._opt[gd.name] = {pn: torch.zeros_like(t) for pn, t in
                                      self._params[f.name].items()}

    def _lr_rows(self, k: int) -> List[List[List[float]]]:
        """This superstep's (k, n_gd, 2) rates, each rounded to f32 as the
        reference's scanned f32 array holds them."""
        if self.lr_rates is None:
            row = [[gd.learning_rate, gd.learning_rate_bias]
                   if gd is not None else [0.0, 0.0] for gd in self.gds]
            lr = np.broadcast_to(np.asarray(row, np.float32),
                                 (k, len(row), 2))
        else:
            lr = np.asarray(self.lr_rates, np.float32)
            if lr.shape[0] != k:
                raise ValueError(
                    f"lr_rates has {lr.shape[0]} rows but the superstep "
                    f"has {k} minibatches")
        return lr.tolist()

    @torch.no_grad()
    def run(self) -> None:
        """One firing: the loader's superstep of k same-class
        minibatches."""
        ld = self.loader
        self._ensure_params()
        dev = self.device
        if self._acc is None:
            self._acc = dev.zeros(3)
        indices = dev.put(ld.superstep_indices)
        mask = dev.put(ld.superstep_mask)
        k = indices.shape[0]
        train = ld.minibatch_class == TRAIN
        images = float(np.sum(ld.superstep_mask))
        if train:
            self.processed_images += images
            lr = self._lr_rows(k)
        else:
            self.processed_eval_images += images
            cparams = self._cast(self._params)
        data, labels = ld.original_data, ld.original_labels
        for j in range(k):
            x = self._ingest(data.index_select(0, indices[j]))
            target = labels.index_select(0, indices[j])
            if train:
                cparams = self._cast(self._params)
            out, residuals = self._forward(cparams, x,
                                           self._rng_counter + j, train)
            m = self.evaluator.metrics_fn(out.float(), target, mask[j])
            if train:
                self._params, self._opt = self._backward(
                    cparams, self._params, self._opt, residuals,
                    m["err_output"], lr[j])
            self._acc += torch.stack([m["n_err"], m["loss_sum"],
                                      m["count"]])
        self._rng_counter += k

    def take_class_metrics(self) -> Tuple[float, float, float]:
        """(n_err, loss_sum, count) accumulated since the last call: ONE
        small device fetch, then reset."""
        if self._acc is None:
            return 0.0, 0.0, 0.0
        acc = self.device.get(self._acc)
        self._acc = None
        return float(acc[0]), float(acc[1]), float(acc[2])

    def host_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Current params as host arrays (port layout); pass them through
        ``convert.params_to_jax`` for a members npz."""
        self._ensure_params()
        return {fn: {pn: self.device.get(t) for pn, t in ps.items()}
                for fn, ps in self._params.items()}

    def set_host_params(self, params) -> None:
        """Adopt host params (port layout); velocities stay as they are."""
        self._ensure_params()
        self._params = {fn: {pn: self.device.put(
            np.asarray(params[fn][pn], np.float32)) for pn in ps}
            for fn, ps in self._params.items()}


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
