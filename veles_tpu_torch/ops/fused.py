"""The fused training step and device-resident multi-member inference.

Counterpart of ``veles_tpu/ops/fused.py``:

- :class:`FusedStepRunner` (single device): the whole training
  iteration per minibatch: its rows, forward in the compute dtype (bf16
  on CUDA) against f32 master params, the evaluator's metrics on the
  f32 output, and on TRAIN the reverse walk of gradient units with the
  SGD update.  One firing runs the loader's superstep of k same-class
  minibatches; ``[n_err, loss_sum, count]`` and, for an evaluator
  with ``compute_confusion``, the (n, n) int32 confusion matrix (each
  valid row's 1 added at ``(target, max_idx)``, the reference's
  ``conf.at[target, max_idx].add(mask)``) accumulate on the device and
  reach the host once per class end
  (:meth:`~FusedStepRunner.take_class_metrics`).  The reference's
  ``lax.scan`` is a Python loop here.  The evaluator's target is the
  minibatch's labels, or, for an evaluator with ``wants_targets``
  (``EvaluatorMSE``), its regression targets in f32 (the target store,
  gathered by the same indices).

  - Resident: the rows and targets are gathered from the
    device-resident data set.
  - Streaming (the loader is not device-resident): the loader's
    host-assembled superstep, already in the compute dtype (or as
    stored, when not floating), with its labels or f32 targets, is
    copied up and minibatch j is ``batch[j]``
    (:meth:`_upload_superstep`).  On CUDA it goes through
    one of two pinned staging buffers, allocated once, on a copy stream
    of its own; the compute stream waits on the copy's event, and a
    staging buffer is refilled only once the firing that last used it
    has finished on the device, so at most two supersteps are in
    flight.  A failed pin or copy raises.  On the
    CPU the batch is used as it is.
  - A quantized loader (``loader.dequant``): the uint8 rows, gathered
    on the device or streamed, go through ``engine/core.py``'s
    ``build_ingest`` prologue (``q.float() * scale + bias`` in f32)
    before the forward's cast to the compute dtype.

  A snapshot pickles the runner with its params, velocities and partial
  class metrics (the confusion matrix among them) as host arrays, its
  dropout counter and its counters; ``initialize`` rebuilds the chains
  and re-binds the device.  :meth:`~FusedStepRunner.set_host_params`
  may change a layer's param shapes (``ResizableAll2All.resize``): the
  layer's momentum buffers are then reshaped as the reference's
  ``reconcile_velocities`` does, and :meth:`~FusedStepRunner.
  invalidate_trace` rebuilds the chains.  Telemetry, as the
  reference's: each firing's host submission seconds (never a device
  wait) into ``fused.<kind>_dispatch_seconds``, the first firing of a
  kind apart (``fused.first_<kind>_dispatch_seconds`` and the
  ``fused.first_dispatch`` event); ``fused.dispatches``,
  ``fused.minibatches``, ``fused.<kind>_images`` / ``_seconds``; the
  streamed wire bytes and staging seconds; and at :meth:`stop` the
  delivered images/s and MFU (``fused.summary``).  A streamed upload
  that runs out of card memory (or fault point ``device.oom_on_put``,
  ``site=stream``) waits for the in-flight firings and retries once.

  Under data parallelism (``group``, set by ``parallel.DataParallel``)
  each rank takes its columns ``[lo, hi)`` of every (k, mb) superstep:
  its indices (resident), its assembled slice (streamed) or its columns
  of the whole superstep's rows assembled by the row-sharded gather
  (``loader.shard_resident``).  The evaluator divides the error seed by
  the global minibatch's valid rows, ``build_backward`` sums each
  layer's gradients over the group before its update, the first firing
  broadcasts rank 0's params and velocities, and the class metrics are
  summed over the group where a class end reads them.  Each rank
  launches the LRN kernels on its slice.
- :class:`EnsembleEvalEngine`, the serving half of the reference's
  class.  Every member's params are stacked along a leading member axis
  and uploaded once; a prediction runs each member's forward in the
  device's compute dtype against the f32 stacked params and averages
  the member probabilities on the device in f32, in a fixed order
  (``engine/core.py``).  The request-level API (:meth:`attach_batcher`
  / :meth:`submit`) coalesces concurrent requests into fixed-shape
  micro-batches; the residency manager spills and restores the stacked
  params (:meth:`spill_params` / :meth:`restore_params`).  Scoring:
  :meth:`~EnsembleEvalEngine.error_pct` runs a host split through in
  fixed-size chunks (the last one zero-padded and masked) with a
  ``[wrong, count]`` f32 carry on the device, fetched once at the end;
  :meth:`~EnsembleEvalEngine.attach_dataset` uploads a split once, and
  ``predict_proba_resident`` / ``error_pct_resident`` gather its rows on
  the device by index.  The online tier reads the live stacked tree
  (:attr:`~EnsembleEvalEngine.stacked_params`) and replaces it in one
  attribute store (:meth:`~EnsembleEvalEngine.adopt_stacked_params`,
  through ``ResidencyManager.swap_params``): a dispatch reads the tree
  once, so it answers wholly from the old params or wholly from the
  new.  :meth:`~EnsembleEvalEngine.notify_next_dispatch` arms a
  one-shot hook fired after the next serving dispatch.
  :meth:`~EnsembleEvalEngine.warm_up` runs one dispatch of zeros at the
  serving shape before a hive's hello, so cuDNN's first use lands
  there and not in a client's request; it counts apart
  (``warmup_dispatches``, ``warmup_seconds``) and only it sets the
  first-dispatch gauge.  Scoring and host predictions count into
  ``ensemble.*``.  ``shard_members=True`` on a ``MeshDevice`` (the
  reference's ``fused.py:870-930``) pads the members to a multiple of
  the mesh's N places by repeating member 0 and keeps place p's P/N on
  place p (``engine/core.py`` ``MemberPlacement``): the request rows are
  copied to each place, each real member runs on its place, and the
  head place adds them in the fixed order; ``param_bytes_per_device``
  is the padded stack over N, the residency charge.  On a mesh,
  ``attach_dataset(shard=)`` row-shards the split over the places
  (``MeshDevice.put_sharded``; ``"auto"`` by ``$VELES_MESH_SHARD_DATA``
  against ``$VELES_MAX_RESIDENT_BYTES``) and the resident paths gather
  through ``batching.make_mesh_row_gather``, bitwise the replicated
  gather's rows.
- :class:`PopulationTrainEngine` (``ops/population.py``): P genomes
  trained as one cohort under ``torch.func.vmap``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import events, faults, prng, profiling, telemetry
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.engine import core as engine_core
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.ops import batching

#: the ``prng`` stream whose seed keys the per-layer dropout draws
RNG_STREAM = "fused"

log = logging.getLogger("veles_tpu_torch.fused")


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
        #: on-device [n_err, loss_sum, count] since the last class end,
        #: and the (n, n) int32 confusion matrix (None: not wanted)
        self._acc: Optional[torch.Tensor] = None
        self._conf: Optional[torch.Tensor] = None
        #: per-minibatch ABSOLUTE (weights, bias) rates, (k, n_gd, 2),
        #: written by LearningRateAdjust; None = the units' own rates
        self.lr_rates = None
        #: samples dispatched (mask sums), train and eval apart
        self.processed_images = 0.0
        self.processed_eval_images = 0.0
        #: True when the runner came from a snapshot with its params
        self.restored = False
        self.streaming = False
        #: bytes streamed host -> device (data, and labels or targets),
        #: and the host seconds spent staging and queueing those copies
        self.stream_transfer_bytes = 0
        self.stream_transfer_seconds = 0.0
        self._host_opt: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self._acc_carry: Optional[np.ndarray] = None
        self._conf_carry: Optional[np.ndarray] = None
        self._stream_state = None
        #: streamed uploads retried after a device OOM
        self.stream_oom_retries = 0
        self._first_run_ts: Optional[float] = None
        self._dispatch_seen: set = set()
        #: the data-parallel group (``parallel.DataParallel.install``)
        #: and this rank's (lo, hi, global minibatch); None: one device
        self.group = None
        self._rows: Optional[Tuple[int, int, int]] = None
        self._sharded_gather = None

    #: rebuilt by initialize, never pickled
    _unpicklable = ("device", "_params", "_opt", "_acc", "_conf", "_ingest",
                    "_forward", "_backward", "_cast", "_stream_state",
                    "_first_run_ts", "_dispatch_seen", "group", "_rows",
                    "_sharded_gather")

    def _to_host(self, d: dict) -> None:
        """Write the live device state into ``d`` as host arrays: params,
        velocities and the partial class metrics (a stop may land in the
        middle of a class)."""
        if self._params is not None:
            d["_host_params"] = self.host_params()
            d["_host_opt"] = {g: {p: self.device.get(t)
                                  for p, t in ps.items()}
                              for g, ps in self._opt.items()}
        if self._acc is not None:
            d["_acc_carry"] = self.device.get(self._acc)
            d["_conf_carry"] = None if self._conf is None else \
                self.device.get(self._conf)

    def __getstate__(self) -> dict:
        d = dict(self.__dict__)
        self._to_host(d)
        for key in self._unpicklable:
            d.pop(key, None)
        return d

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("_conf_carry", None)
        self.__dict__.setdefault("stream_oom_retries", 0)
        for key in self._unpicklable:
            self.__dict__[key] = None
        self._dispatch_seen = set()
        self.restored = self._host_params is not None

    def initialize(self, device: Any,
                   params: Optional[Dict[str, Dict[str, np.ndarray]]] = None
                   ) -> None:
        """Bind the device and the initial host params (port layout),
        which are uploaded at the first firing.  ``params=None`` keeps
        what a snapshot restored: params, velocities and the partial
        class metrics."""
        if params is not None:
            self._host_params, self._host_opt = params, None
            self._acc_carry = self._conf_carry = None
        else:
            self._to_host(self.__dict__)
            if self._host_params is None:
                raise ValueError(f"{self.name}: no params to start from")
        self.device = device
        self.compute_dtype = batching.resolve_compute_dtype(
            self.compute_dtype, device)
        self._params = self._opt = self._acc = self._conf = None
        self._stream_state = None
        self._bind_group()
        self.streaming = not getattr(self.loader, "device_resident", True)
        if self.streaming and getattr(self.loader, "dequant", None) is None:
            # the forward's first op is this cast: doing it on the host
            # halves the bytes that cross PCIe in bf16
            self.loader.stream_dtype = self.compute_dtype
        self._ingest = engine_core.build_ingest(
            getattr(self.loader, "dequant", None), device)
        self._build_chains()

    def _bind_group(self) -> None:
        """Under data parallelism: check the STATIC minibatch
        (``max_minibatch_size``, which clamps below ``minibatch_size``
        when every class is smaller) against the group's size, take this
        rank's rows, keep a restored partial class's metrics on rank 0
        only (they are the whole group's: every rank sums them at the
        class end), and build the row-sharded gather."""
        self._rows = self._sharded_gather = None
        group = self.group
        if group is None:
            return
        mb = self.loader.max_minibatch_size
        if mb % group.world_size:
            raise ValueError(
                f"static minibatch shape {mb} (loader max_minibatch_size) "
                f"not divisible by the {group.world_size}-rank group; "
                f"lower minibatch_size or pad the data set")
        self._rows = group.rows(mb) + (mb,)
        if group.rank != 0:
            self._acc_carry = self._conf_carry = None
        if getattr(self.loader, "shard_resident", False):
            rows = len(self.loader.original_data)
            self._sharded_gather = batching.make_sharded_row_gather(group,
                                                                    rows)

    def _build_chains(self) -> None:
        seed = prng.get(RNG_STREAM).seed
        self._forward = engine_core.build_forward(
            self.forwards, seed, self.compute_dtype, rows=self._rows)
        self._backward = engine_core.build_backward(
            self.forwards, self.gds, self.compute_dtype, group=self.group)
        self._cast = batching.make_caster(self.compute_dtype)

    def invalidate_trace(self) -> None:
        """Rebuild the forward and backward chains after a param shape
        changed (the counterpart of the reference's
        ``invalidate_trace``; eager chains hold no shapes, so the params
        and velocities on the device stay)."""
        self._build_chains()

    @property
    def has_params(self) -> bool:
        """True once :meth:`initialize` gave the runner params."""
        return self._params is not None or self._host_params is not None

    def _want_confusion(self) -> bool:
        ev = self.evaluator
        return bool(getattr(ev, "compute_confusion", False)) and \
            getattr(ev, "n_classes", None) is not None

    def _ensure_params(self) -> None:
        """f32 master params on the device, and the velocities: the
        restored ones, else zeros."""
        if self._params is not None:
            return
        self._params = {fn: {pn: self.device.put(
            np.asarray(a, np.float32)) for pn, a in ps.items()}
            for fn, ps in self._host_params.items()}
        self._opt = {}
        for f, gd in zip(self.forwards, self.gds):
            if gd is None or not gd.gradient_moment:
                continue
            if self._host_opt is not None:
                self._opt[gd.name] = {pn: self.device.put(a) for pn, a in
                                      self._host_opt[gd.name].items()}
            else:
                self._opt[gd.name] = {pn: torch.zeros_like(t) for pn, t in
                                      self._params[f.name].items()}
        self._host_params = self._host_opt = None
        if self.group is not None:
            # every rank starts from rank 0's params and velocities
            for tree in (self._params, self._opt):
                for ps in tree.values():
                    for t in ps.values():
                        self.group.broadcast_(t)
        # params and velocities are this runner's device footprint: the
        # arbiter's train pool
        from veles_tpu_torch.serve import residency
        residency.charge(self.device, self.name,
                         residency.tree_nbytes(self._params) +
                         residency.tree_nbytes(self._opt), "train")

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
        self._materialize_acc()
        rows = self._rows
        mask_host = ld.superstep_mask
        n_total = None
        if rows is not None:
            # the error seed's denominator: the global minibatch's rows
            n_total = dev.put(mask_host.sum(axis=1, dtype=np.float32))
            mask_host = mask_host[:, rows[0]:rows[1]]
        mask = dev.put(mask_host)
        k = mask.shape[0]
        train = ld.minibatch_class == TRAIN
        images = float(np.sum(mask_host))
        if train:
            self.processed_images += images
            lr = self._lr_rows(k)
        else:
            self.processed_eval_images += images
            cparams = self._cast(self._params)
        if self._first_run_ts is None:
            self._first_run_ts = time.monotonic()
        t0 = time.perf_counter()
        use_targets = self.evaluator.wants_targets
        if self.streaming:
            xb, tb = self._upload_superstep(k, use_targets)
        elif self._sharded_gather is not None:
            xb, tb = self._gather_sharded(use_targets)
        else:
            idx = ld.superstep_indices
            indices = dev.put(idx if rows is None
                              else idx[:, rows[0]:rows[1]])
            data = ld.original_data
            store = ld.original_targets if use_targets else \
                ld.original_labels
        for j in range(k):
            if self.streaming or self._sharded_gather is not None:
                x, target = self._ingest(xb[j]), tb[j]
                if use_targets:
                    target = target.float()
            else:
                x = self._ingest(data.index_select(0, indices[j]))
                target = store.index_select(0, indices[j])
                if use_targets:
                    target = target.float()
            if train:
                cparams = self._cast(self._params)
            out, residuals = self._forward(cparams, x,
                                           self._rng_counter + j, train)
            m = self.evaluator.metrics_fn(
                out.float(), target, mask[j],
                *(() if n_total is None else (n_total[j],)))
            if train:
                self._params, self._opt = self._backward(
                    cparams, self._params, self._opt, residuals,
                    m["err_output"], lr[j])
            self._acc += torch.stack([m["n_err"], m["loss_sum"],
                                      m["count"]])
            if self._conf is not None:
                # a scatter-add into the flat (n, n) matrix:
                # index_put_(accumulate=True) would check its indices'
                # range on the host, a device sync every minibatch
                n = self._conf.shape[0]
                self._conf.view(-1).index_add_(
                    0, target * n + m["max_idx"], mask[j].to(torch.int32))
        self._rng_counter += k
        if self.streaming and dev.platform == "cuda":
            # the staging buffer of this firing is free again once the
            # device has run everything queued so far
            self._stream_state.release()
        self._record_dispatch("train" if train else "eval",
                              time.perf_counter() - t0, k, images)

    def _record_dispatch(self, kind: str, dt: float, k: int,
                         images: float) -> None:
        """One firing's host submission seconds (the device may still
        be running it).  The first firing of each kind meets cuDNN's
        first use and goes to a gauge and the journal, not the
        steady-state histogram."""
        if not telemetry.enabled():
            return
        if kind not in self._dispatch_seen:
            self._dispatch_seen.add(kind)
            telemetry.gauge(f"fused.first_{kind}_dispatch_seconds").set(dt)
            telemetry.event(events.EV_FUSED_FIRST_DISPATCH, kind=kind,
                            seconds=round(dt, 4),
                            streaming=bool(self.streaming))
        else:
            telemetry.histogram(f"fused.{kind}_dispatch_seconds").record(dt)
        telemetry.counter(events.CTR_FUSED_DISPATCHES).inc()
        telemetry.counter(f"fused.{kind}_seconds").inc(dt)
        telemetry.counter(events.CTR_FUSED_MINIBATCHES).inc(k)
        telemetry.counter(f"fused.{kind}_images").inc(images)

    def stop(self) -> None:
        """The end of a run: the delivered-rate summary."""
        self._record_telemetry_summary()

    def _record_telemetry_summary(self) -> None:
        """Train images/s over the host's clock since the first firing
        (the run's delivered rate, host gaps included), the analytic
        GFLOPs an image and, where the card's peak is known, the MFU."""
        if self._first_run_ts is None or not telemetry.enabled():
            return
        elapsed = time.monotonic() - self._first_run_ts
        self._first_run_ts = None   # stop() may run more than once
        images = self.processed_images
        if elapsed <= 0 or images <= 0:
            return
        rate = images / elapsed
        telemetry.gauge(events.GAUGE_FUSED_TRAIN_IMAGES_PER_SEC_WALL).set(
            round(rate, 3))
        try:
            flops = profiling.model_flops_per_sample(self.forwards)["train"]
            telemetry.gauge(events.GAUGE_FUSED_TRAIN_GFLOPS_PER_IMAGE).set(
                round(flops / 1e9, 4))
            u = profiling.mfu(rate, flops, self.device)
            if u is not None:
                telemetry.gauge(events.GAUGE_FUSED_MFU).set(round(u, 5))
            telemetry.event(
                events.EV_FUSED_SUMMARY, images=images,
                images_per_sec_wall=round(rate, 2),
                mfu=round(u, 5) if u is not None else None,
                streaming=bool(self.streaming))
        except Exception:  # noqa: BLE001 — the summary is best-effort
            log.exception("telemetry summary failed")

    def _upload_superstep(self, k: int, use_targets: bool):
        """The loader's host superstep as device tensors ((k, mb, ...)
        data, and (k, mb) labels or (k, mb, ...) f32 targets)."""
        ld = self.loader
        xb = ld.superstep_data
        tb = ld.superstep_targets if use_targets else ld.superstep_labels
        if xb is None or tb is None or len(xb) != k:
            raise RuntimeError(
                f"{self.name}: streaming, but the loader assembled no "
                f"superstep of {k} minibatches "
                f"({'targets' if use_targets else 'labels'} included)")
        n_wire = xb.numel() * xb.element_size() + \
            tb.numel() * tb.element_size()
        self.stream_transfer_bytes += n_wire
        telemetry.counter(events.CTR_FUSED_STREAM_TRANSFER_BYTES).inc(n_wire)
        t0 = time.perf_counter()
        for attempt in (1, 2):
            try:
                if faults.fire("device.oom_on_put", site="stream"):
                    raise torch.cuda.OutOfMemoryError(
                        "fault-injected OOM on the streaming upload")
                if self.device.platform == "cuda":
                    if self._stream_state is None:
                        self._stream_state = _StagedUpload(
                            self.device.device, ld.superstep, xb, tb)
                    xb, tb = self._stream_state.upload(xb, tb)
                break
            except torch.cuda.OutOfMemoryError as e:
                # the firings in flight still hold their uploads: wait
                # for them and retry once, then give up
                if attempt == 2:
                    raise
                log.warning("%s: the streaming upload hit device OOM (%s);"
                            " draining the firings in flight and retrying "
                            "once", self.name, e)
                self.stream_oom_retries += 1
                telemetry.counter(events.CTR_FUSED_STREAM_OOM_RETRIES).inc()
                telemetry.event(events.EV_DEVICE_OOM_RETRY, site="stream")
                if self.device.platform == "cuda":
                    torch.cuda.synchronize(self.device.device)
        dt = time.perf_counter() - t0
        self.stream_transfer_seconds += dt
        telemetry.counter(events.CTR_FUSED_STREAM_TRANSFER_SECONDS).inc(dt)
        return xb, tb

    def _gather_sharded(self, use_targets: bool):
        """This rank's (k, mb/N, ...) rows and labels or targets of the
        superstep, from the row-sharded resident set: the whole
        superstep's rows assembled by the sharded gather (one
        ``all_reduce`` a store), then this rank's columns."""
        ld = self.loader
        idx = ld.superstep_indices
        k, mb = idx.shape
        lo, hi, _ = self._rows
        data = ld.original_data
        store = ld.original_targets if use_targets else ld.original_labels
        stores = [data] if store is data else [data, store]
        got = self._sharded_gather(self.device.put(idx.reshape(-1)),
                                   *stores)
        x, t = got[0], got[-1]
        return (x.reshape((k, mb) + tuple(x.shape[1:]))[:, lo:hi],
                t.reshape((k, mb) + tuple(t.shape[1:]))[:, lo:hi])

    def reduce_partial_metrics(self) -> None:
        """Sum a partial class's metrics over the group in place (every
        rank then holds the whole group's): before a coordinated stop's
        snapshot, which rank 0 writes."""
        if self.group is not None and self._acc is not None:
            self.group.all_reduce_(self._acc)
            if self._conf is not None:
                self.group.all_reduce_(self._conf)

    def last_copy_ms(self) -> Optional[float]:
        """Device ms of the last streamed superstep's host-to-device
        copy (CUDA only; waits for it)."""
        st = self._stream_state
        return None if st is None else st.last_copy_ms()

    def take_class_metrics(self) -> Tuple[float, float, float,
                                          Optional[np.ndarray]]:
        """(n_err, loss_sum, count, confusion) accumulated since the last
        call, then reset: the metrics and the (n, n) int32 confusion
        matrix (None when the evaluator computes none) fetched once.
        Under data parallelism they are summed over the group first, on
        every rank at the same class end."""
        if self.group is not None:
            self._materialize_acc()
            self.reduce_partial_metrics()
        if self._acc is None:
            acc, conf = self._acc_carry, self._conf_carry
            self._acc_carry = self._conf_carry = None
            if acc is None:
                return 0.0, 0.0, 0.0, None
        else:
            acc = self.device.get(self._acc)
            conf = None if self._conf is None else \
                self.device.get(self._conf)
        self._acc = self._conf = None
        return float(acc[0]), float(acc[1]), float(acc[2]), conf

    def _materialize_acc(self) -> None:
        """The class's metrics on the device, from a restored carry or
        zeros (a firing accumulates into them; a group's class end sums
        them, on every rank)."""
        if self._acc is not None:
            return
        dev = self.device
        self._acc = dev.zeros(3) if self._acc_carry is None else \
            dev.put(self._acc_carry)
        if self._want_confusion():
            n = self.evaluator.n_classes
            self._conf = dev.zeros((n, n), torch.int32) \
                if self._conf_carry is None else dev.put(self._conf_carry)
        self._acc_carry = self._conf_carry = None

    def host_params(self, names=None) -> Dict[str, Dict[str, np.ndarray]]:
        """Current params as host arrays (port layout), of every forward
        or of the forwards ``names``; pass them through
        ``convert.params_to_jax`` for a members npz."""
        self._ensure_params()
        return {fn: {pn: self.device.get(t) for pn, t in ps.items()}
                for fn, ps in self._params.items()
                if names is None or fn in names}

    def device_params(self, name: str) -> Dict[str, torch.Tensor]:
        """Forward ``name``'s live f32 master params on the device (no
        copy): what stacks the DBN's stages without a host visit."""
        self._ensure_params()
        return dict(self._params[name])

    def set_host_params(self, params) -> None:
        """Adopt host params (port layout).  Velocities stay as they
        are, unless a param changed shape: its momentum buffer is then
        reshaped, the overlap keeping its history and new entries
        starting at zero (the reference's ``reconcile_velocities``)."""
        self._ensure_params()
        self._params = {fn: {pn: self.device.put(
            np.asarray(params[fn][pn], np.float32)) for pn in ps}
            for fn, ps in self._params.items()}
        for f, gd in zip(self.forwards, self.gds):
            if gd is None or gd.name not in self._opt:
                continue
            vel = self._opt[gd.name]
            for pn, p in self._params[f.name].items():
                v = vel[pn]
                if v.shape == p.shape:
                    continue
                new = torch.zeros_like(p)
                overlap = tuple(slice(0, min(a, b))
                                for a, b in zip(v.shape, p.shape))
                new[overlap] = v[overlap]
                vel[pn] = new


class _StagedUpload:
    """The CUDA side of the streaming firing: two pinned staging buffers
    (data, and labels or targets, each in the dtype and per-minibatch
    shape of the first superstep's), allocated once for up to ``k``
    minibatches, a copy stream, and per buffer the event after which it
    may be refilled."""

    def __init__(self, device: torch.device, k: int, xb: torch.Tensor,
                 tb: torch.Tensor) -> None:
        self.device = device
        self.staging = [tuple(
            torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                        pin_memory=True) for t in (xb, tb))
            for _ in range(2)]
        self.copy_stream = torch.cuda.Stream(device)
        self.released: List[Optional[torch.cuda.Event]] = [None, None]
        self.slot = 0
        self._copy_events = None

    def upload(self, xb: torch.Tensor, tb: torch.Tensor):
        i = self.slot
        if self.released[i] is not None:
            # the firing that last read this buffer's copy is done
            self.released[i].synchronize()
        xs, ts = self.staging[i]
        k = len(xb)
        xs, ts = xs[:k], ts[:k]
        xs.copy_(xb)
        ts.copy_(tb)
        compute = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record()
            xd = xs.to(self.device, non_blocking=True)
            td = ts.to(self.device, non_blocking=True)
            done.record()
        compute.wait_event(done)
        # allocated on the copy stream, read on the compute stream
        xd.record_stream(compute)
        td.record_stream(compute)
        self._copy_events = (start, done)
        return xd, td

    def release(self) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.released[self.slot] = ev
        self.slot ^= 1

    def last_copy_ms(self) -> Optional[float]:
        if self._copy_events is None:
            return None
        start, done = self._copy_events
        done.synchronize()
        return start.elapsed_time(done)


class EnsembleEvalEngine:
    def __init__(self, forwards: List[Any],
                 member_params: List[Dict[str, Dict[str, Any]]],
                 device: Any, compute_dtype: Optional[torch.dtype] = None,
                 shard_members: bool = False) -> None:
        if not member_params:
            raise ValueError("empty ensemble")
        mesh = getattr(device, "mesh", None)
        if shard_members and (mesh is None or mesh.size < 2):
            raise ValueError("shard_members needs a mesh device "
                             "(MeshDevice) of at least 2 places")
        self.forwards = list(forwards)
        self.device = device
        self.n_members = len(member_params)
        self._check_members(member_params)
        self.compute_dtype = batching.resolve_compute_dtype(
            compute_dtype, device)
        #: True: the stacked member axis is split P/N over the device's
        #: mesh of places, and a model over one place's budget serves
        #: resident at padded/N bytes a place instead of spilling
        self.member_sharded = bool(shard_members)
        self._placement = engine_core.MemberPlacement(
            device, self.n_members, mesh if shard_members else None,
            knob=False)
        #: stacked member count, mesh padding included
        self._n_stacked = self._placement.n_stacked
        #: the per-place tiles of the stacked params (one tile off a
        #: mesh); None while spilled
        self._tiles = self._placement.stack(self.forwards, member_params)
        #: device bytes of the stacked f32 params of the real members
        self.param_bytes = batching.stacked_param_bytes(member_params)
        #: the residency charge a device: the padded stack over N places
        #: when member-sharded, the whole stack otherwise
        self.param_bytes_per_device = self.param_bytes \
            // self.n_members * self._n_stacked // len(
                self._placement.places)
        self._mean_probs = engine_core.build_mean_probs(
            self.forwards, self.n_members, self.compute_dtype,
            self._placement.places)
        self._batcher = None
        #: the attached evaluation split (attach_dataset): a tensor, or
        #: its per-place row tiles when row-sharded
        self._dataset: Any = None
        self._labels: Any = None
        #: real rows of the attached split (the tiles are padded)
        self._dataset_rows = 0
        self._dataset_sharded = False
        self._gather = None
        # a lock of the port only: the reference counts dispatches in
        # its jitted path's Python wrapper without one
        self._count_lock = witness.lock("fused.count")
        #: serving dispatches answered (micro-batches, not requests)
        self.dispatches = 0
        #: warm-up dispatches (:meth:`warm_up`) and their seconds, apart
        self.warmup_dispatches = 0
        self.warmup_seconds = 0.0
        #: True once a dispatch (a warm-up's included) set the
        #: first-dispatch gauge
        self._first_seen = False
        #: the one-shot hook of :meth:`notify_next_dispatch`
        self._on_next_dispatch = None

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
        tiles = self._tiles   # one read: a spill may land after it
        if tiles is None:
            raise RuntimeError("params are spilled; restore_params()")
        return self._mean_probs(tiles, x)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Mean member probabilities for a host batch."""
        t0 = time.perf_counter()
        out = self._predict_host(x)
        self._record_chunks(events.HIST_ENSEMBLE_DISPATCH_SECONDS,
                            time.perf_counter() - t0, 1, len(out))
        return out

    def _predict_host(self, x: np.ndarray) -> np.ndarray:
        xb = self.device.put(np.asarray(x, np.float32))
        return self.device.get(self.predict(xb))

    def _record_chunks(self, hist: str, dt: float, chunks: int,
                       images: int) -> None:
        """A fetched prediction or scoring pass: its wall seconds (the
        fetch at its end is the sync) and its chunks and images."""
        if not telemetry.enabled():
            return
        telemetry.histogram(hist).record(dt)
        telemetry.counter(events.CTR_ENSEMBLE_CHUNKS).inc(chunks)
        telemetry.counter(events.CTR_ENSEMBLE_SECONDS).inc(dt)
        telemetry.counter(events.CTR_ENSEMBLE_IMAGES).inc(images)
        telemetry.counter(events.CTR_ENSEMBLE_MEMBER_IMAGES).inc(
            images * self.n_members)

    def _score(self, acc: torch.Tensor, x: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``acc + [wrong, count]`` of one masked chunk, on the device."""
        pred = self.predict(x).argmax(-1)
        wrong = ((pred != labels).to(torch.float32) * mask).sum()
        return acc + torch.stack([wrong, mask.sum()])

    def error_pct(self, x: np.ndarray, labels: np.ndarray,
                  chunk: int = 256) -> float:
        """Classification error % of the averaged ensemble over a host
        split, in fixed-size chunks (one giant batch would hold every
        member's activations of the whole split at once)."""
        x = np.asarray(x, np.float32)
        labels = np.asarray(labels, np.int64)
        chunk = max(1, min(chunk, len(x)))
        dev = self.device
        t0 = time.perf_counter()
        acc = dev.zeros(2)
        for i in range(0, len(x), chunk):
            xb, lb, mask = batching.pad_chunk(x[i:i + chunk],
                                              labels[i:i + chunk], chunk)
            acc = self._score(acc, dev.put(xb), dev.put(lb), dev.put(mask))
        acc = dev.get(acc)
        self._record_chunks(events.HIST_ENSEMBLE_SCORE_SECONDS,
                            time.perf_counter() - t0,
                            -(-len(x) // chunk), len(x))
        return 100.0 * float(acc[0]) / max(float(acc[1]), 1.0)

    # -- resident path -------------------------------------------------

    def attach_dataset(self, x: np.ndarray,
                       labels: Optional[np.ndarray] = None,
                       shard: Any = "auto") -> None:
        """Upload an evaluation split once; the ``*_resident`` methods
        gather its rows on the device by index.  On a mesh device
        ``shard=True`` row-shards it over the places (1/N of the rows a
        place), ``False`` keeps it whole on the head place, and
        ``"auto"`` shards by ``$VELES_MESH_SHARD_DATA`` against
        ``$VELES_MAX_RESIDENT_BYTES`` (``parallel.mesh.shard_rows``)."""
        from veles_tpu_torch.parallel.mesh import shard_rows
        x = np.asarray(x, np.float32)
        labels = None if labels is None else np.asarray(labels, np.int64)
        mesh = getattr(self.device, "mesh", None)
        if mesh is None or mesh.size < 2:
            sharded = False
        elif shard == "auto":
            sharded = shard_rows(x.nbytes)
        else:
            sharded = bool(shard)
        self._dataset_rows = len(x)
        self._dataset_sharded = sharded
        put = self.device.put_sharded if sharded else self.device.put
        self._dataset = put(x)
        self._labels = None if labels is None else put(labels)
        self._gather = batching.make_mesh_row_gather(
            mesh.places, len(self._dataset[0])) if sharded else None

    def _attached_rows(self, idx: torch.Tensor, *stores) -> list:
        """Rows ``idx`` of each attached store, on the head place."""
        if self._gather is not None:
            return self._gather(idx, *stores)
        return [s.index_select(0, idx) for s in stores]

    def predict_proba_resident(self, indices) -> np.ndarray:
        """Mean member probabilities of the attached rows ``indices``."""
        if self._dataset is None:
            raise RuntimeError("attach_dataset() first")
        t0 = time.perf_counter()
        idx = self.device.put(np.asarray(indices, np.int64))
        out = self.device.get(self.predict(
            self._attached_rows(idx, self._dataset)[0]))
        self._record_chunks(events.HIST_ENSEMBLE_DISPATCH_SECONDS,
                            time.perf_counter() - t0, 1, len(out))
        return out

    def error_pct_resident(self, n: Optional[int] = None,
                           chunk: int = 256) -> float:
        """Error % over the first ``n`` attached rows (default: all),
        gathered on the device: no pixel crosses PCIe per call."""
        if self._dataset is None or self._labels is None:
            raise RuntimeError("attach_dataset(x, labels) first")
        total = self._dataset_rows if n is None else int(n)
        chunk = max(1, min(chunk, total))
        dev = self.device
        t0 = time.perf_counter()
        acc = dev.zeros(2)
        for i in range(0, total, chunk):
            idx, mask = batching.padded_index_chunk(
                i, min(i + chunk, total), chunk)
            x, labels = self._attached_rows(dev.put(idx), self._dataset,
                                            self._labels)
            acc = self._score(acc, x, labels, dev.put(mask))
        acc = dev.get(acc)
        self._record_chunks(events.HIST_ENSEMBLE_SCORE_SECONDS,
                            time.perf_counter() - t0, -(-total // chunk),
                            total)
        return 100.0 * float(acc[0]) / max(float(acc[1]), 1.0)

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

    def submit(self, rows: np.ndarray, deadline_ms=None, ctx=None):
        """Enqueue one request; returns a Future of the mean member
        probabilities for exactly its rows.  ``ctx`` (a
        :class:`veles_tpu_torch.trace.TraceContext`) rides through, so
        the batcher attributes queue wait and dispatch to the request's
        trace."""
        if self._batcher is None:
            raise RuntimeError("attach_batcher() first")
        return self._batcher.submit(rows, deadline_ms=deadline_ms,
                                    ctx=ctx)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted request has resolved."""
        return self._batcher is None or self._batcher.drain(timeout)

    def _claim_first(self) -> bool:
        """Under the count lock: True for the first dispatch this engine
        ran, cuDNN's first use and the kernels' first launch."""
        if self._first_seen:
            return False
        self._first_seen = True
        return True

    @staticmethod
    def _record_first(dt: float, rows: int) -> None:
        """The first dispatch's gauge, counter and event (outside the
        count lock: telemetry takes its own locks)."""
        telemetry.counter(events.CTR_SERVE_COMPILES).inc()
        telemetry.gauge(events.GAUGE_SERVE_FIRST_DISPATCH_SECONDS).set(
            round(dt, 4))
        telemetry.event(events.EV_SERVE_FIRST_DISPATCH, rows=rows,
                        seconds=round(dt, 4))

    def warm_up(self, rows: int, sample_shape=None) -> float:
        """One dispatch of ``rows`` rows of zeros (the serving shape:
        ``sample_shape``, else the first forward's), answers discarded:
        what a hive runs for each resident model before its hello.  It
        counts only in ``warmup_dispatches`` and ``warmup_seconds`` (and,
        being the first, sets the first-dispatch gauge).  Returns its
        seconds."""
        shape = sample_shape or self.forwards[0].input_shape[1:]
        t0 = time.perf_counter()
        self._predict_host(np.zeros((rows,) + tuple(shape), np.float32))
        dt = time.perf_counter() - t0
        with self._count_lock:
            self.warmup_dispatches += 1
            self.warmup_seconds += dt
            first = self._claim_first()
        if first:
            self._record_first(dt, rows)
        return dt

    def _serve_dispatch(self, xb: np.ndarray) -> np.ndarray:
        """One fixed-shape dispatch (the batcher's flush callback).  The
        engine's first (cuDNN's first use and the kernels' first launch
        land in it; a hive's warm-up takes it) goes to the
        ``serve.first_dispatch_seconds`` gauge, every later one to the
        ``serve.dispatch_seconds`` histogram the fleet reads, as in the
        reference."""
        t0 = time.perf_counter()
        out = self._predict_host(xb)
        dt = time.perf_counter() - t0
        with self._count_lock:
            first = self._claim_first()
            self.dispatches += 1
            cb, self._on_next_dispatch = self._on_next_dispatch, None
        if first:
            self._record_first(dt, int(xb.shape[0]))
        else:
            telemetry.histogram(events.HIST_SERVE_DISPATCH_SECONDS).record(
                dt)
        telemetry.counter(events.CTR_SERVE_MEMBER_ROWS).inc(
            int(xb.shape[0]) * self.n_members)
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a probe must never fail
                # the dispatch it observed
                log.exception("next-dispatch hook failed")
        return out

    # -- residency -----------------------------------------------------

    def spill_params(self) -> None:
        """Drop the stacked device params (LRU spill); the host copies
        stay with the residency manager."""
        self._tiles = None

    def restore_params(self, member_params) -> None:
        """Upload the host member copies again, on the same placement."""
        self._tiles = self._placement.stack(self.forwards, member_params)

    @property
    def stacked_params(self):
        """The live member-stacked param tree of the real members (None
        while spilled): off a mesh the one tile itself, member-sharded
        a copy gathered on the head place."""
        tiles = self._tiles
        return None if tiles is None else self._placement.gather_tree(tiles)

    def adopt_stacked_params(self, stacked) -> None:
        """Serve ``stacked``, a device tree of the same structure and
        shapes, from the next dispatch on: one attribute store, so a
        dispatch that already read the old tree finishes on it.  The
        tree holds the real members; a member-sharded engine tiles it
        over its places, padded by repeating the tree's first member
        (the reference's handoff padding).  Callers go through
        ``ResidencyManager.swap_params``, which orders this against
        spill decisions."""
        self._tiles = self._placement.tile_tree(stacked)

    def notify_next_dispatch(self, callback) -> None:
        """Arm a one-shot hook fired right after the next serving
        dispatch completes (the online tier's time-to-serve clock)."""
        with self._count_lock:
            self._on_next_dispatch = callback

    @property
    def resident(self) -> bool:
        return self._tiles is not None

    @property
    def busy(self) -> bool:
        """Rows queued or in flight: such an engine is never spilled."""
        b = self._batcher
        return b is not None and b.pending_rows > 0

    def release(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        self._tiles = self._dataset = self._labels = None


from veles_tpu_torch.ops.population import PopulationTrainEngine  # noqa: E402,F401
