"""Population-batched GA training: P genomes of one shape signature
trained as one cohort, every layer one kernel for all members.

Counterpart of ``veles_tpu/ops/fused.py:PopulationTrainEngine`` (re-
exported from ``ops/fused.py``).  The initial params of the workflow
(the same for every member: same seed, same shapes) are stacked P times
along a leading member axis, with the momentum buffers and the
``[n_err, loss_sum, count]`` accumulator; each member's (lr, bias lr)
and (wd, bias wd) become (P, n_gd, 2) arrays.  One member's functional
chain, built from ``engine/core.py``'s ``build_forward`` /
``build_backward`` as the fused step builds it, runs under
``torch.func.vmap``:

- on the member axis (``in_dims=0``): params, velocities, this
  minibatch's rates and the decays;
- broadcast (``None``): the minibatch's rows, targets and mask, gathered
  and ingested ONCE outside the member chain, so device memory holds
  params x P and never data x P;
- ``randomness="same"``: every member shares the genome run's seed, so
  dropout, binarization, CD-k and stochastic pooling draw exactly what
  a per-genome run draws.

Under ``vmap`` a dense layer's ``mm`` becomes one ``bmm``, a conv with
stacked weights one grouped convolution, and the LRN kernels fold the
member axis into their rows through their member rule
(``ops/lrn_cuda.py``): one launch per layer for all members.

The engine drives the workflow's OWN loader as the fused loop does (the
same supersteps, shuffle and ``rng_counter`` advance on every firing,
TEST firings skipped but counted), runs each member's base rates
through the workflow's ``LearningRateAdjust`` policy with its
epoch/iteration logic (:meth:`PopulationTrainEngine._member_lr`), and
keeps each member's ``min_valid`` / ``min_valid_epoch`` / ``complete``
bookkeeping of ``DecisionGD`` on the host, with one (P, 3) fetch per
class end.  A streaming loader's superstep is uploaded once through the
fused runner's pinned staging and broadcast over the members.  The
confusion matrix is not computed: the GA reads ``n_err`` only.

Member sharding (the reference's ``fused.py:1424-1500``): given a
``mesh`` of places (``parallel/mesh.py``) the member axis is padded to a
multiple of its N places by repeating member 0 and each place holds its
P/N members (``engine/core.py`` ``MemberPlacement``).  Each place runs
the same ``vmap`` chain over its tile; the minibatch is gathered and
ingested once and copied to each place, the draws are made once
(``prng.SharedDraws``) and copied, and the ``(P, 3)`` accumulator is
fetched tile by tile with the fillers' rows dropped before anything
reads them.  The LRN kernels' member rule folds a tile's members into
its rows: one launch a layer a place.  ``$VELES_MESH_SHARD_MEMBERS=
never`` keeps every member on the workflow's device.  The cohort's
stack is charged to the arbiter's cohort pool per device: the fullest
place's bytes.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch import events, faults, prng, telemetry
from veles_tpu_torch.engine import core as engine_core
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.ops import batching


class PopulationTrainEngine:
    """``PopulationTrainEngine(workflow, rates, decays).run()`` -> the
    (P,) fitness vector: each member's least validation ``n_err`` (train
    ``n_err`` without a validation split), the quantity
    ``launcher.workflow_fitness`` reads off a per-genome run.

    ``workflow`` is initialized for training (``initialize(device,
    train=True)``) and not run; ``rates`` and ``decays`` are (P, n_gd,
    2) ``[lr, lr_bias]`` / ``[wd, wd_bias]`` arrays.  Members that
    complete early stop updating their bookkeeping; their params train
    on until the whole cohort is done, as in the reference.  ``mesh``
    shards the members over its places."""

    def __init__(self, workflow: Any, member_rates: np.ndarray,
                 member_decays: np.ndarray, mesh: Any = None) -> None:
        fused = getattr(workflow, "fused", None)
        if fused is None or fused.device is None or not fused.has_params:
            raise ValueError("PopulationTrainEngine needs a workflow "
                             "initialized for training")
        self.workflow = workflow
        self.fused = fused
        self.loader = fused.loader
        self.forwards = list(fused.forwards)
        self.gds = list(fused.gds)
        self.evaluator = fused.evaluator
        self.decision = workflow.decision
        self.lr_adjust = getattr(workflow, "lr_adjust", None)
        self.device = fused.device
        self.compute_dtype = fused.compute_dtype
        self.streaming = bool(fused.streaming)
        rates = np.asarray(member_rates, np.float32)
        decays = np.asarray(member_decays, np.float32)
        n_gd = len(self.gds)
        if rates.shape != decays.shape or rates.ndim != 3 or \
                rates.shape[1:] != (n_gd, 2):
            raise ValueError(
                f"member hyperparameters must be (P, {n_gd}, 2) "
                f"[lr, lr_bias] / [wd, wd_bias] arrays; got "
                f"{rates.shape} / {decays.shape}")
        self.n_members = int(rates.shape[0])
        dev = self.device
        #: where the member axis lives: one tile on ``device``, or P/N a
        #: place over ``mesh``
        self.placement = engine_core.MemberPlacement(dev, self.n_members,
                                                     mesh)
        self.member_sharded = self.placement.sharded
        #: stacked member count, mesh padding included
        self._n_stacked = self.placement.n_stacked
        rates, decays = self.placement.pad(rates, decays)
        self._rates = rates
        #: per-place tiles of the decays, params and velocities
        self._wd = self.placement.put_members(decays)
        host = fused.host_params()
        self._tiles: Optional[List[Dict[str, Dict[str, torch.Tensor]]]] \
            = self.placement.stack(self.forwards, [host] * self.n_members)
        self._opt: Optional[List[Dict[str, Dict[str, torch.Tensor]]]] = [{
            gd.name: {pn: torch.zeros_like(t)
                      for pn, t in tile[f.name].items()}
            for f, gd in zip(self.forwards, self.gds)
            if gd is not None and gd.gradient_moment} for tile in self._tiles]
        self._rng_counter = 0
        self._la_iteration = 0
        #: (epoch, class, (P, 3) host metrics) of every class end, in
        #: order: what a per-genome run's decision history holds
        self.history: list = []
        #: the last run's wall seconds (ending in the last class end's
        #: fetch, which waits for the device) and its TRAIN and VALID
        #: minibatches
        self.seconds = 0.0
        self.minibatches = 0
        self._build()
        # the stacked params, velocities and decays: the cohort's device
        # footprint per device (the fullest place's), in the arbiter's
        # cohort pool
        from veles_tpu_torch.serve import residency
        pl = self.placement
        residency.charge(dev, "population", pl.tile_bytes(self._tiles) +
                         pl.tile_bytes(self._opt) + pl.tile_bytes(self._wd),
                         "cohort")

    def _build(self) -> None:
        from veles_tpu_torch.ops.fused import RNG_STREAM
        seed = prng.get(RNG_STREAM).seed
        cd = self.compute_dtype
        draws = prng.SharedDraws(self.device.device) \
            if self.member_sharded else None
        forward_pass = engine_core.build_forward(self.forwards, seed, cd,
                                                 draws=draws)
        backward_update = engine_core.build_backward(self.forwards,
                                                     self.gds, cd)
        cast = batching.make_caster(cd)
        metrics_fn = self.evaluator.metrics_fn

        def stats(m):
            return torch.stack([m["n_err"], m["loss_sum"], m["count"]])

        def member_train(params, opt, lrow, wd, x, target, mask, rc):
            # one member's train minibatch: the body of the fused step,
            # with this member's rates and decays as tensors
            cparams = cast(params)
            out, residuals = forward_pass(cparams, x, rc, True)
            m = metrics_fn(out.float(), target, mask)
            params, opt = backward_update(cparams, params, opt, residuals,
                                          m["err_output"], lrow, wd)
            return params, opt, stats(m)

        def member_eval(cparams, x, target, mask, rc):
            out, _ = forward_pass(cparams, x, rc, False)
            return stats(metrics_fn(out.float(), target, mask))

        def train_step(params, opt, lrow, wd, x, target, mask, rc):
            return torch.func.vmap(
                functools.partial(member_train, rc=rc),
                in_dims=(0, 0, 0, 0, None, None, None),
                randomness="same")(params, opt, lrow, wd, x, target, mask)

        def eval_step(cparams, x, target, mask, rc):
            return torch.func.vmap(
                functools.partial(member_eval, rc=rc),
                in_dims=(0, None, None, None),
                randomness="same")(cparams, x, target, mask)

        self._cast = cast
        self._train_step = train_step
        self._eval_step = eval_step

    # -- per-member learning-rate schedule ------------------------------

    def _member_lr(self, k: int) -> np.ndarray:
        """(P, k, n_gd, 2) absolute rates for this train firing: each
        member's bases through the workflow's lr policy with the
        epoch/iteration argument logic of ``LearningRateAdjust.run``."""
        P, n_gd = self._rates.shape[:2]
        la = self.lr_adjust
        if la is None:
            return np.ascontiguousarray(np.broadcast_to(
                self._rates[:, None], (P, k, n_gd, 2)))
        ld = self.loader
        e = ld.epoch_number
        ended = bool(ld.epoch_ended)

        def t_of(j: int) -> int:
            if la.by == "epoch":
                return e - 1 if (ended and j < k - 1) else e
            return self._la_iteration + j

        out = np.empty((P, k, n_gd, 2), np.float32)
        for j in range(k):
            t = t_of(j)
            for m in range(P):
                for gi in range(n_gd):
                    out[m, j, gi, 0] = la.policy(
                        float(self._rates[m, gi, 0]), t)
                    out[m, j, gi, 1] = la.policy(
                        float(self._rates[m, gi, 1]), t)
        self._la_iteration += k
        return out

    # -- the run loop ----------------------------------------------------

    def _minibatches(self, k: int, use_targets: bool):
        """The firing's k (x, target) pairs, one at a time, each ingested
        once for all members (and copied to each place by the caller):
        gathered from the resident set, or sliced from the streamed
        superstep, uploaded once."""
        ld = self.loader
        ingest = self.fused._ingest
        if self.streaming:
            xb, tb = self.fused._upload_superstep(k, use_targets)
            for j in range(k):
                yield ingest(xb[j]), tb[j]
            return
        indices = self.device.put(ld.superstep_indices)
        store = ld.original_targets if use_targets else ld.original_labels
        for j in range(k):
            target = store.index_select(0, indices[j])
            yield (ingest(ld.original_data.index_select(0, indices[j])),
                   target.float() if use_targets else target)

    @torch.no_grad()
    def run(self) -> np.ndarray:
        """Train the whole cohort; returns the (P,) fitness vector.  The
        run is the ``ga.cohort_train`` span (host seconds, journalled)
        and counts into ``ga.cohorts`` / ``ga.cohort_members``; fault
        point ``device.oom_on_put`` (``site=cohort``) raises the card's
        OOM before anything runs, which the GA evaluator answers by
        splitting the cohort."""
        with telemetry.span(events.SPAN_GA_COHORT_TRAIN, journal=True,
                            members=self.n_members):
            telemetry.counter(events.CTR_GA_COHORTS).inc()
            telemetry.counter(events.CTR_GA_COHORT_MEMBERS).inc(
                self.n_members)
            if faults.fire("device.oom_on_put", site="cohort",
                           members=self.n_members):
                raise torch.cuda.OutOfMemoryError(
                    "fault-injected OOM on the cohort dispatch")
            return self._run()

    def _run(self) -> np.ndarray:
        ld = self.loader
        dev = self.device
        dec = self.decision
        P = self.n_members
        pl = self.placement
        n_places = len(pl.places)
        max_epochs = dec.max_epochs
        fail_iters = dec.fail_iterations
        has_valid = ld.class_lengths[VALID] > 0
        use_targets = self.evaluator.wants_targets
        min_valid = np.full(P, np.inf)
        min_valid_epoch = np.full(P, -1, np.int64)
        min_train = np.full(P, np.inf)
        complete = np.zeros(P, bool)
        params, opt = list(self._tiles), list(self._opt)
        acc = pl.zeros_members((self._n_stacked, 3))
        self.minibatches = 0
        t0 = time.perf_counter()
        try:
            while not complete.all():
                ld.run()
                k = int(ld.superstep_indices.shape[0])
                klass = ld.minibatch_class
                if klass in (TRAIN, VALID):
                    masks = pl.put_replicated(dev.put(ld.superstep_mask))
                    batches = self._minibatches(k, use_targets)
                    self.minibatches += k
                if klass == TRAIN:
                    lr = pl.put_members(self._member_lr(k))
                    for j, (x, target) in enumerate(batches):
                        xs = pl.put_replicated(x)
                        ts = pl.put_replicated(target)
                        for p in range(n_places):
                            params[p], opt[p], s = self._train_step(
                                params[p], opt[p], lr[p][:, j],
                                self._wd[p], xs[p], ts[p], masks[p][j],
                                self._rng_counter + j)
                            acc[p] += s
                elif klass == VALID:
                    cparams = [self._cast(t) for t in params]
                    for j, (x, target) in enumerate(batches):
                        xs = pl.put_replicated(x)
                        ts = pl.put_replicated(target)
                        for p in range(n_places):
                            acc[p] += self._eval_step(
                                cparams[p], xs[p], ts[p], masks[p][j],
                                self._rng_counter + j)
                if self.streaming and klass in (TRAIN, VALID) and \
                        dev.platform == "cuda":
                    self.fused._stream_state.release()
                # TEST firings never feed fitness: no dispatch, but the
                # rng_counter advances as in the per-genome run
                self._rng_counter += k
                if not ld.class_ended:
                    continue
                # one (P, 3) fetch per class end, the fillers' rows
                # dropped
                a = pl.fetch_members(acc)
                acc = pl.zeros_members((self._n_stacked, 3))
                self.history.append((ld.epoch_number, int(klass), a))
                err = a[:, 0].astype(np.float64)
                live = ~complete
                if klass == VALID:
                    # DecisionGD.on_validation_ended, per member
                    better = live & (err < min_valid)
                    min_valid = np.where(better, err, min_valid)
                    min_valid_epoch = np.where(better, ld.epoch_number,
                                               min_valid_epoch)
                if klass == TRAIN:
                    if not has_valid:
                        better = live & (err < min_train)
                        min_train = np.where(better, err, min_train)
                    # DecisionGD.on_train_ended: the epoch already counts
                    # the one that ended
                    epoch = ld.epoch_number
                    if max_epochs is not None and epoch >= max_epochs:
                        complete[:] = True
                    if has_valid:
                        complete |= (min_valid_epoch >= 0) & \
                            (epoch - min_valid_epoch > fail_iters)
        finally:
            ld.stop()
        self.seconds = time.perf_counter() - t0
        self._tiles, self._opt = params, opt
        return min_valid if has_valid else min_train

    def member_params(self, i: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Member ``i``'s trained params as host arrays (port layout)."""
        p, j = self.placement.locate(i)
        return {fn: {pn: self.device.get(t[j]) for pn, t in ps.items()}
                for fn, ps in self._tiles[p].items()}

    def change_norms(self) -> np.ndarray:
        """(P, leaves) L2 norms of each real member's change from the
        params it started from (the workflow's, which the cohort leaves
        untrained), the leaves in tree order: how far each member moved,
        computed on each place, one small fetch."""
        norms = []
        for tile in self._tiles:
            cols = []
            for fn, ps in tile.items():
                start = self.fused.device_params(fn)
                for pn, t in ps.items():
                    cols.append((t - start[pn].to(t.device)).flatten(1)
                                .norm(dim=1))
            norms.append(torch.stack(cols, 1))
        return self.placement.fetch_members(norms)

    def release(self) -> None:
        """Drop the stacked device state: an evaluator lives across many
        cohorts, and device memory must not accumulate."""
        self._tiles = self._opt = self._wd = None

    @property
    def _params(self):
        """The member-stacked param tree of the real members (the
        reference's attribute, which ``genetics/handoff.py`` adopts
        from): off a mesh the one tile itself, member-sharded a copy
        gathered on the head place; None after :meth:`release`."""
        tiles = self._tiles
        return None if tiles is None else self.placement.gather_tree(tiles)

