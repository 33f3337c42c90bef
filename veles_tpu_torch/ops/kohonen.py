"""The Kohonen self-organizing map: its math and its two units.

Counterpart of ``veles_tpu/ops/kohonen.py`` (``grid_coords``,
``som_step_masked``, ``som_qe_masked``, ``KohonenForward``,
``KohonenTrainer``).  Unsupervised: there is no gradient chain; the
trainer IS the weight update.  The SOM computes in f32 on every device,
as the reference does.

- :func:`som_step_masked`: one minibatch's update of the ``(N, D)``
  prototypes on an ``sx * sy`` grid, winners by ``argmin`` of the
  squared distances, a gaussian neighbourhood of radius ``sigma`` around
  each winner, the step ``alpha * (h^T x - h.sum * w) / max(mask.sum(),
  1)``; padded rows (mask 0) are out of the sums and the quantization
  error.  :func:`som_qe_masked` is the evaluation classes' body.
- :class:`KohonenForward` holds the map's shape; its ``(N, D)`` weights
  are drawn from the ``"weights"`` stream as ``uniform(-0.1, 0.1)``,
  bitwise the reference's, and :meth:`KohonenForward.apply_fwd` returns
  the ``(B, N)`` squared distances.
- :class:`KohonenTrainer` owns the weights on the device and the
  schedule: alpha and sigma decay exponentially from ``alpha0`` /
  ``sigma0`` (default ``max(sx, sy) / 2``) to ``alpha_min`` /
  ``sigma_min`` over ``decay_epochs``.  One firing runs the loader's
  whole group of ``k`` minibatches on the device (``engine/core.py``'s
  SOM builders, the reference's fused path, which is the port's only
  one) and sums the group's quantization error and row count in f32 in
  step order; a TRAIN group updates the weights, an evaluation group
  only measures.  :meth:`KohonenTrainer.take_class_metrics` hands
  ``DecisionGD`` the class's ``(0, qe_sum, count, None)``, the contract of
  ``FusedStepRunner.take_class_metrics``.  With a ``mesh`` set before
  ``initialize`` (the reference's ``trainer.mesh``), a resident data set
  that ``$VELES_MESH_SHARD_DATA`` shards is held row-sharded over its
  places, and each group gathers its rows through
  ``batching.make_mesh_row_gather`` (the reference's
  ``kohonen.py:366-371``): bitwise the replicated gather's rows.

- :class:`SOMPopulationEngine`: P hyperparameter genomes ``(alpha0,
  alpha_min, sigma0, sigma_min)`` over one map shape and its initial
  weights, stacked on a leading member axis and trained as one cohort:
  the group builders of ``engine/core.py`` run under
  ``torch.func.vmap`` with the weights and each member's (k,) alpha and
  sigma rows on the member axis and the data broadcast, so the device
  holds prototypes x P, never data x P.  On a mesh the members shard P/N
  a place (``engine/core.py`` ``MemberPlacement``).

Telemetry: each trainer firing counts into ``som.fused_dispatches`` /
``som.fused_images``; a cohort's run is the ``som.cohort_train`` span
and counts into ``som.cohorts`` / ``som.cohort_members``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import events, prng, telemetry
from veles_tpu_torch.engine import core as engine_core
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.ops import batching


def grid_coords(sx: int, sy: int) -> np.ndarray:
    """(N, 2) f32 (y, x) grid coordinates of the N = sx * sy neurons,
    row-major over y."""
    ys, xs = np.meshgrid(np.arange(sy), np.arange(sx), indexing="ij")
    return np.stack([ys.reshape(-1), xs.reshape(-1)], 1).astype(np.float32)


def sq_distances(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distances of the (B, D) rows to the (N, D)
    prototypes, in the reference's expanded form."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * x @ weights.T
            + (weights * weights).sum(1)[None, :])


def som_step_masked(weights: torch.Tensor, x: torch.Tensor,
                    coords: torch.Tensor, alpha: torch.Tensor,
                    sigma: torch.Tensor, mask: torch.Tensor):
    """One masked SOM update.  ``weights`` (N, D), ``x`` (B, D),
    ``coords`` (N, 2), ``alpha`` and ``sigma`` f32 scalars, ``mask``
    (B,).  Returns ``(new_weights, winners, qe_sum, n_valid)``."""
    d2 = sq_distances(weights, x)
    winners = d2.argmin(1)
    qe_sum = (torch.sqrt(torch.clamp(
        d2.gather(1, winners[:, None])[:, 0], min=0.0)) * mask).sum()
    wc = coords[winners]
    gd2 = ((wc[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    h = torch.exp(-gd2 / (2.0 * sigma * sigma)) * mask[:, None]
    num = h.T @ x
    den = h.sum(0)[:, None]
    n = torch.clamp(mask.sum(), min=1.0)
    delta = alpha * (num - den * weights) / n
    return weights + delta, winners, qe_sum, mask.sum()


def som_qe_masked(weights: torch.Tensor, x: torch.Tensor,
                  mask: torch.Tensor):
    """One minibatch's masked quantization error (the sum of
    ``sqrt(min distance)`` over valid rows) and its valid-row count."""
    d2 = sq_distances(weights, x)
    qe = (torch.sqrt(torch.clamp(d2.min(1).values, min=0.0)) * mask).sum()
    return qe, mask.sum()


class KohonenForward:
    """The map: its shape, its initial weights, and the distances of a
    batch to every prototype (the SOM's serving op)."""

    #: no draws in the forward
    stochastic = False

    def __init__(self, workflow: Any = None, shape: Tuple[int, int] = (8, 8),
                 name: str = "kohonen_fwd") -> None:
        self.workflow = workflow
        self.name = name
        self.sy, self.sx = shape
        self.input_shape: Optional[Tuple[int, ...]] = None
        self.output_shape: Optional[Tuple[int, ...]] = None

    @property
    def n_neurons(self) -> int:
        return self.sx * self.sy

    def initialize(self, input_shape: Tuple[int, ...]) -> None:
        self.input_shape = tuple(input_shape)
        self.output_shape = (self.input_shape[0], self.n_neurons)

    def param_shapes(self, input_shape) -> dict:
        return {"weights": (self.n_neurons,
                            int(np.prod(input_shape[1:])))}

    def fill_params(self) -> dict:
        """The reference's draw: ``uniform(-0.1, 0.1)`` of (N, D) from
        the ``"weights"`` stream, in f32."""
        gen = prng.get("weights").numpy
        shape = self.param_shapes(self.input_shape)["weights"]
        return {"weights": gen.uniform(-0.1, 0.1, shape).astype(np.float32)}

    def apply_fwd(self, params, x: torch.Tensor, rng=None, train=False):
        """(B, ...) samples -> ((B, N) squared distances, no residual)."""
        return sq_distances(params["weights"],
                            x.reshape(x.shape[0], -1)), None


class KohonenTrainer:
    def __init__(self, workflow: Any = None,
                 forward: Optional[KohonenForward] = None,
                 name: str = "kohonen_trainer", alpha0: float = 0.3,
                 alpha_min: float = 0.01, sigma0: Optional[float] = None,
                 sigma_min: float = 0.5, decay_epochs: int = 20) -> None:
        self.workflow = workflow
        self.name = name
        self.forward = forward
        self.alpha0, self.alpha_min = alpha0, alpha_min
        self.sigma0 = sigma0
        self.sigma_min = sigma_min
        self.decay_epochs = decay_epochs
        self.loader = None
        self.device = None
        #: the (N, D) f32 prototypes on the device
        self.weights: Optional[torch.Tensor] = None
        #: on-device [qe_sum, count] since the last class end
        self._acc: Optional[torch.Tensor] = None
        #: samples dispatched (mask sums), train and eval apart
        self.processed_images = 0.0
        self.processed_eval_images = 0.0
        #: SOM steps run (train minibatches)
        self.steps = 0
        self._train_epoch = self._eval_epoch = None
        #: a mesh of places (``parallel/mesh.py``) for the row-sharded
        #: resident data set, set before :meth:`initialize`
        self.mesh = None
        #: the data set's per-place row tiles, when row-sharded
        self._data_tiles: Optional[List[torch.Tensor]] = None

    def initialize(self, device: Any, weights: np.ndarray) -> None:
        """Bind the device, put the initial host ``weights`` there, and
        build the group's step chains for the loader's residency (the
        data set row-sharded over ``mesh`` where the knob says so)."""
        f = self.forward
        self.device = device
        if self.sigma0 is None:
            self.sigma0 = max(f.sx, f.sy) / 2.0
        self.weights = device.put(np.asarray(weights, np.float32))
        self._acc = None
        coords = device.put(grid_coords(f.sx, f.sy))
        ld = self.loader
        resident = ld.device_resident
        gather = None
        self._data_tiles = None
        if resident and self.mesh is not None and self.mesh.size > 1:
            from veles_tpu_torch.parallel.mesh import (row_tile,
                                                       shard_rows)
            host = device.get(ld.original_data)
            if shard_rows(host.nbytes):
                n = self.mesh.size
                self._data_tiles = [
                    device.put(row_tile(host, r, n), to=place)
                    for r, place in enumerate(self.mesh.places)]
                gather = batching.make_mesh_row_gather(
                    self.mesh.places, len(self._data_tiles[0]))
        self._train_epoch = engine_core.build_som_epoch(coords, resident,
                                                        gather)
        self._eval_epoch = engine_core.build_som_eval(resident, gather)

    def schedule_at(self, epoch: int) -> Tuple[float, float]:
        t = min(epoch, self.decay_epochs) / max(self.decay_epochs, 1)
        alpha = self.alpha0 * (self.alpha_min / self.alpha0) ** t
        sigma = self.sigma0 * (self.sigma_min / self.sigma0) ** t
        return alpha, sigma

    def schedule_steps(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The (k,) f32 (alpha, sigma) rows of this group.  The loader
        raises ``epoch_number`` inside the firing that emits an epoch's
        last minibatch, so the reference's steps 0..k-2 of that group
        train at the old epoch's (alpha, sigma) and only the last step
        at the new epoch's; this reproduces it."""
        ld = self.loader
        e = ld.epoch_number
        ended = bool(ld.epoch_ended)
        a_bulk, s_bulk = self.schedule_at(e - 1 if ended else e)
        alphas = np.full((k,), a_bulk, np.float32)
        sigmas = np.full((k,), s_bulk, np.float32)
        if ended:
            alphas[k - 1], sigmas[k - 1] = self.schedule_at(e)
        return alphas, sigmas

    @torch.no_grad()
    def run(self) -> None:
        """One firing: the loader's group of k same-class minibatches."""
        ld = self.loader
        dev = self.device
        mask_host = ld.superstep_mask
        k = len(mask_host)
        mask = dev.put(mask_host)
        if ld.device_resident:
            data = self._data_tiles if self._data_tiles is not None \
                else ld.original_data
            rows = (data, dev.put(ld.superstep_indices))
        else:
            rows = (ld.superstep_data.to(dev.device),)
        n = float(np.sum(mask_host))
        if ld.minibatch_class == TRAIN:
            alphas, sigmas = self.schedule_steps(k)
            self.weights, stats = self._train_epoch(
                self.weights, dev.put(alphas), dev.put(sigmas), *rows, mask)
            self.processed_images += n
            self.steps += k
        else:
            stats = self._eval_epoch(self.weights, *rows, mask)
            self.processed_eval_images += n
        self._acc = stats if self._acc is None else self._acc + stats
        telemetry.counter(events.CTR_SOM_FUSED_DISPATCHES).inc()
        telemetry.counter(events.CTR_SOM_FUSED_IMAGES).inc(int(n))

    def take_class_metrics(self) -> Tuple[float, float, float, None]:
        """(n_err = 0, qe_sum, count, no confusion) since the last call:
        one small device fetch, then reset."""
        if self._acc is None:
            return 0.0, 0.0, 0.0, None
        acc = self.device.get(self._acc)
        self._acc = None
        return 0.0, float(acc[0]), float(acc[1]), None

    def host_weights(self) -> np.ndarray:
        return self.device.get(self.weights)


class SOMPopulationEngine:
    """``SOMPopulationEngine(workflow, hparams).run()`` -> the (P,)
    fitness vector: each member's least per-epoch mean quantization
    error, on the validation class when the loader has one, else on
    train: what a per-member run's decision history reads.

    ``workflow`` is a Kohonen workflow initialized for training and not
    run; ``hparams`` a (P, 4) ``[alpha0, alpha_min, sigma0, sigma_min]``
    array.  The engine drives the workflow's own loader to
    ``decision.max_epochs``; each member's schedule is the trainer's
    exponential decay with its own four values, and its per-step epoch
    logic (``KohonenTrainer.schedule_steps``).  The trained maps stay in
    ``weights`` ((P, N, D) on the device) until :meth:`release`.

    On a ``mesh`` the member axis shards P/N a place as the supervised
    cohort's does (``engine/core.py`` ``MemberPlacement``: padded by
    repeating member 0, the fillers' rows dropped from every fetch; the
    reference's ``kohonen.py:484-500``): each place runs the vmapped
    group over its tile, the rows gathered once and copied to every
    place.  ``weights`` is then the real members' maps gathered on the
    head place."""

    def __init__(self, workflow: Any, member_hparams: np.ndarray,
                 mesh: Any = None) -> None:
        trainer = workflow.trainer
        if trainer.device is None or trainer.weights is None:
            raise ValueError("SOMPopulationEngine needs a Kohonen workflow "
                             "initialized for training")
        hp = np.asarray(member_hparams, np.float32)
        if hp.ndim != 2 or hp.shape[1] != 4:
            raise ValueError(
                f"member hyperparameters must be a (P, 4) [alpha0, "
                f"alpha_min, sigma0, sigma_min] array; got {hp.shape}")
        self.workflow = workflow
        self.trainer = trainer
        self.loader = workflow.loader
        self.decision = workflow.decision
        self.device = trainer.device
        self.n_members = int(hp.shape[0])
        self.placement = engine_core.MemberPlacement(
            self.device, self.n_members, mesh)
        self.member_sharded = self.placement.sharded
        self._n_stacked = self.placement.n_stacked
        (hp,) = self.placement.pad(hp)
        self._hp = hp
        self.streaming = not self.loader.device_resident
        f = trainer.forward
        w0 = self.device.get(trainer.weights)
        #: the per-place tiles of the stacked maps
        self._tiles: Optional[List[torch.Tensor]] = \
            self.placement.put_members(
                np.repeat(w0[None], self._n_stacked, axis=0))
        coords = self.device.put(grid_coords(f.sx, f.sy))
        # a sharded cohort's places take the group's rows gathered once
        # (the streamed form); one device gathers them in the group
        resident = not self.streaming and not self.member_sharded
        data_dims = (None, None) if resident else (None,)
        #: a place's group: the vmapped epoch over its tile, the grid on
        #: that place
        self._train = [torch.func.vmap(
            engine_core.build_som_epoch(c, resident),
            in_dims=(0, 0, 0) + data_dims + (None,))
            for c in self.placement.put_replicated(coords)]
        self._eval = torch.func.vmap(
            engine_core.build_som_eval(resident),
            in_dims=(0,) + data_dims + (None,))
        from veles_tpu_torch.serve import residency
        residency.charge(self.device, "som_population",
                         self.placement.tile_bytes(self._tiles), "cohort")

    def _schedule_at(self, epoch: int):
        decay = self.trainer.decay_epochs
        t = min(epoch, decay) / max(decay, 1)
        a0, amin = self._hp[:, 0], self._hp[:, 1]
        s0, smin = self._hp[:, 2], self._hp[:, 3]
        return ((a0 * (amin / a0) ** t).astype(np.float32),
                (s0 * (smin / s0) ** t).astype(np.float32))

    def _member_schedule(self, k: int):
        """(P, k) alphas and sigmas of this group: the old epoch's for
        every step but an ended epoch's last, as
        ``KohonenTrainer.schedule_steps`` does it."""
        ld = self.loader
        e = ld.epoch_number
        ended = bool(ld.epoch_ended)
        a_bulk, s_bulk = self._schedule_at(e - 1 if ended else e)
        alphas = np.repeat(a_bulk[:, None], k, axis=1)
        sigmas = np.repeat(s_bulk[:, None], k, axis=1)
        if ended:
            alphas[:, k - 1], sigmas[:, k - 1] = self._schedule_at(e)
        return np.ascontiguousarray(alphas), np.ascontiguousarray(sigmas)

    def run(self) -> np.ndarray:
        with telemetry.span(events.SPAN_SOM_COHORT_TRAIN, journal=True,
                            members=self.n_members):
            telemetry.counter(events.CTR_SOM_COHORTS).inc()
            telemetry.counter(events.CTR_SOM_COHORT_MEMBERS).inc(
                self.n_members)
            return self._run()

    @torch.no_grad()
    def _run(self) -> np.ndarray:
        ld = self.loader
        dev = self.device
        pl = self.placement
        P = self.n_members
        max_epochs = self.decision.max_epochs
        fit_class = VALID if ld.class_lengths[VALID] > 0 else TRAIN
        best = np.full(P, np.inf)
        acc = pl.zeros_members((self._n_stacked, 2))
        tiles = list(self._tiles)
        try:
            while True:
                ld.run()
                klass = ld.minibatch_class
                k = len(ld.superstep_mask)
                if klass in (TRAIN, fit_class):
                    masks = pl.put_replicated(dev.put(ld.superstep_mask))
                    if ld.device_resident and not pl.sharded:
                        rows = [(ld.original_data,
                                 dev.put(ld.superstep_indices))]
                    else:
                        if ld.device_resident:
                            # the group's rows, gathered once
                            xb = torch.stack([
                                ld.original_data.index_select(0, i)
                                for i in dev.put(ld.superstep_indices)])
                        else:
                            xb = ld.superstep_data.to(dev.device)
                        rows = [(x,) for x in pl.put_replicated(xb)]
                if klass == TRAIN:
                    alphas, sigmas = self._member_schedule(k)
                    al, si = pl.put_members(alphas), pl.put_members(sigmas)
                    for p in range(len(pl.places)):
                        tiles[p], stats = self._train[p](
                            tiles[p], al[p], si[p], *rows[p], masks[p])
                        if fit_class == TRAIN:
                            acc[p] += stats
                elif klass == fit_class:
                    for p in range(len(pl.places)):
                        acc[p] += self._eval(tiles[p], *rows[p], masks[p])
                if not ld.class_ended:
                    continue
                if klass == fit_class:
                    a = pl.fetch_members(acc).astype(np.float64)
                    best = np.minimum(best,
                                      a[:, 0] / np.maximum(a[:, 1], 1.0))
                    acc = pl.zeros_members((self._n_stacked, 2))
                if klass == TRAIN and max_epochs is not None and \
                        ld.epoch_number >= max_epochs:
                    break
        finally:
            ld.stop()
        self._tiles = tiles
        return best

    @property
    def weights(self) -> Optional[torch.Tensor]:
        """The real members' (P, N, D) maps: the one tile off a mesh, the
        tiles gathered on the head place (the fillers dropped) on one;
        None after :meth:`release`."""
        tiles = self._tiles
        return None if tiles is None else self.placement.gather(tiles)

    @property
    def _params(self):
        """The stacked maps as a member-stacked param tree (the
        reference's attribute; ``genetics/handoff.py`` adopts from it),
        None after :meth:`release`."""
        w = self.weights
        if w is None:
            return None
        return {self.trainer.forward.name: {"weights": w}}

    def release(self) -> None:
        """Drop the stacked maps."""
        self._tiles = None
