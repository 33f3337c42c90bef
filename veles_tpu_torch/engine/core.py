"""The chains every engine loop runs: forward with residuals, backward
with the SGD update, the serving ensemble's inference, and the Kohonen
SOM's group of minibatches.

Counterpart of ``veles_tpu/engine/core.py`` (``build_ingest``,
``build_forward``, ``build_backward``, ``build_member_forward``,
``build_mean_probs``, ``build_som_step``, ``build_som_epoch``,
``build_som_eval``).  Of the reference's ``ExecutionCore`` (donation,
sharding, the HBM arbiter) the port keeps one seam,
:class:`MemberPlacement`: where a cohort's or an ensemble's stacked
member axis lives, on one device or P/N a place over a mesh of places
(``parallel/mesh.py``), the reference's ``put_members``,
``zeros_members``, ``put_replicated`` and ``replicate_for_fetch``
(``veles_tpu/engine/core.py:379-500``).  PyTorch runs eagerly, so there
is nothing to donate or compile; the engines charge the arbiter through
``serve/residency.py`` ``charge``.  Data parallelism is one process per
rank with the gradient ``all_reduce`` in :func:`build_backward`.  Each
``lax.scan`` of the reference is a Python loop over the group's
minibatches here; the SOM builders take the row-sharded gather as
``gather`` (``ops/batching.py``), as the reference's do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.ops import batching


def build_ingest(dequant: Any, device: Any) -> Callable:
    """The wire-format prologue: the identity for f32 or bf16 batches;
    for a quantized loader (``dequant``, an ``AffineDequant``) the affine
    uint8 dequantization ``x.float() * scale + bias`` in f32, the host
    normalizer's order, with ``scale`` and ``bias`` put on ``device``
    once.  Per-feature normalizers give arrays of the sample's shape,
    which broadcast over the (mb, H, W, C) batch.  It runs before the
    forward's cast to the compute dtype."""
    if dequant is None:
        return lambda x: x
    q_scale = device.put(np.asarray(dequant.scale, np.float32))
    q_bias = device.put(np.asarray(dequant.bias, np.float32))

    def ingest(x: torch.Tensor) -> torch.Tensor:
        return x.float() * q_scale + q_bias

    return ingest


def build_forward(forwards: List[Any], seed: int,
                  compute_dtype: torch.dtype, rows=None,
                  draws: Any = None) -> Callable:
    """One model's forward chain WITH residuals.  Its first op casts the
    rows to the compute dtype: bf16 in mixed precision, and in f32 any
    rows that are not f32 (a byte set with the codec off stays bytes up
    to here, ``loader/fullbatch.py``).  In training mode each
    stochastic layer ``i`` draws from ``prng.torch_generator(seed,
    rng_counter, i)``, the port's counterpart of the reference's
    ``fold_in(fold_in(key(seed), rc), i)``; a data-parallel rank passes
    ``rows=(lo, hi, global minibatch)`` and its layers draw the global
    minibatch's and keep their rows (``prng.RowSlice``); a member-sharded
    cohort passes ``draws`` (a ``prng.SharedDraws``), and its places
    share each minibatch's draws, made once."""
    extra = {} if rows is None else {"rows": rows}

    def generator(rng_counter: int, i: int, device: torch.device):
        if draws is not None:
            return draws.generator(seed, rng_counter, i)
        return prng.torch_generator(seed, rng_counter, i, device, **extra)

    def forward_pass(params: Dict[str, Dict[str, torch.Tensor]],
                     x: torch.Tensor, rng_counter: int, train: bool):
        residuals = []
        x = x.to(compute_dtype)
        for i, f in enumerate(forwards):
            rng = generator(rng_counter, i, x.device) \
                if f.stochastic and train else None
            x, res = f.apply_fwd(params[f.name], x, rng=rng, train=train)
            residuals.append(res)
        return x, residuals

    return forward_pass


def build_backward(forwards: List[Any], gds: List[Any],
                   compute_dtype: torch.dtype, group: Any = None
                   ) -> Callable:
    """The backward + SGD chain: walk the gradient units in reverse,
    skip the chain head's err_input when nothing consumes it (for a
    stride-4 first conv, its whole input gradient), and apply
    ``update_params`` with this minibatch's (lr, bias lr) row, and with
    the (wd, bias wd) row ``wd`` when the caller gives one (the
    population engine's per-member decays; ``wd=None`` keeps the units'
    own).  The error is cast to the compute dtype when it is not f32.
    With a data-parallel ``group`` (``parallel/mesh.py``) each layer's
    gradients are summed over the ranks between its backward and its
    update, as one flat f32 buffer and one ``all_reduce``: the sum is
    identical on every rank, and so are the updated params."""
    first_gd = next((i for i, g in enumerate(gds) if g is not None), -1)
    mixed = compute_dtype != torch.float32

    def reduce_grads(grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        names = list(grads)
        flat = torch.cat([grads[n].float().reshape(-1) for n in names])
        group.all_reduce_(flat, "grads")
        out, at = {}, 0
        for n in names:
            g = grads[n]
            out[n] = flat[at:at + g.numel()].view(g.shape)
            at += g.numel()
        return out

    def backward_update(cparams, params, opt, residuals, err, lr, wd=None):
        if mixed:
            err = err.to(compute_dtype)
        new_params = dict(params)
        new_opt = dict(opt)
        for i in range(len(forwards) - 1, -1, -1):
            f, gd = forwards[i], gds[i]
            if gd is None:
                continue
            if i == first_gd and gd.can_skip_err_input:
                _, grads = gd.backward_from_saved(
                    cparams[f.name], residuals[i], err,
                    need_err_input=False)
                err_in = None
            else:
                err_in, grads = gd.backward_from_saved(
                    cparams[f.name], residuals[i], err)
            residuals[i] = None   # free the activation as soon as used
            if grads and group is not None:
                grads = reduce_grads(grads)
            if grads:
                p, v = gd.update_params(
                    params[f.name], grads, opt.get(gd.name, {}),
                    rates=(lr[i][0], lr[i][1]),
                    decays=None if wd is None else (wd[i][0], wd[i][1]))
                new_params[f.name] = p
                if gd.name in opt:
                    new_opt[gd.name] = v
            err = err_in
        return new_params, new_opt

    return backward_update


def build_member_forward(forwards: List[Any], compute_dtype: torch.dtype
                         ) -> Callable:
    """One member's pure inference chain (no rng, f32 output)."""
    def member_forward(params: Dict[str, Dict[str, torch.Tensor]],
                       x: torch.Tensor) -> torch.Tensor:
        x = x.to(compute_dtype)
        for f in forwards:
            x, _ = f.apply_fwd(params[f.name], x, rng=None, train=False)
        return x.float()
    return member_forward


def build_mean_probs(forwards: List[Any], n_members: int,
                     compute_dtype: torch.dtype, places) -> Callable:
    """The ensemble's mean member probabilities: each member's forward,
    then a FIXED left-to-right f32 add chain over the real members
    divided by their count, the order the reference pins
    (``engine/core.py:239-242``).  The reference ``jax.vmap``s one
    member's forward over the stacked member axis; here that axis is a
    loop that slices member ``i`` out of its place's tile (a view, no
    copy).

    ``params`` is the list of per-place tiles (:class:`MemberPlacement`,
    one tile off a mesh) and ``places`` their devices: the rows ``x``
    (on the head place) are copied to each place once, each REAL
    member's probabilities are computed on its place and copied to the
    head place, and the add chain runs over them in member order; a
    filler member (``batching.pad_members``) is stored but never
    computed.  On one place every copy is the tensor itself."""
    cast = batching.make_caster(compute_dtype)
    member_forward = build_member_forward(forwards, compute_dtype)

    @torch.inference_mode()
    def mean_probs(tiles, x: torch.Tensor) -> torch.Tensor:
        head = x.device
        per = next(iter(next(iter(tiles[0].values())).values())).shape[0]
        tiles = [cast(t) for t in tiles]
        xs = [x.to(place) for place in places]
        acc: Optional[torch.Tensor] = None
        for i in range(n_members):
            p, j = divmod(i, per)
            probs = member_forward({f: {pn: t[j] for pn, t in ps.items()}
                                    for f, ps in tiles[p].items()},
                                   xs[p]).to(head)
            acc = probs if acc is None else acc + probs
        return acc / n_members

    return mean_probs


def build_som_step(coords: torch.Tensor) -> Callable:
    """One masked Kohonen minibatch update (``ops/kohonen.py``'s
    ``som_step_masked``) on the device grid ``coords`` (N, 2): the
    closure takes ``(weights, x, alpha, sigma, mask)`` with ``x`` still
    in the loader's sample shape."""
    from veles_tpu_torch.ops.kohonen import som_step_masked

    def som_update(weights, x, alpha, sigma, mask):
        return som_step_masked(weights, x.reshape(x.shape[0], -1), coords,
                               alpha, sigma, mask)

    return som_update


def build_som_epoch(coords: torch.Tensor, resident: bool = True,
                    gather: Optional[Callable] = None) -> Callable:
    """A whole SOM group (one epoch's class at the SOM's grouping): the
    weights carried from step to step, step j at ``(alphas[j],
    sigmas[j])``, and the group's quantization error and row count
    summed in f32 in step order.  Returns ``(weights, [qe, count])``.

    ``resident=True``: ``epoch(weights, alphas, sigmas, dataset,
    indices, mask)`` gathers the (k, mb) ``indices`` rows from the
    device-resident ``dataset``; otherwise ``epoch(weights, alphas,
    sigmas, xb, mask)`` takes the host-assembled (k, mb, ...) batches
    already on the device.  ``gather(indices, dataset)`` (resident only)
    replaces the plain ``index_select`` when the data set is row-sharded
    (``batching.make_mesh_row_gather``); it returns the rows of each
    store given."""
    som_update = build_som_step(coords)
    take = _taker(gather)

    def run(weights, alphas, sigmas, batches, mask):
        qe = cnt = torch.zeros((), dtype=torch.float32,
                               device=weights.device)
        for j, x in enumerate(batches):
            weights, _, qe_b, n_b = som_update(weights, x, alphas[j],
                                               sigmas[j], mask[j])
            qe, cnt = qe + qe_b, cnt + n_b
        return weights, torch.stack([qe, cnt])

    if resident:
        def epoch(weights, alphas, sigmas, dataset, indices, mask):
            return run(weights, alphas, sigmas,
                       (take(dataset, i) for i in indices), mask)
        return epoch
    return run


def _taker(gather: Optional[Callable]) -> Callable:
    """``take(dataset, indices)``: the plain ``index_select``, or the
    row-sharded ``gather``'s one store."""
    if gather is None:
        return lambda dataset, idx: dataset.index_select(0, idx)
    return lambda dataset, idx: gather(idx, dataset)[0]


def build_som_eval(resident: bool = True,
                   gather: Optional[Callable] = None) -> Callable:
    """The evaluation classes' twin of :func:`build_som_epoch`: the
    weights untouched, the quantization error and row count summed.
    ``evaluate(weights, dataset, indices, mask)`` resident, else
    ``evaluate(weights, xb, mask)``; returns ``[qe, count]``."""
    from veles_tpu_torch.ops.kohonen import som_qe_masked
    take = _taker(gather)

    def run(weights, batches, mask):
        qe = cnt = torch.zeros((), dtype=torch.float32,
                               device=weights.device)
        for j, x in enumerate(batches):
            qe_b, n_b = som_qe_masked(weights, x.reshape(x.shape[0], -1),
                                      mask[j])
            qe, cnt = qe + qe_b, cnt + n_b
        return torch.stack([qe, cnt])

    if resident:
        def evaluate(weights, dataset, indices, mask):
            return run(weights, (take(dataset, i) for i in indices), mask)
        return evaluate
    return run


class MemberPlacement:
    """Where an engine's stacked member axis lives: the seam the cohort
    engines (``ops/population.py``, ``ops/kohonen.py``) and the ensemble
    engine (``ops/fused.py``) share, the counterpart of the reference's
    ``ExecutionCore`` member placement (``put_members``,
    ``zeros_members``, ``put_replicated``, ``replicate_for_fetch``).

    Off a mesh (``mesh`` None or of one place) every member lives on
    ``device``: one tile.  On a mesh the member axis is padded to a
    whole multiple of its N places by repeating member 0
    (``batching.pad_members``) and place p holds members ``[p * per,
    (p + 1) * per)``.  Every member-axis value is its list of per-place
    tiles, a stacked param tree the list of per-place trees.
    ``$VELES_MESH_SHARD_MEMBERS=never`` keeps a mesh-given cohort on
    ``device`` (the reference's switch; ``knob=False`` for the
    ensemble, whose switch is the residency manager's)."""

    def __init__(self, device: Any, n_members: int, mesh: Any = None,
                 knob: bool = True) -> None:
        from veles_tpu_torch import knobs
        from veles_tpu_torch.parallel.mesh import shard_mode
        if mesh is not None and mesh.size < 2:
            mesh = None
        if mesh is not None and knob and shard_mode(
                knobs.get(knobs.MESH_SHARD_MEMBERS)) == "never":
            mesh = None
        self.device = device
        self.mesh = mesh
        self.n_members = int(n_members)
        n = mesh.size if mesh is not None else 1
        self.n_stacked = -(-self.n_members // n) * n
        self.per = self.n_stacked // n
        self.places = mesh.places if mesh is not None else (device.device,)

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def pad(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Host arrays with a leading member axis, padded to
        ``n_stacked`` members."""
        return batching.pad_members(list(arrays), len(self.places))[0]

    def put_members(self, array: np.ndarray) -> List[torch.Tensor]:
        """A padded member-axis host array, place p's tile on place p
        (``h2d_bytes`` charged the padded total once)."""
        if not self.sharded:
            return [self.device.put(array)]
        from veles_tpu_torch.parallel.mesh import put_member_sharded
        return put_member_sharded(self.mesh, self.device,
                                  np.asarray(array))

    def zeros_members(self, shape) -> List[torch.Tensor]:
        """Zeros of ``(n_stacked,) + shape[1:]``, tiled (f32)."""
        tail = tuple(int(s) for s in shape[1:])
        return [torch.zeros((self.per,) + tail, dtype=torch.float32,
                            device=place) for place in self.places]

    def put_replicated(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A device tensor's copy on every place (the tensor itself where
        a place is its device): a minibatch, a mask, the draws."""
        return [t.to(place) for place in self.places]

    def stack(self, forwards: List[Any],
              member_params: List[Dict[str, Dict[str, Any]]]
              ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per-place trees of the members' f32 params stacked on the
        member axis, padded to ``n_stacked`` by repeating member 0."""
        members = list(member_params) + \
            [member_params[0]] * (self.n_stacked - len(member_params))
        tiles: List[Dict[str, Dict[str, torch.Tensor]]] = \
            [{} for _ in self.places]
        for f in forwards:
            for t in tiles:
                t[f.name] = {}
            for pn in members[0][f.name]:
                stacked = np.stack([np.asarray(m[f.name][pn], np.float32)
                                    for m in members])
                for t, part in zip(tiles, self.put_members(stacked)):
                    t[f.name][pn] = part
        return tiles

    def fetch_members(self, tiles: List[torch.Tensor]) -> np.ndarray:
        """A tiled member-axis value on the host, REAL members only (the
        fillers' rows dropped)."""
        return np.concatenate([t.detach().to("cpu").numpy()
                               for t in tiles])[:self.n_members]

    def tile_tree(self, tree: Dict[str, Dict[str, torch.Tensor]]
                  ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """A member-stacked device tree of ``n_members`` members as
        per-place tiles, padded by repeating its member 0 (a handoff's
        best member, a promotion's first): what an engine adopts.  Off a
        mesh the tree itself is the one tile."""
        if not self.sharded:
            return [tree]
        tiles: List[Dict[str, Dict[str, torch.Tensor]]] = \
            [{} for _ in self.places]
        for fn, ps in tree.items():
            for t in tiles:
                t[fn] = {}
            for pn, a in ps.items():
                if len(a) < self.n_stacked:
                    a = torch.cat([a, a[:1].expand(
                        (self.n_stacked - len(a),) + tuple(a.shape[1:]))])
                for p, (t, place) in enumerate(zip(tiles, self.places)):
                    t[fn][pn] = a[p * self.per:(p + 1) * self.per].to(place)
        return tiles

    def gather(self, tiles: List[torch.Tensor]) -> torch.Tensor:
        """A tiled member-axis value as one tensor of the REAL members on
        ``device``: off a mesh the one tile itself, on one a copy
        gathered from the places (the fillers dropped)."""
        if not self.sharded:
            return tiles[0]
        head = self.device.device
        return torch.cat([t.to(head) for t in tiles])[:self.n_members]

    def gather_tree(self, tiles: List[Dict[str, Dict[str, torch.Tensor]]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-place trees as one member-stacked tree of the REAL members
        (:meth:`gather` of each leaf; off a mesh the one tile itself)."""
        if not self.sharded:
            return tiles[0]
        return {fn: {pn: self.gather([t[fn][pn] for t in tiles])
                     for pn in ps} for fn, ps in tiles[0].items()}

    def locate(self, i: int) -> Tuple[int, int]:
        """(place, row in its tile) of member ``i``."""
        return divmod(int(i), self.per)

    def tile_bytes(self, tiles: List[Any]) -> int:
        """Bytes the fullest place holds of a tiled value (a list of
        tensors or of trees): the per-device charge."""
        from veles_tpu_torch.serve.residency import tree_nbytes
        return max(tree_nbytes(t) for t in tiles)
