"""The chains every engine loop runs: forward with residuals, backward
with the SGD update, the serving ensemble's inference, and the Kohonen
SOM's group of minibatches.

Counterpart of ``veles_tpu/engine/core.py`` (``build_ingest``,
``build_forward``, ``build_backward``, ``build_member_forward``,
``build_mean_probs``, ``build_som_step``, ``build_som_epoch``,
``build_som_eval``).  The reference's ``ExecutionCore`` (donation,
sharding, the HBM arbiter) is not ported: PyTorch runs eagerly, and a
process drives one device; data parallelism is one process per rank
with the gradient ``all_reduce`` in :func:`build_backward`.  Each ``lax.scan`` of the reference is a Python
loop over the group's minibatches here, and the SOM builders have no
row-sharded gather.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

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
                  compute_dtype: torch.dtype, rows=None) -> Callable:
    """One model's forward chain WITH residuals.  Its first op casts the
    rows to the compute dtype: bf16 in mixed precision, and in f32 any
    rows that are not f32 (a byte set with the codec off stays bytes up
    to here, ``loader/fullbatch.py``).  In training mode each
    stochastic layer ``i`` draws from ``prng.torch_generator(seed,
    rng_counter, i)``, the port's counterpart of the reference's
    ``fold_in(fold_in(key(seed), rc), i)``; a data-parallel rank passes
    ``rows=(lo, hi, global minibatch)`` and its layers draw the global
    minibatch's and keep their rows (``prng.RowSlice``)."""
    extra = {} if rows is None else {"rows": rows}

    def forward_pass(params: Dict[str, Dict[str, torch.Tensor]],
                     x: torch.Tensor, rng_counter: int, train: bool):
        residuals = []
        x = x.to(compute_dtype)
        for i, f in enumerate(forwards):
            rng = prng.torch_generator(seed, rng_counter, i, x.device,
                                       **extra) \
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
                     compute_dtype: torch.dtype) -> Callable:
    """The ensemble's mean member probabilities: each member's forward,
    then a FIXED left-to-right f32 add chain over the real members
    divided by their count, the order the reference pins
    (``engine/core.py:239-242``).  The reference ``jax.vmap``s one
    member's forward over the stacked member axis; here that axis is a
    loop that slices member ``i`` out of each stacked tensor (a view,
    no copy)."""
    cast = batching.make_caster(compute_dtype)
    member_forward = build_member_forward(forwards, compute_dtype)

    @torch.inference_mode()
    def mean_probs(params, x: torch.Tensor) -> torch.Tensor:
        cparams = cast(params)
        acc: Optional[torch.Tensor] = None
        for i in range(n_members):
            member = {f: {p: t[i] for p, t in ps.items()}
                      for f, ps in cparams.items()}
            probs = member_forward(member, x)
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


def build_som_epoch(coords: torch.Tensor, resident: bool = True
                    ) -> Callable:
    """A whole SOM group (one epoch's class at the SOM's grouping): the
    weights carried from step to step, step j at ``(alphas[j],
    sigmas[j])``, and the group's quantization error and row count
    summed in f32 in step order.  Returns ``(weights, [qe, count])``.

    ``resident=True``: ``epoch(weights, alphas, sigmas, dataset,
    indices, mask)`` gathers the (k, mb) ``indices`` rows from the
    device-resident ``dataset``; otherwise ``epoch(weights, alphas,
    sigmas, xb, mask)`` takes the host-assembled (k, mb, ...) batches
    already on the device."""
    som_update = build_som_step(coords)

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
                       (dataset.index_select(0, i) for i in indices), mask)
        return epoch
    return run


def build_som_eval(resident: bool = True) -> Callable:
    """The evaluation classes' twin of :func:`build_som_epoch`: the
    weights untouched, the quantization error and row count summed.
    ``evaluate(weights, dataset, indices, mask)`` resident, else
    ``evaluate(weights, xb, mask)``; returns ``[qe, count]``."""
    from veles_tpu_torch.ops.kohonen import som_qe_masked

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
            return run(weights,
                       (dataset.index_select(0, i) for i in indices), mask)
        return evaluate
    return run
