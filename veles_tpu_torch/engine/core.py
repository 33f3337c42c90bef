"""The chains every engine loop runs: forward with residuals, backward
with the SGD update, and the serving ensemble's inference.

Counterpart of ``veles_tpu/engine/core.py`` (``build_ingest``,
``build_forward``, ``build_backward``, ``build_member_forward``,
``build_mean_probs``).  The reference's ``ExecutionCore`` (donation,
sharding, the HBM arbiter) is not ported: PyTorch runs eagerly, and the
port has one device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from veles_tpu_torch import prng
from veles_tpu_torch.ops import batching


def build_ingest(dequant: Any) -> Callable:
    """The wire-format prologue: the identity, until quantized loaders
    are ported."""
    if dequant is not None:
        raise NotImplementedError("quantized ingest is not ported")
    return lambda x: x


def build_forward(forwards: List[Any], seed: int,
                  compute_dtype: torch.dtype) -> Callable:
    """One model's forward chain WITH residuals.  In training mode each
    stochastic layer ``i`` draws from ``prng.torch_generator(seed,
    rng_counter, i)``, the port's counterpart of the reference's
    ``fold_in(fold_in(key(seed), rc), i)``."""
    mixed = compute_dtype != torch.float32

    def forward_pass(params: Dict[str, Dict[str, torch.Tensor]],
                     x: torch.Tensor, rng_counter: int, train: bool):
        residuals = []
        if mixed:
            x = x.to(compute_dtype)
        for i, f in enumerate(forwards):
            rng = prng.torch_generator(seed, rng_counter, i, x.device) \
                if f.stochastic and train else None
            x, res = f.apply_fwd(params[f.name], x, rng=rng, train=train)
            residuals.append(res)
        return x, residuals

    return forward_pass


def build_backward(forwards: List[Any], gds: List[Any],
                   compute_dtype: torch.dtype) -> Callable:
    """The backward + SGD chain: walk the gradient units in reverse,
    skip the chain head's err_input when nothing consumes it (for a
    stride-4 first conv, its whole input gradient), and apply
    ``update_params`` with this minibatch's (lr, bias lr) row.  The
    error is cast to the compute dtype when it is not f32."""
    first_gd = next((i for i, g in enumerate(gds) if g is not None), -1)
    mixed = compute_dtype != torch.float32

    def backward_update(cparams, params, opt, residuals, err,
                        lr: List[List[float]]):
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
            if grads:
                p, v = gd.update_params(params[f.name], grads,
                                        opt.get(gd.name, {}),
                                        rates=(lr[i][0], lr[i][1]))
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
