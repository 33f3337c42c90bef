"""Inference chain builders shared by the serving engine.

Counterpart of ``veles_tpu/engine/core.py:build_member_forward`` and
``build_mean_probs``.  The reference ``jax.vmap``s one member's forward
over a stacked member axis; here the member axis is a loop that slices
member ``i`` out of each stacked tensor (a view, no copy), so each
member's layers launch at the request batch size.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from veles_tpu_torch.ops import batching


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
    (``engine/core.py:239-242``)."""
    cast = batching.make_caster(compute_dtype)
    member_forward = build_member_forward(forwards, compute_dtype)

    @torch.inference_mode()
    def mean_probs(params, x: torch.Tensor) -> torch.Tensor:
        cparams = cast(params)
        acc = None
        for i in range(n_members):
            member = {f: {p: t[i] for p, t in ps.items()}
                      for f, ps in cparams.items()}
            probs = member_forward(member, x)
            acc = probs if acc is None else acc + probs
        return acc / n_members

    return mean_probs
