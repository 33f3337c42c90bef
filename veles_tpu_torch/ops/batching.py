"""Fixed-shape batching helpers of the engines.

Counterpart of ``veles_tpu/ops/batching.py`` (single-device subset): the
compute-dtype policy, the param caster, member stacking, the
residency byte count, and the zero-padded micro-batch.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def resolve_compute_dtype(compute_dtype: Any, device: Any) -> torch.dtype:
    """An explicit ``compute_dtype`` wins, else the device's policy
    (bf16 on CUDA, f32 on the CPU), else float32."""
    cd = compute_dtype
    if cd is None and device is not None:
        cd = device.compute_dtype
    return cd if cd is not None else torch.float32


def make_caster(cd: torch.dtype):
    """``cast(tree)`` mapping every f32 tensor of a ``{fwd: {pname:
    tensor}}`` tree to ``cd`` (the identity when ``cd`` is f32)."""
    if cd == torch.float32:
        return lambda tree: tree

    def cast(tree):
        return {f: {p: t.to(cd) if t.dtype == torch.float32 else t
                    for p, t in ps.items()}
                for f, ps in tree.items()}
    return cast


def stack_member_params(forwards: List[Any],
                        member_params: List[Dict[str, Dict[str, Any]]],
                        device: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """{fwd_name: {pname: (n_members, ...)}}: every member's f32 params
    stacked along a leading member axis and uploaded once."""
    return {
        f.name: {
            pn: device.put(np.stack(
                [np.asarray(m[f.name][pn], np.float32)
                 for m in member_params]))
            for pn in member_params[0][f.name]}
        for f in forwards}


def stacked_param_bytes(member_params:
                        List[Dict[str, Dict[str, Any]]]) -> int:
    """Device bytes :func:`stack_member_params` will occupy (f32),
    known before any upload: the residency budget reads it."""
    return sum(int(np.prod(np.shape(arr))) * 4
               for m in member_params for p in m.values()
               for arr in p.values())


def pad_rows(x: np.ndarray, chunk: int) -> np.ndarray:
    """Rows zero-padded to the fixed ``chunk`` shape (the batcher drops
    the padded rows' outputs on the host after the dispatch)."""
    if len(x) < chunk:
        x = np.concatenate(
            [x, np.zeros((chunk - len(x),) + x.shape[1:], x.dtype)])
    return x
