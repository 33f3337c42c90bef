"""Fixed-shape batching helpers of the engines.

Counterpart of ``veles_tpu/ops/batching.py``: the compute-dtype policy,
the param caster, member stacking and the mesh's member padding
(:func:`pad_members`), the residency byte count, the zero-padded
micro-batch, and the row-sharded gathers: a data-parallel rank's
(:func:`make_sharded_row_gather`) and a mesh's places'
(:func:`make_mesh_row_gather`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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


def pad_members(arrays: List[np.ndarray], multiple: int
                ) -> Tuple[List[np.ndarray], int]:
    """Each array's leading member axis padded to a whole multiple of
    ``multiple`` by repeating the first member's row (the reference's
    ``veles_tpu/ops/batching.py:186-204``): a filler member computes
    member 0's math, and its rows are dropped before anything reads
    them.  Returns the padded arrays and the padded member count."""
    p = len(arrays[0])
    p_pad = -(-p // multiple) * multiple
    if p_pad == p:
        return list(arrays), p
    return [np.concatenate([a, np.repeat(a[:1], p_pad - p, axis=0)])
            for a in arrays], p_pad


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


def pad_chunk(xb: np.ndarray, lb: np.ndarray, chunk: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A fixed-shape (rows, labels) chunk and its validity mask: padded
    rows carry mask 0 and cannot score."""
    mask = np.ones(chunk, np.float32)
    if len(xb) < chunk:
        pad = chunk - len(xb)
        mask[len(xb):] = 0.0
        xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        lb = np.concatenate([lb, np.zeros(pad, lb.dtype)])
    return xb, lb, mask


def padded_index_chunk(start: int, stop: int, chunk: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The fixed-shape index window [start, stop) and its validity mask
    for the resident gathers (padded with index 0, masked out)."""
    idx = np.arange(start, stop, dtype=np.int64)
    mask = np.ones(chunk, np.float32)
    if len(idx) < chunk:
        mask[len(idx):] = 0.0
        idx = np.pad(idx, (0, chunk - len(idx)))
    return idx, mask


def make_sharded_row_gather(group: Any, rows_local: int):
    """``gather(indices, *stores)`` over ROW-SHARDED resident stores
    (each rank holds ``rows_local`` consecutive rows,
    ``parallel.mesh.put_row_sharded``): every rank looks the GLOBAL
    ``indices`` up in its own shard, zeroes the rows it does not hold,
    and one ``all_reduce`` sum a store assembles the rows on every rank.
    Exactly one rank contributes each row, so the sum is one real value
    plus N-1 zeros: exact.  Integer stores (uint8 pixels, int64 labels)
    ride the sum as int32 and are cast back, exact for any byte or
    label.  Returns the gathered rows of each store, in order.  Indices
    must point at real rows (the padded tail is placement filler)."""
    lo = group.rank * rows_local

    def gather(indices: torch.Tensor, *stores):
        loc = (indices - lo).clamp(0, rows_local - 1)
        hit = (indices >= lo) & (indices < lo + rows_local)
        out = []
        for s in stores:
            x = s.index_select(0, loc)
            keep = hit.reshape(hit.shape + (1,) * (x.dim() - 1))
            x = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
            if x.is_floating_point():
                out.append(group.all_reduce_(x, "gather"))
            else:
                out.append(group.all_reduce_(x.to(torch.int32),
                                             "gather").to(s.dtype))
        return out

    return gather


def make_mesh_row_gather(places, rows_local: int):
    """``gather(indices, *tiles_of_stores)`` over stores ROW-SHARDED on
    a mesh's places (place r holds ``rows_local`` consecutive rows,
    ``MeshDevice.put_sharded``): the counterpart of the reference's
    ``shard_map`` local gather + ``psum`` in one process.  Each place
    looks the GLOBAL ``indices`` up in its own tile, and the head place
    (``places[0]``, where ``indices`` lie) keeps, row by row, the one
    place that holds it (``torch.where``: a selection, no arithmetic, so
    the gathered rows are bitwise the replicated gather's, any dtype).
    Each store is given as its list of per-place tiles; returns the
    gathered rows of each store on the head place, in order.  Indices
    must point at real rows (the padded tail is placement filler)."""
    head = torch.device(places[0])

    def gather(indices: torch.Tensor, *stores):
        out = []
        for tiles in stores:
            got = None
            for r, (place, tile) in enumerate(zip(places, tiles)):
                lo = r * rows_local
                loc = (indices - lo).clamp(0, rows_local - 1)
                hit = (indices >= lo) & (indices < lo + rows_local)
                x = tile.index_select(0, loc.to(place)).to(head)
                if got is None:
                    got = x
                    continue
                keep = hit.reshape(hit.shape + (1,) * (x.dim() - 1))
                got = torch.where(keep, x, got)
            out.append(got)
        return out

    return gather
