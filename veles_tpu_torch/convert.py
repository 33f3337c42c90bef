"""Carrying member weights between the reference's layout and the port's.

The reference (and the members npz, which both frameworks read) keeps
conv weights HWIO ``(ky, kx, C_in, n_kernels)``, deconv weights
``(ky, kx, n_kernels, C_in)`` and fully-connected weights ``(n_in,
n_out)`` with ``n_in`` flattened in NHWC order.  The port keeps conv
weights OIHW ``(n_kernels, C_in, ky, kx)``, the layout
``torch.nn.functional.conv2d`` takes, and deconv weights ``(C_in,
n_kernels, ky, kx)``, the layout ``conv_transpose2d`` takes; everything
else (biases, fc weights, which the port flattens in the same NHWC
order) is unchanged.  This module is the ONLY place layouts are
converted.  A 4-D ``weights`` array is a conv or a deconv kernel (no
other layer type of the port has one), and the same axis permutation
carries both: ``(3, 2, 0, 1)`` one way, ``(2, 3, 1, 0)`` back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Params = Dict[str, Dict[str, np.ndarray]]

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _convert(member_params: Params, axes) -> Params:
    out: Params = {}
    for fname, p in member_params.items():
        out[fname] = {}
        for pname, arr in p.items():
            a = np.asarray(arr, np.float32)
            if pname == "weights" and a.ndim == 4:
                a = a.transpose(axes)
            out[fname][pname] = np.ascontiguousarray(a)
    return out


def params_from_jax(member_params: Params) -> Params:
    """``{fwd_name: {pname: array}}`` in the reference's layout (as
    ``load_members`` returns it, or a reference unit's
    ``gather_params()`` per forward) -> the port's layout: conv weights
    HWIO -> OIHW, all else as is, every array f32 and contiguous."""
    return _convert(member_params, _HWIO_TO_OIHW)


def params_to_jax(member_params: Params) -> Params:
    """The inverse of :func:`params_from_jax` (port -> reference
    layout), for writing a members npz from port-made params."""
    return _convert(member_params, _OIHW_TO_HWIO)
