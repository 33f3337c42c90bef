"""Export a trained workflow to VTPN, the format of the native C++
inference runtime (``native/src/libveles.cc``).

The port's copy of ``veles_tpu/export.py``: for the same params it
writes the same bytes.  The file carries what inference needs and
nothing else: the forward op chain with its hyperparameters and its f32
weights in the reference's layouts (conv weights HWIO, deconv weights
``(ky, kx, n_kernels, C_in)``, dense weights ``(n_in, n_out)``).
Dropout keeps its slot as an identity op, so the op indices match the
workflow's forward indices.

The params come from the card (``workflow.fused.host_params()``) and
are turned into the reference's layout by ``convert.params_to_jax``,
the one place layouts are converted.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List, Tuple

import numpy as np

from veles_tpu_torch.convert import params_to_jax

# op / activation / attr enums: they must match native/src/libveles.cc
OP_DENSE, OP_CONV, OP_MAXPOOL, OP_AVGPOOL, OP_LRN, OP_DROPOUT, \
    OP_DECONV, OP_ACTIVATION, OP_STOCHPOOL_EVAL, OP_BINARIZE \
    = range(1, 11)
ACT = {"linear": 0, "tanh": 1, "relu": 2, "sigmoid": 3, "softmax": 4,
       "log": 5}
A_KX, A_KY, A_SX, A_SY, A_PX, A_PY, A_NKERN, A_LRN_N, A_ALPHA, \
    A_BETA, A_K = range(11)

MAGIC = b"VTPN"
VERSION = 1

Record = Tuple[int, int, Dict[int, float], Dict[int, np.ndarray]]


def _op_record(unit, params: Dict[str, np.ndarray]) -> Record:
    """(op_type, act, attrs, tensors) for one forward unit; ``params`` is
    its params in the reference's layout ({} for a unit without)."""
    from veles_tpu_torch.ops.activation import ActivationBase
    from veles_tpu_torch.ops.all2all import All2All
    from veles_tpu_torch.ops.conv import Conv
    from veles_tpu_torch.ops.deconv import Deconv
    from veles_tpu_torch.ops.dropout import Dropout
    from veles_tpu_torch.ops.lrn import LRNormalizer
    from veles_tpu_torch.ops.pooling import (AvgPooling, MaxPooling,
                                             StochasticPooling)
    from veles_tpu_torch.ops.rbm import Binarization

    act = ACT.get(unit.activation_mode, 0)
    tensors: Dict[int, np.ndarray] = {}
    if "weights" in params:
        tensors[0] = np.asarray(params["weights"], np.float32)
    if "bias" in params and unit.include_bias:
        tensors[1] = np.asarray(params["bias"], np.float32)

    if isinstance(unit, (Deconv, Conv)):
        py, px = unit.padding
        sy, sx = unit.sliding
        op = OP_DECONV if isinstance(unit, Deconv) else OP_CONV
        return op, act, {A_KX: unit.kx, A_KY: unit.ky, A_SX: sx, A_SY: sy,
                         A_PX: px, A_PY: py,
                         A_NKERN: unit.n_kernels}, tensors
    if isinstance(unit, All2All):
        return OP_DENSE, act, {}, tensors
    pools = ((StochasticPooling, OP_STOCHPOOL_EVAL),
             (MaxPooling, OP_MAXPOOL), (AvgPooling, OP_AVGPOOL))
    for cls, op in pools:
        if isinstance(unit, cls):
            sy, sx = unit.sliding
            return op, 0, {A_KX: unit.kx, A_KY: unit.ky,
                           A_SX: sx, A_SY: sy}, {}
    if isinstance(unit, LRNormalizer):
        return OP_LRN, 0, {A_LRN_N: unit.n, A_ALPHA: unit.alpha,
                           A_BETA: unit.beta, A_K: unit.k}, {}
    if isinstance(unit, Dropout):
        return OP_DROPOUT, 0, {}, {}
    if isinstance(unit, Binarization):
        # the inference form is the unit's eval mode: x > 0.5
        return OP_BINARIZE, 0, {}, {}
    if isinstance(unit, ActivationBase):
        return OP_ACTIVATION, act, {}, {}
    raise ValueError(
        f"unit {unit.name} ({type(unit).__name__}) has no native "
        f"inference equivalent")


def _write_op(f: BinaryIO, op_type: int, act: int,
              attrs: Dict[int, float],
              tensors: Dict[int, np.ndarray]) -> None:
    f.write(struct.pack("<III", op_type, act, len(attrs)))
    for key in sorted(attrs):
        f.write(struct.pack("<Id", key, float(attrs[key])))
    f.write(struct.pack("<I", len(tensors)))
    for tid in sorted(tensors):
        arr = np.ascontiguousarray(tensors[tid], np.float32)
        f.write(struct.pack("<II", tid, arr.ndim))
        f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
        f.write(arr.tobytes())


def export_model(workflow: Any, path: str) -> str:
    """Write an initialized workflow's forward chain, with its current
    params, to ``path`` (atomically) and return ``path``."""
    forwards: List[Any] = list(workflow.forwards)
    if not forwards:
        raise ValueError("workflow has no forward units")
    params = params_to_jax(workflow.fused.host_params())
    in_shape = tuple(forwards[0].input_shape[1:])
    records = [_op_record(u, params.get(u.name, {})) for u in forwards]
    from veles_tpu_torch.snapshotter import atomic_write
    with atomic_write(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION, len(records)))
        f.write(struct.pack("<q", len(in_shape)))
        f.write(struct.pack(f"<{len(in_shape)}q", *in_shape))
        for rec in records:
            _write_op(f, *rec)
    return path
