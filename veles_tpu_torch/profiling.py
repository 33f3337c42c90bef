"""Profiling: analytic FLOPs, MFU, and ``torch.profiler`` traces.

Counterpart of ``veles_tpu/profiling.py``, with its FLOPs conventions:

- one multiply-accumulate is 2 FLOPs;
- a training step is forward + backward, and the backward of a
  weighted layer costs about twice its forward, so a weighted layer
  counts 3x its forward FLOPs and a weightless one 2x;
- elementwise, pooling and normalization layers count their output
  elements (LRN 10 a element; a pooling window's size per output), so
  the total errs high and MFU low.

:func:`forward_flops_per_sample`, :func:`model_flops_per_sample` and
:func:`layer_flops_table` read an initialized forward chain (its units'
``input_shape`` / ``output_shape``) and give the reference's numbers
for every layer type the port has.  :func:`mfu` divides achieved
FLOP/s by the card's peak from :data:`PEAK_FLOPS`.  :func:`trace` wraps
a run in ``torch.profiler.profile`` (CPU and CUDA activities) and
exports a Chrome trace into its directory; ``--profile DIR`` on the
command line uses it, and the launcher writes ``flops_table.json``
beside the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

#: peak dense bf16 tensor-core FLOP/s by ``torch.cuda.get_device_name``
#: substring, first match wins.  Spec values, not readings: NVIDIA's
#: H100 SXM datasheet gives 989 TFLOP/s dense in bf16 (its 1,979 is
#: with 2:4 sparsity), at the full 700 W power limit; a card set below
#: it runs slower under load.  "NVIDIA H100 80GB HBM3" is the SXM part.
PEAK_FLOPS = (
    ("H100 80GB HBM3", 989e12),
)


def device_peak_flops(device: Any) -> Optional[float]:
    """The peak of ``device`` (a ``TorchDevice`` or ``torch.device``)
    from :data:`PEAK_FLOPS`, or None (the CPU, or a card not listed)."""
    import torch
    dev = getattr(device, "device", device)
    if torch.device(dev).type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for sub, peak in PEAK_FLOPS:
        if sub in name:
            return peak
    return None


def _numel(shape: Iterable[int]) -> int:
    return int(np.prod([int(s) for s in shape])) if shape else 0


def _param_shapes(unit) -> Dict[str, tuple]:
    return unit.param_shapes(unit.input_shape)


def unit_has_weights(unit) -> bool:
    return "weights" in _param_shapes(unit)


def forward_flops_per_sample(unit) -> float:
    """Analytic forward FLOPs of ONE sample through an initialized
    forward unit."""
    out_shape = tuple(unit.output_shape)
    out_elems = _numel(out_shape[1:])
    kind = type(unit).__name__
    if hasattr(unit, "n_kernels") and hasattr(unit, "kx"):
        # conv family: 2 * ky*kx*c_in * n_kernels per output pixel; a
        # deconv runs the same MACs laid out over its INPUT pixels
        c_in = int(unit.input_shape[-1])
        macs_per_px = unit.ky * unit.kx * c_in * unit.n_kernels
        spatial = _numel(unit.input_shape[1:3]) if "Deconv" in kind \
            else _numel(out_shape[1:3])
        return 2.0 * macs_per_px * spatial
    if hasattr(unit, "output_sample_shape"):
        # dense: 2 * in_features * out_features
        return 2.0 * _numel(unit.input_shape[1:]) * \
            _numel(unit.output_sample_shape)
    if hasattr(unit, "kx"):        # pooling: a window reduce per output
        return float(unit.ky * unit.kx * out_elems)
    if "LRN" in kind:
        return 10.0 * out_elems
    return float(out_elems)        # activations, dropout, the rest


def model_flops_per_sample(forwards: List[Any]) -> Dict[str, float]:
    """{"forward": F, "train": T} FLOPs of one sample, with the 3x / 2x
    weighted / weightless training multipliers."""
    fwd = train = 0.0
    for u in forwards:
        f = forward_flops_per_sample(u)
        fwd += f
        train += f * (3.0 if unit_has_weights(u) else 2.0)
    return {"forward": fwd, "train": train}


def layer_flops_table(forwards: List[Any]) -> List[Dict[str, Any]]:
    """Per-layer rows: name, type, output shape, forward and train FLOPs
    a sample, and the weights' and bias's element count."""
    rows = []
    for u in forwards:
        f = forward_flops_per_sample(u)
        shapes = _param_shapes(u)
        rows.append({
            "name": u.name,
            "type": type(u).__name__,
            "output_shape": tuple(int(s) for s in u.output_shape),
            "fwd_flops_per_sample": f,
            "train_flops_per_sample":
                f * (3.0 if "weights" in shapes else 2.0),
            "params": _numel(shapes.get("weights", ())) +
                      _numel(shapes.get("bias", ())),
        })
    return rows


def mfu(images_per_sec: float, train_flops_per_sample: float,
        device: Any) -> Optional[float]:
    """Model FLOPs utilization against the card's peak; None when the
    peak is unknown."""
    peak = device_peak_flops(device)
    if not peak:
        return None
    return images_per_sec * train_flops_per_sample / peak


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler.profile`` over the block, with CPU activity and,
    when a card is there, CUDA activity; on exit the Chrome trace is
    exported into ``log_dir`` as ``trace_<pid>_<time>.json``.  Yields
    the profiler (its ``key_averages()`` and ``events()`` are readable
    after the block), or None and does nothing when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}"
                 f".json"))
