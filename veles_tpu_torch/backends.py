"""Devices: where the port's tensors live and which dtype they compute in.

Counterpart of ``veles_tpu/backends.py`` (``JaxDevice``,
``make_device``), single-device only.

- :class:`TorchDevice` wraps one ``torch.device``.  ``put`` copies a
  host array onto it (counting ``h2d_bytes``), ``get`` copies back,
  ``zeros`` allocates there, ``synchronize`` waits for its queue.
- The dtype policy mirrors ``JaxDevice``: bf16 on the accelerator
  (CUDA here, the TPU there), f32 on the CPU.
- TF32 is switched OFF for both cuBLAS matmuls and cuDNN convolutions
  when a CUDA device is made: cuDNN defaults to TF32 for f32 convs,
  which keeps about three decimal digits and would make an f32 run on
  the card disagree with the f32 reference by far more than its
  summation order does.  bf16 compute is unaffected.
- :func:`make_device` has NO silent fallback, unlike the reference's
  ``make_device("auto")``, which drops to the CPU when no accelerator
  answers: ``"auto"`` means CUDA device 0 and raises when there is
  none.  ``"cpu"`` is the only way onto the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


class TorchDevice:
    """One torch device plus the port's dtype policy."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.platform = self.device.type          # "cuda" | "cpu"
        self.backend_name = "torch"
        if self.platform == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.compute_dtype = torch.bfloat16 if self.platform == "cuda" \
            else torch.float32
        #: bytes copied host -> device through :meth:`put`
        self.h2d_bytes = 0

    def put(self, array: Any) -> torch.Tensor:
        """A device copy of a host array (dtype-preserving).  The copy
        is a value snapshot: the caller may reuse its buffer at once."""
        arr = np.ascontiguousarray(array)
        self.h2d_bytes += arr.nbytes
        t = torch.from_numpy(arr.copy() if self.platform == "cpu"
                             else arr)
        return t.to(self.device)

    def get(self, t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu").numpy()

    def zeros(self, shape, dtype: torch.dtype = torch.float32) \
            -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def synchronize(self) -> None:
        if self.platform == "cuda":
            torch.cuda.synchronize(self.device)

    def total_memory(self) -> Optional[int]:
        """Device memory in bytes, or None where the device reports
        none (the CPU)."""
        if self.platform == "cuda":
            return int(torch.cuda.get_device_properties(
                self.device).total_memory)
        return None

    def __repr__(self) -> str:
        return f"<TorchDevice {self.device} compute={self.compute_dtype}>"


def make_device(backend: str = "auto") -> TorchDevice:
    """``"auto"``/``"cuda"``: CUDA device 0, raising when there is no
    card.  ``"cpu"``: the CPU (tests and the plain path)."""
    if backend in ("auto", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"backend {backend!r} needs a CUDA device and "
                f"torch.cuda.is_available() is False; pass -b cpu to "
                f"run on the CPU")
        return TorchDevice(torch.device("cuda", 0))
    if backend == "cpu":
        return TorchDevice(torch.device("cpu"))
    raise ValueError(f"unknown backend {backend!r} "
                     f"(want auto, cuda or cpu)")
