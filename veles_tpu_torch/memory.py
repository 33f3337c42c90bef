"""Vector: a host array and its device twin, kept coherent explicitly
(the port's copy of ``veles_tpu/memory.py``).

A ``Vector`` holds a numpy host array (``.mem``) and a ``torch.Tensor``
on its device (``.devmem``, on the ``torch.device`` of the
``TorchDevice`` it was initialized with).  The reference's protocol
keeps them coherent:

- ``map_read()``: the host is about to read (copy down if stale);
- ``map_write()``: the host will read and write (the device goes stale);
- ``map_invalidate()``: the host will overwrite all of it (no copy
  down; the device goes stale);
- ``unmap()``: the device is about to compute (copy up if stale).

A device write REBINDS ``devmem`` to the computation's output tensor,
as the reference rebinds its immutable ``jax.Array``: assigning
``devmem`` marks the host copy stale.  A host copy is never a view of a
device tensor, not even of one on the CPU, so a host write cannot reach
the device behind the protocol's back.  Pickling syncs the host copy and
drops the device one.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch.backends import TorchDevice

HOST = 1
DEVICE = 2


def as_device(device: Any) -> Optional[TorchDevice]:
    """A ``TorchDevice`` for ``device`` (a TorchDevice, a
    ``torch.device`` or its name); None stays None."""
    if device is None or isinstance(device, TorchDevice):
        return device
    return TorchDevice(torch.device(device))


def _to_host(t: torch.Tensor) -> np.ndarray:
    a = t.detach().to("cpu").numpy()
    return a.copy() if t.device.type == "cpu" else a


class Vector:
    """A host numpy array and an optional device tensor, synchronized
    explicitly."""

    def __init__(self, data: Optional[np.ndarray] = None,
                 name: str = "") -> None:
        self.name = name
        self._mem: Optional[np.ndarray] = None
        self._devmem: Optional[torch.Tensor] = None
        self._valid = 0
        self.device: Optional[TorchDevice] = None
        if data is not None:
            self.mem = data

    # -- allocation ----------------------------------------------------

    @property
    def mem(self) -> Optional[np.ndarray]:
        return self._mem

    @mem.setter
    def mem(self, value: Optional[np.ndarray]) -> None:
        if value is None:
            self._mem = None
            self._valid = 0
            return
        self._mem = np.ascontiguousarray(value)
        self._valid = HOST

    def reset(self, new_mem: Optional[np.ndarray] = None) -> None:
        self._devmem = None
        self.mem = new_mem

    def drop_devmem(self) -> None:
        """Free the device copy.  A valid host copy survives; where the
        device held the only valid copy, the stale host array goes too,
        and the vector reads as unallocated."""
        self._devmem = None
        self._valid &= HOST
        if not self._valid:
            self._mem = None

    def __bool__(self) -> bool:
        return self._mem is not None or self._devmem is not None

    @property
    def shape(self) -> Tuple[int, ...]:
        if self._mem is not None:
            return self._mem.shape
        if self._devmem is not None:
            return tuple(self._devmem.shape)
        raise AttributeError(f"Vector '{self.name}' not allocated")

    @property
    def dtype(self) -> np.dtype:
        if self._mem is not None:
            return self._mem.dtype
        return torch.empty(0, dtype=self._devmem.dtype).numpy().dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        """Bytes of the freshest buffer."""
        if self._mem is not None:
            return int(self._mem.nbytes)
        if self._devmem is not None:
            return int(self._devmem.element_size() * self._devmem.numel())
        return 0

    @property
    def sample_size(self) -> int:
        """Elements per sample of the leading axis."""
        s = self.shape
        return int(np.prod(s[1:])) if len(s) > 1 else 1

    def __len__(self) -> int:
        return self.shape[0]

    # -- device attach -------------------------------------------------

    def initialize(self, device: Any, upload: bool = True) -> None:
        """Attach to ``device`` and push the host data to it.
        ``upload=False`` attaches without the push, for a buffer that is
        rebound or overwritten before it is read (a unit's output)."""
        self.device = as_device(device)
        if upload and self.device is not None and self._mem is not None:
            self.unmap()

    @property
    def devmem(self) -> Optional[torch.Tensor]:
        return self._devmem

    @devmem.setter
    def devmem(self, value: Optional[torch.Tensor]) -> None:
        """Rebind the device tensor (a computation's output) and mark the
        host copy stale: a device-side write."""
        self._devmem = value
        self._valid = DEVICE if value is not None else (self._valid & HOST)

    # -- coherence protocol -------------------------------------------

    def map_read(self) -> np.ndarray:
        """The host is about to read: copy down if the host is stale."""
        if not self._valid & HOST:
            if self._devmem is None:
                raise RuntimeError(f"Vector '{self.name}': nothing valid")
            self._mem = _to_host(self._devmem)
            self._valid |= HOST
        return self._mem

    def map_write(self) -> np.ndarray:
        """The host will read and write: sync down, then the device copy
        is stale."""
        m = self.map_read()
        self._valid = HOST
        return m

    def map_invalidate(self) -> np.ndarray:
        """The host will overwrite all of it: no sync down, the device
        copy is stale."""
        if self._mem is None:
            if self._devmem is None:
                raise RuntimeError(f"Vector '{self.name}': nothing valid")
            self._mem = np.empty(self.shape, self.dtype)
        self._valid = HOST
        return self._mem

    def current(self) -> Any:
        """The freshest buffer without a transfer: the device tensor
        when one is bound, else the host array."""
        return self._devmem if self._devmem is not None else self._mem

    def unmap(self) -> Any:
        """The device is about to compute: copy up if the device is
        stale.  The device tensor (the host array with no device)."""
        if self.device is None:
            return self._mem
        if not self._valid & DEVICE:
            if self._mem is None:
                raise RuntimeError(f"Vector '{self.name}': nothing valid")
            self._devmem = self.device.put(self._mem)
            self._valid = HOST | DEVICE
        return self._devmem

    # -- snapshots -----------------------------------------------------

    def __getstate__(self) -> dict:
        if self._valid and not (self._valid & HOST):
            self.map_read()
        return {"name": self.name, "mem": self._mem}

    def __setstate__(self, state: dict) -> None:
        self.name = state["name"]
        self._mem = state["mem"]
        self._devmem = None
        self.device = None
        self._valid = HOST if self._mem is not None else 0

    def __repr__(self) -> str:
        shape = None
        try:
            shape = self.shape
        except AttributeError:
            pass
        return f"Vector('{self.name}', shape={shape}, valid={self._valid})"
