"""AcceleratedUnit: the base of a unit that computes on a device (the
port's copy of ``veles_tpu/accelerated_units.py``).

A subclass declares:

- ``apply(params, inputs, rng=None) -> outputs``: a pure function of
  ``{name: torch.Tensor}`` dicts, run on the unit's device;
- ``gather_params()`` and its ``Vector``s through
  :meth:`~AcceleratedUnit.declare_input` and
  :meth:`~AcceleratedUnit.declare_output`, so the unit knows what to
  sync around a firing.

``run()`` keeps the reference's dispatch shape: sync the inputs up,
compute, and rebind the outputs' device tensors, which stay on the
device until someone ``map_read``s them.  There is one path for every
device (no ``torch.compile``); with no device given, ``initialize``
takes the card (``make_device("auto")``, which raises without one).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from veles_tpu_torch.backends import TorchDevice, make_device
from veles_tpu_torch.memory import Vector, as_device
from veles_tpu_torch.units import Unit


class AcceleratedUnit(Unit):
    """A unit whose ``run()`` computes on its device."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.device: Optional[TorchDevice] = None
        #: name -> Vector: buffers this unit reads (synced up before run)
        self.input_vectors: Dict[str, Vector] = {}
        #: name -> Vector: buffers this unit writes (rebound after run)
        self.output_vectors: Dict[str, Vector] = {}

    # -- wiring --------------------------------------------------------

    def declare_input(self, name: str, vector: Vector) -> Vector:
        self.input_vectors[name] = vector
        return vector

    def declare_output(self, name: str, vector: Vector) -> Vector:
        self.output_vectors[name] = vector
        return vector

    # -- lifecycle -----------------------------------------------------

    def initialize(self, device: Any = None, **kwargs: Any) -> None:
        self.device = as_device(device) or make_device("auto")
        for v in self.input_vectors.values():
            if v:
                v.initialize(self.device)
        for v in self.output_vectors.values():
            if v:
                # an output is rebound before anything reads it
                v.initialize(self.device, upload=False)

    # -- the pure compute seam ----------------------------------------

    def apply(self, params: Dict[str, torch.Tensor],
              inputs: Dict[str, torch.Tensor],
              rng: Any = None) -> Dict[str, torch.Tensor]:
        """Pure compute: tensors in, tensors out, on the inputs'
        device."""
        raise NotImplementedError

    def gather_params(self) -> Dict[str, torch.Tensor]:
        """The parameter tensors for ``apply``, on the device."""
        return {}

    def gather_inputs(self) -> Dict[str, torch.Tensor]:
        return {n: v.unmap() for n, v in self.input_vectors.items() if v}

    def scatter_outputs(self, outputs: Dict[str, torch.Tensor]) -> None:
        for n, t in outputs.items():
            v = self.output_vectors.get(n)
            if v is not None:
                v.devmem = t

    # -- dispatch ------------------------------------------------------

    def run(self) -> None:
        if self.device is None:
            raise RuntimeError(f"{self.name}: run() before initialize()")
        with torch.no_grad():
            outputs = self.apply(self.gather_params(), self.gather_inputs())
        self.scatter_outputs(outputs)
