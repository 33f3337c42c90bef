"""ResizableAll2All: a dense layer whose output width changes between
training runs, keeping the columns it has already learned.

Counterpart of ``veles_tpu/ops/resizable_all2all.py``.  The port's
params live in the fused runner (``ops/fused.py``), not in the unit, so
:meth:`ResizableAll2All.resize` works through the workflow's runner:

- it reads the f32 master params with ``host_params``;
- it draws the new layer's params from the ``"weights"`` stream at its
  new width (``fill_params``, bitwise the reference's draws at that
  point of the stream) and copies the overlapping columns (and bias
  entries) over them;
- it writes them back with ``set_host_params``, which reshapes the
  layer's momentum buffers as the reference's ``reconcile_velocities``
  does (the overlap keeps its history, new entries start at zero);
- it rebuilds the runner's chains (``invalidate_trace``).

The next layer's input width changes with it: the caller refills that
layer for the new width, as the reference's caller does.  Without a
runner (a unit outside a workflow) only the shapes change.
"""

from __future__ import annotations

import logging

import numpy as np

from veles_tpu_torch.ops.all2all import All2All, GradientDescent

log = logging.getLogger("veles.resizable_all2all")


class ResizableAll2All(All2All):
    def resize(self, new_output: int) -> None:
        """Change the output width to ``new_output``: kept columns carry
        their trained values, new ones are drawn from the ``"weights"``
        stream."""
        new_output = int(new_output)
        old = self.neurons_number
        if new_output == old:
            return
        if new_output <= 0:
            raise ValueError(f"{self.name}: resize to {new_output}")
        fused = getattr(self.workflow, "fused", None)
        params = fused.host_params() \
            if fused is not None and fused.has_params else None
        self.output_sample_shape = (new_output,)
        if self.input_shape is not None:
            self.initialize(self.input_shape)
        if params is not None:
            new = self.fill_params()
            keep = min(old, new_output)
            for pname, a in params[self.name].items():
                new[pname][..., :keep] = np.asarray(a)[..., :keep]
            params[self.name] = new
            fused.set_host_params(params)
            fused.invalidate_trace()
        log.info("resized %s: %d -> %d outputs", self.name, old,
                 new_output)


class GDResizableAll2All(GradientDescent):
    """The dense backward; the runner reshapes its momentum buffers
    after a resize (``FusedStepRunner.set_host_params``)."""
