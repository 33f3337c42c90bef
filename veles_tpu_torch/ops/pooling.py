"""Pooling units: max, average and stochastic over VALID windows with a
floor-size output, and their gradient units.

Counterpart of ``veles_tpu/ops/pooling.py`` (``MaxPooling``,
``AvgPooling``, ``StochasticPooling``, ``GDMaxPooling``,
``GDAvgPooling``).  NHWC at the
boundary; the NCHW view inside is the same memory (see ``ops/conv.py``).
The backward is the backward of ``F.max_pool2d`` / ``F.avg_pool2d``
(``torch.func.vjp`` at the saved input), as the reference takes
``jax.vjp`` of its ``reduce_window``.  Where a max window holds equal
values, torch and XLA may route the error to different ones; on a real
net those ties are the zeros a ReLU leaves, whose gradient the ReLU
kills anyway.

``StochasticPooling`` works on the (B, OH, OW, ky*kx, C) window stack
the reference builds (window position ``iy*kx + ix``).  Eval mode is
the probability-weighted average with ``p = |x| / max(sum |x|,
1e-12)`` over each window; train mode samples one element per window
with ``p ∝ |x|`` by Gumbel-max on ``log(|x| + 1e-12)``, the Gumbel
noise ``-log(-log(max(u, tiny)))`` from the uniforms of
``prng.uniform`` (``jax.random.gumbel``'s formula), and keeps
``(x, idx)``.  ``GDStochasticPooling`` routes the error to the sampled
elements with a scatter-add (overlapping windows add), as the
reference's ``GDMaxPooling`` does through the saved indices; the
autograd re-run of the other pools would differentiate the eval-mode
average instead.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from veles_tpu_torch import prng
from veles_tpu_torch.ops.conv import _pair, conv_out_size
from veles_tpu_torch.ops.nn_units import ForwardUnit, GradientUnit


class PoolingBase(ForwardUnit):

    def __init__(self, workflow=None, kx: int = 2, ky: int = 2,
                 sliding: Any = None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = kx, ky
        self.sliding = _pair(sliding) if sliding is not None else (ky, kx)

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        sy, sx = self.sliding
        return (b, conv_out_size(h, self.ky, 0, sy),
                conv_out_size(w, self.kx, 0, sx), c)

    def pool(self, x_nchw: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        return self.pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaxPooling(PoolingBase):
    def pool(self, x_nchw):
        return F.max_pool2d(x_nchw, (self.ky, self.kx), self.sliding)


class AvgPooling(PoolingBase):
    def pool(self, x_nchw):
        return F.avg_pool2d(x_nchw, (self.ky, self.kx), self.sliding)


class StochasticPooling(PoolingBase):
    """Train: one window element sampled with p ∝ |x|; eval: the
    probability-weighted average (Zeiler & Fergus 2013)."""

    stochastic = True

    def windows(self, x: torch.Tensor) -> torch.Tensor:
        """(B, OH, OW, ky*kx, C) strided views stacked, row-major over
        the window."""
        sy, sx = self.sliding
        _, oh, ow, _ = self.output_shape_for(tuple(x.shape))
        return torch.stack(
            [x[:, iy:iy + (oh - 1) * sy + 1:sy, ix:ix + (ow - 1) * sx + 1:sx]
             for iy in range(self.ky) for ix in range(self.kx)], dim=3)

    def apply(self, params, x):
        w = self.windows(x)
        a = torch.abs(w)
        p = a / torch.clamp(a.sum(dim=3, keepdim=True), min=1e-12)
        return (w * p).sum(dim=3)

    def apply_fwd(self, params, x, rng=None, train=True):
        if not train:
            return self.apply(params, x), None
        if rng is None:
            raise ValueError(f"{self.name}: training mode needs a "
                             f"generator")
        w = self.windows(x)
        u = prng.uniform(rng, w.shape, w.device)
        tiny = torch.finfo(torch.float32).tiny
        g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        idx = (torch.log(torch.abs(w) + 1e-12) + g).argmax(dim=3)
        y = torch.gather(w, 3, idx[:, :, :, None, :])[:, :, :, 0, :]
        return y, (x, idx)


class GDStochasticPooling(GradientUnit):
    """err_input: each window's error added onto the element its
    forward sampled."""

    def backward_from_saved(self, params, saved, err_output):
        x, idx = saved
        f = self.forward
        b, h, w, c = x.shape
        _, oh, ow, _ = err_output.shape
        sy, sx = f.sliding
        dev = x.device
        row = (torch.arange(oh, device=dev) * sy)[None, :, None, None] + \
            torch.div(idx, f.kx, rounding_mode="floor")
        col = (torch.arange(ow, device=dev) * sx)[None, None, :, None] + \
            idx % f.kx
        flat = ((torch.arange(b, device=dev)[:, None, None, None] * h
                 + row) * w + col) * c + \
            torch.arange(c, device=dev)[None, None, None, :]
        # out of place: under torch.func.vmap the error is batched over
        # members and the fresh zeros are not
        err_input = torch.index_add(
            torch.zeros(b * h * w * c, dtype=err_output.dtype, device=dev),
            0, flat.reshape(-1), err_output.reshape(-1))
        return err_input.reshape(x.shape), {}


class _GDPooling(GradientUnit):
    def backward_from_saved(self, params, saved, err_output):
        # torch.func.vjp, not autograd.grad: it also runs inside
        # torch.func.vmap (the population engine's member axis)
        x, _ = saved
        _, pullback = torch.func.vjp(lambda t: self.forward.apply({}, t), x)
        (err_input,) = pullback(err_output)
        return err_input, {}


GDMaxPooling = _GDPooling
GDAvgPooling = _GDPooling
