"""Each forward unit of the port against the JAX package's unit.

The same numpy inputs and params (the reference's layout, carried over
by ``convert.params_from_jax``) go through the reference's
``apply_fwd(train=False)`` on XLA:CPU and through the port's unit on the
CPU, in f32; atol 1e-5 covers the two libraries' summation orders at
these small widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu.ops import all2all as jax_all2all
from veles_tpu.ops import conv as jax_conv
from veles_tpu.ops import dropout as jax_dropout
from veles_tpu.ops import pooling as jax_pooling
from veles_tpu_torch.convert import params_from_jax, params_to_jax
from veles_tpu_torch.ops.registry import forward_registry

ATOL = 1e-5

#: (layer type, forward kwargs, input shape)
CASES = [
    ("conv", {"n_kernels": 6, "kx": 3, "ky": 3}, (2, 9, 9, 3)),
    ("conv_relu", {"n_kernels": 8, "kx": 11, "ky": 11, "sliding": 4},
     (2, 31, 27, 3)),
    ("conv_relu", {"n_kernels": 5, "kx": 5, "ky": 3, "padding": (1, 2)},
     (1, 8, 7, 4)),
    ("conv_tanh", {"n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
                   "sliding": (2, 1)}, (2, 7, 6, 3)),
    ("max_pooling", {"kx": 3, "ky": 3, "sliding": 2}, (2, 15, 14, 5)),
    ("max_pooling", {"kx": 2, "ky": 2}, (1, 7, 7, 3)),
    ("avg_pooling", {"kx": 3, "ky": 2, "sliding": (1, 2)}, (2, 8, 9, 4)),
    ("all2all", {"output_sample_shape": 7}, (3, 10)),
    ("all2all_relu", {"output_sample_shape": 16}, (2, 3, 3, 12)),
    ("all2all_tanh", {"output_sample_shape": (2, 3)}, (2, 5)),
    ("softmax", {"output_sample_shape": 5}, (4, 2, 2, 6)),
    ("dropout", {"dropout_ratio": 0.5}, (3, 4, 4, 2)),
]

_REFERENCE = {
    "conv": jax_conv.Conv, "conv_relu": jax_conv.ConvRELU,
    "conv_tanh": jax_conv.ConvTanh,
    "max_pooling": jax_pooling.MaxPooling,
    "avg_pooling": jax_pooling.AvgPooling,
    "all2all": jax_all2all.All2All,
    "all2all_relu": jax_all2all.All2AllRELU,
    "all2all_tanh": jax_all2all.All2AllTanh,
    "softmax": jax_all2all.All2AllSoftmax,
    "dropout": jax_dropout.Dropout,
}


@pytest.mark.parametrize("kind,kwargs,shape", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_unit_forward_matches_reference(kind, kwargs, shape):
    rng = np.random.default_rng(sum(shape))
    ref = _REFERENCE[kind](None, name="u", **kwargs)
    port = forward_registry[kind](None, name="u", **kwargs)
    port.initialize(shape)
    assert port.output_shape == tuple(ref.output_shape_for(shape))

    # weights at 1/sqrt(fan-in): outputs of order one, so atol is
    # about the f32 rounding of the sums
    params = {p: (rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]) or 1)
                  ).astype(np.float32)
              for p, s in ref.param_shapes(shape).items()}
    port_params = params_from_jax({"u": params})["u"]
    # the port's own param shapes are the converted reference ones
    assert {p: a.shape for p, a in port_params.items()} == \
        port.param_shapes(shape)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)

    want, _ = ref.apply_fwd({p: jnp.asarray(a) for p, a in params.items()},
                            jnp.asarray(x), train=False)
    got, res = port.apply_fwd(
        {p: torch.from_numpy(a) for p, a in port_params.items()},
        torch.from_numpy(x), train=False)
    assert res is None
    assert tuple(got.shape) == port.output_shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fc_flattens_in_nhwc_order():
    """The first fc layer reads an NHWC activation flattened row-major:
    a weight row is one (y, x, c) position, as in the reference."""
    unit = forward_registry["all2all"](None, name="fc",
                                       output_sample_shape=1,
                                       include_bias=False)
    x = torch.zeros(1, 2, 3, 4)
    x[0, 1, 2, 3] = 1.0
    w = torch.zeros(24, 1)
    w[((1 * 3) + 2) * 4 + 3, 0] = 5.0
    y, _ = unit.apply_fwd({"weights": w}, x)
    assert float(y) == 5.0


def test_conv_weights_round_trip_between_layouts():
    rng = np.random.default_rng(0)
    hwio = rng.standard_normal((5, 3, 4, 7)).astype(np.float32)
    port = params_from_jax({"c": {"weights": hwio,
                                  "bias": np.ones(7, np.float32)}})
    assert port["c"]["weights"].shape == (7, 4, 5, 3)
    back = params_to_jax(port)
    np.testing.assert_array_equal(back["c"]["weights"], hwio)
    np.testing.assert_array_equal(back["c"]["bias"], np.ones(7))


def test_training_mode_is_not_in_this_slice():
    """Training mode belongs to the training slice (now ported): there a
    unit keeps the residual its gradient unit reads, while eval mode
    keeps none, and dropout draws its mask only from the generator the
    fused step hands it."""
    unit = forward_registry["dropout"](None, name="d", dropout_ratio=0.5)
    with pytest.raises(ValueError, match="Generator"):
        unit.apply_fwd({}, torch.ones(2, 3), train=True)
    fc = forward_registry["all2all"](None, name="fc", output_sample_shape=2)
    x, w = torch.ones(1, 3), {"weights": torch.ones(3, 2)}
    y, res = fc.apply_fwd(w, x)
    assert res[0] is x and res[1] is y
    assert fc.apply_fwd(w, x, train=False)[1] is None
