"""The port's LRN forward against the JAX package's.

``lrn_fwd_plain`` is the function the CUDA kernel computes (and what
the wrapper runs on a CPU tensor); it is held against the reference's
``LRNormalizer`` (XLA's banded form on jnp arrays) and against the
reference's Pallas kernel in interpret mode, at AlexNet's channel
widths, with the tolerances of the reference's own Pallas test
(``tests/test_ops.py``: rtol 2e-5, atol 1e-6 in f32).  The CUDA kernel
itself runs only on the card; ``chip_smoke.py`` holds it against
``lrn_fwd_plain`` there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu.ops import lrn as jax_lrn
from veles_tpu.ops import lrn_pallas
from veles_tpu_torch.ops import lrn as port_lrn
from veles_tpu_torch.ops import lrn_cuda

RTOL, ATOL = 2e-5, 1e-6
#: (C, n): AlexNet's widths, then the edges of the kernels' design that
#: chip_smoke.py also drives on the card: C not a multiple of the
#: 8-element vector, C under n, n = 1, a window past the vector path's
#: widest (9) and one wider than a neighbouring vector (19)
CASES = [(96, 5), (256, 5), (96, 4), (100, 5), (3, 5), (96, 1), (96, 9),
         (96, 19)]


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_band_matrix_matches_reference(n):
    for c in (7, 16, 96):
        for transpose in (False, True):
            np.testing.assert_array_equal(
                lrn_cuda.band_matrix(c, n, transpose),
                jax_lrn.band_matrix(c, n, transpose))


def _x(c, seed):
    # large enough that alpha * window sum is a sizable part of den
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 5, 4, c)) * 30.0).astype(np.float32)


@pytest.mark.parametrize("c,n", CASES)
def test_plain_matches_reference_unit_and_pallas_kernel(c, n):
    """Against the reference unit's XLA form and its numpy oracle, and
    against its Pallas kernel in interpret mode where that kernel takes
    the config (``lrn_pallas.usable``: not for C under n)."""
    k, alpha = 2.0, 1e-4
    x = _x(c, seed=c + n)
    got = lrn_cuda.lrn_fwd_plain(torch.from_numpy(x), n, k, alpha).numpy()

    ref_unit = jax_lrn.LRNormalizer(alpha=alpha, beta=0.75, n=n, k=k)
    want_xla, _ = ref_unit.apply_fwd({}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want_xla), RTOL, ATOL)
    want_np, _ = ref_unit.apply_fwd({}, x, train=False)
    np.testing.assert_allclose(got, want_np, RTOL, ATOL)

    if lrn_pallas.usable(x.shape, n, 0.75):
        want_pl = lrn_pallas.lrn_fwd(jnp.asarray(x), n, k, alpha,
                                     interpret=True)
        np.testing.assert_allclose(got, np.asarray(want_pl), RTOL, ATOL)
    else:
        assert n > c


@pytest.mark.parametrize("beta", [0.5, 1.0, 0.6])
def test_plain_other_beta_matches_reference_unit(beta):
    """beta != 3/4 takes the general power (the kernel's powf)."""
    x = _x(16, seed=3)
    got = lrn_cuda.lrn_fwd_plain(torch.from_numpy(x), 5, 2.0, 1e-3,
                                 beta).numpy()
    ref_unit = jax_lrn.LRNormalizer(alpha=1e-3, beta=beta, n=5, k=2.0)
    want, _ = ref_unit.apply_fwd({}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), RTOL, ATOL)


def test_port_unit_matches_reference_and_counts_no_launch_on_cpu():
    x = _x(96, seed=7)
    before = lrn_cuda.lrn_fwd.launches
    unit = port_lrn.LRNormalizer(alpha=1e-4, beta=0.75, n=5, k=2.0)
    unit.initialize(x.shape)
    got, res = unit.apply_fwd({}, torch.from_numpy(x), train=False)
    assert res is None and got.dtype == torch.float32
    ref_unit = jax_lrn.LRNormalizer(alpha=1e-4, beta=0.75, n=5, k=2.0)
    want, _ = ref_unit.apply_fwd({}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    # a CPU tensor takes the plain version: the kernel's count is the
    # count of kernel launches only
    assert lrn_cuda.lrn_fwd(torch.from_numpy(x), 5, 2.0, 1e-4) is not None
    assert lrn_cuda.lrn_fwd.launches == before == 0


def test_plain_bf16_squares_in_input_dtype():
    """bf16 in: x*x is rounded to bf16 before the f32 window sum, as
    the Pallas kernel squares in its input dtype; y comes back bf16."""
    x = torch.from_numpy(_x(8, seed=11)).to(torch.bfloat16)
    y = lrn_cuda.lrn_fwd_plain(x, 5, 2.0, 1e-4)
    assert y.dtype == torch.bfloat16
    xf = x.float()
    sq = (x * x).float()
    band = torch.from_numpy(lrn_cuda.band_matrix(8, 5))
    r = torch.rsqrt(2.0 + 1e-4 * (sq.reshape(-1, 8) @ band))
    want = (xf.reshape(-1, 8) * (r * torch.sqrt(r))).to(
        torch.bfloat16).reshape(x.shape)
    assert torch.equal(y, want)
    # squaring in f32 instead gives another answer somewhere
    r32 = torch.rsqrt(2.0 + 1e-4 * ((xf * xf).reshape(-1, 8) @ band))
    assert not torch.equal((xf.reshape(-1, 8) * r32).float(),
                           (xf.reshape(-1, 8) * r).float())


def test_check_config_rejects_what_the_kernel_cannot_take():
    lrn_cuda.check_config(96, 5)
    lrn_cuda.check_config(lrn_cuda.MAX_CHANNELS, 1)
    with pytest.raises(ValueError):
        lrn_cuda.check_config(96, 0)
    with pytest.raises(ValueError):
        lrn_cuda.check_config(lrn_cuda.MAX_CHANNELS + 1, 5)
    unit = port_lrn.LRNormalizer(n=0)
    with pytest.raises(ValueError):
        unit.initialize((1, 3, 3, 8))
