"""The port's LRN backward against the JAX package's.

``lrn_bwd_plain`` is the function the CUDA ``lrn_bwd`` kernel computes
(and what the wrapper runs on CPU tensors).  At AlexNet's channel widths
and an even window, with alpha = 3e-2 so that the window term matters,
it is held against three references in f32, at the tolerance of the
reference's own Pallas backward test (``tests/test_ops.py``: rtol 2e-4,
atol 1e-5): the reference's ``GDLRNormalizer`` on numpy (its
shifted-adds oracle), the reference's Pallas kernel in interpret mode,
and autograd of ``lrn_fwd_plain`` in f64 taken through ``LRNFunction``.
The kernel itself runs only on the card; ``chip_smoke.py`` holds it
against ``lrn_bwd_plain`` there.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from veles_tpu.ops import lrn as jax_lrn
from veles_tpu.ops import lrn_pallas
from veles_tpu_torch.ops import lrn as port_lrn
from veles_tpu_torch.ops import lrn_cuda

RTOL, ATOL = 2e-4, 1e-5
K, ALPHA = 2.0, 3e-2
#: (C, n): AlexNet's widths, then the edges of the kernels' design that
#: chip_smoke.py also drives on the card: C not a multiple of the
#: 8-element vector, C under n, n = 1, a window past the vector path's
#: widest (9) and one wider than a neighbouring vector (19)
CASES = [(96, 5), (256, 5), (96, 4), (100, 5), (3, 5), (96, 1), (96, 9),
         (96, 19)]
#: the cases the reference's Pallas kernel takes (not C under n)
PALLAS_CASES = [(c, n) for c, n in CASES
                if lrn_pallas.usable((16, 3, 3, c), n, 0.75)]


def _inputs(c, n, seed=None):
    rng = np.random.default_rng(seed if seed is not None else c * 10 + n)
    x = rng.standard_normal((16, 3, 3, c)).astype(np.float32)
    err = rng.standard_normal(x.shape).astype(np.float32)
    return x, err


def _plain(x, err, n, beta=0.75, alpha=ALPHA):
    return lrn_cuda.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(err),
                                  n, K, alpha, beta).numpy()


@pytest.mark.parametrize("c,n", CASES)
def test_plain_matches_reference_numpy_oracle(c, n):
    x, err = _inputs(c, n)
    u = jax_lrn.LRNormalizer(alpha=ALPHA, beta=0.75, n=n, k=K)
    _, res = u.apply_fwd({}, x)
    want, grads = jax_lrn.GDLRNormalizer(forward=u).backward_from_saved(
        {}, res, err)
    assert grads == {}
    np.testing.assert_allclose(_plain(x, err, n), want, RTOL, ATOL)


@pytest.mark.parametrize("c,n", PALLAS_CASES)
def test_plain_matches_reference_pallas_kernel(c, n):
    x, err = _inputs(c, n)
    assert lrn_pallas.usable(x.shape, n, 0.75)
    want = np.asarray(lrn_pallas.lrn_bwd(x, err, n, K, ALPHA,
                                         interpret=True))
    np.testing.assert_allclose(_plain(x, err, n), want, RTOL, ATOL)


@pytest.mark.parametrize("c,n", CASES)
def test_lrn_function_matches_autograd_of_plain_forward_in_f64(c, n):
    x, err = _inputs(c, n)
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    y64 = lrn_cuda.lrn_fwd_plain(x64, n, K, ALPHA)
    (want,) = torch.autograd.grad(y64, x64, torch.from_numpy(err).double())

    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_lrn.LRNFunction.apply(xt, n, K, ALPHA, 0.75)
    np.testing.assert_allclose(
        y.detach().numpy(), lrn_cuda.lrn_fwd_plain(
            torch.from_numpy(x), n, K, ALPHA).numpy())
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(err))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), RTOL, ATOL)


@pytest.mark.parametrize("beta", [0.5, 1.0, 0.6])
def test_plain_other_beta_matches_reference_oracle(beta):
    """beta != 3/4 takes the general powers (the kernel's powf)."""
    x, err = _inputs(16, 5, seed=3)
    u = jax_lrn.LRNormalizer(alpha=ALPHA, beta=beta, n=5, k=K)
    _, res = u.apply_fwd({}, x)
    want, _ = jax_lrn.GDLRNormalizer(forward=u).backward_from_saved(
        {}, res, err)
    np.testing.assert_allclose(_plain(x, err, 5, beta), want, RTOL, ATOL)


def test_plain_bf16_rounds_t_before_the_adjoint_sum():
    """bf16 in: t = e*x*den^-(beta+1) is rounded to bf16 before its
    window sum, as the Pallas kernel feeds it to the matrix unit; the
    result comes back in err's dtype."""
    x, err = _inputs(8, 5, seed=11)
    xb = (torch.from_numpy(x) * 30).to(torch.bfloat16)
    eb = torch.from_numpy(err).to(torch.bfloat16)
    got = lrn_cuda.lrn_bwd_plain(xb, eb, 5, K, 1e-4)
    assert got.dtype == torch.bfloat16
    xf, ef = xb.float().reshape(-1, 8), eb.float().reshape(-1, 8)
    band = torch.from_numpy(lrn_cuda.band_matrix(8, 5))
    r = torch.rsqrt(K + 1e-4 * ((xb * xb).float().reshape(-1, 8) @ band))
    d = r * torch.sqrt(r)
    t = ef * xf * (d * r * r)
    bt = torch.from_numpy(lrn_cuda.band_matrix(8, 5, transpose=True))

    def result(tt):
        return (ef * d - (2.0 * 1e-4 * 0.75) * xf * (tt @ bt)).to(
            torch.bfloat16).reshape(xb.shape)
    assert torch.equal(got, result(t.to(torch.bfloat16).float()))
    assert not torch.equal(got, result(t))


def test_port_units_count_no_launch_on_cpu():
    """CPU tensors take the plain versions: the kernels' counts are the
    counts of kernel launches only."""
    x, err = _inputs(96, 5, seed=7)
    fwd = port_lrn.LRNormalizer(alpha=ALPHA, beta=0.75, n=5, k=K)
    fwd.initialize(x.shape)
    gd = port_lrn.GDLRNormalizer(forward=fwd)
    y, res = fwd.apply_fwd({}, torch.from_numpy(x))
    assert res[0].shape == x.shape and res[1] is None
    ein, grads = gd.backward_from_saved({}, res, torch.from_numpy(err))
    assert grads == {}
    np.testing.assert_array_equal(ein.numpy(), _plain(x, err, 5))
    assert lrn_cuda.lrn_bwd.launches == 0 and lrn_cuda.lrn_fwd.launches == 0


def test_wrapper_refuses_mixed_devices():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="no kernel"):
        lrn_cuda.lrn_bwd(x, torch.ones(2, 8, device="meta"), 5, K, ALPHA)


def test_each_kernel_library_hashes_only_its_own_source(tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(lrn_cuda.CSRC_DIR, csrc)
    monkeypatch.setattr(lrn_cuda, "CSRC_DIR", str(csrc))
    before = {nm: lrn_cuda.library_path(nm) for nm in lrn_cuda.KERNELS}
    assert set(lrn_cuda.KERNELS) == {"lrn_fwd", "lrn_bwd"}
    assert len(set(before.values())) == 2
    for nm, path in before.items():
        assert os.path.dirname(path) == lrn_cuda.BUILD_DIR
        assert os.path.basename(path).startswith(f"lib{nm}-")
    with open(csrc / "lrn_bwd.cu", "a") as f:
        f.write("\n// edited\n")
    after = {nm: lrn_cuda.library_path(nm) for nm in lrn_cuda.KERNELS}
    assert after["lrn_fwd"] == before["lrn_fwd"]
    assert after["lrn_bwd"] != before["lrn_bwd"]
    with open(csrc / "lrn_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    again = {nm: lrn_cuda.library_path(nm) for nm in lrn_cuda.KERNELS}
    assert again["lrn_bwd"] == after["lrn_bwd"]
    assert again["lrn_fwd"] != after["lrn_fwd"]


def test_check_config_bounds_both_kernels_at_the_layer():
    """The largest C is the backward row path's: a row's f32 squares, t
    and e*d, 12 bytes a channel of shared memory within 227 KiB a block
    (the vector path has no limit of its own); the layer rejects more at
    its shape, before any launch."""
    assert lrn_cuda.MAX_CHANNELS == 232448 // 12 == 19370
    lrn_cuda.check_config(lrn_cuda.MAX_CHANNELS, 5)
    with pytest.raises(ValueError):
        lrn_cuda.check_config(lrn_cuda.MAX_CHANNELS + 1, 5)
    unit = port_lrn.LRNormalizer(n=5)
    with pytest.raises(ValueError, match="channels"):
        unit.initialize((1, 2, 2, lrn_cuda.MAX_CHANNELS + 1))
