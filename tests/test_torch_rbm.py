"""The port's RBM family and the wine and mnist_rbm models, against the
JAX package on XLA:CPU, with the reference's own uniforms injected
through the port's draw seam (``test_torch_layers.reference_draws``).

- ``Binarization``: the train-mode samples (``u < x``) and the eval-mode
  threshold exactly the reference's; the error passes straight through.
- ``RBM``: the reconstruction and ``hidden_of`` within rtol 1e-5 / atol
  1e-6; its three params cross ``convert.py`` unchanged.
- ``GDRBM`` at ``cd_k`` 1 and 2 from the same residual and key: the
  weights, bias and vbias gradients within rtol 1e-5 / atol 1e-6,
  ``err_input`` zeros; ``cd_k`` 0 refused.
- ``models/wine.py`` and ``models/mnist_rbm.py`` (binarization and CD-1
  sampling on the reference's draws) through ``create_workflow``, the
  port resident and streamed against the reference, under
  ``test_torch_zoo.py``'s rule: initial params bitwise, the same
  minibatch order, equal n_err and count, loss within rtol 1e-4, final
  params within rtol 1e-4 / atol 1e-5.
- ``python -m veles_tpu_torch -b cpu veles_tpu_torch/models/mnist_rbm.py``
  with a cut config trains (the wine CLI runs in
  ``test_torch_profiling.py``, with ``--profile``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import data_dir_in_both
from test_torch_layers import _key_chain, reference_draws  # noqa: F401
from test_torch_train import _seed_both
from test_torch_zoo import (_FL, _port_init, _ref_init, _run,
                            assert_reference_rule)
from veles_tpu.models import mnist_rbm as ref_mnist_rbm
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops import rbm as ref_rbm
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, params_to_jax
from veles_tpu_torch.models import mnist_rbm, wine
from veles_tpu_torch.ops import rbm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 9753


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rbm_params(n_vis, n_hid, seed=0):
    rng = np.random.default_rng(seed)
    return {"weights": (rng.standard_normal((n_vis, n_hid)) * 0.1)
            .astype(np.float32),
            "bias": (rng.standard_normal(n_hid) * 0.1).astype(np.float32),
            "vbias": (rng.standard_normal(n_vis) * 0.1).astype(np.float32)}


# -- the units ---------------------------------------------------------------

def test_binarization_samples_the_references_draws(reference_draws):
    x = np.random.default_rng(1).random((5, 6, 6, 1)).astype(np.float32)
    ref, port = ref_rbm.Binarization(None), rbm.Binarization(None)
    key = _key_chain(SEED, 7, 0, None)
    want, _ = ref.apply_fwd({}, jnp.asarray(x), rng=key)
    got, res = port.apply_fwd({}, torch.from_numpy(x),
                              rng=prng.torch_generator(SEED, 7, 0, None))
    assert res is None and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()
    want_eval, _ = ref.apply_fwd({}, jnp.asarray(x), train=False)
    got_eval, _ = port.apply_fwd({}, torch.from_numpy(x), train=False)
    np.testing.assert_array_equal(got_eval.numpy(), np.asarray(want_eval))
    err = torch.from_numpy(x)
    assert rbm.GDBinarization(None, forward=port).backward_from_saved(
        {}, None, err)[0] is err


def test_rbm_forward_is_the_references():
    params = _rbm_params(12, 5)
    x = np.random.default_rng(2).random((4, 3, 4, 1)).astype(np.float32)
    ref, port = ref_rbm.RBM(None, n_hidden=5), rbm.RBM(None, n_hidden=5)
    assert port.param_shapes(x.shape) == ref.param_shapes(x.shape) == \
        {"weights": (12, 5), "bias": (5,), "vbias": (12,)}
    out = ref.apply({k: jnp.asarray(v) for k, v in params.items()},
                    {"input": jnp.asarray(x)})
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    got, (rx, h0, rng) = port.apply_fwd(pp, torch.from_numpy(x), rng="key")
    assert got.shape == x.shape and rng == "key"
    _close(got, out["output"])
    _close(h0, out["hidden"])
    _close(port.hidden_of(pp, torch.from_numpy(x)), out["hidden"])
    # vbias crosses the layout conversion as it is, in both directions
    back = params_to_jax(params_from_jax({"r": params}))["r"]
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


@pytest.mark.parametrize("cd_k", [1, 2])
def test_gdrbm_cd_k_gradients_are_the_references(reference_draws, cd_k):
    params = _rbm_params(20, 6, seed=cd_k)
    x = (np.random.default_rng(3).random((8, 20)) > 0.5).astype(np.float32)
    key = _key_chain(SEED, 2, 1, None)
    ref = ref_rbm.RBM(None, n_hidden=6)
    rgd = ref_rbm.GDRBM(None, forward=ref, cd_k=cd_k)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    h0 = ref.hidden_of(jparams, jnp.asarray(x))
    want_in, want = jax.jit(lambda p, xx, hh, k: rgd.backward_from_saved(
        p, (xx, hh, k), None))(jparams, jnp.asarray(x), h0, key)
    port = rbm.RBM(None, n_hidden=6)
    gd = rbm.GDRBM(None, forward=port, cd_k=cd_k)
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    _, saved = port.apply_fwd(pp, torch.from_numpy(x),
                              rng=prng.torch_generator(SEED, 2, 1, None))
    got_in, got = gd.backward_from_saved(pp, saved, None)
    assert not got_in.any() and got_in.shape == x.shape
    assert set(got) == set(want) == {"weights", "bias", "vbias"}
    for k in got:
        _close(got[k], want[k])
    assert float(np.abs(np.asarray(want["weights"])).max()) > 1e-3
    with pytest.raises(ValueError, match="cd_k must be >= 1"):
        rbm.GDRBM(None, forward=port, cd_k=0)


# -- the models --------------------------------------------------------------

def _both(tmp_path, port_mod, ref_mod, overrides, streamed=False):
    with data_dir_in_both(tmp_path):
        _seed_both(SEED)
        ref = _run(ref_mod.create_workflow(_FL(), **overrides), _ref_init)
        port_over = dict(overrides)
        if streamed:
            port_over["loader"] = dict(overrides["loader"],
                                       max_resident_bytes=0)
        _seed_both(SEED)
        w = port_mod.create_workflow(_FL(), **port_over)
        port = _run(w, _port_init)
    assert w.loader.device_resident != streamed
    return ref, port, w


def test_wine_trains_as_the_reference(tmp_path):
    over = {"loader": dict(wine.DEFAULTS["loader"], n_valid=23),
            "decision": {"max_epochs": 4, "fail_iterations": 100}}
    assert wine.DEFAULTS == ref_wine.DEFAULTS
    ref, port, w = _both(tmp_path, wine, ref_wine, over)
    assert w.loader.class_lengths == [0, 23, 140]
    assert w.loader.sample_shape == (13, 1)
    assert_reference_rule(ref, port)
    # the streamed run is the resident run
    _, streamed, ws = _both(tmp_path, wine, ref_wine, over, streamed=True)
    assert ws.fused.stream_transfer_bytes > 0
    assert_reference_rule(ref, streamed)


RBM_CUT = {"loader": dict(mnist_rbm.DEFAULTS["loader"], minibatch_size=50,
                          n_train=150, n_valid=60),
           "decision": {"max_epochs": 2, "fail_iterations": 50}}


@pytest.fixture(scope="module")
def reference_rbm_run(tmp_path_factory):
    """The reference's mnist_rbm run on the cut set (its streamed run is
    its resident run)."""
    with data_dir_in_both(tmp_path_factory.mktemp("rbm")):
        _seed_both(SEED)
        return _run(ref_mnist_rbm.create_workflow(_FL(), **RBM_CUT),
                    _ref_init)


@pytest.mark.parametrize("streamed", [False, True])
def test_mnist_rbm_trains_as_the_reference(tmp_path, reference_draws,
                                           reference_rbm_run, streamed):
    assert mnist_rbm.DEFAULTS == ref_mnist_rbm.DEFAULTS
    over = dict(RBM_CUT)
    if streamed:
        over["loader"] = dict(RBM_CUT["loader"], max_resident_bytes=0)
    with data_dir_in_both(tmp_path):
        _seed_both(SEED)
        w = mnist_rbm.create_workflow(_FL(), **over)
        port = _run(w, _port_init)
    assert w.loader.device_resident != streamed
    assert [f.name for f in w.forwards] == ["fwd0_binarization", "fwd1_rbm"]
    assert_reference_rule(reference_rbm_run, port)
    valid = [h["loss"] for h in w.decision.history
             if h["class"] == "validation"]
    assert valid[-1] < valid[0]


def test_mnist_rbm_cli_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
         "veles_tpu_torch/models/mnist_rbm.py",
         "root.mnist_rbm.loader={'minibatch_size': 50, 'n_train': 100, "
         "'n_valid': 50, 'targets_from_data': True}",
         "root.mnist_rbm.decision.max_epochs=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "complete: reached max_epochs=2" in proc.stderr
    assert "epoch 2 train: n_err=0" in proc.stderr
