"""The port's Kohonen SOM against the JAX package's on XLA:CPU.

- ``som_step_masked`` and ``som_qe_masked`` against the reference's on
  random inputs with a partial mask: winners and the valid count equal,
  the new weights and the quantization error within rtol 1e-5 / atol
  1e-6 (the same f32 operations; the matmuls sum in another order).
- ``KohonenForward.apply_fwd``'s distances likewise, and its initial
  weights bitwise the reference's.
- ``schedule_steps`` equals the reference's row for row, in the middle
  of an epoch, at an epoch's end (every step but the last at the old
  epoch's alpha and sigma) and past ``decay_epochs``.
- ``models/kohonen.py`` through ``create_workflow`` against the
  reference's ``KohonenWorkflow`` on its default (fused) path: 500
  samples in minibatches of 50 for 2 epochs; a train class that ends in
  a ragged, masked minibatch; a validation split, which runs the
  evaluation class; and the last two streamed from the host.  The bar
  is the reference's own numpy-vs-JAX one (``tests/test_models.py``):
  initial weights bitwise, the same minibatch order, equal counts,
  history loss (the mean quantization error) within rtol 1e-4, final
  weights within rtol 1e-4 / atol 1e-5.
- ``python -m veles_tpu_torch -b cpu veles_tpu_torch/models/kohonen.py``
  with a cut config trains.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _record_order, _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.models import kohonen as ref_kohonen
from veles_tpu.ops import kohonen as ref_ops
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.models import kohonen
from veles_tpu_torch.ops import kohonen as ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 99


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _som_inputs(seed=4, b=12, n=16, d=10):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0
    return w, x, mask


def test_som_step_and_qe_are_the_references():
    w, x, mask = _som_inputs()
    coords = ref_ops.grid_coords(4, 4).astype(np.float32)
    np.testing.assert_array_equal(ops.grid_coords(4, 4), coords)
    alpha, sigma = np.float32(0.3), np.float32(2.0)
    want = ref_ops.som_step_masked(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(coords), alpha, sigma,
        jnp.asarray(mask))
    t = torch.from_numpy
    got = ops.som_step_masked(t(w), t(x), t(coords),
                              torch.tensor(alpha), torch.tensor(sigma),
                              t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[3]) == float(want[3]) == 9.0
    for g, r in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    # the padded rows move nothing: the same step over the valid rows
    # alone, unmasked
    alone = ops.som_step_masked(t(w), t(x[:9]), t(coords),
                                torch.tensor(alpha), torch.tensor(sigma),
                                torch.ones(9))
    np.testing.assert_allclose(got[0].numpy(), alone[0].numpy(),
                               rtol=1e-6, atol=1e-7)
    want_qe = ref_ops.som_qe_masked(jnp.asarray(w), jnp.asarray(x),
                                    jnp.asarray(mask))
    got_qe = ops.som_qe_masked(t(w), t(x), t(mask))
    np.testing.assert_allclose(got_qe[0].numpy(), np.asarray(want_qe[0]),
                               rtol=1e-5, atol=1e-6)
    assert float(got_qe[1]) == float(want_qe[1])


def test_forward_distances_and_init_are_the_references():
    w, x, _ = _som_inputs(b=5, d=12)
    xs = x.reshape(5, 2, 3, 2)
    ref = ref_kohonen.KohonenForward(None, shape=(4, 4))
    want, _ = ref.apply_fwd({"weights": jnp.asarray(w)}, jnp.asarray(xs))
    port = ops.KohonenForward(None, shape=(4, 4))
    port.initialize(xs.shape)
    got, res = port.apply_fwd({"weights": torch.from_numpy(w)},
                              torch.from_numpy(xs))
    assert res is None and port.output_shape == (5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _seed_both(7)
    from veles_tpu import prng as ref_prng
    ref_w = ref_prng.get("weights").numpy.uniform(
        -0.1, 0.1, (16, 12)).astype(np.float32)
    np.testing.assert_array_equal(port.fill_params()["weights"], ref_w)


class _Loader:
    def __init__(self, epoch_number, epoch_ended):
        self.epoch_number, self.epoch_ended = epoch_number, epoch_ended


@pytest.mark.parametrize("epoch,ended", [(3, False), (3, True), (1, True),
                                         (9, True), (12, False)])
def test_schedule_steps_is_the_references(epoch, ended):
    cfg = {"alpha0": 0.3, "alpha_min": 0.01, "sigma_min": 0.5,
           "decay_epochs": 8}
    ref = ref_ops.KohonenTrainer(None, sigma0=4.0, **cfg)
    port = ops.KohonenTrainer(None, sigma0=4.0, **cfg)
    ref.loader = port.loader = _Loader(epoch, ended)
    want, got = ref.schedule_steps(5), port.schedule_steps(5)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    # two rows only where the epoch end crosses a step of the decay
    rows = set(zip(got[0].tolist(), got[1].tolist()))
    assert len(rows) == (2 if ended and epoch <= 8 else 1)
    if ended:
        assert (got[0][-1], got[1][-1]) == tuple(
            np.float32(v) for v in port.schedule_at(epoch))


# -- the workflow ------------------------------------------------------------

class _FL:
    workflow = None


CASES = {
    "published_shape": {"minibatch_size": 50, "n_train": 500, "n_valid": 0},
    "ragged": {"minibatch_size": 50, "n_train": 230, "n_valid": 0},
    "validation": {"minibatch_size": 50, "n_train": 300, "n_valid": 60},
    "streamed": {"minibatch_size": 50, "n_train": 230, "n_valid": 60,
                 "max_resident_bytes": 0},
}


def _train(mod, init, loader):
    _seed_both(SEED)
    w = mod.create_workflow(_FL(), loader=dict(
        loader, shape=(8, 8, 1), n_classes=10, seed=888),
        decision={"max_epochs": 2})
    init(w)
    first = weights(w)
    order = []
    _record_order(w, order)
    w.run()
    return w, first, order, list(w.decision.history), weights(w)


def weights(w):
    if hasattr(w.trainer, "host_weights"):
        return w.trainer.host_weights()
    return np.asarray(w.forward.weights.map_read()).copy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kohonen_trains_as_the_reference(case):
    loader = CASES[case]
    _, rfirst, rorder, rhist, rlast = _train(
        ref_kohonen, lambda w: w.initialize(device=JaxDevice(platform="cpu")),
        loader)
    w, pfirst, porder, phist, plast = _train(
        kohonen,
        lambda w: w.initialize(device=make_device("cpu"), train=True),
        loader)
    assert w.trainer.steps == 2 * -(-loader["n_train"] // 50)
    assert w.loader.device_resident == ("max_resident_bytes" not in loader)
    np.testing.assert_array_equal(pfirst, rfirst)
    assert porder == rorder
    # one firing per class: the whole class is one group
    assert len(porder) == len(phist)
    assert [(h["epoch"], h["class"], h["n_err"], h["count"])
            for h in phist] == [(h["epoch"], h["class"], h["n_err"],
                                 h["count"]) for h in rhist]
    for g, r in zip(phist, rhist):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-4)
    np.testing.assert_allclose(plast, rlast, rtol=1e-4, atol=1e-5)
    assert np.abs(plast - pfirst).max() > 0.1
    train = [h["loss"] for h in phist if h["class"] == "train"]
    assert train[-1] < train[0]


def test_kohonen_keeps_the_references_defaults():
    assert kohonen.DEFAULTS == ref_kohonen.DEFAULTS


def test_cli_trains_kohonen():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s", "5",
         "veles_tpu_torch/models/kohonen.py",
         "root.kohonen.loader.n_train=400",
         "root.kohonen.decision.max_epochs=3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "epoch 3 train: n_err=0" in proc.stderr
    assert "complete: reached max_epochs=3" in proc.stderr
    assert "wall-clock: 1200 train + 0 eval samples, 12 SOM steps" \
        in proc.stderr
