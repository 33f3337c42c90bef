"""The port's small layer families, its resize and its confusion matrix,
against the JAX package on XLA:CPU.

- The five standalone activations, ``all2all_sigmoid`` and the cutter:
  output, ``err_input`` and gradients within rtol 1e-5 / atol 1e-5 (the
  same f32 formulas; XLA's and torch's transcendental functions differ
  in the last bits); the cutter's over-cut raises the reference's
  message.
- Stochastic pooling in eval mode, and in train mode with the
  reference's own uniforms injected through the port's draw seam
  (``prng.torch_generator`` and ``prng.uniform``, fixture
  ``reference_draws``): the sampled indices exactly equal, output and
  ``err_input`` (a scatter-add over overlapping windows) within rtol
  1e-5 / atol 1e-5.
- The resize scenario of ``tests/test_rbm_family.py``: train, widen a
  ``resizable_all2all`` layer, refill the softmax for the new width,
  train on.  The new columns and the refilled softmax are bitwise the
  reference's draws; the velocities keep their overlap; then
  ``test_torch_zoo.py``'s rule (equal n_err and count, loss within rtol
  1e-4, final params within rtol 1e-4 / atol 1e-5).
- The confusion matrix exactly equal to the reference's at every class
  end of a wine run whose validation class ends in a padded minibatch,
  and carried through a snapshot taken in the middle of a class.
- The registry's 24 layer type names equal the reference's.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _seed_both
from test_torch_zoo import _FL
from veles_tpu.backends import JaxDevice
from veles_tpu.loader.synthetic import \
    SyntheticClassificationLoader as RefLoader
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops import activation as ref_activation
from veles_tpu.ops import all2all as ref_all2all
from veles_tpu.ops import cutter as ref_cutter
from veles_tpu.ops import pooling as ref_pooling
from veles_tpu.ops.registry import forward_registry as ref_registry
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.models import wine
from veles_tpu_torch.ops import activation, all2all, cutter, pooling
from veles_tpu_torch.ops.registry import forward_registry, gd_registry
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

SEED = 8642


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _key_chain(seed, counter, layer, device):
    """The reference's layer key, ``fold_in(fold_in(key(seed), rc), i)``
    (``veles_tpu/engine/core.py``), in place of the port's generator."""
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                 counter), layer)


#: ``jax.random.uniform`` compiled once a shape (eagerly it compiles
#: every primitive of threefry on each new shape)
_uniform = jax.jit(lambda key, shape: jax.random.uniform(key, shape,
                                                         jnp.float32),
                   static_argnums=1)


def _reference_uniform(rng, shape, device, t=0):
    """``jax.random.uniform`` of the reference's key, and of
    ``fold_in(key, t)`` at Gibbs step ``t > 0`` (``GDRBM``)."""
    key = rng if t == 0 else jax.random.fold_in(rng, t)
    u = np.array(_uniform(key, tuple(int(s) for s in shape)))
    return torch.from_numpy(u).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's draw seam replaced: every stochastic layer draws the
    reference's own uniforms."""
    monkeypatch.setattr(prng, "torch_generator", _key_chain)
    monkeypatch.setattr(prng, "uniform", _reference_uniform)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# -- activations, all2all_sigmoid, cutter ----------------------------------

ACTIVATIONS = ["ActivationTanh", "ActivationSigmoid", "ActivationStrictRELU",
               "ActivationRELU", "ActivationLog"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_and_its_gradient_are_the_references(name):
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal((3, 4, 5, 2)) * 3).astype(np.float32)
    err = rng.standard_normal(x.shape).astype(np.float32)
    ref = getattr(ref_activation, name)(None)
    port = getattr(activation, name)(None)
    want = np.asarray(ref.apply({}, {"input": jnp.asarray(x)})["output"])
    got, saved = port.apply_fwd({}, torch.from_numpy(x))
    assert port.output_shape_for(x.shape) == x.shape
    _close(got, want)
    want_in, _ = ref_activation.GDActivation(None, forward=ref) \
        .backward_from_saved({}, (jnp.asarray(x), jnp.asarray(want)),
                             jnp.asarray(err))
    got_in, grads = activation.GDActivation(None, forward=port) \
        .backward_from_saved({}, saved, torch.from_numpy(err))
    assert grads == {}
    _close(got_in, want_in)


def test_all2all_sigmoid_and_its_gradient_are_the_references():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 3, 3)).astype(np.float32)
    w = rng.standard_normal((9, 7)).astype(np.float32) * 0.5
    b = rng.standard_normal(7).astype(np.float32)
    err = rng.standard_normal((6, 7)).astype(np.float32)
    ref = ref_all2all.All2AllSigmoid(None, output_sample_shape=7)
    port = all2all.All2AllSigmoid(None, output_sample_shape=7)
    assert port.activation_mode == ref.activation_mode == "sigmoid"
    rparams = {"weights": jnp.asarray(w), "bias": jnp.asarray(b)}
    pparams = {"weights": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    want = np.asarray(ref.apply(rparams, {"input": jnp.asarray(x)})["output"])
    got, saved = port.apply_fwd(pparams, torch.from_numpy(x))
    _close(got, want)
    want_in, want_g = ref_all2all.GDSigmoid(None, forward=ref) \
        .backward_from_saved(rparams, (jnp.asarray(x), jnp.asarray(want)),
                             jnp.asarray(err))
    got_in, got_g = all2all.GDSigmoid(None, forward=port) \
        .backward_from_saved(pparams, saved, torch.from_numpy(err))
    _close(got_in, want_in)
    assert set(got_g) == set(want_g) == {"weights", "bias"}
    for k in got_g:
        _close(got_g[k], want_g[k])


@pytest.mark.parametrize("padding", [(1, 2, 1, 1), (2, 1, 0, 3),
                                     (0, 0, 0, 0)])
def test_cutter_and_its_gradient_are_the_references(padding):
    rng = np.random.default_rng(sum(padding))
    x = rng.standard_normal((2, 10, 12, 3)).astype(np.float32)
    ref = ref_cutter.Cutter(None, padding=padding)
    port = cutter.Cutter(None, padding=padding)
    want = np.asarray(ref.apply({}, {"input": jnp.asarray(x)})["output"])
    got, saved = port.apply_fwd({}, torch.from_numpy(x))
    assert port.output_shape_for(x.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    err = rng.standard_normal(want.shape).astype(np.float32)
    want_in, _ = ref_cutter.GDCutter(None, forward=ref).backward_from_saved(
        {}, (jnp.asarray(x), jnp.asarray(want)), jnp.asarray(err))
    got_in, _ = cutter.GDCutter(None, forward=port).backward_from_saved(
        {}, saved, torch.from_numpy(err))
    assert got_in.shape == x.shape
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))


def test_cutter_refuses_an_over_cut_and_a_bad_padding():
    for mod in (ref_cutter, cutter):
        with pytest.raises(ValueError) as e:
            mod.Cutter(None, padding=(5, 5, 5, 5)).output_shape_for(
                (1, 8, 8, 1))
        assert str(e.value) == \
            "Cutter: padding (5, 5, 5, 5) consumes the whole 8x8 input"
        with pytest.raises(ValueError, match="required"):
            mod.Cutter(None, padding=(1, 2))


# -- stochastic pooling ------------------------------------------------------

#: (kx, ky, sliding): disjoint windows, and overlapping ones whose error
#: adds up where they overlap
POOLS = [(2, 2, None), (3, 3, 2), (3, 2, (1, 2))]


def _pool_input(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, 9, 8, 4)).astype(np.float32)


@pytest.mark.parametrize("kx,ky,sliding", POOLS)
def test_stochastic_pooling_eval_is_the_references(kx, ky, sliding):
    x = _pool_input(kx * ky)
    kw = dict(kx=kx, ky=ky, sliding=sliding)
    ref = ref_pooling.StochasticPooling(None, **kw)
    port = pooling.StochasticPooling(None, **kw)
    want, _ = ref.apply_fwd({}, jnp.asarray(x), train=False)
    got, res = port.apply_fwd({}, torch.from_numpy(x), train=False)
    assert res is None
    assert tuple(got.shape) == port.output_shape_for(x.shape) == want.shape
    _close(got, want)


def test_stochastic_pooling_train_draws_and_routes_as_the_reference(
        reference_draws):
    kx, ky, sliding = POOLS[1]   # overlapping windows
    x = _pool_input(kx + 10 * ky)
    kw = dict(kx=kx, ky=ky, sliding=sliding)
    ref = ref_pooling.StochasticPooling(None, **kw)
    port = pooling.StochasticPooling(None, **kw)
    key = _key_chain(SEED, 3, 1, None)
    want, (_, want_idx) = jax.jit(lambda xx, k: ref.apply_fwd(
        {}, xx, rng=k))(jnp.asarray(x), key)
    got, (_, idx) = port.apply_fwd({}, torch.from_numpy(x),
                                   rng=prng.torch_generator(SEED, 3, 1, None))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(got, want)
    err = np.random.default_rng(1).standard_normal(want.shape) \
        .astype(np.float32)
    want_in, _ = jax.jit(lambda xx, ii, ee: ref_pooling.GDMaxPooling(
        None, forward=ref).backward_from_saved({}, (xx, ii), ee))(
        jnp.asarray(x), want_idx, jnp.asarray(err))
    got_in, grads = pooling.GDStochasticPooling(None, forward=port) \
        .backward_from_saved({}, (torch.from_numpy(x), idx),
                             torch.from_numpy(err))
    assert grads == {}
    _close(got_in, want_in)
    # every error lands on a sampled element: nothing is lost or doubled
    np.testing.assert_allclose(got_in.sum().item(), err.sum(), rtol=1e-4)


def _assert_same_history(want, got):
    assert [(h["epoch"], h["class"], h["n_err"], h["count"]) for h in got] \
        == [(h["epoch"], h["class"], h["n_err"], h["count"]) for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)


def _assert_params_close(want, got):
    assert set(want) == set(got)
    for f in want:
        assert set(want[f]) == set(got[f])
        for p in want[f]:
            np.testing.assert_allclose(got[f][p], want[f][p], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{f}.{p}")


# -- resize ------------------------------------------------------------------

RESIZE_LAYERS = [
    {"type": "resizable_all2all", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05}}]
RESIZE_LOADER = dict(minibatch_size=20, n_train=80, n_valid=20,
                     shape=(6, 6, 1), n_classes=4)


def _resize_reference():
    _seed_both(SEED)
    dev = JaxDevice(platform="cpu")
    w = RefWorkflow(loader_factory=lambda wf: RefLoader(
        wf, name="loader", **RESIZE_LOADER), layers=RESIZE_LAYERS,
        loss_function="softmax", decision_config={"max_epochs": 2},
        name="ResizeWf")
    w.evaluator.compute_confusion = False
    w.initialize(device=dev)
    w.run()
    before = w.fused.host_params()
    w.forwards[0].resize(12)
    sm = w.forwards[1]
    sm.weights.reset()
    sm.bias.reset()
    sm.fill_params((0, 12))
    sm.weights.initialize(dev)
    sm.bias.initialize(dev)
    refilled = {f.name: {p: np.array(v.map_read())
                         for p, v in f.param_vectors().items()}
                for f in w.forwards}
    # what the reference's next firing does first (``_collect_opt``)
    w.gds[0].reconcile_velocities()
    vel = {k: np.array(v.map_read())
           for k, v in w.gds[0].accumulated_grads.items()}
    w.decision.complete.set(False)
    w.decision.max_epochs = 4
    w.run()
    return before, refilled, vel, list(w.decision.history), \
        w.fused.host_params()


def _resize_port():
    _seed_both(SEED)
    w = StandardWorkflow(loader_factory=lambda wf: \
        SyntheticClassificationLoader(wf, name="loader", **RESIZE_LOADER),
        layers=RESIZE_LAYERS,
        loss_function="softmax", decision_config={"max_epochs": 2},
        name="ResizeWf")
    w.initialize(device=make_device("cpu"), train=True)
    w.run()
    before = w.fused.host_params()
    vel_before = {k: v.clone() for k, v in
                  w.fused._opt[w.gds[0].name].items()}
    w.forwards[0].resize(12)
    sm = w.forwards[1]
    sm.initialize((w.loader.max_minibatch_size, 12))
    params = w.fused.host_params()
    params[sm.name] = sm.fill_params()
    w.fused.set_host_params(params)
    refilled = w.fused.host_params()
    vel = {k: v.numpy().copy() for k, v in
           w.fused._opt[w.gds[0].name].items()}
    w.decision.complete = False
    w.decision.max_epochs = 4
    w.run()
    return before, refilled, vel, vel_before, w


def test_resize_between_runs_is_the_references():
    rbefore, rrefilled, rvel, rhist, rlast = _resize_reference()
    pbefore, prefilled, pvel, pvel_before, w = _resize_port()
    _assert_params_close(params_from_jax(rbefore), pbefore)
    name, sm = w.forwards[0].name, w.forwards[1].name
    assert w.forwards[0].output_shape == (20, 12)
    assert prefilled[name]["weights"].shape == (36, 12)
    # the kept columns are the trained ones, the new ones the draws
    np.testing.assert_array_equal(prefilled[name]["weights"][:, :8],
                                  pbefore[name]["weights"])
    np.testing.assert_array_equal(prefilled[name]["bias"][:8],
                                  pbefore[name]["bias"])
    np.testing.assert_array_equal(prefilled[name]["weights"][:, 8:],
                                  rrefilled[name]["weights"][:, 8:])
    np.testing.assert_array_equal(prefilled[name]["bias"][8:],
                                  rrefilled[name]["bias"][8:])
    for p in ("weights", "bias"):
        np.testing.assert_array_equal(prefilled[sm][p], rrefilled[sm][p])
    # the velocities: history on the overlap, zeros on the new columns
    for p, v in pvel.items():
        assert v.shape == rvel[p].shape == prefilled[name][p].shape
        np.testing.assert_array_equal(v[..., :8], pvel_before[p].numpy())
        assert not v[..., 8:].any() and not rvel[p][..., 8:].any()
        _close(v, rvel[p])
    _assert_same_history(rhist, w.decision.history)
    assert len(w.decision.history) == 8
    _assert_params_close(params_from_jax(rlast), w.fused.host_params())


def test_a_resize_without_a_runner_changes_only_shapes():
    from veles_tpu_torch.ops.resizable_all2all import ResizableAll2All
    u = ResizableAll2All(None, output_sample_shape=6)
    u.initialize((3, 4))
    u.resize(9)
    assert u.output_shape == (3, 9)
    assert u.param_shapes(u.input_shape)["weights"] == (4, 9)
    with pytest.raises(ValueError, match="resize to 0"):
        u.resize(0)


# -- the confusion matrix ----------------------------------------------------

#: wine cut: the validation class of 23 rows ends in a padded minibatch
WINE_CUT = {"loader": dict(wine.DEFAULTS["loader"], n_train=60, n_valid=23),
            "decision": {"max_epochs": 3, "fail_iterations": 100}}


def _record_confusion(w, out):
    run = w.decision.run

    def decision_run():
        run()
        ld = w.loader
        if ld.class_ended:
            k = ld.minibatch_class
            out.append((k, np.array(w.decision.confusion_per_class[k])))
    w.decision.run = decision_run


def _wine_confusion(port: bool, superstep=8):
    _seed_both(SEED)
    mod = wine if port else ref_wine
    w = mod.create_workflow(_FL(), **WINE_CUT)
    w.superstep = superstep
    if port:
        w.initialize(device=make_device("cpu"), train=True)
    else:
        w.initialize(device=JaxDevice(platform="cpu"))
    out = []
    _record_confusion(w, out)
    w.run()
    return w, out


def test_confusion_matrix_is_the_references_at_every_class_end():
    ref, want = _wine_confusion(port=False)
    w, got = _wine_confusion(port=True)
    assert w.evaluator.compute_confusion and w.evaluator.n_classes == 3
    assert len(got) == len(want) == 6
    for (gk, g), (wk, m) in zip(got, want):
        assert gk == wk
        assert g.dtype == np.int32 and g.shape == (3, 3)
        np.testing.assert_array_equal(g, m)
    for h, (k, m) in zip(w.decision.history, got):
        # its rows count each label, its trace the right answers
        assert m.sum() == h["count"] and np.trace(m) == h["count"] - \
            h["n_err"]
    _assert_same_history(ref.decision.history, w.decision.history)


def test_confusion_matrix_rides_a_mid_class_snapshot():
    """A snapshot taken after the first firing of a TRAIN class carries
    the partial matrix: the resumed run ends every class with the
    straight run's matrix."""
    _, straight = _wine_confusion(port=True, superstep=2)
    _seed_both(SEED)
    w = wine.create_workflow(_FL(), **WINE_CUT)
    w.superstep = 2
    w.initialize(device=make_device("cpu"), train=True)
    got = []
    _record_confusion(w, got)
    ld = w.loader
    while True:       # the loop of StandardWorkflow.run, stopped early
        ld.run()
        w.fused.run()
        w.decision.run()
        if ld.minibatch_class == TRAIN and not ld.class_ended:
            break
    del w.decision.run        # the recorder: not part of the workflow
    blob = pickle.dumps(w)
    assert w.fused.__getstate__()["_conf_carry"].sum() == 20
    w2 = pickle.loads(blob)
    _record_confusion(w2, got)
    w2.initialize(device=make_device("cpu"), train=True)
    w2.run()
    assert len(got) == len(straight)
    for (gk, g), (sk, s) in zip(got, straight):
        assert gk == sk
        np.testing.assert_array_equal(g, s)


# -- the registry ------------------------------------------------------------

def test_registry_has_the_references_layer_types():
    assert len(ref_registry) == 24
    assert set(forward_registry) == set(gd_registry) == set(ref_registry)
    for kind, (fwd, _) in ref_registry.items():
        assert forward_registry[kind].__name__ == fwd.__name__, kind
