"""Population-batched training in the port (``ops/population.py``'s
``PopulationTrainEngine``, ``ops/kohonen.py``'s ``SOMPopulationEngine``)
against per-genome runs of the port and the JAX package's engines on
XLA:CPU, and the pieces that put the units under ``torch.func.vmap``.

- wine, the reference test's 3 learning rates (0.3, 0.05, 0.8) with
  ``fail_iterations=1`` so members stop at different epochs: the
  cohort's fitness equals per-genome runs of the port within atol 1e-3
  (the reference's own pin, ``tests/test_ga_cohort.py``) and the
  reference's engine on the same init exactly.  Params are compared at
  rates where training is stable (0.1, 0.05, 0.02; 5 epochs): within
  1e-5 of the reference's engine and of per-genome runs (the same f32
  operations; ``bmm`` and ``mm`` sum in another order).  At 0.8 with
  momentum 0.9 a rounding difference grows without bound: two per-genome
  runs, the port's and the reference's, part by more than 10 in a
  weight after 5 epochs, so no param bar holds there.
- Streaming equals resident bitwise (the same rows, gathered on the
  device or streamed from the host).
- A CD-k RBM cohort (k = 1, 2) on the reference's own uniforms
  (``test_torch_layers.reference_draws``): member params equal per-genome
  runs and the reference's engine within rtol 1e-4 / atol 5e-6, the
  reference test's own bar for its cohort against per-genome runs (a
  probability that moves in its last bits can flip one Bernoulli
  sample).
- A narrow conv net with two ``norm`` layers, max pooling, dropout and a
  step lr schedule, 2 learning rates: the cohort equals per-genome runs
  (fitness equal, params within 1e-6); every LRN plain call of the
  cohort came through the member rule with the members in front (one
  call a layer for both members).
- The LRN custom ops under ``vmap`` equal their plain versions per
  member, for every placement of the member axis; ``_GDPooling`` through
  ``torch.func.vjp`` equals the old ``torch.autograd.grad`` result
  bitwise; ``GDStochasticPooling``'s out-of-place scatter-add works
  under ``vmap``; ``update_params(decays=)`` equals the reference's.
- The SOM cohort, resident and streamed, against per-member runs
  (within 1e-5 relative) and against the reference's
  ``SOMPopulationEngine`` (within 1e-4).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_layers import reference_draws  # noqa: F401 — a fixture
from test_torch_train import LOADER as TINY_LOADER
from test_torch_train import TINY_LAYERS, WORKFLOW as TINY_WORKFLOW
from test_torch_train import _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.loader.synthetic import MnistLoader as RefMnistLoader
from veles_tpu.models import kohonen as ref_kohonen
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops import nn_units as ref_nn_units
from veles_tpu.ops.fused import PopulationTrainEngine as RefEngine
from veles_tpu.ops.kohonen import SOMPopulationEngine as RefSOMEngine
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import workflow_fitness
from veles_tpu_torch.loader.synthetic import (MnistLoader,
                                              SyntheticClassificationLoader)
from veles_tpu_torch.models import kohonen, wine
from veles_tpu_torch.ops import lrn_cuda, nn_units
from veles_tpu_torch.ops.fused import PopulationTrainEngine
from veles_tpu_torch.ops.kohonen import SOMPopulationEngine
from veles_tpu_torch.ops.pooling import (AvgPooling, GDAvgPooling,
                                         GDMaxPooling, GDStochasticPooling,
                                         MaxPooling, StochasticPooling)
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

CPU = make_device("cpu")


class _FL:
    workflow = None


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


# -- wine: the cohort against per-genome runs and the reference -----------

WINE_LRS = [0.3, 0.05, 0.8]
WINE_WD = 0.001


def _wine_layers(lr):
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
             "<-": {"learning_rate": lr, "weight_decay": WINE_WD,
                    "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": lr, "gradient_moment": 0.9}}]


def _wine(lr, fail=1, epochs=5, **loader):
    _seed_both(1234)
    lcfg = dict(wine.DEFAULTS["loader"], **loader)
    w = wine.create_workflow(
        _FL(), layers=_wine_layers(lr), loader=lcfg,
        decision={"max_epochs": epochs, "fail_iterations": fail})
    w.initialize(device=CPU, train=True)
    return w


def _wine_hypers(lrs=WINE_LRS):
    rates = np.asarray([[[lr, lr], [lr, lr]] for lr in lrs], np.float32)
    decays = np.asarray([[[WINE_WD, 0.0], [0.0, 0.0]]] * len(lrs),
                        np.float32)
    return rates, decays


def test_wine_cohort_equals_per_genome_runs_and_the_reference():
    oracle = []
    for lr in WINE_LRS:
        w = _wine(lr)
        w.run()
        oracle.append(workflow_fitness(w))
    rates, decays = _wine_hypers()
    w = _wine(WINE_LRS[0])
    engine = PopulationTrainEngine(w, rates, decays)
    fits = engine.run()
    assert np.allclose(fits, oracle, atol=1e-3), (fits, oracle)
    # members stop at different epochs (fail_iterations=1)
    assert len(set(oracle)) > 1

    np.testing.assert_array_equal(fits, _ref_cohort(WINE_LRS, 1, 5)[0])
    assert engine.minibatches > 0 and engine.seconds > 0.0
    engine.release()
    assert engine._params is None


def _ref_cohort(lrs, fail, epochs):
    rates, decays = _wine_hypers(lrs)
    _seed_both(1234)
    rw = ref_wine.create_workflow(
        _FL(), layers=_wine_layers(lrs[0]),
        decision={"max_epochs": epochs, "fail_iterations": fail})
    rw.initialize(device=JaxDevice(platform="cpu"))
    ref = RefEngine(rw, rates, decays)
    return ref.run(), ref


STABLE_LRS = [0.1, 0.05, 0.02]


def test_wine_cohort_params_equal_the_reference_and_per_genome():
    rates, decays = _wine_hypers(STABLE_LRS)
    w = _wine(STABLE_LRS[0], fail=100)
    engine = PopulationTrainEngine(w, rates, decays)
    fits = engine.run()
    ref_fits, ref = _ref_cohort(STABLE_LRS, 100, 5)
    np.testing.assert_array_equal(fits, ref_fits)
    for i, lr in enumerate(STABLE_LRS):
        got = engine.member_params(i)
        genome = _wine(lr, fail=100)
        genome.run()
        want = genome.fused.host_params()
        for f in w.forwards:
            for pn, a in got[f.name].items():
                np.testing.assert_allclose(
                    a, np.asarray(ref._params[f.name][pn][i]), rtol=1e-5,
                    atol=1e-5)
                np.testing.assert_allclose(a, want[f.name][pn], rtol=1e-5,
                                           atol=1e-5)


def test_streaming_cohort_equals_resident_bitwise():
    rates, decays = _wine_hypers()
    out = {}
    for name, loader in (("resident", {}),
                         ("stream", {"max_resident_bytes": 0})):
        w = _wine(WINE_LRS[0], **loader)
        engine = PopulationTrainEngine(w, rates, decays)
        assert engine.streaming == (name == "stream")
        fits = engine.run()
        out[name] = (fits, [engine.member_params(i)
                            for i in range(len(WINE_LRS))],
                     [a for _, _, a in engine.history])
    assert out["stream"][0].tolist() == out["resident"][0].tolist()
    for hs, hr in zip(out["stream"][2], out["resident"][2]):
        np.testing.assert_array_equal(hs, hr)
    for ms, mr in zip(out["stream"][1], out["resident"][1]):
        for fn in mr:
            for pn in mr[fn]:
                np.testing.assert_array_equal(ms[fn][pn], mr[fn][pn])


def test_bad_hyperparameter_shapes_are_refused():
    w = _wine(0.3)
    with pytest.raises(ValueError):
        PopulationTrainEngine(w, np.zeros((2, 3, 2)), np.zeros((2, 3, 2)))
    with pytest.raises(ValueError):
        PopulationTrainEngine(w, np.zeros((2, 2, 2)), np.zeros((3, 2, 2)))


# -- the RBM cohort on the reference's draws ---------------------------------

RBM_LOADER = {"minibatch_size": 50, "n_train": 200, "n_valid": 50}
RBM_LRS = [0.3, 0.05, 0.8]


def _rbm_layers(lr, cd_k):
    return [{"type": "binarization", "->": {}, "<-": {}},
            {"type": "rbm", "->": {"n_hidden": 16},
             "<-": {"learning_rate": lr, "gradient_moment": 0.5,
                    "cd_k": cd_k}}]


def _rbm(workflow_cls, loader_cls, device, lr, cd_k):
    _seed_both(1234)
    w = workflow_cls(
        loader_factory=lambda wf: loader_cls(
            wf, name="loader", targets_from_data=True, **RBM_LOADER),
        layers=_rbm_layers(lr, cd_k), loss_function="mse",
        decision_config={"max_epochs": 2}, name="RbmCohortWf")
    if device is CPU:
        w.initialize(device=device, train=True)
    else:
        w.initialize(device=device)
    return w


@pytest.mark.parametrize("cd_k", [1, 2])
def test_rbm_cohort_on_reference_draws(cd_k, reference_draws):  # noqa: F811
    oracle = []
    for lr in RBM_LRS:
        w = _rbm(StandardWorkflow, MnistLoader, CPU, lr, cd_k)
        w.run()
        oracle.append(w.fused.host_params()[w.forwards[1].name])
    w = _rbm(StandardWorkflow, MnistLoader, CPU, RBM_LRS[0], cd_k)
    rates = np.asarray([[[lr, lr]] * len(w.gds) for lr in RBM_LRS],
                       np.float32)
    engine = PopulationTrainEngine(w, rates, np.zeros_like(rates))
    engine.run()
    rw = _rbm(RefWorkflow, RefMnistLoader, JaxDevice(platform="cpu"),
              RBM_LRS[0], cd_k)
    ref = RefEngine(rw, rates, np.zeros_like(rates))
    ref.run()
    name = w.forwards[1].name
    for i, want in enumerate(oracle):
        got = engine.member_params(i)[name]
        for pn, a in want.items():
            np.testing.assert_allclose(got[pn], a, rtol=1e-4, atol=5e-6)
            np.testing.assert_allclose(
                got[pn], np.asarray(ref._params[name][pn][i]), rtol=1e-4,
                atol=5e-6)


# -- a conv net with LRN and max pooling: the member rule --------------------

TINY_LRS = [0.05, 0.02]


def _tiny(lr):
    _seed_both(4321)
    layers = copy.deepcopy(TINY_LAYERS)
    for layer in layers:
        if "learning_rate" in layer["<-"]:
            layer["<-"]["learning_rate"] = lr
    w = StandardWorkflow(
        loader_factory=lambda wf: SyntheticClassificationLoader(
            wf, name="loader", **TINY_LOADER),
        name="tiny", **dict(TINY_WORKFLOW, layers=layers))
    w.initialize(device=CPU, train=True)
    return w


def test_conv_lrn_cohort_runs_through_the_member_rule(monkeypatch):
    oracle = []
    for lr in TINY_LRS:
        w = _tiny(lr)
        w.run()
        oracle.append((workflow_fitness(w), w.fused.host_params()))
    w = _tiny(TINY_LRS[0])
    rates = np.asarray([[[gd.learning_rate * lr / TINY_LRS[0],
                          gd.learning_rate_bias * lr / TINY_LRS[0]]
                         for gd in w.gds] for lr in TINY_LRS], np.float32)
    decays = np.asarray([[[gd.weight_decay, gd.weight_decay_bias]
                          for gd in w.gds]] * len(TINY_LRS), np.float32)
    seen = {"fwd": [], "bwd": []}
    fwd_plain, bwd_plain = lrn_cuda.lrn_fwd_plain, lrn_cuda.lrn_bwd_plain

    def count_fwd(x, *a):
        seen["fwd"].append(tuple(x.shape))
        return fwd_plain(x, *a)

    def count_bwd(x, e, *a):
        seen["bwd"].append(tuple(x.shape))
        return bwd_plain(x, e, *a)
    monkeypatch.setattr(lrn_cuda, "lrn_fwd_plain", count_fwd)
    monkeypatch.setattr(lrn_cuda, "lrn_bwd_plain", count_bwd)
    engine = PopulationTrainEngine(w, rates, decays)
    fits = engine.run()
    P = len(TINY_LRS)
    assert all(len(s) == 5 and s[0] == P for s in seen["fwd"] + seen["bwd"])
    train_mb, valid_mb = engine.minibatches - 2 * 2, 2 * 2
    # two norm layers: one call each a minibatch for all members
    assert len(seen["fwd"]) == 2 * engine.minibatches
    assert len(seen["bwd"]) == 2 * train_mb and valid_mb == 4
    assert fits.tolist() == [o[0] for o in oracle]
    for i, (_, want) in enumerate(oracle):
        got = engine.member_params(i)
        for fn, ps in want.items():
            for pn, a in ps.items():
                np.testing.assert_allclose(got[fn][pn], a, rtol=1e-6,
                                           atol=1e-6)


@pytest.mark.parametrize("dims", [(0, 0), (0, None), (None, 0), (1, 1),
                                  (3, 0)])
def test_lrn_member_rule_equals_the_plain_version(dims):
    rng = np.random.default_rng(7)
    shape = (3, 2, 5, 4, 24)       # 3 members in front, channels last

    def operand(bdim):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return t[0] if bdim is None else torch.movedim(t, 0, bdim)
    bx, be = dims
    x, e = operand(bx), operand(be)
    fwd = torch.func.vmap(lambda a: lrn_cuda.lrn_fwd(a, 5, 2.0, 1e-3),
                          in_dims=bx if bx is not None else 0)
    if bx is not None:
        y = fwd(x)
        xm = torch.movedim(x, bx, 0)
        for i in range(3):
            torch.testing.assert_close(
                y[i], lrn_cuda.lrn_fwd_plain(xm[i], 5, 2.0, 1e-3),
                rtol=0, atol=0)
    bwd = torch.func.vmap(
        lambda a, b: lrn_cuda.lrn_bwd(a, b, 5, 2.0, 1e-3), in_dims=dims)
    g = bwd(x, e)
    for i in range(3):
        xi = x if bx is None else torch.movedim(x, bx, 0)[i]
        ei = e if be is None else torch.movedim(e, be, 0)[i]
        torch.testing.assert_close(
            g[i], lrn_cuda.lrn_bwd_plain(xi, ei, 5, 2.0, 1e-3),
            rtol=0, atol=0)


# -- units under vmap -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pooling_vjp_is_the_autograd_result_bitwise(kind):
    f = (MaxPooling if kind == "max" else AvgPooling)(None, kx=3, ky=3,
                                                      sliding=2)
    gd = (GDMaxPooling if kind == "max" else GDAvgPooling)(None, forward=f)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 11, 11, 6))
                         .astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((4, 5, 5, 6))
                         .astype(np.float32))
    got, grads = gd.backward_from_saved({}, (x, None), e)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        (want,) = torch.autograd.grad(f.apply({}, xx), xx, e)
    assert grads == {} and torch.equal(got, want)
    xs = torch.stack([x, 2.0 * x])
    es = torch.stack([e, -e])
    batched = torch.func.vmap(
        lambda a, b: gd.backward_from_saved({}, (a, None), b)[0])(xs, es)
    for i in range(2):
        assert torch.equal(batched[i],
                           gd.backward_from_saved({}, (xs[i], None),
                                                  es[i])[0])


def test_stochastic_pooling_gradient_under_vmap():
    f = StochasticPooling(None, kx=2, ky=2, sliding=2)
    f.initialize((3, 6, 6, 4))
    gd = GDStochasticPooling(None, forward=f)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 6, 6, 4))
                         .astype(np.float32))
    _, (_, idx) = f.apply_fwd({}, x, rng=prng.torch_generator(
        1, 2, 3, torch.device("cpu")))
    es = torch.from_numpy(rng.standard_normal((2, 3, 3, 3, 4))
                          .astype(np.float32))
    batched = torch.func.vmap(
        lambda b: gd.backward_from_saved({}, (x, idx), b)[0])(es)
    for i in range(2):
        assert torch.equal(batched[i],
                           gd.backward_from_saved({}, (x, idx), es[i])[0])


@pytest.mark.parametrize("moment", [0.0, 0.9])
def test_update_params_decays_are_the_references(moment):
    rng = np.random.default_rng(11)
    p = {"weights": rng.standard_normal((5, 3)).astype(np.float32),
         "bias": rng.standard_normal(3).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    v = {k: rng.standard_normal(a.shape).astype(np.float32)
         for k, a in p.items()}
    ref = ref_nn_units.GradientUnit(None, gradient_moment=moment,
                                    weight_decay=0.5)
    port = nn_units.GradientUnit(None, gradient_moment=moment,
                                 weight_decay=0.5)
    t = {k: {n: torch.from_numpy(a) for n, a in d.items()}
         for k, d in (("p", p), ("g", g), ("v", v))}
    j = {k: {n: jnp.asarray(a) for n, a in d.items()}
         for k, d in (("p", p), ("g", g), ("v", v))}
    rates = (np.float32(0.1), np.float32(0.2))
    decays = (np.float32(0.01), np.float32(0.003))
    got = port.update_params(t["p"], t["g"], t["v"],
                             rates=tuple(torch.tensor(r) for r in rates),
                             decays=tuple(torch.tensor(d) for d in decays))
    want = ref.update_params(j["p"], j["g"], j["v"], rates=rates,
                             decays=decays)
    for a, b in zip(got, want):
        for n in a:
            np.testing.assert_allclose(a[n].numpy(), np.asarray(b[n]),
                                       rtol=1e-6, atol=1e-7)
    # decays=None keeps the unit's own weight decay
    own = port.update_params(t["p"], t["g"], t["v"], rates=(0.1, 0.2))
    ref_own = ref.update_params(j["p"], j["g"], j["v"], rates=rates)
    np.testing.assert_allclose(own[0]["weights"].numpy(),
                               np.asarray(ref_own[0]["weights"]),
                               rtol=1e-6, atol=1e-7)


# -- the SOM cohort ------------------------------------------------------------

SOM_LOADER = {"minibatch_size": 50, "n_train": 400, "n_valid": 100,
              "shape": (6, 6, 1), "n_classes": 5, "seed": 888}
SOM_GENOMES = np.asarray([[0.3, 0.01, 3.0, 0.5], [0.5, 0.05, 3.0, 0.8],
                          [0.1, 0.02, 1.5, 0.4]], np.float32)


def _som_cfg(hp, **loader):
    return {"loader": dict(SOM_LOADER, **loader), "som_shape": (4, 5),
            "trainer": {"alpha0": float(hp[0]), "alpha_min": float(hp[1]),
                        "sigma0": float(hp[2]), "sigma_min": float(hp[3]),
                        "decay_epochs": 3},
            "decision": {"max_epochs": 3}}


@pytest.mark.parametrize("streamed", [False, True])
def test_som_cohort_equals_per_member_runs_and_the_reference(streamed):
    loader = {"max_resident_bytes": 0} if streamed else {}
    oracle = []
    for hp in SOM_GENOMES:
        _seed_both(4242)
        w = kohonen.create_workflow(_FL(), **_som_cfg(hp, **loader))
        w.initialize(device=CPU, train=True)
        w.run()
        oracle.append((min(h["loss"] for h in w.decision.history
                           if h["class"] == "validation"),
                       w.trainer.host_weights()))
    _seed_both(4242)
    w = kohonen.create_workflow(_FL(), **_som_cfg(SOM_GENOMES[0], **loader))
    w.initialize(device=CPU, train=True)
    engine = SOMPopulationEngine(w, SOM_GENOMES)
    assert engine.streaming == streamed
    fits = engine.run()
    np.testing.assert_allclose(fits, [o[0] for o in oracle], rtol=1e-5)
    for i, (_, want) in enumerate(oracle):
        np.testing.assert_allclose(engine.weights[i].numpy(), want,
                                   rtol=1e-5, atol=1e-6)
    _seed_both(4242)
    rw = ref_kohonen.create_workflow(_FL(), **_som_cfg(SOM_GENOMES[0]))
    rw.initialize(device=JaxDevice(platform="cpu"))
    ref = RefSOMEngine(rw, SOM_GENOMES)
    ref_fits = ref.run()
    np.testing.assert_allclose(fits, ref_fits, rtol=1e-4)
    np.testing.assert_allclose(
        engine.weights.numpy(),
        np.asarray(ref._params[rw.forward.name]["weights"]), rtol=1e-4,
        atol=1e-5)
    with pytest.raises(ValueError):
        SOMPopulationEngine(w, SOM_GENOMES[:, :3])
