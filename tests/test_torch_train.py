"""The port's training path against the JAX package's.

Same seeds and the same numpy inputs go through the reference on
XLA:CPU and through the port on the CPU, in f32:

- the named numpy streams, the synthetic data set and the initial
  params are bitwise the reference's;
- each gradient unit's ``backward_from_saved`` gives the reference's
  err_input and grads (atol 1e-5: the two libraries' summation orders
  at these small widths);
- the lr policies and the per-minibatch rate rows are the reference's;
- a tiny AlexNet-shaped net trained for 2 epochs by the port's
  ``StandardWorkflow`` + ``FusedStepRunner`` matches the reference's
  (same minibatch order, equal n_err and count per class end, loss
  within rtol 1e-4, final params within rtol 1e-4 / atol 1e-5);
- ``python -m veles_tpu_torch -b cpu`` trains a tiny workflow file.
"""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu import datasets as ref_datasets
from veles_tpu import prng as ref_prng
from veles_tpu.backends import JaxDevice
from veles_tpu.loader.synthetic import \
    SyntheticClassificationLoader as RefLoader
from veles_tpu.ops import lr_adjust as ref_lr_adjust
from veles_tpu.ops.registry import forward_registry as ref_registry
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import datasets, prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.ops import lr_adjust
from veles_tpu_torch.ops.registry import forward_registry, gd_registry
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_streams():
    """A fresh port stream registry (the reference's is reset by
    conftest)."""
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()


def _seed_both(seed):
    ref_prng._streams.clear()
    ref_prng.seed_all(seed)
    prng._streams.clear()
    prng.seed_all(seed)


# -- streams, data, initial params --------------------------------------

@pytest.mark.parametrize("seed", [1, 1234, 2**40 + 3])
def test_numpy_streams_are_bitwise_the_references(seed):
    _seed_both(seed)
    for name in ("weights", "loader", "fused", "dropout"):
        a, b = ref_prng.get(name), prng.get(name)
        assert a.seed == b.seed
        np.testing.assert_array_equal(a.numpy.random(5), b.numpy.random(5))
        np.testing.assert_array_equal(a.numpy.integers(0, 1 << 40, 7),
                                      b.numpy.integers(0, 1 << 40, 7))
        np.testing.assert_array_equal(a.numpy.standard_normal(3),
                                      b.numpy.standard_normal(3))


def test_torch_generator_is_deterministic_and_distinct():
    def draw(seed, counter, layer):
        g = prng.torch_generator(seed, counter, layer, torch.device("cpu"))
        return torch.rand(6, generator=g)
    assert torch.equal(draw(7, 3, 11), draw(7, 3, 11))
    assert not torch.equal(draw(7, 3, 11), draw(7, 4, 11))
    assert not torch.equal(draw(7, 3, 11), draw(7, 3, 12))
    assert not torch.equal(draw(7, 3, 11), draw(8, 3, 11))


@pytest.mark.parametrize("shape,kw", [
    ((9, 7, 3), {"max_shift": 2, "noise": 0.5}),
    ((12, 10), {"max_shift": 1}),
    ((8, 8, 1), {"max_shift": 0, "n_test": 4}),
])
def test_synthetic_classification_is_bitwise_the_references(shape, kw):
    want = ref_datasets.synthetic_classification(
        13, 5, shape, n_classes=4, seed=77, **kw)
    got = datasets.synthetic_classification(13, 5, shape, n_classes=4,
                                            seed=77, **kw)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        for a, b in zip(w, g):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


#: (layer type, forward kwargs, input shape) with params
PARAM_CASES = [
    ("conv_relu", {"n_kernels": 6, "kx": 5, "ky": 3, "sliding": 2,
                   "weights_filling": "gaussian", "weights_stddev": 0.01},
     (2, 11, 9, 3)),
    ("conv", {"n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
              "bias_filling": "uniform", "bias_stddev": 0.1},
     (1, 5, 5, 2)),
    ("all2all_relu", {"output_sample_shape": 7}, (2, 3, 3, 4)),
    ("softmax", {"output_sample_shape": 5, "weights_filling": "gaussian",
                 "bias_filling": "gaussian", "bias_stddev": 0.2}, (3, 6)),
]


def test_fill_params_is_bitwise_the_references():
    """Units drawn one after another from the "weights" stream, as a
    workflow's forwards are, give the reference's params exactly."""
    _seed_both(99)
    for kind, kw, shape in PARAM_CASES:
        ref = ref_registry[kind][0](None, name="u", **kw)
        ref.fill_params(shape)
        want = {p: v.mem for p, v in ref.param_vectors().items()}
        port = forward_registry[kind](None, name="u", **kw)
        port.initialize(shape)
        got = port.fill_params()
        want = params_from_jax({"u": want})["u"]
        assert set(got) == set(want) and got
        for p in want:
            assert got[p].dtype == np.float32
            np.testing.assert_array_equal(got[p], want[p])


# -- gradient units -----------------------------------------------------

#: (layer type, forward kwargs, input shape); inputs have no ties, so
#: max pooling routes every error to the same element in both
GD_CASES = [
    ("conv_relu", {"n_kernels": 6, "kx": 11, "ky": 11, "sliding": 4},
     (2, 23, 27, 3)),
    ("conv_tanh", {"n_kernels": 5, "kx": 5, "ky": 3, "padding": (1, 2)},
     (2, 8, 7, 4)),
    ("conv", {"n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
              "sliding": (2, 1)}, (1, 7, 6, 3)),
    ("max_pooling", {"kx": 3, "ky": 3, "sliding": 2}, (2, 11, 13, 5)),
    ("avg_pooling", {"kx": 3, "ky": 2, "sliding": (1, 2)}, (2, 8, 9, 4)),
    ("all2all", {"output_sample_shape": 7}, (3, 10)),
    ("all2all_relu", {"output_sample_shape": 16}, (2, 3, 3, 12)),
    ("all2all_tanh", {"output_sample_shape": 6}, (4, 5)),
    ("softmax", {"output_sample_shape": 5}, (4, 2, 2, 6)),
    ("norm", {"alpha": 3e-2, "beta": 0.75, "n": 5, "k": 2.0},
     (2, 3, 4, 16)),
    ("norm", {"alpha": 3e-2, "beta": 0.75, "n": 4, "k": 2.0},
     (2, 3, 3, 12)),
]


def _units(kind, kw, shape, seed):
    rng = np.random.default_rng(seed)
    ref = ref_registry[kind][0](None, name="u", **kw)
    ref_gd = ref_registry[kind][1](None, forward=ref, name="g")
    port = forward_registry[kind](None, name="u", **kw)
    port.initialize(shape)
    port_gd = gd_registry[kind](None, forward=port, name="g")
    params = {p: (rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]) or 1)
                  ).astype(np.float32)
              for p, s in ref.param_shapes(shape).items()}
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    err = rng.standard_normal(port.output_shape).astype(np.float32)
    return ref, ref_gd, port, port_gd, params, x, err


def _check(got_ein, got_grads, want_ein, want_grads):
    if want_ein is None:
        assert got_ein is None
    else:
        np.testing.assert_allclose(got_ein.numpy(), np.asarray(want_ein),
                                   atol=ATOL)
    want_grads = params_from_jax(
        {"u": {p: np.asarray(g) for p, g in want_grads.items()}})["u"]
    assert set(got_grads) == set(want_grads)
    for p, g in want_grads.items():
        np.testing.assert_allclose(got_grads[p].numpy(), g, atol=ATOL)


@pytest.mark.parametrize("kind,kw,shape", GD_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(GD_CASES)])
def test_gradient_unit_matches_reference(kind, kw, shape):
    ref, ref_gd, port, port_gd, params, x, err = _units(kind, kw, shape,
                                                        sum(shape))
    jparams = {p: jnp.asarray(a) for p, a in params.items()}
    _, res = ref.apply_fwd(jparams, jnp.asarray(x), train=True)
    want_ein, want_grads = ref_gd.backward_from_saved(jparams, res,
                                                      jnp.asarray(err))
    tparams = {p: torch.from_numpy(a)
               for p, a in params_from_jax({"u": params})["u"].items()}
    _, tres = port.apply_fwd(tparams, torch.from_numpy(x), train=True)
    got_ein, got_grads = port_gd.backward_from_saved(
        tparams, tres, torch.from_numpy(err))
    _check(got_ein, got_grads, want_ein, want_grads)


@pytest.mark.parametrize("kind", ["conv_relu", "all2all_relu"])
def test_chain_head_skips_err_input(kind):
    case = next(c for c in GD_CASES if c[0] == kind)
    ref, ref_gd, port, port_gd, params, x, err = _units(*case, seed=5)
    assert port_gd.can_skip_err_input
    jparams = {p: jnp.asarray(a) for p, a in params.items()}
    _, res = ref.apply_fwd(jparams, jnp.asarray(x), train=True)
    want_ein, want_grads = ref_gd.backward_from_saved(
        jparams, res, jnp.asarray(err), need_err_input=False)
    tparams = {p: torch.from_numpy(a)
               for p, a in params_from_jax({"u": params})["u"].items()}
    _, tres = port.apply_fwd(tparams, torch.from_numpy(x), train=True)
    got_ein, got_grads = port_gd.backward_from_saved(
        tparams, tres, torch.from_numpy(err), need_err_input=False)
    _check(got_ein, got_grads, want_ein, want_grads)


def test_dropout_backward_applies_the_given_mask():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    err = rng.standard_normal(x.shape).astype(np.float32)
    mask = ((rng.random(x.shape) < 0.6) / 0.6).astype(np.float32)
    ref = ref_registry["dropout"][0](None, name="d", dropout_ratio=0.4)
    want, _ = ref_registry["dropout"][1](None, forward=ref).\
        backward_from_saved({}, (x, mask), err)
    port = forward_registry["dropout"](None, name="d", dropout_ratio=0.4)
    got, grads = gd_registry["dropout"](None, forward=port).\
        backward_from_saved({}, (torch.from_numpy(x),
                                 torch.from_numpy(mask)),
                            torch.from_numpy(err))
    assert grads == {}
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_train_mask_comes_from_the_generator():
    port = forward_registry["dropout"](None, name="d", dropout_ratio=0.25)
    x = torch.ones(64, 32)

    def run():
        g = prng.torch_generator(5, 2, 7, torch.device("cpu"))
        return port.apply_fwd({}, x, rng=g, train=True)
    (y, (xs, mask)), (y2, _) = run(), run()
    assert torch.equal(y, y2) and xs is x
    kept = mask > 0
    assert torch.allclose(mask[kept], torch.tensor(1 / 0.75))
    assert 0.6 < float(kept.float().mean()) < 0.9
    assert port.apply_fwd({}, x, train=False) == (x, None)
    with pytest.raises(ValueError, match="Generator"):
        port.apply_fwd({}, x, train=True)


def test_update_params_is_the_references_momentum_sgd():
    rng = np.random.default_rng(8)
    w = {p: rng.standard_normal(s).astype(np.float32)
         for p, s in (("weights", (4, 3)), ("bias", (3,)))}
    g = {p: rng.standard_normal(a.shape).astype(np.float32)
         for p, a in w.items()}
    v = {p: rng.standard_normal(a.shape).astype(np.float32)
         for p, a in w.items()}
    kw = dict(learning_rate=0.1, learning_rate_bias=0.2, weight_decay=0.01,
              weight_decay_bias=0.001, gradient_moment=0.9)
    ref = ref_registry["all2all"][1](None, name="g", **kw)
    port = gd_registry["all2all"](None, name="g", **kw)
    for rates in (None, (0.05, 0.5)):
        want_p, want_v = ref.update_params(w, g, v, rates=rates)
        got_p, got_v = port.update_params(
            *[{p: torch.from_numpy(a) for p, a in d.items()}
              for d in (w, g, v)], rates=rates)
        for p in w:
            np.testing.assert_allclose(got_p[p].numpy(), want_p[p],
                                       rtol=1e-6)
            np.testing.assert_allclose(got_v[p].numpy(), want_v[p],
                                       rtol=1e-6)


# -- lr schedules -------------------------------------------------------

POLICIES = [("fixed", {}), ("step", {"gamma": 0.5, "step": 3}),
            ("exp", {"gamma": 0.9}), ("inv", {"gamma": 0.01, "power": 0.6}),
            ("arbitrary", {"points": [(2, 0.3), (5, 0.07)]})]


@pytest.mark.parametrize("name,kw", POLICIES, ids=[p[0] for p in POLICIES])
def test_lr_policy_matches_reference(name, kw):
    want = ref_lr_adjust.make_policy(name, **kw)
    got = lr_adjust.make_policy(name, **kw)
    for t in range(40):
        assert got(0.01, t) == want(0.01, t)


@pytest.mark.parametrize("by", ["epoch", "iteration"])
def test_lr_adjust_superstep_rows_match_reference(by):
    """The (k, n_gd, 2) rows over a sequence of firings, with supersteps
    that cross an epoch boundary on their last minibatch (the t_of(j)
    rule) and eval firings that leave the rates alone."""
    firings = [(1, 1, 0, False), (2, 3, 0, False), (2, 2, 1, True),
               (1, 1, 1, False), (2, 3, 1, False), (2, 3, 2, True),
               (2, 1, 3, True)]

    def drive(mod):
        gds = [SimpleNamespace(learning_rate=0.1, learning_rate_bias=0.2),
               SimpleNamespace(learning_rate=0.05, learning_rate_bias=0.05)]
        unit = mod.LearningRateAdjust(
            None, policy_name="step",
            policy_kwargs={"gamma": 0.5, "step": 1}, by=by)
        unit.loader = SimpleNamespace()
        unit.gds = gds
        unit.fused = SimpleNamespace(lr_rates=None)
        rows = []
        for klass, k, epoch, ended in firings:
            unit.loader.__dict__.update(minibatch_class=klass, superstep_k=k,
                                        epoch_number=epoch,
                                        epoch_ended=ended)
            unit.run()
            rows.append((unit.fused.lr_rates,
                         [(g.learning_rate, g.learning_rate_bias)
                          for g in gds]))
        return rows
    assert drive(lr_adjust) == drive(ref_lr_adjust)


# -- the whole step -----------------------------------------------------

GD = {"learning_rate": 0.05, "weight_decay": 0.0005, "gradient_moment": 0.9}
TINY_LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 11, "ky": 11,
                                 "sliding": 4, "weights_filling": "gaussian",
                                 "weights_stddev": 0.05}, "<-": GD},
    {"type": "norm", "->": {"alpha": 1e-3, "beta": 0.75, "n": 5, "k": 2.0},
     "<-": {}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
     "<-": {}},
    {"type": "conv_relu", "->": {"n_kernels": 12, "kx": 5, "ky": 5,
                                 "padding": 2, "weights_filling": "gaussian",
                                 "weights_stddev": 0.05}, "<-": GD},
    {"type": "norm", "->": {"alpha": 1e-3, "beta": 0.75, "n": 5, "k": 2.0},
     "<-": {}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
     "<-": {}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 16,
                                    "weights_filling": "gaussian",
                                    "weights_stddev": 0.05}, "<-": GD},
    {"type": "dropout", "->": {"dropout_ratio": 0.0}, "<-": {}},
    {"type": "softmax", "->": {"output_sample_shape": 5,
                               "weights_filling": "gaussian",
                               "weights_stddev": 0.05}, "<-": GD},
]
LOADER = dict(n_train=96, n_valid=24, shape=(67, 67, 3), n_classes=5,
              noise=0.5, max_shift=4, seed=227, minibatch_size=16)
WORKFLOW = dict(layers=TINY_LAYERS, loss_function="softmax",
                decision_config={"max_epochs": 2, "fail_iterations": 100},
                lr_adjust_config={"policy_name": "step",
                                  "policy_kwargs": {"gamma": 0.5,
                                                    "step": 1},
                                  "by": "epoch"},
                superstep=3)
SEED = 4321


def _record_order(w, order):
    fire = w.loader.run

    def run():
        fire()
        order.append((int(w.loader.minibatch_class),
                      w.loader.superstep_indices.tolist(),
                      w.loader.superstep_mask.tolist()))
    w.loader.run = run


def _train_reference():
    _seed_both(SEED)
    w = RefWorkflow(loader_factory=lambda wf: RefLoader(
        wf, name="loader", **LOADER), name="tiny", **WORKFLOW)
    w.evaluator.compute_confusion = False
    w.initialize(device=JaxDevice(platform="cpu"))
    first = {f: {p: np.asarray(a) for p, a in ps.items()}
             for f, ps in w.fused.host_params().items()}
    order = []
    _record_order(w, order)
    w.run()
    last = {f: {p: np.asarray(a) for p, a in ps.items()}
            for f, ps in w.fused.host_params().items()}
    return first, order, list(w.decision.history), last


def _train_port():
    _seed_both(SEED)
    w = StandardWorkflow(loader_factory=lambda wf:
                         SyntheticClassificationLoader(wf, name="loader",
                                                       **LOADER),
                         name="tiny", **WORKFLOW)
    w.initialize(device=make_device("cpu"), train=True)
    first = w.fused.host_params()
    order = []
    _record_order(w, order)
    w.run()
    last = w.fused.host_params()
    # host_params / set_host_params round-trip the device params
    w.fused.set_host_params(first)
    back = w.fused.host_params()
    for f in first:
        for p in first[f]:
            np.testing.assert_array_equal(back[f][p], first[f][p])
    return first, order, list(w.decision.history), last


@pytest.fixture(scope="module")
def trained():
    ref = _train_reference()
    port = _train_port()
    return ref, port


def test_whole_step_starts_from_the_references_params(trained):
    (want, _, _, _), (got, _, _, _) = trained
    want = params_from_jax(want)
    assert set(got) == set(want)
    for f in want:
        for p in want[f]:
            np.testing.assert_array_equal(got[f][p], want[f][p])


def test_whole_step_minibatch_order_is_the_references(trained):
    (_, want, _, _), (_, got, _, _) = trained
    assert len(got) == len(want) == 2 * (1 + 2)
    assert got == want


def test_whole_step_history_matches_reference(trained):
    (_, _, want, _), (_, _, got, _) = trained
    assert [(r["epoch"], r["class"]) for r in got] == \
        [(r["epoch"], r["class"]) for r in want] == \
        [(0, "validation"), (1, "train"), (1, "validation"), (2, "train")]
    for g, w in zip(got, want):
        assert g["n_err"] == w["n_err"] and g["count"] == w["count"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)


def test_whole_step_final_params_match_reference(trained):
    (first, _, _, want), (_, _, _, got) = trained
    want = params_from_jax(want)
    moved = 0.0
    for f in want:
        for p in want[f]:
            np.testing.assert_allclose(got[f][p], want[f][p], rtol=1e-4,
                                       atol=1e-5)
            moved = max(moved, float(np.abs(
                want[f][p] - params_from_jax(first)[f][p]).max()))
    assert moved > 1e-3   # training moved the params well past atol


def test_serving_initialize_generates_no_data():
    w = StandardWorkflow(loader_factory=lambda wf:
                         SyntheticClassificationLoader(wf, name="loader",
                                                       **LOADER),
                         name="tiny", **WORKFLOW)
    w.initialize(device=make_device("cpu"))
    assert w.loader.class_lengths == [0, 0, 0]
    assert w.loader.original_data is None and w.fused.device is None
    assert w.forwards[-1].output_shape == (1, 5)


# -- the command line ---------------------------------------------------

WORKFLOW_FILE = textwrap.dedent("""
    from veles_tpu_torch.loader.synthetic import \\
        SyntheticClassificationLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

    LAYERS = [
        {"type": "conv_relu", "->": {"n_kernels": 4, "kx": 5, "ky": 5,
                                     "sliding": 2}},
        {"type": "norm", "->": {"n": 3}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 8}},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "softmax", "->": {"output_sample_shape": 3}},
    ]


    def create_workflow(launcher):
        w = StandardWorkflow(
            loader_factory=lambda wf: SyntheticClassificationLoader(
                wf, name="loader", n_train=24, n_valid=8, shape=(13, 13, 2),
                n_classes=3, minibatch_size=8),
            layers=LAYERS, decision_config={"max_epochs": 1},
            superstep=2, name="cli_tiny")
        launcher.workflow = w
        return w
""")


def test_cli_trains_a_workflow_file_on_the_cpu(tmp_path):
    wf = tmp_path / "tiny_workflow.py"
    wf.write_text(WORKFLOW_FILE)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "-s", "7",
         str(wf), "root.unused.key=1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "epoch 1 train" in proc.stderr
    assert "complete: reached max_epochs=1" in proc.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
         "--snapshot", "x", str(wf)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "--snapshot" in bad.stderr
