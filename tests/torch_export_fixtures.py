"""Shared nets and helpers of ``test_torch_export.py`` and
``test_torch_native.py``.

- :data:`NETS`: the nets of ``tests/test_native.py`` (the reference's
  native runtime tests), by that file's test names, and a tiny
  AlexNet-shaped net with both ``norm`` layers (and a standalone
  activation, for the bytes alone); each with its loss, its
  sample shape and the tolerance of native's answers against the
  forward (the reference's, test by test).
- :func:`build_pair`: the net as the reference's workflow (numpy
  device) and as the port's (CPU), both initialized, and params drawn
  from a seed with numpy in the reference's layout loaded into both.
- :func:`sample_rows`: rows of a net's data, to answer.
- :func:`port_forward`: the port's f32 eval forward of a workflow with
  its current params.
"""

import copy

import numpy as np
import torch

from veles_tpu import prng as ref_prng
from veles_tpu.backends import NumpyDevice
from veles_tpu.datasets import synthetic_classification
from veles_tpu.loader import ArrayLoader as RefArrayLoader
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.models.alexnet import alexnet_layers
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

CPU = make_device("cpu")
SHAPE = (12, 12, 1)


def _lr(lr):
    return {"learning_rate": lr}


SOFTMAX_ONLY = [{"type": "softmax", "->": {"output_sample_shape": 4},
                 "<-": _lr(0.1)}]


def tiny_alexnet_layers():
    """``models/alexnet.py``'s layers at narrow widths for a 67x67x3
    input: conv 11x11/4, norm, pool 3/2, conv 5x5, norm, pool, three
    conv 3x3, pool, two fc+dropout and the softmax."""
    layers = copy.deepcopy(alexnet_layers(n_classes=4))
    widths = iter([8, 12, 16, 16, 12])
    for layer in layers:
        fwd = layer["->"]
        if "n_kernels" in fwd:
            fwd["n_kernels"] = next(widths)
        if layer["type"] == "all2all_relu":
            fwd["output_sample_shape"] = 32
    return layers


#: name -> (layers, loss, sample shape, atol of native vs the forward)
NETS = {
    "dense_net": ([
        {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
         "<-": _lr(0.1)},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": _lr(0.1)}], "softmax", SHAPE, 1e-5),
    "conv_net_with_everything": ([
        {"type": "conv_relu",
         "->": {"n_kernels": 6, "kx": 3, "ky": 3, "padding": 1,
                "sliding": 2}, "<-": _lr(0.05)},
        {"type": "norm", "->": {"n": 3}, "<-": {}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2, "sliding": 2},
         "<-": {}},
        {"type": "dropout", "->": {"dropout_ratio": 0.4}, "<-": {}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 12},
         "<-": _lr(0.05)},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": _lr(0.05)}], "softmax", SHAPE, 1e-4),
    "avgpool_and_stochpool": ([
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2, "sliding": 2},
         "<-": {}},
        {"type": "stochastic_pooling",
         "->": {"kx": 2, "ky": 2, "sliding": 2}, "<-": {}},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": _lr(0.1)}], "softmax", SHAPE, 1e-5),
    "autoencoder_with_deconv": ([
        {"type": "conv_tanh",
         "->": {"n_kernels": 4, "kx": 4, "ky": 4, "sliding": 2,
                "padding": 1}, "<-": _lr(0.02)},
        {"type": "deconv",
         "->": {"n_kernels": 1, "kx": 4, "ky": 4, "sliding": 2,
                "padding": 1}, "<-": _lr(0.02)}], "mse", SHAPE, 1e-4),
    "model_metadata": (SOFTMAX_ONLY, "softmax", SHAPE, 1e-5),
    "truncated_file": (SOFTMAX_ONLY, "softmax", SHAPE, 1e-5),
    "wrong_input_shape": (SOFTMAX_ONLY, "softmax", SHAPE, 1e-5),
    "dbn_mlp": ([
        {"type": "binarization", "->": {}, "<-": {}},
        {"type": "all2all_sigmoid", "->": {"output_sample_shape": 12},
         "<-": _lr(0.1)},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": _lr(0.1)}], "softmax", SHAPE, 1e-5),
    "alexnet_tiny": (tiny_alexnet_layers(), "softmax", (67, 67, 3), 1e-4),
    # the reference writes a standalone activation with its unit's
    # activation_mode, "linear" (ROADMAP Queue 3): bytes only
    "standalone_activation": ([
        {"type": "activation_tanh", "->": {}, "<-": {}},
        {"type": "softmax", "->": {"output_sample_shape": 4},
         "<-": _lr(0.1)}], "softmax", SHAPE, None),
}


def _data(shape):
    return synthetic_classification(40, 20, shape, n_classes=4, seed=42)


def sample_rows(name, n=8):
    """The first ``n`` training rows of net ``name``'s data."""
    return _data(NETS[name][2])[0][0][:n]


def draw_params(ref_wf, seed):
    """{fwd name: {pname: f32 array}} in the reference's layout, uniform
    in +-sqrt(3 / fan_in) (the init's scale), from one numpy seed."""
    gen = np.random.default_rng(seed)
    out = {}
    for f in ref_wf.forwards:
        ps = {}
        for pname, shape in f.param_shapes(f.input.shape).items():
            fan_in = f.weight_fan_in(shape) if pname == "weights" \
                else shape[-1]
            a = np.sqrt(3.0 / max(1, fan_in))
            ps[pname] = gen.uniform(-a, a, shape).astype(np.float32)
        if ps:
            out[f.name] = ps
    return out


def build_pair(name, seed=20261018):
    """(reference workflow, port workflow, reference-layout params) for
    net ``name`` of :data:`NETS`, the same params loaded into both."""
    layers, loss, shape, _ = NETS[name]
    train, valid, _ = _data(shape)
    ref_prng._streams.clear()
    ref_prng.seed_all(777)
    rtrain, rvalid = train, valid
    if loss == "mse":
        rtrain = (train[0], train[1], train[0])
        rvalid = (valid[0], valid[1], valid[0])
    ref = RefWorkflow(
        loader_factory=lambda wf: RefArrayLoader(
            wf, train=rtrain, valid=rvalid, minibatch_size=20,
            name="loader"),
        layers=copy.deepcopy(layers), loss_function=loss,
        decision_config={"max_epochs": 1}, name="native_wf")
    ref.initialize(device=NumpyDevice())
    params = draw_params(ref, seed)
    for f in ref.forwards:
        for pname, arr in params.get(f.name, {}).items():
            getattr(f, pname).map_invalidate()[...] = arr

    prng._streams.clear()
    prng.seed_all(777)
    port = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(
            wf, train=train, valid=valid, minibatch_size=20,
            targets_from_labels=loss == "mse", name="loader"),
        layers=copy.deepcopy(layers), loss_function=loss,
        decision_config={"max_epochs": 1}, name="native_wf")
    port.initialize(device=CPU, train=True)
    port.fused.set_host_params(params_from_jax(params))
    return ref, port, params


def port_forward(w, x):
    """The port's f32 eval forward of ``x`` (NHWC numpy) through ``w``'s
    forwards with its current params, flattened to (B, -1)."""
    params = w.fused.host_params()
    out = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    with torch.no_grad():
        for f in w.forwards:
            p = {k: torch.from_numpy(v) for k, v in
                 params.get(f.name, {}).items()}
            out, _ = f.apply_fwd(p, out, rng=None, train=False)
    return out.reshape(len(x), -1).numpy()
