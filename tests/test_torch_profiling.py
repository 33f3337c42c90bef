"""The port's profiling module and ``--profile``, against the JAX
package's analytic FLOPs.

- ``layer_flops_table`` and ``model_flops_per_sample`` exactly equal to
  the reference's (same conventions: a multiply-add is 2 FLOPs, a
  weighted layer trains at 3x its forward, a weightless one at 2x) for
  the AlexNet, mnist_ae, wine, mnist_rbm and DBN fine-tune layer lists,
  each initialized at the same minibatch.
- ``mfu`` has no peak for the CPU; the H100 row is the datasheet's.
- ``python -m veles_tpu_torch -b cpu --profile DIR
  veles_tpu_torch/models/wine.py`` trains, and writes a Chrome trace and
  a ``flops_table.json`` whose numbers equal the reference's.
"""

import glob
import json
import os
import subprocess
import sys

import pytest

from test_torch_data import data_dir_in_both
from test_torch_train import _seed_both
from test_torch_zoo import _FL
from veles_tpu import profiling as ref_profiling
from veles_tpu.backends import JaxDevice
from veles_tpu.models import alexnet as ref_alexnet
from veles_tpu.models import mnist_ae as ref_mnist_ae
from veles_tpu.models import mnist_dbn as ref_mnist_dbn
from veles_tpu.models import mnist_rbm as ref_mnist_rbm
from veles_tpu.models import wine as ref_wine
from veles_tpu_torch import prng, profiling
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.models import alexnet, mnist_ae, mnist_dbn, mnist_rbm, \
    wine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (port module, reference module, the cut loader; None: DEFAULTS)
MODELS = {
    "alexnet": (alexnet, ref_alexnet,
                dict(alexnet.DEFAULTS["loader"], n_train=8, n_valid=4,
                     minibatch_size=4)),
    "mnist_ae": (mnist_ae, ref_mnist_ae,
                 dict(mnist_ae.DEFAULTS["loader"], n_train=20, n_valid=10)),
    "wine": (wine, ref_wine, None),
    "mnist_rbm": (mnist_rbm, ref_mnist_rbm,
                  dict(mnist_rbm.DEFAULTS["loader"], n_train=20,
                       n_valid=10)),
    "mnist_dbn": (mnist_dbn, ref_mnist_dbn,
                  dict(mnist_dbn.DEFAULTS["loader"], n_train=20,
                       n_valid=10)),
}


@pytest.fixture(autouse=True)
def _port_state():
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def _json(obj):
    """Tuples as lists, as ``flops_table.json`` holds them."""
    return json.loads(json.dumps(obj))


def reference_table(ref_mod, loader, tmp_path):
    over = {} if loader is None else {"loader": loader}
    with data_dir_in_both(tmp_path):
        _seed_both(7)
        w = ref_mod.create_workflow(_FL(), **over)
        w.initialize(device=JaxDevice(platform="cpu"))
    return _json({"layers": ref_profiling.layer_flops_table(w.forwards),
                  "total": ref_profiling.model_flops_per_sample(w.forwards)})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flops_tables_are_the_references(name, tmp_path):
    port_mod, ref_mod, loader = MODELS[name]
    want = reference_table(ref_mod, loader, tmp_path)
    over = {} if loader is None else {"loader": loader}
    w = port_mod.create_workflow(_FL(), **over)
    ld = loader or port_mod.DEFAULTS["loader"]
    # shapes only, at the loader's static minibatch
    mb = min(ld["minibatch_size"], max(ld["n_train"], ld["n_valid"]))
    w.initialize(device=make_device("cpu"), batch=mb)
    got = _json({"layers": profiling.layer_flops_table(w.forwards),
                 "total": profiling.model_flops_per_sample(w.forwards)})
    assert got == want
    assert got["total"]["train"] > 2 * got["total"]["forward"] > 0


def test_mfu_knows_the_h100_datasheet_peak_only():
    assert profiling.mfu(1000.0, 1e9, make_device("cpu")) is None
    assert dict(profiling.PEAK_FLOPS) == {"H100 80GB HBM3": 989e12}


def test_profile_flag_writes_a_trace_and_the_references_table(tmp_path):
    out = tmp_path / "prof"
    env = dict(os.environ, HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu", "--profile",
         str(out), "veles_tpu_torch/models/wine.py",
         "root.wine.decision.max_epochs=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "complete: reached max_epochs=2" in proc.stderr
    traces = glob.glob(str(out / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") for e in events)
    with open(out / "flops_table.json") as f:
        got = json.load(f)
    assert got == reference_table(ref_wine, None, tmp_path)
    assert not [p for p in os.listdir(out) if p.endswith(".tmp")]
