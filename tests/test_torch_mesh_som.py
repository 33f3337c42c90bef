"""Member sharding of the port's other cohorts on a mesh of CPU places:
a conv net with LRN and dropout (``ops/population.py``, ``prng.
SharedDraws``), the SOM cohort and the SOM trainer's row-sharded gather
(``ops/kohonen.py``); after ``tests/test_zoo_fused.py``'s SOM cohort
case.

- the conv net (``test_torch_train.py``'s tiny AlexNet, dropout at
  0.25), P = 3 over 2 places: the draws are made once a minibatch and
  shared by the places, each place's LRN calls fold its tile's members
  (one call a layer a place), and the fitness equals the unsharded
  engine's, the params within ``test_torch_population.py``'s rtol 1e-4
  / atol 5e-6;
- the SOM cohort, P = 3 over 2 places, resident and streamed: fitness
  bitwise the unsharded engine's, within 1e-4 of the reference's sharded
  engine (2 virtual XLA:CPU devices);
- the SOM trainer's row-sharded gather (3 places) trains bitwise like
  the replicated data set.
"""

import copy

import numpy as np
import pytest

from test_torch_mesh_cohort import _assert_params
from test_torch_population import (SOM_GENOMES, TINY_LRS, _FL, _som_cfg,
                                   _tiny)
from test_torch_train import TINY_LAYERS, _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.models import kohonen as ref_kohonen
from veles_tpu.ops.kohonen import SOMPopulationEngine as RefSOMEngine
from veles_tpu.parallel import make_mesh as ref_make_mesh
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.models import kohonen
from veles_tpu_torch.ops import lrn_cuda
from veles_tpu_torch.ops.fused import PopulationTrainEngine
from veles_tpu_torch.ops.kohonen import SOMPopulationEngine
from veles_tpu_torch.parallel import make_mesh

CPU = make_device("cpu")


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.delenv("VELES_MESH_SHARD_MEMBERS", raising=False)
    monkeypatch.delenv("VELES_MESH_SHARD_DATA", raising=False)
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


# -- a conv net with LRN and dropout: shared draws, the member rule --------

def _dropping(lr):
    layers = copy.deepcopy(TINY_LAYERS)
    for layer in layers:
        if layer["type"] == "dropout":
            layer["->"]["dropout_ratio"] = 0.25
    import test_torch_population
    saved = test_torch_population.TINY_LAYERS
    test_torch_population.TINY_LAYERS = layers
    try:
        return _tiny(lr)
    finally:
        test_torch_population.TINY_LAYERS = saved


def test_sharded_conv_cohort_shares_its_draws_and_folds_its_tiles(
        monkeypatch):
    lrs = TINY_LRS + [0.03]
    w = _dropping(lrs[0])
    rates = np.asarray([[[gd.learning_rate * lr / lrs[0],
                          gd.learning_rate_bias * lr / lrs[0]]
                         for gd in w.gds] for lr in lrs], np.float32)
    decays = np.asarray([[[gd.weight_decay, gd.weight_decay_bias]
                          for gd in w.gds]] * len(lrs), np.float32)
    flat = PopulationTrainEngine(w, rates, decays)
    want = flat.run()
    made, seen = [], []
    gen, fwd_plain = prng.torch_generator, lrn_cuda.lrn_fwd_plain

    def count_gen(*a, **k):
        made.append(a[:3])
        return gen(*a, **k)

    def count_fwd(x, *a):
        seen.append(tuple(x.shape))
        return fwd_plain(x, *a)
    monkeypatch.setattr(prng, "torch_generator", count_gen)
    monkeypatch.setattr(lrn_cuda, "lrn_fwd_plain", count_fwd)
    engine = PopulationTrainEngine(_dropping(lrs[0]), rates, decays,
                                   mesh=make_mesh(2))
    fits = engine.run()
    np.testing.assert_array_equal(fits, want)
    _assert_params(engine, flat, lrs)
    # one generator a (minibatch, stochastic layer), shared by the places
    assert made and len(made) == len(set(made))
    # two norm layers, each one call a place a minibatch, 2 members a call
    assert len(seen) == 2 * 2 * engine.minibatches
    assert all(s[0] == 2 for s in seen)


# -- the SOM cohort and the trainer's row-sharded gather -------------------

def _som(hp, mesh=None, **loader):
    _seed_both(4242)
    w = kohonen.create_workflow(_FL(), **_som_cfg(hp, **loader))
    if mesh is not None:
        w.trainer.mesh = mesh
    w.initialize(device=CPU, train=True)
    return w


@pytest.mark.parametrize("streamed", [False, True])
def test_sharded_som_cohort_equals_unsharded_and_the_reference(streamed):
    loader = {"max_resident_bytes": 0} if streamed else {}
    flat = SOMPopulationEngine(_som(SOM_GENOMES[0], **loader), SOM_GENOMES)
    base = flat.run()
    engine = SOMPopulationEngine(_som(SOM_GENOMES[0], **loader),
                                 SOM_GENOMES, mesh=make_mesh(2))
    assert engine.member_sharded and engine.streaming == streamed
    assert engine._n_stacked == 4 and engine.n_members == 3
    assert [t.shape[0] for t in engine._tiles] == [2, 2]
    fits = engine.run()
    assert fits.shape == (3,)
    np.testing.assert_array_equal(fits, base)
    np.testing.assert_allclose(engine.weights.numpy(), flat.weights.numpy(),
                               rtol=1e-6, atol=1e-7)
    _seed_both(4242)
    rw = ref_kohonen.create_workflow(_FL(), **_som_cfg(SOM_GENOMES[0]))
    rw.initialize(device=JaxDevice(platform="cpu"))
    ref = RefSOMEngine(rw, SOM_GENOMES, mesh=ref_make_mesh(2))
    assert ref.member_sharded
    np.testing.assert_allclose(fits, ref.run(), rtol=1e-4)


def test_som_trainer_row_sharded_gather_is_the_replicated_one(monkeypatch):
    monkeypatch.setenv("VELES_MESH_SHARD_DATA", "always")
    runs = {}
    for name, mesh in (("replicated", None), ("sharded", make_mesh(3))):
        w = _som(SOM_GENOMES[1], mesh=mesh)
        tr = w.trainer
        assert (tr._data_tiles is not None) == (mesh is not None)
        w.run()
        runs[name] = (list(w.decision.history), tr.host_weights(), tr)
    tiles = runs["sharded"][2]._data_tiles
    rows = len(runs["replicated"][2].loader.original_data)
    assert len(tiles) == 3 and len(tiles[0]) == -(-rows // 3)
    assert runs["sharded"][0] == runs["replicated"][0]
    np.testing.assert_array_equal(runs["sharded"][1], runs["replicated"][1])
