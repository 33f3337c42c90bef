"""Member-sharded supervised cohorts in the port (``engine/core.py``
``MemberPlacement``, ``ops/population.py``, ``genetics/worker.py``) on a
mesh of CPU places, against the port's unsharded engine and the JAX
package's engines on conftest's 8 virtual XLA:CPU devices; after
``tests/test_mesh_shard.py:198-285`` (the wide cohort is
``test_torch_mesh_wide.py``'s, the conv net and the SOM
``test_torch_mesh_som.py``'s).

- ``batching.pad_members`` equals the reference's;
- ``MeshDevice``'s accounting: a replicated put charges N copies, a
  row-sharded or member-sharded one the padded total once, each tile on
  its place;
- wine, P = 3 over 2 places (padded to 4): the fitness equals the
  port's unsharded engine's and the reference's sharded and unsharded
  engines' exactly; the params equal the port's unsharded engine's
  within ``test_torch_population.py``'s rtol 1e-4 / atol 5e-6, and the
  reference's at the stable rates;
- ``change_norms`` is each real member's distance from its start;
- ``$VELES_MESH_SHARD_MEMBERS=never`` keeps the cohort on one device;
- ``_hbm_cohort_cap`` equals the reference's for 1 and 8 places, and
  ``never``.
"""

import numpy as np
import pytest
import torch

from test_torch_population import (STABLE_LRS, WINE_LRS, _FL, _ref_cohort,
                                   _wine, _wine_hypers)
from test_torch_train import _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops import batching as ref_batching
from veles_tpu.ops.fused import PopulationTrainEngine as RefEngine
from veles_tpu.parallel import make_mesh as ref_make_mesh
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import batching
from veles_tpu_torch.ops.fused import PopulationTrainEngine
from veles_tpu_torch.parallel import MeshDevice, make_mesh

RTOL, ATOL = 1e-4, 5e-6


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


# -- padding and placement ---------------------------------------------------

@pytest.mark.parametrize("p,multiple", [(3, 2), (11, 8), (4, 2), (1, 8)])
def test_pad_members_equals_the_references(p, multiple):
    gen = np.random.default_rng(p)
    arrays = [gen.standard_normal((p, 2, 3)).astype(np.float32),
              np.arange(p, dtype=np.int32)]
    got, n = batching.pad_members(arrays, multiple)
    want, n_ref = ref_batching.pad_members(arrays, multiple)
    assert n == n_ref and n % multiple == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mesh_device_charges_as_the_reference():
    dev = MeshDevice(make_mesh(8))
    assert dev.n_devices == 8 and dev.total_memory() is None
    base = dev.h2d_bytes
    copies = dev.put_replicated(np.zeros((10, 10), np.float32))
    assert dev.h2d_bytes - base == 400 * 8 and len(copies) == 8
    base = dev.h2d_bytes
    tiles = dev.put_sharded(np.ones((10, 7), np.float32))
    # 10 rows pad to 16 (2 a place): the padded total once
    assert dev.h2d_bytes - base == 16 * 7 * 4
    assert [len(t) for t in tiles] == [2] * 8
    assert not tiles[-1].any() and tiles[4].all() and not tiles[5].any()
    assert all(t.device == p for t, p in zip(tiles, dev.places))
    assert dev.put_sharded(np.zeros((16, 4), np.uint8))[0].dtype == \
        torch.uint8
    base = dev.h2d_bytes
    members = dev.put_members(np.arange(16, dtype=np.float32))
    assert dev.h2d_bytes - base == 16 * 4
    assert [t.tolist() for t in members[:2]] == [[0.0, 1.0], [2.0, 3.0]]
    # the head place is the flat device: one copy
    base = dev.h2d_bytes
    assert dev.put(np.zeros(5, np.float32)).device == dev.places[0]
    assert dev.h2d_bytes - base == 20


# -- the supervised cohort: wine -------------------------------------------

def _sharded(lrs, mesh, fail=1, epochs=5):
    rates, decays = _wine_hypers(lrs)
    w = _wine(lrs[0], fail=fail, epochs=epochs)
    engine = PopulationTrainEngine(w, rates, decays, mesh=mesh)
    fits = engine.run()
    return fits, engine


def _ref_sharded(lrs, n, fail=1, epochs=5):
    rates, decays = _wine_hypers(lrs)
    _seed_both(1234)
    rw = ref_wine.create_workflow(
        _FL(), layers=[{"type": "all2all_tanh",
                        "->": {"output_sample_shape": 8},
                        "<-": {"learning_rate": lrs[0],
                               "weight_decay": 0.001,
                               "gradient_moment": 0.9}},
                       {"type": "softmax", "->": {"output_sample_shape": 3},
                        "<-": {"learning_rate": lrs[0],
                               "gradient_moment": 0.9}}],
        decision={"max_epochs": epochs, "fail_iterations": fail})
    rw.initialize(device=JaxDevice(platform="cpu"))
    ref = RefEngine(rw, rates, decays, mesh=ref_make_mesh(n))
    assert ref.member_sharded
    return np.asarray(ref.run()), ref


def _assert_params(engine, other, lrs, ref=False):
    for i in range(len(lrs)):
        got = engine.member_params(i)
        for fn, ps in got.items():
            for pn, a in ps.items():
                want = np.asarray(other._params[fn][pn][i]) if ref \
                    else other.member_params(i)[fn][pn]
                np.testing.assert_allclose(a, want, rtol=RTOL, atol=ATOL)


def check_sharded_wine(lrs, n, stacked):
    """The sharded cohort of ``lrs`` over ``n`` places against the port's
    unsharded engine and the reference's two engines."""
    fits, engine = _sharded(lrs, make_mesh(n))
    assert engine.member_sharded and engine._n_stacked == stacked
    assert fits.shape == (len(lrs),)
    # every tile on its place, a whole tile each
    tiles = engine._tiles
    assert len(tiles) == n
    for tile, place in zip(tiles, make_mesh(n).places):
        for ps in tile.values():
            assert all(t.device == place and len(t) == stacked // n
                       for t in ps.values())
    rates, decays = _wine_hypers(lrs)
    flat = PopulationTrainEngine(_wine(lrs[0]), rates, decays)
    np.testing.assert_array_equal(fits, flat.run())
    _assert_params(engine, flat, lrs)
    np.testing.assert_array_equal(fits, _ref_cohort(lrs, 1, 5)[0])
    np.testing.assert_array_equal(fits, _ref_sharded(lrs, n)[0])
    # the (P, 3) rows of every class end: the real members only
    assert all(a.shape == (len(lrs), 3) for _, _, a in engine.history)


def test_sharded_wine_cohort_equals_unsharded_and_the_reference():
    check_sharded_wine(WINE_LRS, 2, 4)


def test_sharded_params_equal_the_references_at_stable_rates():
    fits, engine = _sharded(STABLE_LRS, make_mesh(2), fail=100)
    ref_fits, ref = _ref_sharded(STABLE_LRS, 2, fail=100)
    np.testing.assert_array_equal(fits, ref_fits)
    _assert_params(engine, ref, STABLE_LRS, ref=True)
    _, flat_ref = _ref_cohort(STABLE_LRS, 100, 5)
    _assert_params(engine, flat_ref, STABLE_LRS, ref=True)


def test_change_norms_are_each_members_distance_from_its_start():
    """``change_norms`` (what the evaluator reports a chunk) equals each
    real member's host-side distance from the workflow's params, leaf by
    leaf, sharded (fillers dropped) as unsharded."""
    for mesh in (make_mesh(2), None):
        _, engine = _sharded(WINE_LRS, mesh)
        start = engine.fused.host_params()
        want = [[np.linalg.norm(a - start[fn][pn]) for fn, ps in
                 engine.member_params(i).items() for pn, a in ps.items()]
                for i in range(len(WINE_LRS))]
        got = engine.change_norms()
        assert got.shape == (len(WINE_LRS), 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        # the gene is the first layer's rate: its weights move apart
        assert len(set(np.round(got[:, 0], 6))) == len(WINE_LRS)


def test_knob_never_keeps_the_cohort_on_one_device(monkeypatch):
    monkeypatch.setenv("VELES_MESH_SHARD_MEMBERS", "never")
    rates, decays = _wine_hypers([0.3, 0.5])
    engine = PopulationTrainEngine(_wine(0.3), rates, decays,
                                   mesh=make_mesh(8))
    assert not engine.member_sharded and engine._n_stacked == 2
    assert isinstance(engine._params, dict)


def test_the_cohort_cap_equals_the_references(monkeypatch):
    from veles_tpu.genetics.worker import _hbm_cohort_cap as ref_cap
    from veles_tpu_torch.genetics.worker import _hbm_cohort_cap
    monkeypatch.delenv("VELES_TPU_GA_HBM_BUDGET", raising=False)
    w = _wine(0.3)
    _seed_both(1234)
    rw = ref_wine.create_workflow(_FL())
    rw.initialize(device=JaxDevice(platform="cpu"))
    cap1 = _hbm_cohort_cap(w, 0)
    cap8 = _hbm_cohort_cap(w, 0, mesh=make_mesh(8))
    assert cap1 == ref_cap(rw, 0, n_devices=1)
    assert cap8 == ref_cap(rw, 0, n_devices=8) and cap8 >= 4 * cap1
    assert _hbm_cohort_cap(w, 5, mesh=make_mesh(8)) == \
        ref_cap(rw, 5, n_devices=8) == 5
    monkeypatch.setenv("VELES_MESH_SHARD_MEMBERS", "never")
    assert _hbm_cohort_cap(w, 0, mesh=make_mesh(8)) == cap1 == \
        ref_cap(rw, 0, n_devices=8)
