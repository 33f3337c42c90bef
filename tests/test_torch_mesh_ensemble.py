"""The member-sharded ensemble in the port
(``EnsembleEvalEngine(shard_members=True)``, ``engine/core.py``
``build_mean_probs`` over places, ``attach_dataset(shard=)``, the GA
handoff into a sharded stack) on a mesh of CPU places, against the
port's unsharded engine and the JAX package's engines on conftest's 8
virtual XLA:CPU devices; after ``tests/test_mesh_shard.py:287-345`` and
``tests/test_engine_core.py``'s member-sharded case.

- 3 wine members over 2 places (padded to 4) and over 4 (place 3 holds
  a filler only): probabilities and error bitwise the unsharded
  engine's, ``param_bytes_per_device`` the padded stack over N, every
  tile on its place; within the serving tests' 1e-5 of the reference's
  sharded and unsharded engines, argmax exact;
- the row-sharded attach scores exactly like the replicated one (77
  rows over 8 places, 10 a place), and ``"auto"`` shards a split over
  ``$VELES_MAX_RESIDENT_BYTES``;
- a sharded cohort's best members adopted into a sharded serving stack:
  the tiles hold them in order, padded with the best member, and the
  answers equal an unsharded engine's on the same members; a promotion
  (``swap_params``) into the sharded model lands tiled as well.
"""

import numpy as np
import pytest
import torch

from test_torch_population import _FL, _wine, _wine_hypers
from test_torch_train import _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.ensemble import EnsembleTrainer as RefTrainer
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops.fused import EnsembleEvalEngine as RefEngine
from veles_tpu.parallel import MeshJaxDevice
from veles_tpu.parallel import make_mesh as ref_make_mesh
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.genetics.handoff import GAServingHandoff
from veles_tpu_torch.models import wine
from veles_tpu_torch.ops.fused import (EnsembleEvalEngine,
                                       PopulationTrainEngine)
from veles_tpu_torch.parallel import MeshDevice, make_mesh
from veles_tpu_torch.serve.residency import ResidencyManager

CPU = make_device("cpu")
#: the serving tests' bar against the reference (test_torch_ensemble.py)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    for knob in ("VELES_MESH_SHARD_DATA", "VELES_SERVE_MESH_SHARD",
                 "VELES_MAX_RESIDENT_BYTES"):
        monkeypatch.delenv(knob, raising=False)
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


@pytest.fixture(scope="module")
def members():
    """Three wine members trained by the reference (its layout), and the
    rows to answer: the port's and the reference's workflows."""
    _seed_both(1234)
    trainer = RefTrainer(
        lambda: ref_wine.create_workflow(_FL(), decision={"max_epochs": 3}),
        lambda: JaxDevice(platform="cpu"), n_members=3, base_seed=555)
    ref_members = trainer.train()
    prng._streams.clear()
    _seed_both(1234)
    w = wine.create_workflow(_FL(), decision={"max_epochs": 3})
    w.initialize(device=CPU)
    rw = ref_wine.create_workflow(_FL(), decision={"max_epochs": 3})
    rw.initialize(device=JaxDevice(platform="cpu"))
    x = np.random.default_rng(5).standard_normal(
        (40,) + tuple(w.loader.sample_shape)).astype(np.float32)
    y = np.random.default_rng(6).integers(0, 3, 40)
    return ref_members, w, rw, x, y


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_engine_is_the_flat_engine_bitwise(members, n):
    ref_members, w, _, x, y = members
    params = [params_from_jax(m["params"]) for m in ref_members]
    flat = EnsembleEvalEngine(w.forwards, params, CPU)
    mesh = make_mesh(n)
    eng = EnsembleEvalEngine(w.forwards, params, MeshDevice(mesh),
                             shard_members=True)
    assert eng.member_sharded and eng._n_stacked == 4
    assert eng.param_bytes == flat.param_bytes
    assert eng.param_bytes_per_device == flat.param_bytes // 3 * 4 // n
    for tile, place in zip(eng._tiles, mesh.places):
        for ps in tile.values():
            assert all(t.device == place and len(t) == 4 // n
                       for t in ps.values())
    np.testing.assert_array_equal(eng.predict_proba(x),
                                  flat.predict_proba(x))
    assert eng.error_pct(x, y, chunk=16) == flat.error_pct(x, y, chunk=16)
    for fn, ps in eng.stacked_params.items():
        for pn, t in ps.items():
            assert torch.equal(t, flat.stacked_params[fn][pn])
    with pytest.raises(ValueError, match="mesh"):
        EnsembleEvalEngine(w.forwards, params, CPU, shard_members=True)


def test_sharded_engine_agrees_with_the_references(members):
    ref_members, w, rw, x, _ = members
    params = [params_from_jax(m["params"]) for m in ref_members]
    got = EnsembleEvalEngine(w.forwards, params, MeshDevice(make_mesh(2)),
                             shard_members=True).predict_proba(x)
    ref_params = [m["params"] for m in ref_members]
    ref_flat = RefEngine(list(rw.forwards), ref_params,
                         JaxDevice(platform="cpu")).predict_proba(x)
    ref_sharded = RefEngine(list(rw.forwards), ref_params,
                            MeshJaxDevice(ref_make_mesh(2)),
                            shard_members=True).predict_proba(x)
    for want in (ref_flat, ref_sharded):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_row_sharded_attach_scores_exactly_like_the_replicated(members):
    ref_members, w, _, _, _ = members
    x = np.random.default_rng(3).standard_normal(
        (77,) + tuple(w.loader.sample_shape)).astype(np.float32)
    y = np.random.default_rng(4).integers(0, 3, 77)
    params = [params_from_jax(m["params"]) for m in ref_members[:2]]
    eng = EnsembleEvalEngine(w.forwards, params, MeshDevice(make_mesh(8)))
    eng.attach_dataset(x, y, shard=False)
    assert not eng._dataset_sharded
    e_rep = eng.error_pct_resident()
    p_rep = eng.predict_proba_resident(np.arange(10))
    tail = eng.error_pct_resident(n=30, chunk=7)
    eng.attach_dataset(x, y, shard=True)
    assert eng._dataset_sharded and len(eng._dataset) == 8
    # 77 rows -> 80 padded, 10 a place, each tile on its place
    assert [len(t) for t in eng._dataset] == [10] * 8
    assert all(t.device == p for t, p in zip(eng._dataset,
                                             eng.device.places))
    assert eng.error_pct_resident() == e_rep
    np.testing.assert_array_equal(eng.predict_proba_resident(np.arange(10)),
                                  p_rep)
    assert eng.error_pct_resident(n=30, chunk=7) == tail
    eng.release()


def test_oversize_split_attaches_sharded_under_auto(members, monkeypatch):
    ref_members, w, _, x, y = members
    monkeypatch.setenv("VELES_MAX_RESIDENT_BYTES", str(x.nbytes // 2))
    eng = EnsembleEvalEngine(w.forwards,
                             [params_from_jax(ref_members[0]["params"])],
                             MeshDevice(make_mesh(8)))
    eng.attach_dataset(x, y)          # auto
    assert eng._dataset_sharded
    assert eng.error_pct_resident() >= 0.0
    monkeypatch.setenv("VELES_MESH_SHARD_DATA", "never")
    eng.attach_dataset(x, y)
    assert not eng._dataset_sharded
    eng.release()


def test_handoff_into_a_sharded_stack(monkeypatch):
    monkeypatch.setenv("VELES_SERVE_MESH_SHARD", "always")
    lrs = [0.3, 0.05, 0.8, 0.1, 0.02]
    rates, decays = _wine_hypers(lrs)
    w = _wine(lrs[0], fail=1, epochs=4)
    cohort = PopulationTrainEngine(w, rates, decays, mesh=make_mesh(2))
    k = 3
    dev = MeshDevice(make_mesh(2))
    mgr = ResidencyManager(dev, budget_bytes=1 << 30, max_batch=8,
                           max_wait_s=0.002)
    init = [cohort.member_params(i) for i in range(k)]
    ho = GAServingHandoff(mgr, "winner", w.fused.forwards, init,
                          sample_shape=tuple(w.loader.sample_shape))
    assert ho.engine.member_sharded and ho.engine._n_stacked == 4
    fits = cohort.run()
    ho.prewarm(cohort)
    served = ho.adopt_cohort(cohort, fits)
    idx = ho.top_k(fits)
    best = [cohort.member_params(int(i)) for i in idx]
    tiles = served._tiles
    for fn, ps in tiles[0].items():
        for pn in ps:
            rows = [t[fn][pn][j] for t in tiles for j in range(2)]
            # members in top-k order, the filler the best member
            for got, want in zip(rows, best + [best[0]]):
                np.testing.assert_array_equal(got.numpy(), want[fn][pn])
    x = np.random.default_rng(1).standard_normal(
        (4,) + tuple(w.loader.sample_shape)).astype(np.float32)
    flat = EnsembleEvalEngine(w.forwards, best, CPU)
    np.testing.assert_array_equal(served.submit(x).result(timeout=30),
                                  flat.predict_proba(x))
    # a promotion's tree of the real members lands tiled, padded alike
    mgr.swap_params("winner", flat.stacked_params)
    assert len(served._tiles) == 2
    np.testing.assert_array_equal(served.predict_proba(x),
                                  flat.predict_proba(x))
    ho.refresh_host()
    assert len(mgr.models["winner"].member_params) == k
    mgr.close()
    cohort.release()
