"""The GA -> serving handoff in the port (``genetics/handoff.py``), after
the reference's ``TestGAHandoff`` (``tests/test_engine_core.py``), its
mesh case in ``tests/test_torch_mesh_ensemble.py``:

- ``top_k``: the same member order as the reference's, ties included;
- a wine cohort of 3 (the reference test's rates) trained, then its 2
  best members adopted into a pre-built serving engine: the served
  stack equals the cohort's members bitwise, a request flows through
  the batcher, and nothing on the adopt's path saves an npz or fetches
  a tensor to the host;
- the reference's cohort, trained on XLA:CPU, adopted by both handoffs:
  the port's served probabilities within 1e-6 of the reference's (the
  same params; f32 on both sides);
- an adopt after the cohort's release is refused; a SOM cohort exposes
  its maps as the reference's param tree, which the gather slices.
"""

import glob
import os

import numpy as np
import pytest
import torch

from test_torch_train import _seed_both
from veles_tpu.backends import JaxDevice
from veles_tpu.genetics.handoff import GAServingHandoff as RefHandoff
from veles_tpu.models import kohonen as ref_kohonen
from veles_tpu.models import wine as ref_wine
from veles_tpu.ops.fused import PopulationTrainEngine as RefEngine
from veles_tpu.ops.kohonen import SOMPopulationEngine as RefSOMEngine
from veles_tpu.serve import residency as ref_residency
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.genetics import GAServingHandoff
from veles_tpu_torch.models import kohonen, wine
from veles_tpu_torch.ops import batching
from veles_tpu_torch.ops.fused import PopulationTrainEngine
from veles_tpu_torch.ops.kohonen import SOMPopulationEngine
from veles_tpu_torch.serve.residency import ResidencyManager

CPU = make_device("cpu")
LRS = [0.3, 0.05, 0.8]
K = 2


class _FL:
    workflow = None


def _layers(lr):
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
             "<-": {"learning_rate": lr, "weight_decay": 0.001,
                    "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": lr, "gradient_moment": 0.9}}]


def _hypers():
    rates = np.asarray([[[lr, lr], [lr, lr]] for lr in LRS], np.float32)
    decays = np.asarray([[[0.001, 0.0], [0.0, 0.0]]] * len(LRS),
                        np.float32)
    return rates, decays


def _decision():
    return {"max_epochs": 4, "fail_iterations": 1}


def _port_cohort():
    _seed_both(1234)
    w = wine.create_workflow(_FL(), layers=_layers(LRS[0]),
                             decision=_decision())
    w.initialize(device=CPU, train=True)
    return w, PopulationTrainEngine(w, *_hypers())


def _ref_cohort():
    _seed_both(1234)
    rw = ref_wine.create_workflow(_FL(), layers=_layers(LRS[0]),
                                  decision=_decision())
    rw.initialize(device=JaxDevice(platform="cpu"))
    return rw, RefEngine(rw, *_hypers())


def _members(stacked, k=K):
    """The first ``k`` members of a stacked tree, as host arrays."""
    return [{fn: {pn: np.asarray(a[i]) for pn, a in ps.items()}
             for fn, ps in stacked.items()} for i in range(k)]


@pytest.mark.parametrize("fitness,k", [
    ([3.0, 1.0, 2.0], 2), ([5.0, 5.0, 1.0, 5.0], 3),
    ([0.5, 0.5, 0.5], 1), ([2, 9, 0, 4, 0, 7], 4)])
def test_top_k_order_equals_the_reference(fitness, k):
    mine, ref = (GAServingHandoff.__new__(GAServingHandoff),
                 RefHandoff.__new__(RefHandoff))
    mine.k = ref.k = k
    got = mine.top_k(np.asarray(fitness))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.top_k(np.asarray(fitness)))


def test_handoff_serves_trained_members_without_a_host_round_trip(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w, engine = _port_cohort()
    sample_shape = tuple(w.loader.sample_shape)
    mgr = ResidencyManager(CPU, budget_bytes=1 << 30, max_batch=8,
                           max_wait_s=0.002)
    # the scaffold is built from the cohort's INIT params, before it
    # trains
    ho = GAServingHandoff(mgr, "winner", w.fused.forwards,
                          [{fn: {pn: CPU.get(a[i]) for pn, a in ps.items()}
                            for fn, ps in engine._params.items()}
                           for i in range(K)], sample_shape=sample_shape)
    fits = engine.run()
    ho.prewarm(engine)

    def refuse(what):
        def _raise(*a, **k):
            raise AssertionError(f"the handoff touched the host: {what}")
        return _raise

    with monkeypatch.context() as m:
        for fname in ("savez", "savez_compressed", "save"):
            m.setattr(np, fname, refuse(f"np.{fname}"))
        for meth in ("numpy", "cpu", "tolist", "item"):
            m.setattr(torch.Tensor, meth, refuse(f"Tensor.{meth}"))
        m.setattr(CPU, "get", refuse("device.get"))
        served = ho.adopt_cohort(engine, fits)
    assert served is ho.engine and ho.adopt_seconds > 0.0
    idx = ho.top_k(fits)
    np.testing.assert_array_equal(idx, np.argsort(fits, kind="stable")[:K])
    for fn, ps in served.stacked_params.items():
        for pn, a in ps.items():
            assert torch.equal(a, engine._params[fn][pn][
                torch.from_numpy(idx.astype(np.int64))]), (fn, pn)
    x = w.loader.original_data[:4].float().numpy()
    out = served.submit(x).result(timeout=30)
    assert out.shape == (4, 3) and np.all(np.isfinite(out))
    ho.refresh_host()
    host = mgr.models["winner"].member_params
    for i, j in enumerate(idx):
        for fn, ps in engine.member_params(int(j)).items():
            for pn, a in ps.items():
                np.testing.assert_array_equal(host[i][fn][pn], a)
    assert mgr.ledger()["serve"] > 0
    engine.release()
    mgr.close()
    assert glob.glob(os.path.join(str(tmp_path), "**", "*.npz"),
                     recursive=True) == []


def test_served_probabilities_equal_the_reference_handoff():
    rw, ref = _ref_cohort()
    sample_shape = tuple(np.asarray(
        rw.loader.original_data.map_read()).shape[1:])
    init = _members(ref._params)
    rmgr = ref_residency.ResidencyManager(rw.fused.device,
                                          budget_bytes=1 << 30)
    rho = RefHandoff(rmgr, "winner", rw.fused.forwards, init,
                     sample_shape=sample_shape)
    fits = np.asarray(ref.run())
    rserved = rho.adopt_cohort(ref, fits)
    x = np.asarray(rw.loader.original_data.map_read()[:16], np.float32)
    want = np.asarray(rserved.submit(x).result())

    w, _ = _port_cohort()
    mgr = ResidencyManager(CPU, budget_bytes=1 << 30, max_batch=16,
                           max_wait_s=0.002)
    ho = GAServingHandoff(mgr, "winner", w.fused.forwards, init,
                          sample_shape=sample_shape)
    # the reference's trained cohort, as the port's member-stacked tree
    trained = batching.stack_member_params(
        w.fused.forwards, _members(ref._params, len(LRS)), CPU)
    served = ho.adopt(trained, ho.top_k(fits))
    np.testing.assert_array_equal(ho.top_k(fits), rho.top_k(fits))
    got = served.submit(x).result(timeout=30)
    assert want.max() > 0.5   # a net that discriminates
    np.testing.assert_allclose(got, want, atol=1e-6)
    mgr.close()
    rmgr.close()


def test_adopt_after_release_is_refused():
    w, engine = _port_cohort()
    mgr = ResidencyManager(CPU, budget_bytes=1 << 30)
    ho = GAServingHandoff(mgr, "late", w.fused.forwards,
                          _members({fn: {pn: CPU.get(a) for pn, a in
                                         ps.items()}
                                    for fn, ps in engine._params.items()}),
                          sample_shape=tuple(w.loader.sample_shape),
                          warm_rows=0)
    fits = engine.run()
    engine.release()
    with pytest.raises(RuntimeError, match="release"):
        ho.adopt_cohort(engine, fits)
    with pytest.raises(RuntimeError):
        ho.prewarm(engine)
    with pytest.raises(ValueError, match="exactly 2"):
        ho.adopt({}, np.arange(3))
    mgr.close()


def test_som_cohort_maps_are_the_references_param_tree():
    hp = np.asarray([[0.3, 0.01, 3.0, 0.5], [0.5, 0.05, 3.0, 0.8],
                     [0.1, 0.02, 1.5, 0.4]], np.float32)
    cfg = {"loader": {"n_train": 60, "n_valid": 20, "minibatch_size": 20},
           "som_shape": (4, 5), "decision": {"max_epochs": 1}}
    _seed_both(4242)
    w = kohonen.create_workflow(_FL(), **cfg)
    w.initialize(device=CPU, train=True)
    engine = SOMPopulationEngine(w, hp)
    _seed_both(4242)
    rw = ref_kohonen.create_workflow(_FL(), **cfg)
    rw.initialize(device=JaxDevice(platform="cpu"))
    ref = RefSOMEngine(rw, hp)
    tree = engine._params
    assert {fn: set(ps) for fn, ps in tree.items()} == \
        {fn: set(ps) for fn, ps in ref._params.items()}
    got = GAServingHandoff._gather(tree, np.asarray([2, 0], np.int32))
    for fn, ps in got.items():
        for pn, a in ps.items():
            assert torch.equal(a, tree[fn][pn][[2, 0]])
    engine.release()
    assert engine._params is None
