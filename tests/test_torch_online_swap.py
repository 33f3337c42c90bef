"""The residency manager's side of the online tier in the port, after
the reference's ``TestResidencySwapAtomicity`` (``tests/test_online.py``):

- a busy model (rows queued or in flight) is never the spill victim;
- ``swap_params`` on a spilled model raises;
- serving dispatches raced against promotion swaps: every answer equals
  the old params' answer or the new ones', bitwise (one client thread
  sends the same request each time, so every dispatch is the same
  padded batch on the CPU);
- ``refresh_host_params`` is what a later spill restores; ``reserve``,
  ``release`` and ``ledger`` charge the pools the LRU budget reads;
- ``notify_next_dispatch`` fires exactly once, after the next dispatch.
"""

import threading
import time

import numpy as np
import pytest
import torch

from veles_tpu_torch.backends import make_device
from veles_tpu_torch.datasets import synthetic_classification
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.online.promote import PromotionGate
from veles_tpu_torch.online.trainer import ShadowTrainer
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow
from veles_tpu_torch.serve.residency import (POOLS, HostedModel,
                                             ResidencyManager,
                                             install_process_arbiter,
                                             process_arbiter)

CPU = make_device("cpu")


class _FakeEngine:
    def __init__(self, busy=False):
        self.busy = busy
        self.resident = True
        self.spilled = 0
        self.adopted = None

    def drain(self, timeout=30.0):
        return True

    def spill_params(self):
        self.spilled += 1
        self.resident = False

    def adopt_stacked_params(self, stacked):
        self.adopted = stacked


def _hosted(name, nbytes, busy):
    m = HostedModel.__new__(HostedModel)
    m.name, m.forwards, m.member_params = name, [], []
    m.meta, m.sample_shape = {}, None
    m.engine = _FakeEngine(busy=busy)
    m.param_bytes, m.last_used = nbytes, 0.0
    return m


def test_busy_model_is_never_the_spill_victim():
    res = ResidencyManager(CPU, budget_bytes=1000)
    a = _hosted("a", 600, busy=True)     # the LRU one, and mid-flight
    b = _hosted("b", 600, busy=False)
    a.last_used, b.last_used = 1.0, 2.0
    incoming = _hosted("c", 600, busy=False)
    incoming.engine = None
    for m in (a, b, incoming):
        res.models[m.name] = m
    with res._lock:
        victim, blocked = res._pick_victim(incoming)
    assert victim is b and not blocked and a.engine.spilled == 0
    b.engine.busy = True
    with res._lock:
        victim, blocked = res._pick_victim(incoming)
    assert victim is None and blocked
    # a side charge counts against the same budget
    b.engine.busy = False
    res.models.pop("a")
    res.reserve("c@shadow", 500, pool="train")
    with res._lock:
        victim, _ = res._pick_victim(_hosted("d", 100, busy=False))
    assert victim is b


def test_swap_params_requires_residency():
    res = ResidencyManager(CPU, budget_bytes=1 << 30)
    m = _hosted("a", 100, busy=False)
    res.models["a"] = m
    token = {"fwd": {"weights": torch.zeros(1)}}
    assert res.swap_params("a", token) is m.engine
    assert m.engine.adopted is token
    m.engine.resident = False
    with pytest.raises(RuntimeError, match="not resident"):
        res.swap_params("a", {})
    with pytest.raises(KeyError):
        res.swap_params("nobody", token)


def test_reserve_release_and_ledger():
    res = ResidencyManager(CPU, budget_bytes=1 << 30)
    res.models["a"] = _hosted("a", 300, busy=False)
    res.models["b"] = _hosted("b", 50, busy=False)
    res.models["b"].engine.resident = False
    res.reserve("a@shadow", 600, pool="train")
    res.reserve("a@buffer", 10, pool="scratch")
    res.reserve("a@buffer", 20, pool="scratch")   # a re-charge
    assert res.ledger() == {"serve": 300, "train": 600, "cohort": 0,
                            "scratch": 20}
    assert res.resident_bytes() == 920
    with pytest.raises(ValueError, match="pool"):
        res.reserve("x", 1, pool="nowhere")
    res.release("a@shadow")
    res.release("never-charged")
    assert res.ledger()["train"] == 0 and res.resident_bytes() == 320
    assert set(res.ledger()) == set(POOLS)
    assert install_process_arbiter(res) is res and process_arbiter() is res


def _served(seed=21, n_members=3):
    train, valid, _ = synthetic_classification(64, 16, (6, 6, 1),
                                               n_classes=3, seed=5)
    w = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(
            wf, train=train, valid=valid, minibatch_size=16,
            name="loader"),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
                 "<-": {"learning_rate": 0.1}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.1}}], name="online_wf")
    w.initialize(device=CPU)
    rng = np.random.default_rng(seed)
    members = [{f.name: {pn: (0.3 * rng.standard_normal(s)).astype(
        np.float32) for pn, s in f.param_shapes(f.input_shape).items()}
        for f in w.forwards} for _ in range(n_members)]
    res = ResidencyManager(CPU, budget_bytes=1 << 30, max_batch=8,
                           max_wait_s=0.002)
    res.register(HostedModel("alpha", w.forwards, members,
                             meta={"workflow": w, "seed": seed},
                             sample_shape=(6, 6, 1)))
    return res, res.ensure("alpha"), w, train


def test_swaps_raced_against_dispatches_never_tear_an_answer():
    res, engine, w, (xs, ys) = _served()
    x = xs[:4]
    old_tree = engine.stacked_params
    old = engine.submit(x).result(timeout=30)
    tr = ShadowTrainer(w.forwards, w.gds, w.evaluator, CPU,
                       old_tree, seed=3, lr_scale=1.0, micro_batch=8)
    for k in range(6):   # a shadow that answers measurably otherwise
        idx = tr.sample_rng().integers(0, len(xs), 8)
        tr.step(xs[idx], (ys[idx] + 1) % 3, k)
    new_tree = tr.take_params()
    answers, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            answers.append(engine.submit(x).result(timeout=30))

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    gate = PromotionGate("alpha", res, margin=0.0, min_steps=1)
    gate.last_step_ts = time.monotonic()
    for k in range(21):   # old, new, old, ..., new
        time.sleep(0.005)
        gate.promote(new_tree if k % 2 == 0 else old_tree, tr.steps)
    time.sleep(0.05)
    stop.set()
    t.join(timeout=10)
    new = engine.submit(x).result(timeout=30)
    assert not np.allclose(old, new)   # the swap really landed
    assert engine.stacked_params is new_tree
    assert len(answers) >= 10
    n_new = 0
    for a in answers:
        is_old, is_new = np.array_equal(a, old), np.array_equal(a, new)
        assert is_old or is_new, "torn answer: neither the old params' " \
            "nor the new params'"
        n_new += is_new
    assert n_new > 0
    assert gate.promotions == 21
    assert gate.last_promotion["swap_ms"] >= 0.0
    assert gate.time_to_serve_ms is not None
    res.close()


def test_refresh_host_params_is_what_a_spill_restores():
    res, engine, w, (xs, _) = _served(seed=4)
    m = res.models["alpha"]
    tr = ShadowTrainer(w.forwards, w.gds, w.evaluator, CPU,
                       engine.stacked_params, seed=3, lr_scale=1.0,
                       micro_batch=8)
    tr.step(xs[:8], np.zeros(8, np.int64), 0)
    res.swap_params("alpha", tr.take_params())
    res.refresh_host_params("alpha", tr.host_members())
    promoted = engine.predict_proba(xs[:5])
    engine.spill_params()
    assert not m.resident
    with pytest.raises(RuntimeError, match="not resident"):
        res.swap_params("alpha", tr.take_params())
    assert res.ensure("alpha") is engine and m.resident
    np.testing.assert_array_equal(engine.predict_proba(xs[:5]), promoted)
    res.close()


def test_notify_next_dispatch_fires_exactly_once():
    res, engine, _, (xs, _) = _served(seed=5)
    fired = []
    engine.notify_next_dispatch(lambda: fired.append(engine.dispatches))
    engine.submit(xs[:2]).result(timeout=30)
    engine.submit(xs[:3]).result(timeout=30)
    assert fired == [1]
    # a hook that raises never fails the dispatch it observed
    engine.notify_next_dispatch(lambda: 1 / 0)
    assert engine.submit(xs[:2]).result(timeout=30).shape == (2, 3)
    assert engine.batcher.last_activity <= time.monotonic()
    res.close()
