"""The port's online-learning tier (``veles_tpu_torch/online``) against
the JAX package's (``veles_tpu/online``) on XLA:CPU.

- ``ReplayBuffer``: the reservoir, the holdout partition, the version,
  ``sample`` and ``holdout`` equal the reference's bitwise for the same
  adds and generators, and so do the uint8 codec's verdict, its bytes and
  its decoded rows.
- ``TrafficTap``: the same tapped subsequence, the same pending joins and
  orphans, the same buffers as the reference's over one request stream.
- ``PromotionGate``: the same verdicts, states, counts and cooldowns over
  one sequence of gate rounds.
- ``ShadowTrainer`` on a tiny conv + LRN + max pool + FC ensemble of 3
  members (dropout 0, momentum on): K steps on the same micro-batches
  from the same stacked params.  Every param within rtol 1e-5 / atol
  1e-6 of the reference's (the same f32 operations; a batched matmul and
  a grouped convolution sum in another order than XLA's), ``n_err`` and
  ``count`` exactly equal, the loss within 1e-5 relative, and the
  held-out ``error_pct`` of shadow and incumbent equal.
- The offline replay of the ``(step, buffer version)`` history equals
  the online trajectory bitwise, with dropout on.
- A promoted tree is never changed by later steps, bitwise.
"""

import numpy as np
import pytest
import torch

from veles_tpu.backends import JaxDevice
from veles_tpu.loader import ArrayLoader as RefArrayLoader
from veles_tpu.loader.quantize import AffineDequant as RefDequant
from veles_tpu.online.buffer import ReplayBuffer as RefBuffer
from veles_tpu.online.promote import PromotionGate as RefGate
from veles_tpu.online.tap import TrafficTap as RefTap
from veles_tpu.online.trainer import ShadowTrainer as RefTrainer
from veles_tpu.ops import batching as ref_batching
from veles_tpu.ops.standard_workflow import StandardWorkflow as RefWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.convert import params_from_jax, params_to_jax
from veles_tpu_torch.datasets import synthetic_classification
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.loader.quantize import AffineDequant
from veles_tpu_torch.online.buffer import ReplayBuffer
from veles_tpu_torch.online.promote import GATE_STATES, PromotionGate
from veles_tpu_torch.online.tap import PENDING_CAP, TrafficTap
from veles_tpu_torch.online.trainer import ShadowTrainer
from veles_tpu_torch.ops import batching
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

CPU = make_device("cpu")


def _buffers_equal(a, b):
    assert a.version == b.version and a._seen == b._seen
    assert a._train_seen == b._train_seen
    assert a._labels == b._labels
    assert a._holdout_labels == b._holdout_labels
    for mine, ref in ((a._rows, b._rows),
                      (a._holdout_rows, b._holdout_rows)):
        assert len(mine) == len(ref)
        for r, s in zip(mine, ref):
            assert r.dtype == s.dtype and np.array_equal(r, s)


# -- the replay buffer ------------------------------------------------------

@pytest.mark.parametrize("holdout_every", [0, 10])
def test_reservoir_equals_the_reference_bitwise(holdout_every):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((300, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 300)
    mine = ReplayBuffer(capacity=32, seed=9, holdout_every=holdout_every)
    ref = RefBuffer(capacity=32, seed=9, holdout_every=holdout_every)
    for i in range(300):
        # one-row and three-row requests, a scalar label for the latter
        n = 1 if i % 3 else 3
        got = mine.add(rows[i:i + n], labels[i])
        assert got == ref.add(rows[i:i + n], labels[i])
    _buffers_equal(mine, ref)
    assert mine.train_rows == 32 and mine.nbytes == ref.nbytes
    assert (mine.holdout_rows > 0) == (holdout_every > 0)
    for seed in (5, 6):
        x1, l1 = mine.sample(16, np.random.default_rng(seed))
        x2, l2 = ref.sample(16, np.random.default_rng(seed))
        assert np.array_equal(x1, x2) and np.array_equal(l1, l2)
    for limit in (None, 5):
        h1, k1 = mine.holdout(limit)
        h2, k2 = ref.holdout(limit)
        assert np.array_equal(h1, h2) and np.array_equal(k1, k2)
    with pytest.raises(ValueError):
        mine.add(rows[:2], [0, 1, 2])


def test_uint8_codec_round_trip_and_verdict_equal_the_reference():
    src = np.random.default_rng(0).integers(0, 256, (40, 8),
                                            dtype=np.uint8)
    scale, bias = 1.0 / 255.0, -0.5
    rows = RefDequant(scale, bias).apply_host(src)  # what clients send
    assert np.array_equal(rows, AffineDequant(scale, bias).apply_host(src))
    noise = np.random.default_rng(1).standard_normal((4, 8)) \
        .astype(np.float32)
    out = {}
    for name, cls, dq in (("port", ReplayBuffer, AffineDequant),
                          ("ref", RefBuffer, RefDequant)):
        bq = cls(64, seed=1, holdout_every=0, dequant=dq(scale, bias))
        bf = cls(64, seed=1, holdout_every=0, dequant=None)
        bn = cls(16, seed=1, holdout_every=0, dequant=dq(scale, bias))
        for i in range(40):
            bq.add(rows[i][None], 0)
            bf.add(rows[i][None], 0)
        bn.add(noise, np.zeros(4))
        out[name] = (bq, bf, bn)
    (bq, bf, bn), (rq, rf, rn) = out["port"], out["ref"]
    assert (bq.quantized, bf.quantized, bn.quantized) == \
        (rq.quantized, rf.quantized, rn.quantized) == (True, False, False)
    assert bq.nbytes * 4 == bf.nbytes == rq.nbytes * 4
    assert bq._rows[0].dtype == np.uint8
    _buffers_equal(bq, rq)
    xq, _ = bq.sample(16, np.random.default_rng(2))
    xf, _ = bf.sample(16, np.random.default_rng(2))
    xr, _ = rq.sample(16, np.random.default_rng(2))
    assert np.array_equal(xq, xf) and np.array_equal(xq, xr)
    x, _ = bn.sample(4, np.random.default_rng(0))
    assert x.dtype == np.float32


# -- the tap --------------------------------------------------------------

def test_tap_admits_and_joins_as_the_reference_does():
    from veles_tpu import telemetry as ref_telemetry
    from veles_tpu_torch import telemetry
    telemetry.reset()
    rng = np.random.default_rng(7)
    taps = {"port": TrafficTap(0.6), "ref": RefTap(0.6)}
    bufs = {"port": ReplayBuffer(64, seed=2, holdout_every=4),
            "ref": RefBuffer(64, seed=2, holdout_every=4)}
    for k in taps:
        taps[k].arm("m", bufs[k])
    joins = {k: [] for k in taps}
    for jid in range(1500):
        rows = rng.standard_normal((1 + jid % 2, 3)).astype(np.float32)
        label = int(rng.integers(0, 3)) if jid % 3 else None
        for k, tap in taps.items():
            tap.tap("m", jid, rows, label)
            tap.tap("unarmed", jid, rows, label)   # never buffered
        if jid % 5 == 0:
            # late labels: some for parked ids, some for evicted or
            # never-tapped ones (orphans)
            late = jid - int(rng.integers(0, 300))
            for k, tap in taps.items():
                joins[k].append(tap.label_for(late, [1]))
    assert joins["port"] == joins["ref"] and True in joins["port"] \
        and False in joins["port"]
    # the stream parked more than the cap: the oldest were evicted
    assert taps["port"].pending_count() == taps["ref"].pending_count()
    assert PENDING_CAP - 10 < taps["port"].pending_count() <= PENDING_CAP
    # the online.* counters, the reference's and the port's alike
    counts = {n: (telemetry.counter(n).value,
                  ref_telemetry.counter(n).value)
              for n in ("online.tapped_rows", "online.labeled_rows",
                        "online.label_orphans")}
    assert all(p == r for p, r in counts.values()), counts
    assert counts["online.label_orphans"][0] == joins["port"].count(False)
    assert taps["port"].lineage_sample("m") == []
    _buffers_equal(bufs["port"], bufs["ref"])
    assert counts["online.labeled_rows"][0] > bufs["port"].capacity


# -- the gate ----------------------------------------------------------------

class _Engine:
    def __init__(self):
        self.hooks = []

    def notify_next_dispatch(self, cb):
        self.hooks.append(cb)


class _Residency:
    def __init__(self):
        self.engine, self.swapped = _Engine(), []

    def swap_params(self, name, params):
        self.swapped.append(params)
        return self.engine


def test_gate_verdicts_and_cooldown_equal_the_reference():
    rounds = [(20.0, 21.0), (10.0, 30.0), (50.0, 20.0), (30.0, 29.5),
              (40.0, 20.0), (18.0, 20.0), (10.0, 40.0), (25.0, 24.0)]
    rows = {}
    for name, cls in (("port", PromotionGate), ("ref", RefGate)):
        res = _Residency()
        gate = cls("m", res, margin=1.0, min_steps=2)
        gate.last_step_ts = 0.0
        seq, steps, it = [], 0, iter(rounds)
        while steps < 80:
            steps += 1
            if not gate.due(steps):
                continue
            try:
                shadow, incumbent = next(it)
            except StopIteration:
                break
            verdict = gate.decide(steps, shadow, incumbent)
            if verdict == "promote":
                gate.promote({"tree": steps}, steps)
            elif verdict == "rollback":
                gate.rollback(steps)
            assert gate.state in GATE_STATES
            seq.append((steps, verdict, gate.state,
                        gate.promotions, gate.rollbacks,
                        gate.cooldown_until_step, gate.last_gate_step))
        for cb in res.engine.hooks:
            cb()
        rows[name] = (seq, len(res.swapped), gate.time_to_serve_ms)
    assert rows["port"][:2] == rows["ref"][:2]
    seq = rows["port"][0]
    verdicts = [r[1] for r in seq]
    assert {"promote", "rollback", "continue"} <= set(verdicts)
    # after a verdict that moved params the gate rests 4 rounds
    for a, b in zip(seq, seq[1:]):
        if a[1] != "continue":
            assert b[0] >= a[0] + 4 * 2
    assert rows["port"][2] is not None and rows["port"][2] >= 0.0
    assert GATE_STATES == ("filling", "training", "promoted",
                           "rolled_back")


# -- the shadow trainer --------------------------------------------------

SHAPE = (8, 8, 3)
N_CLASSES = 3
MB = 8

LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 3, "ky": 3,
                                 "padding": 1},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9,
            "weight_decay": 0.001}},
    {"type": "norm", "->": {"alpha": 1e-2, "beta": 0.75, "n": 5,
                            "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2, "sliding": 2}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "dropout", "->": {"dropout_ratio": 0.0}},
    {"type": "softmax", "->": {"output_sample_shape": N_CLASSES},
     "<-": {"learning_rate": 0.05}},
]


def _data():
    return synthetic_classification(48, 24, SHAPE, n_classes=N_CLASSES,
                                    seed=5)


def _members(forwards, n=3, seed=11):
    """Reference-layout members: each forward's shapes, gaussian at
    1/sqrt(fan-in), from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = {}
        for f in forwards:
            shapes = f.reference_param_shapes(f.input_shape)
            m[f.name] = {pn: (rng.standard_normal(s) / np.sqrt(
                max(int(np.prod(s[:-1])), 1))).astype(np.float32)
                for pn, s in shapes.items()}
        out.append(m)
    return out


def _port_workflow(layers=LAYERS):
    train, valid, _ = _data()
    w = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(
            wf, train=train, valid=valid, minibatch_size=16,
            name="loader"),
        layers=layers, name="online_wf")
    w.initialize(device=CPU)
    return w


def _ref_workflow(layers=LAYERS):
    train, valid, _ = _data()
    w = RefWorkflow(
        loader_factory=lambda wf: RefArrayLoader(
            wf, train=train, valid=valid, minibatch_size=16,
            name="loader"),
        layers=layers, decision_config={"max_epochs": 1},
        name="online_wf")
    device = JaxDevice(platform="cpu")
    w.initialize(device=device)
    return w, device


def _port_trainer(w, members, seed=77, lr_scale=1.0):
    stacked = batching.stack_member_params(
        w.forwards, [params_from_jax(m) for m in members], CPU)
    return ShadowTrainer(w.forwards, w.gds, w.evaluator, CPU, stacked,
                         seed=seed, lr_scale=lr_scale, micro_batch=MB)


def _to_ref_layout(tree, n):
    per = [params_to_jax({fn: {pn: t[i].numpy() for pn, t in ps.items()}
                          for fn, ps in tree.items()}) for i in range(n)]
    return {fn: {pn: np.stack([p[fn][pn] for p in per])
                 for pn in per[0][fn]} for fn in per[0]}


@pytest.fixture(scope="module")
def pair():
    prng.seed_all(1234)
    w = _port_workflow()
    rw, rdev = _ref_workflow()
    assert [f.name for f in w.forwards] == [f.name for f in rw.forwards]
    members = _members(w.forwards)
    return w, rw, rdev, members


def test_shadow_steps_equal_the_reference(pair):
    w, rw, rdev, members = pair
    (xs, ys), (vx, vy), _ = _data()
    mine = _port_trainer(w, members)
    ref = RefTrainer(rw.forwards, rw.gds, rw.evaluator, rdev,
                     ref_batching.stack_member_params(
                         rw.forwards, members, rdev),
                     seed=77, lr_scale=1.0, micro_batch=MB)
    incumbent = batching.stack_member_params(
        w.forwards, [params_from_jax(m) for m in members], CPU)
    ref_incumbent = ref_batching.stack_member_params(rw.forwards, members,
                                                     rdev)
    drift = (ys + 1) % N_CLASSES
    for k in range(6):
        idx = mine.sample_rng().integers(0, len(xs), MB)
        got = mine.step(xs[idx], drift[idx], k)
        want = np.asarray(ref.step(xs[idx], drift[idx], k))
        assert got.shape == (3, 3)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])   # n_err
        np.testing.assert_array_equal(got[:, 2], want[:, 2])   # count
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5)
    assert mine.history == ref.history and mine.steps == ref.steps == 6
    got = _to_ref_layout(mine._params, 3)
    for fn, ps in ref._params.items():
        for pn, a in ps.items():
            np.testing.assert_allclose(got[fn][pn], np.asarray(a),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{fn}.{pn}")
    # the momentum buffers the steps left behind
    for gd in w.gds:
        if gd.gradient_moment:
            assert set(mine._opt[gd.name]) == {"weights", "bias"}
    # held-out error % of shadow and incumbent, on the drifted truth
    vdrift = (vy + 1) % N_CLASSES
    for params, ref_params in ((mine._params, ref._params),
                               (incumbent, ref_incumbent)):
        assert mine.error_pct(params, vx, vdrift) == \
            ref.error_pct(ref_params, vx, vdrift)
    # an abort before the first chunk defers the round
    assert mine.error_pct(incumbent, vx, vdrift, abort=lambda: True) \
        is None


def test_offline_replay_is_exact_in_f32(pair):
    """Adds and steps interleaved online, then the same adds replayed
    against the recorded (step, buffer version) history: the params are
    bitwise the same, dropout included."""
    w = _port_workflow([dict(c, **({"->": {"dropout_ratio": 0.5}}
                                   if c["type"] == "dropout" else {}))
                        for c in LAYERS])
    members = pair[3]
    (xs, ys), _, _ = _data()
    adds = [(xs[i % len(xs)][None], (ys[i % len(ys)] + 1) % N_CLASSES)
            for i in range(120)]

    def make():
        return ReplayBuffer(64, seed=77, holdout_every=8), \
            _port_trainer(w, members)

    buf1, t1 = make()
    for i, (rows, lab) in enumerate(adds):
        buf1.add(rows, lab)
        if buf1.train_rows >= MB and i % 7 == 3:
            x, lb = buf1.sample(MB, t1.sample_rng())
            t1.step(x, lb, buf1.version)
    assert t1.steps >= 10
    def replay(trainer):
        buf, it = ReplayBuffer(64, seed=77, holdout_every=8), iter(adds)
        for step, version in t1.history:
            while buf.version < version:
                buf.add(*next(it))
            x, lb = buf.sample(MB, trainer.sample_rng(step))
            trainer.step(x, lb, version)
        return trainer

    t2 = replay(make()[1])
    for fn, ps in t1._params.items():
        for pn, a in ps.items():
            assert torch.equal(a, t2._params[fn][pn]), f"{fn}.{pn}"
    # the dropout draws shaped the trajectory: without them it differs
    t3 = replay(_port_trainer(_port_workflow(), members))
    assert any(not torch.equal(a, t3._params[fn][pn])
               for fn, ps in t1._params.items() for pn, a in ps.items())


def test_promoted_tree_is_never_changed_by_later_steps(pair):
    w, _, _, members = pair
    (xs, ys), _, _ = _data()
    t = _port_trainer(w, members)
    for k in range(2):
        t.step(xs[k * MB:(k + 1) * MB], ys[k * MB:(k + 1) * MB], k)
    promoted = t.take_params()
    frozen = {fn: {pn: a.clone() for pn, a in ps.items()}
              for fn, ps in promoted.items()}
    before = {fn: {pn: a.clone() for pn, a in ps.items()}
              for fn, ps in t._params.items()}
    for k in range(2, 4):
        t.step(xs[k * MB:(k + 1) * MB], ys[k * MB:(k + 1) * MB], k)
    moved = False
    for fn, ps in promoted.items():
        for pn, a in ps.items():
            assert torch.equal(a, frozen[fn][pn]), f"{fn}.{pn}"
            assert a.data_ptr() != t._params[fn][pn].data_ptr()
            moved |= not torch.equal(t._params[fn][pn], before[fn][pn])
    assert moved
    # the host copies are the shadow's current params, member by member
    host = t.host_members()
    assert len(host) == 3
    for fn, ps in t._params.items():
        for pn, a in ps.items():
            for i in range(3):
                np.testing.assert_array_equal(host[i][fn][pn],
                                              a[i].numpy())
    # a rollback restarts from a copy of the given tree, momentum zero
    t.reset_from(promoted)
    for fn, ps in t._params.items():
        for pn, a in ps.items():
            assert torch.equal(a, promoted[fn][pn])
            assert a.data_ptr() != promoted[fn][pn].data_ptr()
    assert all(not v.any() for ps in t._opt.values() for v in ps.values())
    with pytest.raises(ValueError, match="fixed shape"):
        t.step(xs[:MB - 1], ys[:MB - 1], 0)
