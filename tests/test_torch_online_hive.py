"""``python -m veles_tpu_torch --serve-models NAME=PKG --online -b cpu``
through the port's ``HiveClient``, after the reference's
``TestHiveOnline`` and ``TestHiveOnlinePoison`` (``tests/test_online.py``):

- the package's seed reaches ``meta["seed"]`` and seeds every stream,
  as in the reference's hive;
- the hello says ``"online": true``; ``learner_ctl`` suspends and
  resumes (no step while suspended);
- drifted labels (the truth rotated one class, so the frozen ensemble
  is consistently wrong) are learned and promoted: the promoting round's
  shadow error beats the incumbent's by the margin, the answers after it
  beat the frozen ensemble on the drifted truth, ``time_to_serve_ms`` is
  recorded, and the ``op=learn`` row carries exactly the reference
  learner's keys;
- a late ``label_of`` joins its request by wire id; a label for an
  unknown id counts as an orphan;
- a poisoned stream never promotes: every request that lands in the
  training partition carries a wrong label, sent on the wire, while the
  held-out ones carry the labels the packaged ensemble itself answers.
  Then the process is killed: a waiter fails with ``ReplicaDied`` at
  once;
- the reference's own drill: clean labels on the wire and
  ``online.poison_batch@slot=train&times=*`` armed through
  ``$VELES_FAULTS``, so the tap corrupts exactly the training slot's
  labels: never promoted either, and the hive's ``--metrics-dir``, read
  with the reference's ``veles_tpu/obs.py``, holds the learner's
  counters, its gate rounds and no promotion.
"""

import os
import textwrap
import time

import numpy as np
import pytest

from tests.test_serve import _build_package, _host_oracle
from veles_tpu_torch.serve.client import ReplicaDied

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference test's workflow (``tests/test_serve.py`` WF_TEXT) in
#: the port
PORT_WF = textwrap.dedent("""
    from veles_tpu_torch import prng
    from veles_tpu_torch.datasets import synthetic_classification
    from veles_tpu_torch.loader.fullbatch import ArrayLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

    def create_workflow(launcher):
        prng.seed_all(4242)
        train, valid, _ = synthetic_classification(
            64, 16, (6, 6, 1), n_classes=3, seed=5)
        return StandardWorkflow(
            loader_factory=lambda w: ArrayLoader(
                w, train=train, valid=valid, minibatch_size=16,
                name="loader"),
            layers=[
                {"type": "all2all_tanh",
                 "->": {"output_sample_shape": 12},
                 "<-": {"learning_rate": 0.1}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.1}},
            ],
            decision_config={"max_epochs": 2}, name="hive_wf")
""")

#: the reference test's learner settings (``tests/test_online.py``)
LEARN_ENV = {
    "VELES_ONLINE_MICRO_BATCH": "8",
    "VELES_ONLINE_MIN_STEPS": "4",
    "VELES_ONLINE_LR_SCALE": "1.0",
    "VELES_ONLINE_PROMOTE_MARGIN": "5.0",
    "VELES_ONLINE_HOLDOUT_EVERY": "6",
    "VELES_ONLINE_IDLE_MS": "1",
}


def _drifted(label, n_classes=3):
    return (int(label) + 1) % n_classes


@pytest.fixture(scope="module")
def online_pkg(tmp_path_factory):
    """The reference test's package (members drawn from the reference's
    workflow, seed 11) and its twin with the port's entry."""
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    d = str(tmp_path_factory.mktemp("online_pkgs"))
    pkg = _build_package(d, "alpha", 11)
    wf = os.path.join(d, "wf_port.py")
    with open(wf, "w") as f:
        f.write(PORT_WF)
    pkg["port_pkg"] = pack_ensemble(os.path.join(d, "alpha_port.vpkg"),
                                    "alpha", pkg["members"], wf)
    pkg["dir"] = d
    w = pkg["workflow"]
    pkg["xs"] = np.asarray(w.loader.original_data.mem, np.float32)
    pkg["ys"] = np.asarray(w.loader.original_labels.mem)
    return pkg


def _client(pkg, metrics_dir=None, **env):
    from veles_tpu_torch.serve.client import HiveClient
    return HiveClient({"alpha": pkg["port_pkg"]}, backend="cpu",
                      max_batch=8, max_wait_ms=2, heartbeat_every=0,
                      online=True, env=dict(LEARN_ENV, **env), cwd=REPO,
                      metrics_dir=metrics_dir)


@pytest.fixture(scope="module")
def served(online_pkg):
    c = _client(online_pkg)
    yield c
    c.close()


def test_the_hive_seeds_from_the_package_as_the_reference_does(
        online_pkg):
    from veles_tpu.backends import JaxDevice
    from veles_tpu.config import root as ref_root
    from veles_tpu.serve.hive import load_model_package as ref_load
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    from veles_tpu_torch.serve.hive import load_model_package
    d = online_pkg["dir"]
    # the port's entry without its own seed_all, noting the base seed
    # its workflow was built under
    wf = os.path.join(d, "wf_seen.py")
    with open(wf, "w") as f:
        f.write(PORT_WF.replace(
            "    prng.seed_all(4242)\n", "    seen = prng._default_seed\n")
            .replace("    return StandardWorkflow(",
                     "    w = StandardWorkflow(")
            + "    w.seen_seed = seen\n    return w\n")
    pkg = pack_ensemble(os.path.join(d, "alpha_seen.vpkg"), "alpha",
                        online_pkg["members"], wf)
    saved, ref_saved = dict(root.__dict__), dict(ref_root.__dict__)
    try:
        ref = ref_load("alpha", os.path.join(d, "alpha.vpkg"),
                       JaxDevice(platform="cpu"),
                       os.path.join(d, "ref_install"), {})
        prng.seed_all(1)
        mine = load_model_package("alpha", pkg, make_device("cpu"),
                                  os.path.join(d, "port_install"), {})
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)
        ref_root.__dict__.clear()
        ref_root.__dict__.update(ref_saved)
    assert mine.meta["seed"] == ref.meta["seed"] == 11
    assert mine.meta["workflow"].seen_seed == 11
    assert mine.meta["package"] == "alpha_seen.vpkg"
    assert ref.meta["package"] == "alpha.vpkg"


def _reference_learn_keys():
    """The keys of the reference learner's op=learn row, from a reference
    learner armed on the reference test's in-process model."""
    from tests.test_online import _tiny_served_model
    from veles_tpu.online.trainer import OnlineLearner
    res, _, _, _ = _tiny_served_model()
    learner = OnlineLearner(res, environ={})
    assert learner.arm_model("alpha")
    return set(learner.status()["alpha"])


def test_drift_is_learned_and_promoted(served, online_pkg):
    xs, ys = online_pkg["xs"], online_pkg["ys"]
    payloads = [(xs[i % len(xs)][None], [_drifted(ys[i % len(ys)])])
                for i in range(96)]
    deadline = time.monotonic() + 40
    i, row = 0, None
    while time.monotonic() < deadline:
        for _ in range(8):
            x, lab = payloads[i % len(payloads)]
            i += 1
            r = served.request("alpha", x, label=lab)
            assert "error" not in r, r
        row = served.learn().get("alpha")
        # learn on until the serving params (the incumbent of the later
        # rounds) are good on the drifted truth
        if row and row["promotions"] >= 1 and \
                row["incumbent_error_pct"] is not None and \
                row["incumbent_error_pct"] <= 40.0:
            break
        time.sleep(0.05)
    assert row and row["promotions"] >= 1, row
    assert set(row) == _reference_learn_keys()
    first = served.stats()["online"]["last_promotion"]["alpha"]
    assert first["shadow_error_pct"] <= \
        first["incumbent_error_pct"] - 5.0, first
    assert first["swap_ms"] >= 0.0
    right = wrong_frozen = 0
    for x, lab in payloads[:24]:
        r = served.request("alpha", x)
        assert "pred" in r, r
        right += r["pred"][0] == lab[0]
        wrong_frozen += int(np.argmax(_host_oracle(online_pkg, x),
                                      axis=-1)[0]) != lab[0]
    assert right > 24 - wrong_frozen, (right, wrong_frozen)
    row = served.learn()["alpha"]
    assert row["time_to_serve_ms"] is not None
    assert row["time_to_serve_ms"] >= 0.0
    st = served.stats()
    assert st["online"]["gate_rounds"] >= 1
    assert st["kernel_launches"] == {"lrn_fwd": 0, "lrn_bwd": 0}
    assert st["ledger"]["train"] > 0 and st["ledger"]["scratch"] > 0


def test_learner_ctl_suspends_and_resumes(served, online_pkg):
    assert served.hello["online"] is True
    assert served.learner_ctl(suspend=True) == {"online": True,
                                                "suspended": True}
    time.sleep(0.2)   # a step already under way finishes
    steps = served.stats()["online"]["steps"]
    xs, ys = online_pkg["xs"], online_pkg["ys"]
    for j in range(24):
        r = served.request("alpha", xs[j][None], label=[_drifted(ys[j])])
        assert "error" not in r, r
    time.sleep(0.2)
    st = served.stats()["online"]
    assert st["steps"] == steps and st["suspended"] is True
    assert st["labeled_rows"] >= 24
    assert served.learner_ctl(suspend=False) == {"online": True,
                                                 "suspended": False}


def test_late_label_joins_by_wire_id(served, online_pkg):
    xs, ys = online_pkg["xs"], online_pkg["ys"]
    before = served.stats()["online"]
    jid = served.submit("alpha", xs[:2])
    assert "probs" in served.wait_for(jid, timeout=60)
    served.send_label(jid, [_drifted(y) for y in ys[:2]])
    served.send_label(10 ** 9, [0])   # never tapped: an orphan
    after = served.stats()["online"]
    assert after["labeled_rows"] == before["labeled_rows"] + 2
    assert after["label_orphans"] == before["label_orphans"] + 1
    assert after["tapped_rows"] == before["tapped_rows"] + 2


def test_poisoned_stream_never_promotes(online_pkg):
    """Wrong labels on every training-slot request, the packaged
    ensemble's own answers on the held-out ones (every 6th labeled
    request, ``$VELES_ONLINE_HOLDOUT_EVERY``)."""
    xs = online_pkg["xs"]
    clean = np.argmax(_host_oracle(online_pkg, xs), axis=-1)
    garbage = np.random.default_rng(99).integers(0, 3, 4096)
    c = _client(online_pkg)
    try:
        deadline = time.monotonic() + 40
        i, row = 0, None
        while time.monotonic() < deadline:
            for _ in range(8):
                j = i % len(xs)
                i += 1
                lab = clean[j] if i % 6 == 0 else (
                    clean[j] + 1 + garbage[i % 4096] % 2) % 3
                r = c.request("alpha", xs[j][None], label=[int(lab)])
                assert "error" not in r, r
            row = c.learn().get("alpha")
            if row and row["steps"] >= 12 and \
                    row["shadow_error_pct"] is not None:
                break
            time.sleep(0.05)
        assert row and row["steps"] >= 12, row
        assert row["shadow_error_pct"] is not None, row
        assert row["promotions"] == 0, \
            f"poisoned labels were promoted: {row}"
        # the process gone, a waiter fails at once, not at its timeout
        c.proc.kill()
        t0 = time.monotonic()
        with pytest.raises(ReplicaDied):
            c.request("alpha", xs[:1], timeout=60)
        assert time.monotonic() - t0 < 30
    finally:
        c.close()


def test_poison_batch_fault_never_promotes(online_pkg, tmp_path):
    """Clean labels (the packaged ensemble's own answers) on every
    request, the training slot's corrupted by the armed fault."""
    from veles_tpu import obs
    xs = online_pkg["xs"]
    clean = np.argmax(_host_oracle(online_pkg, xs), axis=-1)
    mdir = str(tmp_path / "m")
    c = _client(online_pkg, metrics_dir=mdir,
                VELES_FAULTS="online.poison_batch@slot=train&times=*")
    try:
        deadline = time.monotonic() + 40
        i, row = 0, None
        while time.monotonic() < deadline:
            for _ in range(8):
                j = i % len(xs)
                i += 1
                r = c.request("alpha", xs[j][None], label=[int(clean[j])])
                assert "error" not in r, r
            row = c.learn().get("alpha")
            if row and row["steps"] >= 12 and \
                    row["shadow_error_pct"] is not None:
                break
            time.sleep(0.05)
        assert row and row["steps"] >= 12, row
        assert row["promotions"] == 0, \
            f"poisoned labels were promoted: {row}"
    finally:
        c.close()
    reg, snaps, _, evs = obs.load_dir(mdir)
    assert len(snaps) == 1
    assert reg.counters["online.steps"].value >= 12
    assert reg.counters["online.labeled_rows"].value == i
    assert "online.promotions" not in reg.counters
    names = [e["event"] for e in evs]
    assert "online.armed" in names and "online.gate" in names
    assert all(e["verdict"] != "promote" for e in evs
               if e["event"] == "online.gate")
    assert names[-1] == "serve.shutdown"


def test_a_promotion_dumps_the_lineage_of_its_traffic(online_pkg,
                                                      tmp_path):
    """Drift sent with a sampled trace context a request: the promotion
    journals the tap's lineage (trace ids the client minted), records
    ``gate.promote`` with ``lineage_n`` in the flight recorder's ring
    and dumps it (``flightrec-<pid>-<n>-promote.json``), as the
    reference's gate does."""
    import glob
    import json

    from veles_tpu_torch import obs, trace
    xs, ys = online_pkg["xs"], online_pkg["ys"]
    mdir = str(tmp_path / "m")
    c = _client(online_pkg, metrics_dir=mdir)
    minted = set()
    try:
        deadline = time.monotonic() + 40
        i, row = 0, None
        while time.monotonic() < deadline:
            for _ in range(8):
                ctx = trace.mint({"VELES_TRACE_SAMPLE": "1"})
                minted.add(ctx.trace_id)
                j = i % len(xs)
                i += 1
                r = c.request("alpha", xs[j][None],
                              label=[_drifted(ys[j])], ctx=ctx)
                assert "error" not in r, r
            row = c.learn().get("alpha")
            if row and row["promotions"] >= 1:
                break
            time.sleep(0.05)
        assert row and row["promotions"] >= 1, row
    finally:
        c.close()
    dumps = glob.glob(os.path.join(mdir, f"flightrec-{c.pid}-*-"
                                         f"promote.json"))
    assert dumps, os.listdir(mdir)
    ring = json.load(open(sorted(dumps)[0]))["ring"]
    gate = [e for e in ring if e["ev"] == "gate.promote"]
    assert gate and 0 < gate[0]["lineage_n"] <= 32
    # the hive admitted each request under a child of the client's span
    hops = [e for e in ring if e["ev"] == "hive.request"]
    assert hops and {e["trace"] for e in hops} <= minted
    _reg, _snaps, _journals, evs = obs.load_dir(mdir)
    promoted = [e for e in evs if e["event"] == "online.promoted"]
    assert promoted and promoted[0]["lineage"]
    assert len(promoted[0]["lineage"]) == gate[0]["lineage_n"]
    assert set(promoted[0]["lineage"]) <= minted
    serves = [e for e in evs if e["event"] == "trace.serve"]
    assert serves and {e["trace"] for e in serves} <= minted
