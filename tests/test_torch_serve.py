"""The port's serving path against the JAX package's.

Twin Forge packages share one members npz (the reference's layout) and
one config file (an AlexNet-shaped net at narrow widths and a 67x67x3
input); their entries differ only in the framework they build:
``veles_tpu.models.alexnet`` or ``veles_tpu_torch.models.alexnet``.  The
port's ``EnsembleEvalEngine`` on the CPU and the reference's on XLA:CPU
must give the same mean probabilities in f32 (atol 1e-5).  Then the
port's micro-batcher, its residency manager, and one round trip through
``python -m veles_tpu_torch --serve-models ... -b cpu``.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
SHAPE = (67, 67, 3)
N_CLASSES = 5

#: AlexNet's layer kinds and order at narrow widths
TINY_LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 11, "ky": 11,
                                 "sliding": 4}},
    {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                            "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 12, "kx": 5, "ky": 5,
                                 "padding": 2}},
    {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                            "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 16}},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "softmax", "->": {"output_sample_shape": N_CLASSES}},
]

CONFIG = textwrap.dedent(f"""
    root.alexnet.layers = {TINY_LAYERS!r}
    root.alexnet.n_classes = {N_CLASSES}
    root.alexnet.loader.shape = {SHAPE!r}
    root.alexnet.loader.n_classes = {N_CLASSES}
    root.alexnet.loader.n_train = 32
    root.alexnet.loader.n_valid = 16
    root.alexnet.loader.minibatch_size = 16
""")

#: (fwd name, reference-layout weight shape); gains keep every layer's
#: output of order one to ten, so LRN's denominator moves and the
#: softmax is far from uniform
PARAM_SHAPES = [
    ("fwd0_conv_relu", (11, 11, 3, 8), 1.0),
    ("fwd3_conv_relu", (5, 5, 8, 12), 1.0),
    ("fwd6_all2all_relu", (3 * 3 * 12, 16), 1.0),
    ("fwd8_softmax", (16, N_CLASSES), 0.3),
]
FORWARD_NAMES = [f"fwd{i}_{c['type']}" for i, c in enumerate(TINY_LAYERS)]


def _members(n_members=2, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_members):
        params = {}
        for name, shape, gain in PARAM_SHAPES:
            fan_in = int(np.prod(shape[:-1]))
            params[name] = {
                "weights": (rng.standard_normal(shape) * gain
                            / np.sqrt(fan_in)).astype(np.float32),
                "bias": (rng.standard_normal(shape[-1]) * 0.1
                         ).astype(np.float32)}
        out.append({"params": params, "seed": seed + i,
                    "valid_error": 0.0, "forward_names": FORWARD_NAMES})
    return out


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + SHAPE) * 50.0).astype(np.float32)


def _pack(d, name, framework, members):
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    sub = os.path.join(d, name)
    os.makedirs(sub)
    entry = os.path.join(sub, "entry.py")
    with open(entry, "w") as f:
        f.write(f"from {framework}.models.alexnet import "
                f"create_workflow  # noqa: F401\n")
    cfg = os.path.join(sub, "tiny_config.py")
    with open(cfg, "w") as f:
        f.write(CONFIG)
    return pack_ensemble(os.path.join(d, f"{name}.vpkg"), name, members,
                         entry, config_files=[cfg])


def _port_model(pkg, install_dir, name="tiny"):
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.serve.hive import load_model_package
    saved = dict(root.__dict__)
    try:
        return load_model_package(name, pkg, make_device("cpu"),
                                  install_dir, {})
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("twins"))
    members = _members()
    pkgs = {"jax": _pack(d, "tiny_jax", "veles_tpu", members),
            "port": _pack(d, "tiny_port", "veles_tpu_torch", members)}
    # the shared npz round-trips unchanged through the port's packaging
    from veles_tpu.ensemble.packaging import load_members as jax_load
    from veles_tpu.forge import ForgePackage as JaxForge
    man = JaxForge.install(pkgs["port"], os.path.join(d, "check"))
    back = jax_load(os.path.join(man["root"], man["snapshot"]))
    for m, b in zip(members, back):
        for fn, p in m["params"].items():
            for pn, a in p.items():
                np.testing.assert_array_equal(b["params"][fn][pn], a)

    # the reference engine on XLA:CPU, f32
    from veles_tpu.backends import JaxDevice
    from veles_tpu.ops.fused import EnsembleEvalEngine as JaxEngine
    from veles_tpu.serve.hive import load_model_package
    model = load_model_package("tiny", pkgs["jax"],
                               JaxDevice(platform="cpu"),
                               os.path.join(d, "jax_install"), {})
    ref = JaxEngine(model.forwards, model.member_params, model_device(
        model))
    x = _rows(7, seed=1)
    want = ref.predict_proba(x)
    rt = _rows(3 * 4, seed=2)
    want_rt = ref.predict_proba(rt)
    ref.release()
    return {"dir": d, "pkgs": pkgs, "x": x, "want": want, "rt": rt,
            "want_rt": want_rt}


def model_device(model):
    return model.meta["workflow"].device


def test_port_engine_matches_reference_engine(twins):
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    model = _port_model(twins["pkgs"]["port"],
                        os.path.join(twins["dir"], "port_install"))
    engine = EnsembleEvalEngine(model.forwards, model.member_params,
                                model.meta["workflow"].device)
    assert engine.compute_dtype == torch.float32 and engine.n_members == 2
    got = engine.predict_proba(twins["x"])
    engine.release()
    want = twins["want"]
    assert got.shape == (7, N_CLASSES) and got.dtype == np.float32
    # a net that actually discriminates, so the comparison means much
    assert want.max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_unconverted_params_fail_at_load(twins):
    """Members left in the reference's layout (conv weights HWIO) do not
    match the port's chain: the engine refuses them at load."""
    from veles_tpu_torch.ensemble.packaging import load_members
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    model = _port_model(twins["pkgs"]["port"],
                        os.path.join(twins["dir"], "port_install2"))
    raw = load_members(os.path.join(
        twins["dir"], "port_install2", "tiny_port-1.0.0",
        "tiny_port_members.npz"))
    with pytest.raises(ValueError, match="fwd0_conv_relu"):
        EnsembleEvalEngine(model.forwards, [m["params"] for m in raw],
                           model.meta["workflow"].device)


class TestMicroBatcher:
    def _batcher(self, dispatch, **kw):
        from veles_tpu_torch.serve.batcher import MicroBatcher
        kw.setdefault("max_batch", 8)
        kw.setdefault("max_wait_s", 0.05)
        return MicroBatcher(dispatch, **kw)

    def test_concurrent_requests_coalesce_into_one_padded_dispatch(self):
        sizes = []

        def dispatch(xb):
            sizes.append(len(xb))
            return xb * 2.0

        b = self._batcher(dispatch, max_batch=16, max_wait_s=0.25)
        futs = []
        threads = [threading.Thread(target=lambda i=i: futs.append(
            (i, b.submit(np.full((2, 4), i, np.float32)))))
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5)
        for i, f in futs:
            np.testing.assert_array_equal(f.result(timeout=5),
                                          np.full((2, 4), 2.0 * i))
        assert sizes == [16]
        assert (b.dispatches, b.rows, b.max_rows) == (1, 8, 8)
        b.close()

    def test_oversized_request_splits_across_dispatches(self):
        sizes = []

        def dispatch(xb):
            sizes.append(len(xb))
            return xb + 1.0

        b = self._batcher(dispatch, max_batch=4, max_wait_s=0.01)
        rows = np.arange(10, dtype=np.float32).reshape(10, 1)
        np.testing.assert_array_equal(b.submit(rows).result(timeout=5),
                                      rows + 1.0)
        assert sizes == [4, 4, 4]
        b.close()

    def test_expired_request_never_dispatches(self):
        from veles_tpu_torch.serve.batcher import DeadlineExpired
        seen = []

        def dispatch(xb):
            seen.append(xb[0, 0])
            return xb

        b = self._batcher(dispatch, max_batch=4, max_wait_s=0.1)
        dead = b.submit(np.full((1, 2), 7.0, np.float32),
                        deadline_ms=time.time() * 1000.0 - 50.0)
        with pytest.raises(DeadlineExpired):
            dead.result(timeout=5)
        ok = b.submit(np.ones((1, 2), np.float32),
                      deadline_ms=time.time() * 1000.0 + 30000.0)
        assert ok.result(timeout=5).shape == (1, 2)
        assert 7.0 not in seen
        b.close()

    def test_failed_dispatch_fails_only_its_batch(self):
        calls = {"n": 0}

        def dispatch(xb):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("boom")
            return xb

        b = self._batcher(dispatch, max_batch=4, max_wait_s=0.01)
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(np.ones((1, 2), np.float32)).result(timeout=5)
        assert b.submit(np.ones((1, 2), np.float32)).result(
            timeout=5).shape == (1, 2)
        with pytest.raises(ValueError):
            b.submit(np.ones((1, 3), np.float32))   # sample shape pinned
        assert b.drain(timeout=5)
        b.close()


def test_residency_spills_the_lru_model_and_restores_it(twins):
    from veles_tpu_torch.serve.residency import ResidencyManager
    a = _port_model(twins["pkgs"]["port"],
                    os.path.join(twins["dir"], "res_a"), name="a")
    b = _port_model(twins["pkgs"]["port"],
                    os.path.join(twins["dir"], "res_b"), name="b")
    dev = a.meta["workflow"].device
    mgr = ResidencyManager(dev, budget_bytes=a.param_bytes + 1024,
                           max_batch=8, max_wait_s=0.01)
    mgr.register(a)
    mgr.register(b)
    with pytest.raises(ValueError):
        mgr.register(a)
    ea = mgr.ensure("a")
    assert a.resident and not b.resident
    mgr.ensure("b")
    assert b.resident and not a.resident and mgr.spills == 1
    # a request to the spilled model restores it (and spills b)
    probs = mgr.ensure("a").submit(twins["x"][:2]).result(timeout=30)
    assert mgr.ensure("a") is ea and a.resident and not b.resident
    np.testing.assert_allclose(probs, twins["want"][:2], atol=ATOL)
    assert mgr.drain_all(timeout=10)
    mgr.close()


def test_out_of_slice_flags_are_rejected():
    from veles_tpu_torch.serve.hive import build_parser
    for flag in (["--online"], ["--mesh", "2"], ["--metrics-dir", "m"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["m=p.vpkg"] + flag)


def test_hive_subprocess_round_trip(twins):
    """One ``--serve-models`` process on the CPU: three concurrent
    requests answered with the right rows and crc, matching the
    reference engine; stats count them; shutdown exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--serve-models",
         f"tiny={twins['pkgs']['port']}", "-b", "cpu", "--max-batch",
         "16", "--max-wait-ms", "200", "--heartbeat-every", "0",
         "--install-dir", os.path.join(twins["dir"], "hive")],
        cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        hello = json.loads(proc.stdout.readline())
        assert hello["ready"] and hello["platform"] == "cpu"
        assert hello["models"]["tiny"] == {
            "members": 2, "param_bytes": hello["models"]["tiny"][
                "param_bytes"], "resident": True, "sharded": False,
            "version": "1.0.0"}
        rt = twins["rt"]
        for i in range(3):
            proc.stdin.write(json.dumps(
                {"id": i, "model": "tiny",
                 "rows": rt[4 * i:4 * i + 1 + i].tolist()}) + "\n")
        proc.stdin.flush()
        answers = {}
        while len(answers) < 3:
            msg = json.loads(proc.stdout.readline())
            answers[msg["id"]] = msg
        for i, a in answers.items():
            probs = np.asarray(a["probs"], np.float32)
            assert a["model"] == "tiny" and a["rows_n"] == 1 + i
            assert a["crc"] == zlib.crc32(probs.tobytes())
            assert a["pred"] == np.argmax(probs, -1).tolist()
            np.testing.assert_allclose(
                probs, twins["want_rt"][4 * i:4 * i + 1 + i], atol=ATOL)
        proc.stdin.write(json.dumps({"op": "stats", "id": "s"}) + "\n")
        proc.stdin.flush()
        stats = json.loads(proc.stdout.readline())["stats"]
        assert stats["requests"] == 3 and stats["rows"] == 6
        assert 1 <= stats["dispatches"] <= 3
        assert stats["kernel_launches"] == {"lrn_fwd": 0}   # CPU: plain
        proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
