"""The port's serving fleet on the CPU, against the reference's test of
it (``tests/test_fleet.py``): a real 2-replica
``FleetRouter(backend="cpu")`` whose replicas are ``--serve-models``
processes of the port, serving the reference test's packaged members
(``_build_package``, seeds 11 and 22) through the port's entry.

- the fleet comes up with the placement the reference's policy gives
  on the same hellos;
- concurrent answers agree with the reference's host oracle
  (``_host_oracle``, the members' forward chain on XLA:CPU) within
  atol 1e-5 in f32, and every answer's crc and row count check;
- requests spread over both replicas; the canary receives its
  deterministic fraction (0.25 of 40, +-0.05, the reference's bar);
- overload sheds with an explicit ``overloaded`` answer at once, by the
  SLO estimate and by the in-flight bound;
- the fleet router reads the replicas' telemetry: the dispatch-cadence
  EMA that admission sheds on is set from ``op=stats``;
- the CLI round trip through ``python -m veles_tpu_torch --serve-fleet``:
  hello, an answer, ``op=fleet``, ``shutdown`` with rc 0; and the
  ``--mesh`` / ``--metrics-dir``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest

from tests.test_fleet import _build_package, _host_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: f32 on both sides: the port's CPU plain path against XLA:CPU
ATOL = 1e-5

#: the reference test's workflow (``tests/test_fleet.py`` WF_TEXT) in the
#: port
PORT_WF = """
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
        decision_config={"max_epochs": 2}, name="fleet_wf")
"""


def port_packages(d, specs):
    """{name: the reference's package dict + "port_pkg", its twin with
    the port's entry} for ``specs`` = {name: seed}."""
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    wf = os.path.join(d, "wf_port.py")
    with open(wf, "w") as f:
        f.write(PORT_WF)
    out = {}
    for name, seed in specs.items():
        pkg = _build_package(d, name, seed)
        pkg["port_pkg"] = pack_ensemble(
            os.path.join(d, f"{name}_port.vpkg"), name, pkg["members"], wf)
        out[name] = pkg
    return out


def check_answer(resp, n_rows):
    """The answer carries probabilities whose crc and row count check."""
    assert "probs" in resp, resp
    probs = np.asarray(resp["probs"], np.float32)
    assert len(probs) == n_rows == resp["rows_n"]
    assert zlib.crc32(probs.tobytes()) == resp["crc"]
    return probs


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_fleet_pkgs"))
    return port_packages(d, {"alpha": 11, "beta": 22})


@pytest.fixture(scope="module")
def router(packages):
    from veles_tpu_torch.serve.router import FleetRouter
    r = FleetRouter({"alpha": packages["alpha"]["port_pkg"],
                     "beta": packages["beta"]["port_pkg"]},
                    n_replicas=2, backend="cpu", max_batch=16,
                    max_wait_ms=5, canaries={"beta": ("alpha", 0.25)},
                    cwd=REPO)
    yield r
    r.close()


def test_fleet_comes_up_with_the_reference_placement(router):
    from veles_tpu.serve.fleet import PlacementPolicy as RefPolicy
    assert len(router.replicas) == 2
    assert all(r.healthy for r in router.replicas)
    assert router.placement == {"alpha": [0, 1], "beta": [0, 1]}
    want = RefPolicy(budget_bytes=None).assign(
        {n: router.hello_models[n]["param_bytes"] for n in router.models},
        2, capacities=[r.capacity_bytes for r in router.replicas])
    assert router.placement == want
    assert router.canaries == {"beta": ("alpha", 0.25)}
    assert all(r.devices == 1 and r.capacity_bytes
               for r in router.replicas)


def test_concurrent_answers_match_the_reference_oracle(router, packages):
    errs = []

    def worker(i):
        try:
            rng = np.random.default_rng(100 + i)
            name = "alpha" if i % 2 == 0 else "beta"
            for _ in range(4):
                x = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
                got = check_answer(router.request(name, x, timeout=60), 2)
                np.testing.assert_allclose(
                    got, _host_oracle(packages[name], x), atol=ATOL)
        except Exception as e:  # noqa: BLE001 — collected below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs


def test_requests_spread_over_both_replicas(router):
    x = np.ones((1, 6, 6, 1), np.float32)
    for _ in range(8):
        check_answer(router.request("alpha", x), 1)
    counts = router.routed_counts()
    assert len(counts) == 2 and all(c > 0 for c in counts), counts


def test_canary_receives_its_traffic_split(router):
    from veles_tpu_torch import telemetry
    x = np.ones((1, 6, 6, 1), np.float32)
    req0 = telemetry.counter("fleet.model.alpha.requests").value
    mir0 = telemetry.counter("fleet.model.beta.mirrored").value
    n = 40
    for _ in range(n):
        check_answer(router.request("alpha", x), 1)
    d_req = telemetry.counter("fleet.model.alpha.requests").value - req0
    d_mir = telemetry.counter("fleet.model.beta.mirrored").value - mir0
    assert d_req == n
    assert abs(d_mir / n - 0.25) <= 0.05, (d_mir, n)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        done = telemetry.histogram("fleet.model.beta.request_seconds") \
            .count + telemetry.counter("fleet.model.beta.errors").value
        if done >= d_mir:
            break
        time.sleep(0.1)
    assert telemetry.histogram(
        "fleet.model.beta.request_seconds").count > 0
    assert telemetry.counter("fleet.model.beta.errors").value == 0


def test_the_router_reads_the_replicas_telemetry(router):
    """The stats the monitor polls carry the reference's keys, and the
    dispatch-cadence EMA admission sheds on is set from them."""
    x = np.ones((1, 6, 6, 1), np.float32)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not all(
            r.ema_cycle_s and r.ema_dispatch_s for r in router.replicas):
        for _ in range(4):
            router.request("alpha", x)
        time.sleep(0.3)
    st = router.replicas[0].client.stats()
    assert st["counters"]["serve.batches"] > 0
    assert st["histograms"]["serve.dispatch_seconds"]["count"] > 0
    assert st["histograms"]["serve.batch_rows"]["count"] > 0
    assert st["kernel_launches"] == {"lrn_fwd": 0}
    for r in router.replicas:
        assert r.ema_cycle_s and r.ema_dispatch_s and r.ema_batch_rows
        assert r.estimated_total_ms() >= 1000.0 * r.ema_cycle_s


def test_overload_sheds_explicitly_not_by_timeout(router):
    from veles_tpu_torch import telemetry
    x = np.ones((1, 6, 6, 1), np.float32)
    shed0 = telemetry.counter("fleet.shed").value
    saved = router.slo_p99_ms, router.max_inflight
    try:
        router.slo_p99_ms = 0.5
        t0 = time.perf_counter()
        r = router.request("alpha", x, timeout=60)
        assert r.get("overloaded") is True and r["error"] == "overloaded"
        assert "est_ms" in r
        assert time.perf_counter() - t0 < 5.0
        router.slo_p99_ms = 0.0
        router.max_inflight = 0
        assert router.request("alpha", x, timeout=60).get("overloaded")
    finally:
        router.slo_p99_ms, router.max_inflight = saved
    assert telemetry.counter("fleet.shed").value - shed0 == 2
    assert telemetry.counter("fleet.model.alpha.shed").value >= 2
    check_answer(router.request("alpha", x), 1)


def _read_msg(proc, timeout=180):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"fleet died rc={proc.poll()}")
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        if "hb" not in msg:
            return msg
    raise AssertionError("no message in time")


def test_cli_round_trip(packages):
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--serve-fleet", "2",
         f"alpha={packages['alpha']['port_pkg']}",
         f"beta={packages['beta']['port_pkg']}",
         "--canary", "beta=alpha:0.5", "-b", "cpu", "--max-batch", "8",
         "--max-wait-ms", "5"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        bufsize=1, cwd=REPO)
    try:
        hello = _read_msg(proc)
        assert hello["ready"] and hello["fleet"] == 2
        assert set(hello["models"]) == {"alpha", "beta"}
        assert hello["canaries"]["beta"]["of"] == "alpha"
        assert hello["placement"] == {"alpha": [0, 1], "beta": [0, 1]}
        assert len(hello["replica_pids"]) == 2
        x = np.ones((1, 6, 6, 1), np.float32)
        proc.stdin.write(json.dumps({"id": 1, "model": "alpha",
                                     "rows": x.tolist()}) + "\n")
        proc.stdin.flush()
        resp = _read_msg(proc)
        assert resp["id"] == 1
        np.testing.assert_allclose(check_answer(resp, 1),
                                   _host_oracle(packages["alpha"], x),
                                   atol=ATOL)
        proc.stdin.write(json.dumps({"op": "fleet", "id": 2}) + "\n")
        proc.stdin.flush()
        st = _read_msg(proc)
        assert st["id"] == 2 and len(st["fleet"]["replicas"]) == 2
        assert all(r["healthy"] for r in st["fleet"]["replicas"])
        proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.parametrize("flag", ["--mesh", "--metrics-dir"])
def test_cli_refuses_what_is_not_ported(packages, flag, tmp_path):
    """Both are ported now.  ``--mesh 2``: every replica owns a mesh of
    two places, and ``op=fleet`` shows ``devices`` 2 for each.
    ``--metrics-dir``: the fleet serves, and its dir holds the router's
    files and one ``replica-<i>`` dir a replica, each with a snapshot
    and a journal that ends in ``serve.shutdown``."""
    value = "2" if flag == "--mesh" else str(tmp_path / "m")
    lines = [{"op": "fleet", "id": 1}] * (flag == "--mesh") + \
        [{"op": "shutdown"}]
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "--serve-fleet", "2",
         f"alpha={packages['alpha']['port_pkg']}", "-b", "cpu", flag,
         value], input="".join(json.dumps(ln) + "\n" for ln in lines),
        capture_output=True, text=True, cwd=REPO, timeout=180)
    assert p.returncode == 0, p.stderr[-2000:]
    if flag == "--mesh":
        (fleet,) = [m["fleet"] for m in map(json.loads,
                                            p.stdout.splitlines())
                    if m.get("id") == 1]
        assert [r["devices"] for r in fleet["replicas"]] == [2, 2], fleet
        return
    d = tmp_path / "m"
    assert sorted(f.name for f in d.glob("replica-*")) == \
        ["replica-0", "replica-1"]
    for sub in [d, d / "replica-0", d / "replica-1"]:
        (snap,) = sub.glob("metrics-*.json")
        (journal,) = sub.glob("journal-*.jsonl")
        assert json.loads(snap.read_text())["pid"] == \
            int(journal.stem.split("-")[1])
        evs = [json.loads(ln)["event"]
               for ln in journal.read_text().splitlines()]
        assert evs[-1] == ("fleet.shutdown" if sub == d
                           else "serve.shutdown")
