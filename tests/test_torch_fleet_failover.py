"""The port's fleet losing nothing, against the reference's tests of it
(``tests/test_fleet.py`` ``TestFleetFailover``, ``tests/test_gauntlet.py``
``TestScaleDownUnderLoad``), on the CPU:

- SIGKILL of one replica while six closed-loop workers have requests in
  flight: every one of the 90 answers carries probabilities within atol
  1e-5 of the reference's host oracle, at least one was retried on the
  peer, and the monitor respawns the replica into its install dir;
- scale-down under load: ``retire_replica`` marks the victim, re-homes
  its exclusive tail model before the SIGTERM, drains it and loses no
  request (never a 404); the victim's install dir joins the warm pool
  and the next ``add_replica`` reuses it, minting a new index;
- the learner rung: ``apply_degradation("learner", ...)`` fans
  learner_suspend / learner_resume to every replica that runs with
  ``VELES_ONLINE=1``, and each replica's learner follows (``op=stats``
  ``online.suspended``).
"""

import threading
import time

import numpy as np
import pytest

from tests.test_fleet import _host_oracle
from tests.test_torch_fleet import ATOL, REPO, check_answer, port_packages


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_failover_pkgs"))
    return port_packages(d, {"alpha": 11})


def test_sigkill_mid_load_loses_nothing(packages):
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.serve.router import FleetRouter
    router = FleetRouter({"alpha": packages["alpha"]["port_pkg"]},
                         n_replicas=2, backend="cpu", max_batch=16,
                         max_wait_ms=5, cwd=REPO, respawn_backoff=0.25)
    try:
        x = np.ones((2, 6, 6, 1), np.float32)
        want = _host_oracle(packages["alpha"], x)
        check_answer(router.request("alpha", x), 2)
        install0 = router.replicas[0].install_dir
        pid0 = router.replicas[0].pid
        retries0 = telemetry.counter("fleet.retries").value
        respawns0 = telemetry.counter("fleet.replica_respawns").value
        results, errs = [], []

        def worker(i):
            try:
                for k in range(15):
                    if i == 0 and k == 3:
                        router.replicas[0].client.proc.kill()
                    results.append(router.request("alpha", x, timeout=60))
            except Exception as e:  # noqa: BLE001 — collected below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        assert len(results) == 6 * 15
        for r in results:
            np.testing.assert_allclose(check_answer(r, 2), want, atol=ATOL)
        assert telemetry.counter("fleet.retries").value > retries0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                router.replicas[0].deaths >= 1
                and router.replicas[0].healthy):
            time.sleep(0.1)
        assert router.replicas[0].deaths >= 1
        assert router.replicas[0].healthy, "replica 0 was not respawned"
        assert router.replicas[0].pid != pid0
        assert router.replicas[0].install_dir == install0
        assert telemetry.counter("fleet.replica_respawns").value \
            > respawns0
        np.testing.assert_allclose(
            check_answer(router.request("alpha", x), 2), want, atol=ATOL)
    finally:
        router.close(kill=True)


class TestScaleDownUnderLoad:
    """``tests/test_gauntlet.py`` TestScaleDownUnderLoad on the port."""

    @pytest.fixture(scope="class")
    def router(self, packages):
        from veles_tpu_torch.serve.fleet import PlacementPolicy
        from veles_tpu_torch.serve.router import FleetRouter
        pkg = packages["alpha"]["port_pkg"]
        r = FleetRouter({"core": pkg, "tail_a": pkg, "tail_b": pkg},
                        n_replicas=2, backend="cpu", max_batch=16,
                        max_wait_ms=5, cwd=REPO,
                        placement=PlacementPolicy(budget_bytes=1 << 30,
                                                  hot={"core"}))
        yield r
        r.close(kill=True)

    def test_placement_splits_the_tail(self, router):
        from veles_tpu.serve.fleet import PlacementPolicy as RefPolicy
        assert sorted(router.placement["core"]) == [0, 1]
        tails = {m: router.placement[m] for m in ("tail_a", "tail_b")}
        assert all(len(p) == 1 for p in tails.values()), tails
        assert {p[0] for p in tails.values()} == {0, 1}, tails
        want = RefPolicy(budget_bytes=1 << 30, hot={"core"}).assign(
            {m: router.hello_models[m]["param_bytes"]
             for m in router.models}, 2,
            capacities=[r.capacity_bytes for r in router.replicas])
        assert router.placement == want

    def test_retire_under_load_loses_nothing(self, router):
        from veles_tpu_torch import events, telemetry
        x = np.ones((1, 6, 6, 1), np.float32)
        models = ["core", "tail_a", "tail_b"]
        for r in router.replicas:
            for m in models:
                assert "probs" in r.client.request(m, x, timeout=120)
        errors, ok = [], [0]
        stop = threading.Event()

        def loop(i):
            while not stop.is_set():
                m = models[i % len(models)]
                res = router.request(m, x, timeout=60)
                if "probs" in res:
                    ok[0] += 1
                elif not res.get("overloaded"):
                    errors.append((m, res))
                time.sleep(0.002)

        threads = [threading.Thread(target=loop, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(1.0)
            victim_idx = router.retire_replica(cause="test",
                                               drain_timeout=60.0)
            assert victim_idx == 1
            time.sleep(1.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not errors, f"lost/404'd {len(errors)}: {errors[:3]}"
        assert ok[0] > 0
        for m, placed in router.placement.items():
            assert victim_idx not in placed, (m, placed)
        for m in models:
            assert "probs" in router.request(m, x, timeout=60)
        live = [r for r in router.replicas if not r.retiring]
        assert len(live) == 1 and live[0].idx == 0
        retired = telemetry.recent_events(events.EV_FLEET_REPLICA_RETIRED)
        assert retired and retired[-1]["replica"] == 1
        assert retired[-1]["drained"] is True
        # an orderly exit: the hive drained and exited 14, and the
        # monitor counted no death
        assert retired[-1]["rc"] == 14
        assert live[0].deaths == 0
        assert router._warm_dirs

    def test_scale_up_reuses_the_warm_dir(self, router):
        from veles_tpu_torch import events, telemetry
        warm = list(router._warm_dirs)
        newbie = router.add_replica(cause="test")
        assert newbie is not None and newbie.idx == 2
        assert newbie.install_dir == warm[-1]
        assert not router._warm_dirs
        spawned = telemetry.recent_events(events.EV_FLEET_SCALE_UP)
        assert spawned and spawned[-1]["replica"] == 2
        assert spawned[-1]["warm_dir"] is True
        x = np.ones((1, 6, 6, 1), np.float32)
        for m in ("core", "tail_a", "tail_b"):
            assert "probs" in router.request(m, x, timeout=120)


def test_the_learner_rung_reaches_every_online_replica(packages):
    from veles_tpu_torch import events, telemetry
    from veles_tpu_torch.serve.router import FleetRouter
    router = FleetRouter({"alpha": packages["alpha"]["port_pkg"]},
                         n_replicas=2, backend="cpu", max_batch=8,
                         max_wait_ms=2, cwd=REPO,
                         env={"VELES_ONLINE": "1",
                              "VELES_ONLINE_MICRO_BATCH": "8",
                              "VELES_ONLINE_IDLE_MS": "1"})
    try:
        assert all(r.client.hello["online"] for r in router.replicas)

        def suspended():
            # op=learn's rows carry the reference's keys, which name no
            # suspension; op=stats' online entry does
            return [r.client.stats()["online"]["suspended"]
                    for r in router.replicas]

        assert all(set(r.client.learn()) == {"alpha"}
                   for r in router.replicas)
        assert suspended() == [False, False]
        router.apply_degradation("learner", True, cause="test")
        assert suspended() == [True, True]
        router.apply_degradation("learner", False, cause="test")
        assert suspended() == [False, False]
        rungs = [(e["event"], e["rung"]) for e in telemetry.recent_events()
                 if e["event"] in (events.EV_FLEET_DEGRADE_ENGAGE,
                                   events.EV_FLEET_DEGRADE_RELEASE)]
        assert rungs[-2:] == [(events.EV_FLEET_DEGRADE_ENGAGE, "learner"),
                              (events.EV_FLEET_DEGRADE_RELEASE, "learner")]
    finally:
        router.close(kill=True)
