"""Gray failures in the port's fleet, against the reference's drills
(``tests/test_fleet.py`` ``TestFleetGrayFailures``), on the CPU: one
replica of a real 2-replica fleet is armed through a per-replica
``VELES_FAULTS`` (``env_overrides``) and stays alive and heartbeating,
and every client answer stays clean (within atol 1e-5 of the reference's
host oracle) and bounded:

- ``hive.slow_dispatch`` (1.5 s a dispatch for the first 6 dispatches):
  hedged, the hedges won by the peer, the replica ejected with
  hedge-loss strikes, traffic after the ejection under 1 s, then
  reinstated after two clean probes once the fault is spent, and the
  losers' late answers dropped as stale;
- ``hive.wedge`` (every request swallowed): caught by the deadline and
  the hedge, ejected, while the monitor sees no death and heartbeats
  keep arriving; its probes fail;
- ``hive.garbage_response`` (every payload replaced after its crc):
  caught by the integrity echo, retried on the peer, ejected, never
  reinstated while armed; ``fleet_status`` shows it;
- ``fleet.replica_flap`` (the replica SIGKILLs itself 0.5 s after every
  hello): the monitor respawns it with a backoff that doubles while it
  keeps dying young, and the fleet answers every request meanwhile.
"""

import time

import numpy as np
import pytest

from tests.test_fleet import _host_oracle
from tests.test_torch_fleet import ATOL, REPO, check_answer, port_packages


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_gray_pkgs"))
    return port_packages(d, {"alpha": 11})


def _router(packages, fault, **kw):
    from veles_tpu_torch.serve.router import FleetRouter
    defaults = dict(n_replicas=2, backend="cpu", max_batch=16,
                    max_wait_ms=5, cwd=REPO,
                    env_overrides={0: {"VELES_FAULTS": fault}})
    defaults.update(kw)
    return FleetRouter({"alpha": packages["alpha"]["port_pkg"]},
                       **defaults)


def _ctr(name):
    from veles_tpu_torch import telemetry
    return telemetry.counter(name).value


def test_slow_replica_hedged_ejected_then_reinstated(packages):
    router = _router(
        packages, "hive.slow_dispatch@label=alpha&times=6&seconds=1.5",
        deadline_ms=8000, hedge_min_ms=60, hedge_budget=1.0,
        probe_interval=0.2, probe_ok=2, probe_backoff_cap=0.4)
    try:
        hedges0, wins0 = _ctr("fleet.hedge.issued"), _ctr("fleet.hedge.wins")
        eject0 = _ctr("fleet.eject.total")
        stale0 = _ctr("fleet.stale_response")
        x = np.ones((1, 6, 6, 1), np.float32)
        want = _host_oracle(packages["alpha"], x)
        for _ in range(30):
            np.testing.assert_allclose(
                check_answer(router.request("alpha", x, timeout=30), 1),
                want, atol=ATOL)
            if _ctr("fleet.eject.total") > eject0:
                break
        assert _ctr("fleet.hedge.issued") > hedges0
        assert _ctr("fleet.hedge.wins") > wins0
        assert _ctr("fleet.eject.total") == eject0 + 1
        st = router.sentinel.status(router.replicas[0])
        assert st["state"] in ("ejected", "probing"), st
        assert st["strikes"].get("hedge_loss", 0) >= 1, st
        post = []
        for _ in range(10):
            t0 = time.perf_counter()
            check_answer(router.request("alpha", x, timeout=30), 1)
            post.append(time.perf_counter() - t0)
        assert max(post) < 1.0, post
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = router.sentinel.status(router.replicas[0])
            if st["state"] == "healthy" and st["reinstatements"] >= 1:
                break
            time.sleep(0.2)
        assert st["state"] == "healthy" and st["reinstatements"] >= 1, st
        assert _ctr("fleet.eject.reinstated_total") >= 1
        check_answer(router.request("alpha", x, timeout=30), 1)
        assert _ctr("fleet.stale_response") > stale0
    finally:
        router.close(kill=True)


def test_wedged_replica_detected_without_heartbeat_loss(packages):
    router = _router(packages, "hive.wedge@times=*", deadline_ms=5000,
                     hedge_min_ms=60, hedge_budget=1.0,
                     probe_interval=0.25, probe_ok=2, heartbeat_every=0.2)
    try:
        eject0 = _ctr("fleet.eject.total")
        probe_fail0 = _ctr("fleet.probe.fail")
        x = np.ones((1, 6, 6, 1), np.float32)
        for _ in range(25):
            check_answer(router.request("alpha", x, timeout=30), 1)
            if _ctr("fleet.eject.total") > eject0:
                break
        assert _ctr("fleet.eject.total") == eject0 + 1
        st = router.sentinel.status(router.replicas[0])
        assert st["state"] in ("ejected", "probing"), st
        r0 = router.replicas[0]
        assert r0.deaths == 0 and r0.healthy and r0.client.heartbeats > 0
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline \
                and _ctr("fleet.probe.fail") <= probe_fail0:
            time.sleep(0.1)
        assert _ctr("fleet.probe.fail") > probe_fail0
        st = router.sentinel.status(router.replicas[0])
        assert st["state"] in ("ejected", "probing"), st
    finally:
        router.close(kill=True)


def test_garbage_response_never_reaches_a_client(packages):
    router = _router(packages, "hive.garbage_response@times=*",
                     deadline_ms=8000, hedge_budget=0.0,
                     probe_interval=0.25, probe_ok=2)
    try:
        strikes0 = _ctr("fleet.integrity_strikes")
        retries0 = _ctr("fleet.retries")
        eject0 = _ctr("fleet.eject.total")
        x = np.ones((2, 6, 6, 1), np.float32)
        want = _host_oracle(packages["alpha"], x)
        for _ in range(20):
            np.testing.assert_allclose(
                check_answer(router.request("alpha", x, timeout=30), 2),
                want, atol=ATOL)
        assert _ctr("fleet.integrity_strikes") > strikes0
        assert _ctr("fleet.retries") > retries0
        assert _ctr("fleet.eject.total") == eject0 + 1
        st = router.sentinel.status(router.replicas[0])
        assert st["state"] in ("ejected", "probing"), st
        assert st["strikes"].get("integrity", 0) >= 2, st
        assert st["reinstatements"] == 0, st
        fs = router.fleet_status()
        assert fs["replicas"][0]["sentinel"]["state"] in ("ejected",
                                                          "probing")
        assert fs["replicas"][1]["sentinel"]["state"] == "healthy"
    finally:
        router.close(kill=True)


def test_flapping_replica_backs_off_while_the_fleet_serves(packages):
    from veles_tpu_torch import events, telemetry
    seen = len(telemetry.recent_events(events.EV_FLEET_REPLICA_DIED))
    router = _router(packages, "fleet.replica_flap@after=0.5&times=*",
                     respawn_backoff=0.25)
    try:
        x = np.ones((1, 6, 6, 1), np.float32)
        want = _host_oracle(packages["alpha"], x)
        deadline = time.monotonic() + 45
        while router.replicas[0].deaths < 3:
            assert time.monotonic() < deadline, router.replicas[0].deaths
            np.testing.assert_allclose(
                check_answer(router.request("alpha", x, timeout=30), 1),
                want, atol=ATOL)
            time.sleep(0.05)
        died = telemetry.recent_events(events.EV_FLEET_REPLICA_DIED)[seen:]
        # each death within STABLE_UPTIME_S of its hello doubles the wait
        assert [e["backoff"] for e in died if e["replica"] == 0][:3] == \
            [0.25, 0.5, 1.0], died
        assert router.replicas[1].deaths == 0
    finally:
        router.close(kill=True)
