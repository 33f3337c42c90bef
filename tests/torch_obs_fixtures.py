"""A fleet's metrics dir for the port's readers' tests, written by either
package's ``FleetRouter`` on the CPU.

Not a test module: ``test_torch_obs_*.py`` import it.  :func:`drive_fleet`
runs the same operations through the router class it is given, so the
reference's fleet and the port's write dirs of one shape: two ``-b cpu``
replicas with the online learner armed serve a model and its canary,
take labeled rows straight to each replica, engage and release the
learner rung, scale up by one replica and retire one.
"""

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference test's learner settings (``tests/test_online.py``)
LEARN_ENV = {
    "VELES_ONLINE": "1",
    "VELES_ONLINE_MICRO_BATCH": "8",
    "VELES_ONLINE_MIN_STEPS": "4",
    "VELES_ONLINE_LR_SCALE": "1.0",
    "VELES_ONLINE_PROMOTE_MARGIN": "5.0",
    "VELES_ONLINE_HOLDOUT_EVERY": "6",
    "VELES_ONLINE_IDLE_MS": "1",
}


def drive_fleet(router_cls, alpha: str, beta: str, mdir: str) -> dict:
    """Serve packages ``alpha`` and ``beta`` (``beta`` a 0.25 canary of
    ``alpha``) from a 2-replica fleet of ``router_cls`` with its metrics in
    ``mdir``, then close it.  {"pids": the live replicas' pids at the
    close, "requests": what the fleet's clients sent}"""
    router = router_cls({"alpha": alpha, "beta": beta}, n_replicas=2,
                        backend="cpu", max_batch=8, max_wait_ms=2,
                        canaries={"beta": ("alpha", 0.25)},
                        metrics_dir=mdir, cwd=REPO, env=dict(LEARN_ENV))
    gen = np.random.default_rng(7)
    sent = 0
    try:
        for _ in range(12):
            x = gen.standard_normal((2, 6, 6, 1)).astype(np.float32)
            assert "probs" in router.request("alpha", x, timeout=60)
            sent += 1
        # labeled rows feed each replica's learner
        for r in router.replicas:
            for j in range(12):
                x = gen.standard_normal((1, 6, 6, 1)).astype(np.float32)
                resp = r.client.wait_for(r.client.submit(
                    "alpha", x, label=[j % 3]), timeout=60)
                assert "probs" in resp, resp
        router.apply_degradation("learner", True, cause="test")
        router.apply_degradation("learner", False, cause="test")
        assert router.add_replica(cause="test") is not None
        for _ in range(6):
            x = gen.standard_normal((1, 6, 6, 1)).astype(np.float32)
            assert "probs" in router.request("beta", x, timeout=60)
            sent += 1
        assert router.retire_replica(cause="test") is not None
        pids = sorted(r.pid for r in router.replicas if not r.retiring)
    finally:
        router.close()
    return {"pids": pids, "requests": sent}


def assert_views_equal(mdir: str) -> dict:
    """The port's views and the reference's on the same dir: every row of
    ``fleet_rows``, ``scale_timeline``, ``fleet_model_rows`` and, for the
    router and each replica, ``arbiter_ledger`` and ``learner_rows``,
    equal (so every integer column exactly), and ``render_fleet`` and
    ``render`` print the same text.  Returns the port's rows."""
    from veles_tpu import obs as ref_obs
    from veles_tpu_torch import obs

    rows = obs.fleet_rows(mdir)
    assert rows == ref_obs.fleet_rows(mdir)
    timeline = obs.scale_timeline(mdir)
    assert timeline == ref_obs.scale_timeline(mdir)
    out = {"fleet_rows": rows, "scale_timeline": timeline, "dirs": {}}
    for label, d in [("router", mdir)] + [
            (f"replica-{i}", p) for i, p in obs.fleet_replica_dirs(mdir)]:
        reg, snaps, journals, events = obs.load_dir(d)
        rreg, rsnaps, rjournals, revents = ref_obs.load_dir(d)
        assert (snaps, journals) == (rsnaps, rjournals)
        assert events == revents
        got = {"arbiter": obs.arbiter_ledger(reg),
               "learner": obs.learner_rows(reg, events),
               "models": obs.fleet_model_rows(reg, events)}
        assert got == {"arbiter": ref_obs.arbiter_ledger(rreg),
                       "learner": ref_obs.learner_rows(rreg, revents),
                       "models": ref_obs.fleet_model_rows(rreg, revents)}
        assert obs.render_arbiter(reg, label) == \
            ref_obs.render_arbiter(rreg, label)
        assert obs.render_learner(reg, events) == \
            ref_obs.render_learner(rreg, revents)
        assert obs.render(d, reg, snaps, journals, events) == \
            ref_obs.render(d, rreg, rsnaps, rjournals, revents)
        out["dirs"][label] = got
    assert obs.render_fleet(mdir) == ref_obs.render_fleet(mdir)
    return out
