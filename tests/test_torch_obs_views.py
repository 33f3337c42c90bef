"""The port's run and fleet views (``veles_tpu_torch/obs.py``) against the
reference's (``veles_tpu/obs.py``) on a fleet dir the port wrote on the
CPU (``tests/torch_obs_fixtures.py``: two ``-b cpu`` replicas with the
learner armed, a canary, labeled rows, the learner rung engaged and
released, a scale-up and a retirement): the same rows from both readers,
the same rendered text, and rows that say what the fleet did.
"""

import os

import pytest

from tests.test_torch_fleet import port_packages
from tests.torch_obs_fixtures import assert_views_equal, drive_fleet
from veles_tpu_torch import obs, telemetry


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    from veles_tpu_torch.serve.router import FleetRouter
    d = str(tmp_path_factory.mktemp("torch_obs_views"))
    pkgs = port_packages(d, {"alpha": 11, "beta": 22})
    mdir = os.path.join(d, "m")
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    # the router's snapshot is this process's registry: this fleet's alone
    telemetry.reset()
    try:
        run = drive_fleet(FleetRouter, pkgs["alpha"]["port_pkg"],
                          pkgs["beta"]["port_pkg"], mdir)
    finally:
        telemetry.configure(None)
        os.environ.pop(telemetry.ENV_DIR, None)
        if saved is not None:
            os.environ[telemetry.ENV_DIR] = saved
        telemetry.reset()
    return mdir, run


def test_the_views_equal_the_references(port_dir):
    mdir, run = port_dir
    views = assert_views_equal(mdir)
    rows = views["fleet_rows"]
    # replicas 0 and 1 served, 2 came with the scale-up and was retired
    assert [r["replica"] for r in rows] == [0, 1, 2]
    assert sorted(r["pid"] for r in rows[:2]) == run["pids"]
    assert all(r["spawns"] == 1 and r["models_resident"] == 2
               for r in rows)
    # every client request, labeled row, canary mirror and hedge is one
    # replica request (the router counts the mirrors and the hedges)
    reg = obs.load_dir(mdir)[0]
    extra = sum(reg.counters[k].value for k in ("fleet.mirrored",
                                                 "fleet.hedge.issued")
                if k in reg.counters)
    assert reg.counters["fleet.mirrored"].value >= 1
    assert sum(r["requests"] for r in rows) == \
        run["requests"] + 2 * 12 + extra
    assert all(r["arbiter"]["pools"]["serve"] > 0 for r in rows)
    kinds = [(r["kind"], r["replica"], r["rung"], r["cause"])
             for r in views["scale_timeline"]]
    assert kinds == [("degrade", None, "learner", "test"),
                     ("recover", None, "learner", "test"),
                     ("scale-up", 2, None, "test"),
                     ("retired", 2, None, None),
                     ("scale-down", 2, None, "test")]
    models = {m["model"]: m for m in views["dirs"]["router"]["models"]}
    assert models["alpha"]["requests"] == 12
    # the canary's requests: its own and the mirrors of alpha's
    assert models["beta"]["mirrored"] >= 1
    assert models["beta"]["requests"] == 6 + models["beta"]["mirrored"]
    assert models["beta"]["canary_of"] == "alpha"
    assert models["beta"]["canary_fraction"] == 0.25
    assert views["dirs"]["router"]["arbiter"] is None
    for i in (0, 1):
        (learner,) = views["dirs"][f"replica-{i}"]["learner"]
        assert learner["model"] == "alpha"
        assert learner["buffer_rows"] is not None
