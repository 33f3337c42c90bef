"""The port's run and fleet views (``veles_tpu_torch/obs.py``) against the
reference's (``veles_tpu/obs.py``) on a fleet dir the reference wrote:
the reference's ``FleetRouter`` and its ``-b cpu`` replicas driven as
``tests/torch_obs_fixtures.py`` drives the port's, read by both readers
with the same rows and the same rendered text.
"""

import os

import pytest

from tests.test_fleet import _build_package
from tests.torch_obs_fixtures import assert_views_equal, drive_fleet


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    from veles_tpu import telemetry as ref_telemetry
    from veles_tpu.serve.router import FleetRouter
    d = str(tmp_path_factory.mktemp("ref_obs_views"))
    pkgs = {n: _build_package(d, n, s)["pkg"]
            for n, s in (("alpha", 11), ("beta", 22))}
    mdir = os.path.join(d, "m")
    saved = os.environ.pop(ref_telemetry.ENV_DIR, None)
    ref_telemetry.reset()
    try:
        run = drive_fleet(FleetRouter, pkgs["alpha"], pkgs["beta"], mdir)
    finally:
        ref_telemetry.configure(None)
        os.environ.pop(ref_telemetry.ENV_DIR, None)
        if saved is not None:
            os.environ[ref_telemetry.ENV_DIR] = saved
        ref_telemetry.reset()
    return mdir, run


def test_the_views_equal_the_references_on_its_own_dir(ref_dir):
    mdir, run = ref_dir
    views = assert_views_equal(mdir)
    rows = views["fleet_rows"]
    assert [r["replica"] for r in rows] == [0, 1, 2]
    assert sorted(r["pid"] for r in rows[:2]) == run["pids"]
    assert [(r["kind"], r["replica"]) for r in views["scale_timeline"]] \
        == [("degrade", None), ("recover", None), ("scale-up", 2),
            ("retired", 2), ("scale-down", 2)]
    models = {m["model"]: m for m in views["dirs"]["router"]["models"]}
    assert models["alpha"]["requests"] == 12
    assert models["beta"]["canary_of"] == "alpha"
    for i in (0, 1):
        (learner,) = views["dirs"][f"replica-{i}"]["learner"]
        assert learner["model"] == "alpha"
