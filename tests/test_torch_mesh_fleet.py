"""A mixed fleet in the port: replica 0 a ``--mesh 2`` hive, replica 1 one
device (``FleetRouter(mesh={0: 2})``, ``--serve-fleet --mesh 0=2``), on
the CPU; after ``tests/test_serve_mesh.py:383-456``.

- the fleet comes up with ``devices`` [2, 1], each capacity from the
  replica's own hello (replica 0's twice replica 1's), and the placement
  is the policy's over those capacities;
- requests round-trip against the host oracle;
- both packages' fleet views (``obs.fleet_rows``) read ``devices``
  [2, 1] and a resident charge a device from the fleet's dir;
- ``parse_mesh`` parses every form as the reference's does, and refuses
  a mix;
- the CLI (``--serve-fleet 2 --mesh 0=2 -b cpu``) answers ``op=fleet``
  with ``devices`` [2, 1].
"""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.test_fleet import _host_oracle
from tests.test_torch_fleet import REPO, port_packages


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_mesh_fleet_pkgs"))
    return port_packages(d, {"alpha": 11, "beta": 22})


@pytest.fixture(scope="module")
def router(packages, tmp_path_factory):
    from veles_tpu_torch.serve.router import FleetRouter
    mdir = str(tmp_path_factory.mktemp("torch_mesh_fleet"))
    r = FleetRouter({"alpha": packages["alpha"]["port_pkg"],
                     "beta": packages["beta"]["port_pkg"]},
                    n_replicas=2, backend="cpu", max_batch=16,
                    max_wait_ms=5, mesh={0: 2}, metrics_dir=mdir, cwd=REPO)
    yield r
    r.close()


def test_the_mixed_fleet_places_by_capacity(router):
    from veles_tpu_torch.serve.fleet import PlacementPolicy
    assert all(r.healthy for r in router.replicas)
    assert [r.devices for r in router.replicas] == [2, 1]
    assert [r.mesh for r in router.replicas] == [2, 0]
    c0, c1 = (r.capacity_bytes for r in router.replicas)
    assert c0 and c1 and c0 == 2 * c1
    rows = router.fleet_status()["replicas"]
    assert [row["devices"] for row in rows] == [2, 1]
    assert rows[0]["device_budget"] == rows[1]["device_budget"] > 0
    want = PlacementPolicy().assign(
        {n: router.hello_models[n]["param_bytes"] for n in router.models},
        2, capacities=[c0, c1])
    assert router.placement == want


def test_round_trip_matches_the_oracle(router, packages):
    rng = np.random.default_rng(123)
    for name in ("alpha", "beta", "alpha"):
        x = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
        r = router.request(name, x, timeout=60)
        np.testing.assert_allclose(np.asarray(r["probs"], np.float32),
                                   _host_oracle(packages[name], x),
                                   atol=1e-5)


def test_both_fleet_views_show_the_mesh(router):
    from veles_tpu import obs as ref_obs
    from veles_tpu_torch import obs, telemetry
    telemetry.flush()
    deadline = time.monotonic() + 60
    rows = []
    while time.monotonic() < deadline:
        rows = obs.fleet_rows(router.metrics_dir)
        if len(rows) == 2 and all(
                r.get("resident_mib_per_device") for r in rows):
            break
        time.sleep(0.5)
    assert [r["devices"] for r in rows] == [2, 1], rows
    assert all(r["resident_mib_per_device"] > 0 for r in rows)
    assert [r["devices"] for r in
            ref_obs.fleet_rows(router.metrics_dir)] == [2, 1]
    assert "devs" in obs.render_fleet(router.metrics_dir)


@pytest.mark.parametrize("specs", [None, [], ["8"], ["1=8"],
                                   ["0=2", "3=8"], ["2", "2"]])
def test_parse_mesh_is_the_references(specs):
    from veles_tpu.serve.router import parse_mesh as ref_parse
    from veles_tpu_torch.serve.router import parse_mesh
    assert parse_mesh(specs) == ref_parse(specs)


def test_parse_mesh_refuses_a_mix():
    from veles_tpu_torch.serve.router import parse_mesh
    with pytest.raises(ValueError, match="mix"):
        parse_mesh(["8", "1=8"])


def test_the_cli_meshes_one_replica(packages):
    lines = [{"id": 1, "model": "alpha", "rows": [[[[0.5]] * 6] * 6]},
             {"op": "fleet", "id": 2}, {"op": "shutdown"}]
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "--serve-fleet", "2",
         f"alpha={packages['alpha']['port_pkg']}", "-b", "cpu", "--mesh",
         "0=2", "--heartbeat-every", "0"],
        input="".join(json.dumps(ln) + "\n" for ln in lines),
        capture_output=True, text=True, cwd=REPO, timeout=180)
    assert p.returncode == 0, p.stderr[-2000:]
    out = {m.get("id"): m for m in map(json.loads, p.stdout.splitlines())}
    assert len(out[1]["probs"]) == 1
    assert [r["devices"] for r in out[2]["fleet"]["replicas"]] == [2, 1]
