"""The port's report CLI (``python -m veles_tpu_torch.tools.obs_report``)
and its fleet view on a live port fleet, against the reference's
(``scripts/obs_report.py``, ``tests/test_fleet.py``):

- the counterparts of the reference's two fleet-view tests
  (``test_per_replica_metrics_dirs_written``,
  ``test_obs_fleet_view_reads_real_replica_dirs``) on a 2-replica ``-b
  cpu`` fleet of the port with a metrics dir;
- the CLI's five modes (``--json``, ``--fleet``, ``--trace ID``,
  ``--traces``, ``--events N``) on that dir: rc 0, the reference's JSON
  keys and values, the reference's text; run as a module it prints the
  same fleet JSON; a dir that is not one exits 2, an empty one 1.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_fleet import REPO, port_packages
from veles_tpu_torch import obs, telemetry
from veles_tpu_torch.tools import obs_report


def _reference_cli():
    spec = importlib.util.spec_from_file_location(
        "ref_obs_report", os.path.join(REPO, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from veles_tpu_torch.serve.router import FleetRouter
    d = str(tmp_path_factory.mktemp("torch_obs_report"))
    pkg = port_packages(d, {"alpha": 11})["alpha"]["port_pkg"]
    mdir = os.path.join(d, "m")
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    router = FleetRouter({"alpha": pkg}, n_replicas=2, backend="cpu",
                         max_batch=8, max_wait_ms=2, metrics_dir=mdir,
                         cwd=REPO)
    gen = np.random.default_rng(3)
    for _ in range(10):
        x = gen.standard_normal((2, 6, 6, 1)).astype(np.float32)
        assert "probs" in router.request("alpha", x, timeout=60)
    yield router, mdir
    router.close()
    telemetry.configure(None)
    os.environ.pop(telemetry.ENV_DIR, None)
    if saved is not None:
        os.environ[telemetry.ENV_DIR] = saved
    telemetry.reset()


def test_per_replica_metrics_dirs_written(fleet):
    router, mdir = fleet
    telemetry.flush()
    for i in (0, 1):
        d = os.path.join(mdir, f"replica-{i}")
        assert os.path.isdir(d), d
        # each replica flushed at least its hello-time snapshot
        files = os.listdir(d)
        assert any(fn.startswith("journal-") for fn in files), files


def test_obs_fleet_view_reads_real_replica_dirs(fleet):
    router, mdir = fleet
    rows = obs.fleet_rows(mdir)
    assert [r["replica"] for r in rows] == [0, 1]
    assert {r["pid"] for r in rows} == {r.pid for r in router.replicas}
    assert "fleet replicas" in obs.render_fleet(mdir)


@pytest.fixture(scope="module")
def closed(fleet):
    """The fleet's dir after its clean shutdown (every final snapshot
    and journal line on disk) and the id of one assembled trace."""
    router, mdir = fleet
    router.close()
    telemetry.flush()
    _reg, merged = obs.load_tree(mdir)
    traces = obs.assemble_traces(merged)
    assert len(traces) == 10
    return mdir, sorted(traces)[0]


def _both(argv, capsys):
    got = []
    for main in (obs_report.main, _reference_cli().main):
        rc = main(argv)
        out = capsys.readouterr().out
        got.append((rc, out))
    return got


@pytest.mark.parametrize("mode", ["json", "fleet", "trace", "traces",
                                  "events"])
def test_the_five_modes_as_the_reference_gives_them(closed, capsys, mode):
    mdir, tid = closed
    argv = {"json": ["--json"], "fleet": ["--fleet"],
            "trace": ["--trace", tid], "traces": ["--traces"],
            "events": ["--events", "5"]}[mode]
    (rc, out), (ref_rc, ref_out) = _both([mdir] + argv, capsys)
    assert rc == ref_rc == 0
    if mode == "json":
        got, want = json.loads(out), json.loads(ref_out)
        assert set(got) == set(want)
        assert got == want
        assert got["snapshots"] >= 1 and got["journal_events"] > 0
    else:
        assert out == ref_out
    if mode == "fleet":
        assert "-- fleet replicas --" in out and "== Sightline" in out
    if mode == "trace":
        assert out.startswith(f"trace {tid}") and "critical path" in out
    if mode == "traces":
        assert len(out.splitlines()) == 10
    if mode == "events":
        assert "journal timeline (last 5 of" in out


def test_the_fleet_json_as_a_module(closed, capsys):
    mdir, _tid = closed
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.obs_report", mdir,
         "--fleet", "--json"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert _reference_cli().main([mdir, "--fleet", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) and got["fleet"] == want["fleet"]
    assert set(got["fleet"]) == {"replicas", "models"}
    assert [r["replica"] for r in got["fleet"]["replicas"]] == [0, 1]
    assert sum(r["requests"] for r in got["fleet"]["replicas"]) >= 10


def test_what_is_not_a_metrics_dir(tmp_path, capsys):
    assert obs_report.main([str(tmp_path / "nowhere")]) == 2
    assert obs_report.main([str(tmp_path)]) == 1
    assert obs_report.main([str(tmp_path), "--fleet"]) == 1
    assert obs_report.main([str(tmp_path), "--trace", "feedface"]) == 1
