"""The port's web status page (``veles_tpu_torch/web_status.py``) against
the reference's (``veles_tpu/web_status.py``).

- Both servers over one fleet metrics dir the port wrote on the CPU
  (``tests/torch_obs_fixtures.py``): ``/api/metrics``, ``/api/traces``,
  one trace by id and the telemetry page's report are equal.
- The legacy push feed round trips (``POST /api/update`` ->
  ``GET /api/status``), refuses what is not a JSON object, escapes the
  runs table, and the runs live under the witnessed ``web_status.state``
  lock.
- ``StatusReporter.payload`` is the reference's for the same decision
  state; a ``-b cpu`` training run with ``--status-server`` posts its
  epochs to a live port server.
"""

import html
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from tests.test_torch_fleet import port_packages
from tests.torch_obs_fixtures import drive_fleet
from veles_tpu import web_status as ref_ws
from veles_tpu_torch import telemetry, web_status
from veles_tpu_torch.analysis import witness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINE_NAME = "WineWorkflow"


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    from veles_tpu_torch.serve.router import FleetRouter
    d = str(tmp_path_factory.mktemp("torch_web_status"))
    pkgs = port_packages(d, {"alpha": 31, "beta": 32})
    mdir = os.path.join(d, "m")
    saved = os.environ.pop(telemetry.ENV_DIR, None)
    telemetry.reset()
    try:
        drive_fleet(FleetRouter, pkgs["alpha"]["port_pkg"],
                    pkgs["beta"]["port_pkg"], mdir)
    finally:
        telemetry.configure(None)
        os.environ.pop(telemetry.ENV_DIR, None)
        if saved is not None:
            os.environ[telemetry.ENV_DIR] = saved
        telemetry.reset()
    return mdir


def _serve_both(mdir=None):
    """A port server and a reference server, started, over ``mdir``
    (None: the legacy feed alone)."""
    made = [mod.WebStatusServer(port=0, host="127.0.0.1", metrics_dir=mdir)
            for mod in (web_status, ref_ws)]
    for s in made:
        s.start_background()
    return made


@pytest.fixture
def servers():
    made = _serve_both()
    yield made
    for s in made:
        s.shutdown()


def _get(server, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=10) as r:
        return r.status, r.read()


def _post(server, path, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_the_telemetry_feed_is_the_references(fleet_dir):
    port, ref = _serve_both(fleet_dir)
    try:
        code, body = _get(port, "/api/metrics")
        rcode, rbody = _get(ref, "/api/metrics")
        assert code == rcode == 200
        got, want = json.loads(body), json.loads(rbody)
        assert got == want
        assert len(got["fleet"]["replicas"]) == 3 and got["snapshots"]
        assert got["fleet"]["scale_timeline"]
        code, body = _get(port, "/api/traces")
        assert (code, json.loads(body)) == \
            (200, json.loads(_get(ref, "/api/traces")[1]))
        traces = json.loads(body)["traces"]
        assert traces, "the fleet dir holds traced requests"
        tid = traces[0]["trace"]
        one = json.loads(_get(port, f"/api/traces?id={tid}")[1])
        assert one == json.loads(_get(ref, f"/api/traces?id={tid}")[1])
        assert one["trace"] == tid and one["events"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/api/traces?id=nope")
        assert e.value.code == 404
        # the page: the same report under the port's own title
        page = _get(port, "/")[1].decode()
        ref_page = _get(ref, "/")[1].decode()
        pre = re.compile(r"<pre>(.*)</pre>", re.S)
        assert pre.search(page).group(1) == pre.search(ref_page).group(1)
        assert "veles_tpu_torch" in page
        assert "-- fleet replicas --" in html.unescape(page)
        # the legacy table stays at /runs beside the telemetry page
        assert b"running workflows" in _get(port, "/runs")[1]
    finally:
        port.shutdown()
        ref.shutdown()


def test_the_legacy_feed_round_trips(servers):
    for s in servers:
        assert json.loads(_get(s, "/api/status")[1]) == {}
        body = json.dumps({"id": "r1", "name": "<w>", "epoch": 3,
                           "train_error_pct": 12.5}).encode()
        assert _post(s, "/api/update", body) == (200, b'{"ok": true}')
        runs = json.loads(_get(s, "/api/status")[1])
        assert runs["r1"]["epoch"] == 3 and runs["r1"]["updated_at"] > 0
        for bad in (b"{not json", b"[1, 2]", b'{"no_id": 1}'):
            assert _post(s, "/api/update", bad)[0] == 400
        assert _post(s, "/elsewhere", body)[0] == 404
        page = _get(s, "/")[1].decode()
        assert "&lt;w&gt;" in page and "<w>" not in page
    port, ref = servers
    strip = {k: v for k, v in json.loads(_get(port, "/api/status")[1])[
        "r1"].items() if k != "updated_at"}
    assert strip == {k: v for k, v in json.loads(_get(ref, "/api/status")[
        1])["r1"].items() if k != "updated_at"}


def test_the_store_is_under_the_witnessed_lock(monkeypatch):
    monkeypatch.setenv(witness.ENV_VAR, "1")
    witness.reset()
    store = web_status.StatusStore()
    outer = witness.lock("t.outer")
    with outer:
        store.update("a", {"x": 1})
    assert store.snapshot()["a"]["x"] == 1
    assert witness.observed_edges() == [("t.outer", "web_status.state")]
    witness.reset()


def _decision(epoch, errs, min_valid, complete):
    return SimpleNamespace(loader=SimpleNamespace(epoch_number=epoch),
                           epoch_error_pct=errs, min_valid_error=min_valid,
                           complete=complete)


@pytest.mark.parametrize("state", [
    (0, [100.0, 100.0, 100.0], float("inf"), False),
    (3, [0.0, 12.345, 23.4567], 7.0, False),
    (10, [0.0, 1.005, 0.0], 2.0, True),
])
def test_reporter_payload_is_the_references(state):
    wf = SimpleNamespace(name="wf")
    got = web_status.StatusReporter(wf, url="http://x/", mode="standalone",
                                    name="status_reporter")
    got.decision = _decision(*state)
    want = ref_ws.StatusReporter(None, url="http://x/", mode="standalone",
                                 name="status_reporter")
    want.workflow = wf
    want.decision = _decision(*state)
    a, b = got.payload(), want.payload()
    assert a.pop("id").startswith("wf-")
    b.pop("id")
    assert a == b
    assert got.url == "http://x"


def test_a_training_run_posts_to_a_live_server(tmp_path):
    server = web_status.WebStatusServer(port=0, host="127.0.0.1")
    server.start_background()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch", "-b", "cpu",
             "--status-server", f"http://127.0.0.1:{server.port}",
             os.path.join(REPO, "veles_tpu_torch", "models", "wine.py"),
             "root.wine.decision.max_epochs=2"], cwd=REPO,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        (run,) = server.store.snapshot().values()
    finally:
        server.shutdown()
    assert run["name"] == WINE_NAME
    assert (run["epoch"], run["complete"], run["mode"]) == \
        (2, True, "standalone")
    assert 0.0 <= run["valid_error_pct"] <= 100.0
    assert run["min_valid_error"] is not None
