"""Mesh serving in the port (``--serve-models --mesh N``, the residency
manager's placement decision) on the CPU, after
``tests/test_serve_mesh.py:141-335``:

- ``ResidencyManager`` on a 4-place ``MeshDevice``: ``always`` /
  ``never`` / ``auto`` (only a model over one place's budget) decide
  each model's placement once; the charge a place is the padded stack
  over N, and the ledger and ``serve.mesh_devices`` read it; a
  one-device manager never shards;
- a ``--mesh 2 -b cpu`` hive (forced to shard) against a flat hive on
  the same package: the hello advertises ``devices`` 2 and the model
  ``sharded``, ``op=stats``'s model row says sharded and resident with 0
  spills, the answers are the flat hive's bitwise and within 1e-5 of the
  host oracle, and the load journals ``serve.model_sharded_resident``;
- (over budget: ``test_torch_mesh_budget.py``)
- a mesh the visible cards cannot hold is refused, naming
  ``$VELES_MESH_RANKS_PER_CARD`` (exit 2 from the hive).
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_fleet import _host_oracle
from tests.test_torch_fleet import REPO, port_packages
from veles_tpu_torch.config import root
from veles_tpu_torch.parallel import MeshDevice, make_mesh

ATOL = 1e-5


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_mesh_pkgs"))
    return port_packages(d, {"alpha": 11, "beta": 22})


def _stacked_bytes(pkg):
    return sum(int(np.prod(np.shape(a))) * 4 for m in pkg["members"]
               for p in m["params"].values() for a in p.values())


def _journal(mdir, name):
    out = []
    for root_dir, _, files in os.walk(mdir):
        for f in files:
            if f.startswith("journal-") and f.endswith(".jsonl"):
                with open(os.path.join(root_dir, f)) as fh:
                    out += [e for e in map(json.loads, fh)
                            if e.get("event") == name]
    return out


def _hosted(packages, device, tmp_path):
    from veles_tpu_torch.serve.hive import load_model_package
    pristine = copy.deepcopy(dict(root.__dict__))
    saved = dict(root.__dict__)
    try:
        return [load_model_package(n, packages[n]["port_pkg"], device,
                                   str(tmp_path), pristine)
                for n in ("alpha", "beta")]
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)


@pytest.mark.parametrize("mode,sharded", [
    ("always", [True, True]), ("never", [False, False]),
    ("auto", [True, False])])
def test_residency_decides_each_placement(packages, tmp_path, monkeypatch,
                                          mode, sharded):
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.serve.residency import ResidencyManager
    monkeypatch.setenv("VELES_SERVE_MESH_SHARD", mode)
    dev = MeshDevice(make_mesh(4))
    alpha, beta = _hosted(packages, dev, tmp_path)
    one = alpha.param_bytes
    # auto: alpha's stack (3 members, 4 padded, one a place) is over the
    # budget, beta cut to its first member is not
    beta.member_params = beta.member_params[:1]
    beta.param_bytes = one // 3
    mgr = ResidencyManager(dev, budget_bytes=one - 1, max_batch=4)
    assert mgr.n_devices == 4
    for m in (alpha, beta):
        mgr.register(m)
        mgr.ensure(m.name)
    assert [m.engine.member_sharded for m in (alpha, beta)] == sharded
    # a sharded stack costs its members padded to a multiple of 4, over 4
    want = [b // p * (-(-p // 4) * 4) // 4 if s else b
            for s, b, p in zip(sharded, (one, beta.param_bytes), (3, 1))]
    assert [mgr._charge(m) for m in (alpha, beta)] == want
    if mode != "never":
        assert mgr.spills == 0 and alpha.resident and beta.resident
        assert mgr.ledger()["serve"] == sum(want) <= mgr.budget_bytes
        assert telemetry.gauge("serve.mesh_devices").value == 4
    else:
        # alpha alone is over the budget: beta's admission spills it
        assert mgr.spills == 1 and not alpha.resident
    # a restore lands on the same placement
    alpha.engine.spill_params()
    mgr.ensure("alpha")
    assert alpha.engine.member_sharded == sharded[0]
    mgr.close()


def test_one_device_never_shards(packages, tmp_path, monkeypatch):
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.serve.residency import ResidencyManager
    monkeypatch.setenv("VELES_SERVE_MESH_SHARD", "always")
    dev = make_device("cpu")
    alpha, _ = _hosted(packages, dev, tmp_path)
    mgr = ResidencyManager(dev, budget_bytes=1, max_batch=4)
    mgr.register(alpha)
    assert not mgr.ensure("alpha").member_sharded
    assert mgr._charge(alpha) == alpha.param_bytes
    mgr.close()


@pytest.fixture(scope="module")
def pair(packages, tmp_path_factory):
    from veles_tpu_torch.serve.client import HiveClient
    mdir = str(tmp_path_factory.mktemp("torch_mesh_hive"))
    model = {"alpha": packages["alpha"]["port_pkg"]}
    mesh = HiveClient(model, backend="cpu", max_batch=8, max_wait_ms=5,
                      metrics_dir=mdir, mesh=2, cwd=REPO,
                      env={"VELES_SERVE_MESH_SHARD": "always"})
    flat = HiveClient(model, backend="cpu", max_batch=8, max_wait_ms=5,
                      cwd=REPO)
    yield {"mesh": mesh, "flat": flat, "mdir": mdir}
    mesh.close()
    flat.close()


def test_mesh_hive_answers_as_the_flat_hive(pair, packages):
    h, f = pair["mesh"].hello, pair["flat"].hello
    assert h["ready"] and h["platform"] == "cpu" and h["devices"] == 2
    assert h["models"]["alpha"]["resident"]
    assert h["models"]["alpha"]["sharded"] is True
    assert f["devices"] == 1 and f["models"]["alpha"]["sharded"] is False
    rng = np.random.default_rng(99)
    for n in (1, 3, 8):
        x = rng.standard_normal((n, 6, 6, 1)).astype(np.float32)
        rm = pair["mesh"].request("alpha", x, timeout=60)
        rf = pair["flat"].request("alpha", x, timeout=60)
        got = np.asarray(rm["probs"], np.float32)
        np.testing.assert_array_equal(got, np.asarray(rf["probs"],
                                                      np.float32))
        assert rm["pred"] == rf["pred"] and rm["crc"] == rf["crc"]
        np.testing.assert_allclose(got, _host_oracle(packages["alpha"], x),
                                   atol=ATOL)
    st = pair["mesh"].stats()
    assert st["models"]["alpha"]["sharded"] is True
    assert st["models"]["alpha"]["resident"] and st["spills"] == 0
    assert st["gauges"]["serve.mesh_devices"] == 2
    assert st["ledger"]["serve"] == \
        _stacked_bytes(packages["alpha"]) // 3 * 4 // 2


def test_mesh_hive_journals_its_sharded_model(pair):
    pair["mesh"].stats()
    evs = _journal(pair["mdir"], "serve.model_sharded_resident")
    assert evs and evs[-1]["model"] == "alpha" and evs[-1]["devices"] == 2
    assert 0 < evs[-1]["per_device"] < evs[-1]["param_bytes"]


def test_a_mesh_the_cards_cannot_hold_is_refused(packages):
    with pytest.raises(ValueError, match="VELES_MESH_RANKS_PER_CARD"):
        make_mesh(2, "cuda") if not _cards() else make_mesh(
            _cards() + 1, "cuda")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "--serve-models",
         f"alpha={packages['alpha']['port_pkg']}", "-b", "cuda", "--mesh",
         "2", "--heartbeat-every", "0"], input="", capture_output=True,
        text=True, cwd=REPO, env=env, timeout=120)
    assert p.returncode == 2, p.stderr[-2000:]
    assert "--mesh 2" in p.stderr and "only 0 visible" in p.stderr
    assert "VELES_MESH_RANKS_PER_CARD" in p.stderr


def _cards():
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
