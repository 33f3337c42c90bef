"""Over budget, after ``tests/test_serve_mesh.py:266-335``: with one
place's budget under one model's stack, a ``--serve-models --mesh 4 -b
cpu`` replica holds both of the tier-1 fleet's models member-sharded and
resident with 0 spills, and a flat replica at the same budget spills
(``test_torch_mesh_serve.py``'s packages and journal reader)."""

import numpy as np
import pytest

from tests.test_fleet import _host_oracle
from tests.test_torch_fleet import REPO
from tests.test_torch_mesh_serve import (ATOL, _journal,  # noqa: F401
                                         _stacked_bytes, packages)


@pytest.mark.parametrize("mesh", [4, 0])
def test_over_budget_mesh_holds_both_and_flat_spills(packages, mesh,
                                                     tmp_path):
    from veles_tpu_torch.serve.client import HiveClient
    # between two sharded models' charge a place (3 members pad to 4, one
    # a place: a third of a stack each) and one model's whole stack
    budget = _stacked_bytes(packages["alpha"]) * 3 // 4
    mdir = str(tmp_path / "m")
    c = HiveClient({"alpha": packages["alpha"]["port_pkg"],
                    "beta": packages["beta"]["port_pkg"]},
                   backend="cpu", max_batch=8, max_wait_ms=5,
                   hbm_budget=budget, metrics_dir=mdir, mesh=mesh, cwd=REPO,
                   env={"VELES_SERVE_MESH_SHARD": "auto"})
    try:
        h = c.hello
        x = np.ones((2, 6, 6, 1), np.float32)
        for name in ("alpha", "beta", "alpha", "beta"):
            r = c.request(name, x, timeout=60)
            np.testing.assert_allclose(np.asarray(r["probs"]),
                                       _host_oracle(packages[name], x),
                                       atol=ATOL)
        st = c.stats()
    finally:
        c.close()
    if mesh:
        assert all(h["models"][n]["resident"] and h["models"][n]["sharded"]
                   for n in ("alpha", "beta")), h
        assert st["gauges"]["serve.models_resident"] == 2
        assert st["gauges"]["serve.mesh_devices"] == 4
        assert 0 < st["gauges"]["serve.resident_bytes_per_device"] <= budget
        assert st["spills"] == 0
        assert {e["model"] for e in _journal(
            mdir, "serve.model_sharded_resident")} == {"alpha", "beta"}
        assert not _journal(mdir, "serve.model_spilled")
    else:
        assert sum(m["resident"] for m in h["models"].values()) == 1
        assert st["spills"] >= 2 and _journal(mdir, "serve.model_spilled")
        assert not _journal(mdir, "serve.model_sharded_resident")
