"""The wide member-sharded cohort (``tests/test_mesh_shard.py``'s): 11
wine genomes over 8 CPU places, padded to 16, against the port's
unsharded engine and the reference's sharded (8 virtual XLA:CPU
devices) and unsharded engines (``test_torch_mesh_cohort.py``'s
``check_sharded_wine``)."""

import pytest

from test_torch_mesh_cohort import check_sharded_wine
from veles_tpu_torch import prng
from veles_tpu_torch.config import root


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.delenv("VELES_MESH_SHARD_MEMBERS", raising=False)
    saved = dict(root.__dict__)
    prng._streams.clear()
    prng.seed_all(1234)
    yield
    prng._streams.clear()
    root.__dict__.clear()
    root.__dict__.update(saved)


def test_a_wide_cohort_over_8_places():
    check_sharded_wine([0.05 + 0.06 * i for i in range(11)], 8, 16)
