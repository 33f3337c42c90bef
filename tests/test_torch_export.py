"""The port's VTPN export (``veles_tpu_torch/export.py``) against the
reference's (``veles_tpu/export.py``).

- For each net of ``tests/test_native.py`` and a tiny AlexNet-shaped net
  with both ``norm`` layers, the same params (drawn from a seed with
  numpy, loaded into both packages' workflows) give byte for byte the
  reference's file.
- The op, activation and attribute enums are ``native/src/libveles.cc``'s.
- A unit without a native equivalent raises the reference's message.
"""

import os
import re

import pytest

from torch_export_fixtures import NETS, build_pair
from veles_tpu import export as ref_export
from veles_tpu.ops import rbm as ref_rbm
from veles_tpu_torch import export
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.ops import rbm

LIBVELES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "src", "libveles.cc")


@pytest.mark.parametrize("name", sorted(NETS))
def test_file_is_byte_for_byte_the_references(name, tmp_path):
    ref, port, params = build_pair(name)
    want = ref_export.export_model(ref, str(tmp_path / "ref.vtpn"))
    got = export.export_model(port, str(tmp_path / "port.vtpn"))
    assert got == str(tmp_path / "port.vtpn")
    with open(want, "rb") as f:
        want_bytes = f.read()
    with open(got, "rb") as f:
        got_bytes = f.read()
    assert got_bytes[:4] == b"VTPN"
    n_floats = sum(a.size for ps in params.values() for a in ps.values())
    assert len(got_bytes) > 4 * n_floats
    assert got_bytes == want_bytes
    # only the temp-file-and-rename's result is left
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["port.vtpn", "ref.vtpn"]


def test_export_writes_the_runners_current_params(tmp_path):
    _, port, params = build_pair("dense_net")
    a = export.export_model(port, str(tmp_path / "a.vtpn"))
    name = port.forwards[0].name
    params[name]["bias"] = params[name]["bias"] + 1.0
    port.fused.set_host_params(params_from_jax(params))
    b = export.export_model(port, str(tmp_path / "b.vtpn"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = fa.read(), fb.read()
    assert len(da) == len(db) and da != db
    # the shifted bias is in the file, in f32
    want = params[name]["bias"].tobytes()
    assert want in db and want not in da


def _enum(text, name):
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def test_enums_are_libveles():
    with open(LIBVELES) as f:
        text = f.read()
    ops = _enum(text, "OpType")
    assert ops == {k: getattr(export, k) for k in ops}
    assert len(ops) == 10
    acts = _enum(text, "Act")
    assert {k[len("ACT_"):].lower(): v for k, v in acts.items()} == \
        export.ACT
    attrs = _enum(text, "AttrKey")
    assert attrs == {k: getattr(export, k) for k in attrs}
    assert len(attrs) == 11
    assert (export.MAGIC, export.VERSION) == \
        (ref_export.MAGIC, ref_export.VERSION)


def test_a_unit_without_a_native_op_raises_the_references_message():
    ref_u = ref_rbm.RBM(None, n_hidden=4, name="fwd0_rbm")
    port_u = rbm.RBM(None, n_hidden=4, name="fwd0_rbm")
    with pytest.raises(ValueError) as want:
        ref_export._op_record(ref_u)
    with pytest.raises(ValueError) as got:
        export._op_record(port_u, {})
    assert str(got.value) == str(want.value)
    assert "fwd0_rbm (RBM) has no native inference equivalent" in \
        str(got.value)


def test_a_workflow_without_forwards_raises(tmp_path):
    class Empty:
        forwards = []
    with pytest.raises(ValueError, match="no forward units"):
        export.export_model(Empty(), str(tmp_path / "e.vtpn"))
    assert not list(tmp_path.iterdir())
