"""The native C++ runtime run by the port (``veles_tpu_torch/native.py``):
the counterparts of ``tests/test_native.py``, and the port's build.

- Each net's file (the port's export of params drawn from a seed)
  answers through ``NativeModel`` within the reference's tolerance of
  the port's f32 eval forward on the CPU (atol 1e-4 where a conv, LRN
  or deconv sums many terms, else 1e-5, as ``tests/test_native.py``
  sets them test by test); softmax rows sum to 1.
- A net trained by the port on the CPU, exported and answered.
- Metadata, a bad file, a truncated file and a wrong input shape.
- The build: ``$CXX``/``g++`` directly (a ``make`` on PATH that would
  leave a mark is never run), only under the build dir given, two
  builders at once in two processes both load, and a failed build
  raises with the compiler's output.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from torch_export_fixtures import NETS, build_pair, port_forward, \
    sample_rows
from veles_tpu_torch import export, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROUNDTRIP = ["dense_net", "conv_net_with_everything",
             "avgpool_and_stochpool", "autoencoder_with_deconv", "dbn_mlp",
             "alexnet_tiny"]


def _export(port, tmp_path, name="model.vtpn"):
    return export.export_model(port, str(tmp_path / name))


@pytest.mark.parametrize("name", ROUNDTRIP)
def test_native_answers_the_ports_forward(name, tmp_path):
    _, port, _ = build_pair(name)
    atol = NETS[name][3]
    model = native.NativeModel(_export(port, tmp_path))
    x = sample_rows(name)
    want = port_forward(port, x)
    got = model.run(x)
    model.close()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    if NETS[name][1] == "softmax":
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_a_net_trained_by_the_port_answers_through_native(tmp_path):
    _, port, params = build_pair("conv_net_with_everything")
    port.run()
    name = port.forwards[0].name
    assert not np.array_equal(port.fused.host_params()[name]["bias"],
                              params[name]["bias"])
    model = native.NativeModel(_export(port, tmp_path))
    x = sample_rows("conv_net_with_everything")
    got = model.run(x)
    np.testing.assert_allclose(got, port_forward(port, x), atol=1e-4)
    assert (got.argmax(-1) == port_forward(port, x).argmax(-1)).all()
    model.close()


def test_model_metadata(tmp_path):
    _, port, _ = build_pair("model_metadata")
    m = native.NativeModel(_export(port, tmp_path))
    assert m.input_shape == (12, 12, 1)
    assert m.output_size == 4
    assert m.num_ops == 1
    m.close()
    m.close()   # idempotent


def test_bad_file_rejected(tmp_path):
    bad = tmp_path / "junk.vtpn"
    bad.write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        native.NativeModel(str(bad))


def test_truncated_file_rejected(tmp_path):
    _, port, _ = build_pair("truncated_file")
    path = tmp_path / "m.vtpn"
    export.export_model(port, str(path))
    data = path.read_bytes()
    (tmp_path / "trunc.vtpn").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated|corrupt"):
        native.NativeModel(str(tmp_path / "trunc.vtpn"))


def test_wrong_input_shape_rejected(tmp_path):
    _, port, _ = build_pair("wrong_input_shape")
    m = native.NativeModel(_export(port, tmp_path))
    with pytest.raises(ValueError, match="sample shape"):
        m.run(np.zeros((2, 5, 5, 1), np.float32))
    m.close()


# -- the build -------------------------------------------------------------

_BUILD = (
    "import ctypes, sys\n"
    "from veles_tpu_torch import native\n"
    "lib = native.ensure_built(sys.argv[1])\n"
    "ctypes.CDLL(lib).veles_num_ops\n"
    "print(lib)\n"
    "print(native.cli_path(sys.argv[1]))\n")


def test_two_builds_at_once_both_load_without_make(tmp_path):
    build_dir = tmp_path / "build"
    fake = tmp_path / "bin"
    fake.mkdir()
    mark = tmp_path / "make-ran"
    (fake / "make").write_text(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    (fake / "make").chmod(0o755)
    env = dict(os.environ, PATH=f"{fake}{os.pathsep}"
               f"{os.environ.get('PATH', '')}")
    env.pop("CXX", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, str(build_dir)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = [out.split() for out, _ in outs]
    assert paths[0] == paths[1]
    for path in paths[0]:
        assert os.path.commonpath([path, str(build_dir)]) == str(build_dir)
        assert os.access(path, os.X_OK)
    # nothing but the two outputs: no builder's temp file is left
    assert sorted(os.listdir(build_dir)) == \
        sorted(os.path.basename(p) for p in paths[0])
    assert not mark.exists()
    # the CLI runs a model
    _, port, _ = build_pair("model_metadata")
    model = _export(port, tmp_path)
    x = tmp_path / "x.f32"
    rows = sample_rows("model_metadata", 2)
    rows.astype(np.float32).tofile(x)
    proc = subprocess.run([paths[0][1], model, str(x), "2"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    printed = np.array([[float(v) for v in line.split()]
                        for line in proc.stdout.splitlines()])
    np.testing.assert_allclose(printed, port_forward(port, rows),
                               atol=1e-5)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ["-fno-such-option-veles"])
    with pytest.raises(RuntimeError) as e:
        native.ensure_built(str(tmp_path))
    msg = str(e.value)
    assert "native build failed" in msg
    assert "-fno-such-option-veles" in msg
    assert not os.listdir(tmp_path)


def test_the_default_build_dir_is_the_ports_own():
    assert native.BUILD_DIR == os.path.join(REPO, "veles_tpu_torch",
                                            "_build")
    lib = native.ensure_built()
    assert os.path.dirname(lib) == native.BUILD_DIR
