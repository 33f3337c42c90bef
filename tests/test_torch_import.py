"""The PyTorch/CUDA port stands alone: ``veles_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package,
and the port's entry points refuse to drop silently onto the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "veles_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "veles_tpu")


def test_every_port_module_imports_with_jax_blocked():
    """A ``None`` in ``sys.modules`` makes any import of that name
    raise, so one stray import anywhere in the package fails here."""
    code = (
        "import pkgutil, sys\n"
        "for m in ('jax', 'jaxlib', 'veles_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import veles_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    veles_tpu_torch.__path__, 'veles_tpu_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = sum(1 for _ in pkgutil.walk_packages([PKG], "veles_tpu_torch."))
    assert int(proc.stdout.strip()) == want > 10


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_make_device_auto_raises_without_a_card(monkeypatch):
    from veles_tpu_torch.backends import make_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_device(backend)
    dev = make_device("cpu")
    assert dev.platform == "cpu" and dev.compute_dtype == torch.float32
    with pytest.raises(ValueError):
        make_device("tpu")


def test_chip_smoke_fails_without_a_card():
    """No CUDA device (none visible): a nonzero exit and no result
    line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
