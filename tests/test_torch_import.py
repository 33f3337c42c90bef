"""The PyTorch/CUDA port stands alone: ``veles_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package,
and no module imports ``zmq``, ``matplotlib`` or ``PIL``, which the
card's machine does not have, when it is imported: the graphics bus
imports ``zmq`` and ``matplotlib`` inside the functions that bind a
socket or render a plot, and the master--slave mode imports ``zmq``
inside the functions that bind or connect its sockets, and nowhere
else.  The port's entry points refuse to drop silently onto the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "veles_tpu_torch")


#: what no module of the port imports: JAX and the reference, and the
#: packages the card's machine lacks
BLOCKED = ("jax", "jaxlib", "veles_tpu", "zmq", "matplotlib", "PIL")
#: of those, what a function may import when it is called (the graphics
#: bus's optional packages, and the master--slave mode's zmq), and the
#: only functions that do
LAZY = ("zmq", "matplotlib")
LAZY_SITES = {("server.py", "serve", "zmq"),
              ("client.py", "serve", "zmq"),
              ("chip_smoke.py", "_zmq_state", "zmq"),
              ("graphics_server.py", "_ensure_sock", "zmq"),
              ("graphics_server.py", "_plt", "matplotlib"),
              ("graphics_server.py", "_plt", "matplotlib.pyplot"),
              ("graphics_client.py", "serve", "zmq"),
              ("graphics_client.py", "main", "zmq")}


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in BLOCKED


def test_every_port_module_imports_with_jax_blocked():
    """A ``None`` in ``sys.modules`` makes any import of that name
    raise, so one stray import anywhere in the package fails here."""
    code = (
        "import pkgutil, sys\n"
        f"for m in {BLOCKED!r}:\n"
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
    names = [m.name for m in pkgutil.walk_packages([PKG],
                                                   "veles_tpu_torch.")]
    assert int(proc.stdout.strip()) == len(names) > 10
    assert {"veles_tpu_torch.snapshotter", "veles_tpu_torch.supervisor",
            "veles_tpu_torch.launcher", "veles_tpu_torch.normalization",
            "veles_tpu_torch.datasets", "veles_tpu_torch.loader.quantize",
            "veles_tpu_torch.loader.fullbatch",
            "veles_tpu_torch.loader.synthetic", "veles_tpu_torch.models.mnist",
            "veles_tpu_torch.models.mnist7",
            "veles_tpu_torch.models.cifar10",
            "veles_tpu_torch.models.mnist_ae",
            "veles_tpu_torch.models.kohonen", "veles_tpu_torch.ops.deconv",
            "veles_tpu_torch.ops.depooling", "veles_tpu_torch.ops.kohonen",
            "veles_tpu_torch.ops.evaluator", "veles_tpu_torch.ops.activation",
            "veles_tpu_torch.ops.cutter", "veles_tpu_torch.ops.rbm",
            "veles_tpu_torch.ops.resizable_all2all",
            "veles_tpu_torch.models.wine", "veles_tpu_torch.models.mnist_rbm",
            "veles_tpu_torch.models.mnist_dbn",
            "veles_tpu_torch.profiling", "veles_tpu_torch.genetics",
            "veles_tpu_torch.genetics.core",
            "veles_tpu_torch.genetics.worker",
            "veles_tpu_torch.genetics.pool",
            "veles_tpu_torch.ensemble.core",
            "veles_tpu_torch.ops.population", "veles_tpu_torch.knobs",
            "veles_tpu_torch.serve.protocol",
            "veles_tpu_torch.serve.client", "veles_tpu_torch.online",
            "veles_tpu_torch.online.buffer", "veles_tpu_torch.online.tap",
            "veles_tpu_torch.online.promote",
            "veles_tpu_torch.online.trainer",
            "veles_tpu_torch.genetics.handoff",
            "veles_tpu_torch.telemetry", "veles_tpu_torch.events",
            "veles_tpu_torch.logger",
            "veles_tpu_torch.faults", "veles_tpu_torch.serve.fleet",
            "veles_tpu_torch.serve.sentinel",
            "veles_tpu_torch.serve.router", "veles_tpu_torch.tools",
            "veles_tpu_torch.tools.obs_report",
            "veles_tpu_torch.tools.chaos_drill",
            "veles_tpu_torch.tools.gauntlet",
            "veles_tpu_torch.serve.autoscale",
            "veles_tpu_torch.serve.traffic", "veles_tpu_torch.trace",
            "veles_tpu_torch.obs",
            "veles_tpu_torch.analysis.witness",
            "veles_tpu_torch.export", "veles_tpu_torch.native",
            "veles_tpu_torch.mutable", "veles_tpu_torch.units",
            "veles_tpu_torch.workflow", "veles_tpu_torch.memory",
            "veles_tpu_torch.accelerated_units",
            "veles_tpu_torch.graphics_server",
            "veles_tpu_torch.graphics_client",
            "veles_tpu_torch.plotting_units", "veles_tpu_torch.web_status",
            "veles_tpu_torch.analysis.engine",
            "veles_tpu_torch.analysis.rules",
            "veles_tpu_torch.analysis.flow",
            "veles_tpu_torch.analysis.concurrency",
            "veles_tpu_torch.analysis.cli",
            "veles_tpu_torch.tools.veleslint",
            "veles_tpu_torch.parallel", "veles_tpu_torch.parallel.mesh",
            "veles_tpu_torch.parallel.data_parallel",
            "veles_tpu_torch.distributable", "veles_tpu_torch.server",
            "veles_tpu_torch.client", "veles_tpu_torch.forge",
            "veles_tpu_torch.tools.scaling_model"} <= set(names)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn_of = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                fn_of.setdefault(node, fn.name)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            mods = [node.module]
        else:
            continue
        for m in mods:
            if not _forbidden(m):
                continue
            site = (os.path.basename(path), fn_of.get(node), m)
            if m.split(".")[0] in LAZY and site in LAZY_SITES:
                continue
            bad.append(m)
    assert not bad, f"{path} imports {bad}"


def test_data_files_cli_runs_without_jax(tmp_path):
    """``python -m veles_tpu_torch.datasets`` writes the files with JAX
    and the reference blocked."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'veles_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['datasets', 'make-mnist-idx', sys.argv[1], "
        "'--n-train', '4', '--n-test', '2']\n"
        "runpy.run_module('veles_tpu_torch.datasets', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(os.listdir(tmp_path)) == 4


def test_supervisor_and_snapshot_envelope_import_without_torch():
    """The supervisor sits beside a training child for the whole run: it
    must not load torch, and neither may what it probes snapshots with
    (the CRC envelope, read without unpickling)."""
    code = (
        "import sys\n"
        "for m in ('torch', 'jax', 'jaxlib', 'veles_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from veles_tpu_torch import supervisor, snapshotter\n"
        "from veles_tpu_torch import __main__\n"
        "assert not snapshotter.verify_snapshot('no such file')\n"
        "print(supervisor.EXIT_PREEMPTED)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "14"


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


@pytest.mark.parametrize("args", [[], ["--only", "fleet"]])
def test_chip_smoke_names_the_phase_that_failed(args):
    """A phase's exception of any type (here the first phase's, with a
    card claimed but none there) is named on stdout, ``phase NAME: FAIL:
    <type>: <message>``, with its traceback on stderr; the exit code is 1
    and no result line is printed."""
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py'] + sys.argv[1:]\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    (line,) = proc.stdout.splitlines()
    assert line.startswith("phase build: FAIL: ")
    kind = line[len("phase build: FAIL: "):].split(":")[0]
    assert kind in ("AssertionError", "RuntimeError")
    assert "Traceback (most recent call last)" in proc.stderr
    assert '"ok"' not in proc.stdout


def _blocked_run(args, blocked, tmp_path):
    """``python -m veles_tpu_torch ARGS`` with the ``blocked`` packages
    made unimportable."""
    code = ("import runpy, sys\n"
            f"for m in {blocked!r}:\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['veles_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('veles_tpu_torch', run_name='__main__',"
            " alter_sys=True)\n")
    env = dict(os.environ, VELES_PLOTS_DIR=str(tmp_path / "plots"))
    return subprocess.run([sys.executable, "-c", code] + args, cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("flags,package", [
    (["-p"], "matplotlib"),
    (["--plots-endpoint", "tcp://127.0.0.1:5999"], "zmq"),
])
def test_plot_flags_refused_without_their_package(flags, package,
                                                  tmp_path):
    """``-p`` without matplotlib and ``--plots-endpoint`` without zmq
    exit 2 naming the package, before the config or the card: a CUDA
    backend is asked for and the workflow file does not exist."""
    blocked = ("jax", "jaxlib", "veles_tpu", package)
    proc = _blocked_run(flags + ["-b", "cuda", "no_such_workflow.py"],
                        blocked, tmp_path)
    assert proc.returncode == 2, proc.stderr
    assert package in proc.stderr and "needs" in proc.stderr
    assert not (tmp_path / "plots").exists()


@pytest.mark.parametrize("flag", ["--listen-address", "--master-address"])
def test_master_slave_flags_refused_without_zmq(flag, tmp_path):
    """``--listen-address`` and ``--master-address`` exit 2 naming zmq
    where it does not import, before the config or the card, as on the
    card's machine; ``--dp`` does not get past the refusal either."""
    blocked = ("jax", "jaxlib", "veles_tpu", "zmq")
    for extra in ([], ["--dp", "2"]):
        proc = _blocked_run([flag, "tcp://127.0.0.1:0", "-b", "cuda", *extra,
                             "no_such_workflow.py"], blocked, tmp_path)
        assert proc.returncode == 2, proc.stderr
        assert "needs zmq" in proc.stderr and flag in proc.stderr


def test_graphics_client_names_zmq_when_it_is_missing():
    code = ("import runpy, sys\n"
            "sys.modules['zmq'] = None\n"
            "sys.argv = ['graphics_client', 'tcp://127.0.0.1:5998']\n"
            "runpy.run_module('veles_tpu_torch.graphics_client',"
            " run_name='__main__', alter_sys=True)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "zmq" in proc.stderr
