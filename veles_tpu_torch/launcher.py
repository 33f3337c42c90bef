"""The launcher: the device and seed around a workflow, and loading
workflow modules and config files.

Counterpart of ``veles_tpu/launcher.py`` (``Launcher``,
``drive_workflow``, ``load_workflow_module``, ``apply_config_file``),
standalone mode only: no snapshots, no data-parallel mesh, no
master/slave, no profiler.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import sys
from typing import Any

from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root

log = logging.getLogger("veles.launcher")


class Launcher:
    """Seeds every named stream (``prng.seed_all``) and makes the device
    (``make_device``: the card unless ``backend="cpu"``; a missing card
    raises)."""

    def __init__(self, backend: str = "auto", seed: int = 1234) -> None:
        self.backend = backend
        prng.seed_all(seed)
        self.device = make_device(backend)
        self.workflow = None
        log.info("launcher: backend=%s device=%r", backend, self.device)

    def create_workflow(self, factory, **kwargs: Any):
        """``factory(launcher, **kwargs)`` -> workflow."""
        self.workflow = factory(self, **kwargs)
        return self.workflow

    def initialize(self) -> None:
        self.workflow.initialize(device=self.device, train=True)

    def run(self) -> None:
        self.workflow.run()


def load_workflow_module(path: str):
    """Import a workflow file (a plain Python file, not necessarily on
    ``sys.path``)."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def apply_config_file(path: str) -> None:
    """Execute a config file for its side effect of mutating ``root``."""
    glb = {"root": root, "__file__": path, "__name__": "__veles_config__"}
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, glb)


def drive_workflow(launcher: Launcher, workflow_file: str) -> None:
    """Load a workflow module and drive it through the launcher: its
    ``run(launcher)``, or else create, initialize and run its
    ``create_workflow(launcher)``."""
    mod = load_workflow_module(workflow_file)
    if hasattr(mod, "run"):
        mod.run(launcher)
    elif hasattr(mod, "create_workflow"):
        launcher.create_workflow(getattr(mod, "create_workflow"))
        launcher.initialize()
        launcher.run()
    else:
        raise RuntimeError(
            f"{workflow_file}: defines neither run(launcher) nor "
            "create_workflow(launcher)")
