"""Loading workflow modules and config files (the serving subset of
``veles_tpu/launcher.py``)."""

from __future__ import annotations

import importlib.util
import os
import sys

from veles_tpu_torch.config import root


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
