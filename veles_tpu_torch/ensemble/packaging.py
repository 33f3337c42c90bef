"""Ensemble members <-> npz <-> Forge package (the port's own copy).

Counterpart of ``veles_tpu/ensemble/packaging.py`` (``save_members``,
``load_members``, ``pack_ensemble``, ``normalize_npz_path``) with the
same wire format: one
npz of ``m<i>|<forward>|<param>`` arrays plus a JSON
``__meta__`` record per member (seed, valid_error, forward_names,
values).  The arrays are in the REFERENCE's layout, which is what makes
one members file serve both frameworks: the port maps them onto its own
layout with ``convert.params_from_jax`` after loading.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.forge import ForgePackage

_SEP = "|"
_META = "__meta__"


def normalize_npz_path(path: str) -> str:
    """The on-disk path of an npz: numpy's ``savez`` appends ``.npz``
    when it is missing, so every save and load applies this same rule
    (``--ensemble-test`` loads what ``--ensemble-train`` saved under the
    same flag value)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_members(path: str, members: List[Dict[str, Any]]) -> str:
    """Serialize member dicts (``params``, ``seed``, ``valid_error``,
    ``forward_names``, optional ``values``) to one npz; returns the
    on-disk path (numpy appends ``.npz`` when missing)."""
    if not members:
        raise ValueError("empty ensemble")
    arrays: Dict[str, np.ndarray] = {}
    meta = []
    for i, m in enumerate(members):
        meta.append({"seed": m["seed"],
                     "valid_error": m["valid_error"],
                     "forward_names": m["forward_names"],
                     "values": m.get("values")})
        for fname, p in m["params"].items():
            for pname, arr in p.items():
                if _SEP in fname or _SEP in pname:
                    raise ValueError(f"name {fname!r}/{pname!r} "
                                     f"contains {_SEP!r}")
                arrays[f"m{i}{_SEP}{fname}{_SEP}{pname}"] = \
                    np.asarray(arr)
    arrays[_META] = np.frombuffer(json.dumps(meta).encode(),
                                  np.uint8).copy()
    # stored, not deflated: float weights deflate slowly and hardly at
    # all (np.load reads the reference's compressed files the same way)
    np.savez(path, **arrays)
    return normalize_npz_path(path)


def load_members(path: str) -> List[Dict[str, Any]]:
    """Inverse of :func:`save_members`.  Weightless forwards (pooling,
    LRN, dropout) get an empty params dict each."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META]))
        members: List[Dict[str, Any]] = []
        for i, md in enumerate(meta):
            params: Dict[str, Dict[str, np.ndarray]] = {
                fn: {} for fn in md.get("forward_names", [])}
            prefix = f"m{i}{_SEP}"
            for key in z.files:
                if key.startswith(prefix):
                    _, fname, pname = key.split(_SEP, 2)
                    params.setdefault(fname, {})[pname] = z[key]
            members.append(dict(md, params=params))
    return members


def pack_ensemble(out_path: str, name: str,
                  members: List[Dict[str, Any]], workflow_file: str,
                  config_files: Optional[List[str]] = None,
                  version: str = "1.0.0", author: str = "",
                  description: str = "") -> str:
    """A Forge package whose snapshot is the members npz and whose
    entry is ``workflow_file``."""
    with tempfile.TemporaryDirectory() as tmp:
        npz = save_members(os.path.join(tmp, f"{name}_members.npz"),
                           members)
        return ForgePackage.pack(
            out_path, name, workflow_file, config_files=config_files,
            snapshot=npz, version=version, author=author,
            description=description or
            f"ensemble of {len(members)} members")
