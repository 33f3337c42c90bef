"""Forge packages: pack, read and install (the port's own copy).

Counterpart of ``veles_tpu/forge.py:ForgePackage`` (``pack``,
``read_manifest``, ``install``), reading and writing the same wire
format: a ``.tar.gz`` holding ``manifest.json`` first (name, version,
entry, configs, snapshot, sha256 of every file), the workflow entry
module, config files and an optional snapshot.  The marketplace
(serve / publish / fetch) is not ported.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tarfile
import tempfile
import time
from typing import Any, Dict, List, Optional

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ForgePackage:
    @staticmethod
    def pack(out_path: str, name: str, workflow_file: str,
             config_files: Optional[List[str]] = None,
             snapshot: Optional[str] = None,
             version: str = "1.0.0", author: str = "",
             description: str = "") -> str:
        files = [workflow_file] + list(config_files or [])
        if snapshot:
            files.append(snapshot)
        for f in files:
            if not os.path.isfile(f):
                raise FileNotFoundError(f)
        bases = [os.path.basename(f) for f in files]
        if len(set(bases)) != len(bases):
            raise ValueError(f"duplicate file name in package: {bases}")
        manifest = {
            "format_version": FORMAT_VERSION,
            "name": name,
            "version": version,
            "author": author,
            "description": description,
            "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "entry": os.path.basename(workflow_file),
            "configs": [os.path.basename(c) for c in (config_files or [])],
            "snapshot": os.path.basename(snapshot) if snapshot else None,
            "sha256": {os.path.basename(f): _sha256(f) for f in files},
        }
        blob = json.dumps(manifest, indent=2).encode()
        with tarfile.open(out_path, "w:gz") as tar:
            info = tarfile.TarInfo(MANIFEST)
            info.size = len(blob)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(blob))
            for f in files:
                tar.add(f, arcname=os.path.basename(f))
        return out_path

    @staticmethod
    def read_manifest(pkg_path: str) -> Dict[str, Any]:
        with tarfile.open(pkg_path, "r:gz") as tar:
            # pack() writes the manifest first: no need to decompress
            # the whole archive to find it
            member = tar.next()
            if member is None or member.name != MANIFEST:
                member = tar.getmember(MANIFEST)
            if not member.isfile():
                raise ValueError(
                    f"bad manifest member in {pkg_path!r}: not a file")
            manifest = json.loads(tar.extractfile(member).read())
        if manifest.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"package format {manifest['format_version']} is newer "
                f"than this framework understands ({FORMAT_VERSION})")
        return manifest

    @staticmethod
    def install(pkg_path: str, dest_dir: str,
                verify: bool = True) -> Dict[str, Any]:
        """Extract and checksum-verify; returns the manifest with a
        'root' key naming the extracted directory."""
        manifest = ForgePackage.read_manifest(pkg_path)
        target = os.path.join(dest_dir,
                              f"{manifest['name']}-{manifest['version']}")
        os.makedirs(dest_dir, exist_ok=True)
        # extract + verify in a staging dir so a failed verification
        # never leaves tampered files at the install path
        staging = tempfile.mkdtemp(dir=dest_dir, prefix=".staging-")
        try:
            with tarfile.open(pkg_path, "r:gz") as tar:
                for member in tar.getmembers():
                    mpath = os.path.normpath(member.name)
                    if mpath.startswith("..") or os.path.isabs(mpath) \
                            or not (member.isfile() or member.isdir()):
                        raise ValueError(
                            f"unsafe member in package: {member.name!r}")
                    if verify and member.isfile() and mpath != MANIFEST \
                            and mpath not in manifest["sha256"]:
                        raise ValueError(
                            f"package member {member.name!r} is not "
                            f"listed in the manifest checksums")
                tar.extractall(staging, filter="data")
            if verify:
                for fname, want in manifest["sha256"].items():
                    got = _sha256(os.path.join(staging, fname))
                    if got != want:
                        raise ValueError(
                            f"checksum mismatch for {fname}: "
                            f"{got[:12]} != {want[:12]}")
            if os.path.isdir(target):
                shutil.rmtree(target)
            os.rename(staging, target)
        except Exception:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        manifest["root"] = target
        return manifest
