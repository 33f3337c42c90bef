"""Forge: package, inspect, install and share trained workflows (the
port's own copy of ``veles_tpu/forge.py``).

``ForgePackage`` (``pack``, ``read_manifest``, ``install``,
``list_store``) reads and writes the reference's package format: a
``.tar.gz`` holding ``manifest.json`` first (name, version, entry,
configs, snapshot, sha256 of every file), the workflow entry module,
config files and an optional snapshot.

The marketplace is the reference's over the same HTTP wire, so either
package's client talks to either package's server:

    GET  /forge/list          -> JSON array of manifests (+ "file")
    GET  /forge/pkg/FILE      -> the package's bytes
    POST /forge/upload/FILE   (body: the package) -> its manifest

``make_forge_server`` serves a store directory (stdlib
``ThreadingHTTPServer``; no authentication: bind a trusted interface,
loopback by default).  An upload's name must be a plain ``.vpkg`` /
``.tar.gz`` file name, its ``Content-Length`` in (0, 2 GiB]; it is
staged in the store, must read as a manifested package, and only then
lands under its name (``os.replace``); a rejected upload leaves nothing.
``publish`` streams a package from disk to a server; ``fetch`` takes
the newest version of a name (the listing's ``file`` checked as an
upload's name is), streams it to a staging file, validates its
manifest and only then gives it its name: a failed fetch leaves
nothing behind.

    python -m veles_tpu_torch.forge pack OUT.vpkg --name X WORKFLOW.py \
        [CONFIG.py ...] [--snapshot SNAP] [--version V] [--author A]
        [--description D]
    python -m veles_tpu_torch.forge info    PKG.vpkg
    python -m veles_tpu_torch.forge install PKG.vpkg [DEST_DIR]
    python -m veles_tpu_torch.forge list    [STORE_DIR]
    python -m veles_tpu_torch.forge serve   [STORE_DIR] [--port 8188]
        [--host 127.0.0.1]
    python -m veles_tpu_torch.forge publish PKG.vpkg http://HOST:PORT
    python -m veles_tpu_torch.forge fetch   NAME http://HOST:PORT [DEST_DIR]
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
        # a gzip container at level 0: every reader opens it as it opens
        # the reference's ("r:gz"), and the float weights that fill a
        # package deflate slowly and hardly at all
        with tarfile.open(out_path, "w:gz", compresslevel=0) as tar:
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

    @staticmethod
    def list_store(store_dir: str) -> List[Dict[str, Any]]:
        """The manifests of the store's packages (each with its
        ``file``), by file name; unreadable files are left out."""
        out = []
        if not os.path.isdir(store_dir):
            return out
        for fn in sorted(os.listdir(store_dir)):
            if fn.endswith((".vpkg", ".tar.gz")):
                try:
                    m = ForgePackage.read_manifest(
                        os.path.join(store_dir, fn))
                except (tarfile.TarError, KeyError, ValueError):
                    continue
                m["file"] = fn
                out.append(m)
        return out


# -- the marketplace over HTTP ------------------------------------------

#: the largest upload a server takes
MAX_UPLOAD = 1 << 31


def _safe_pkg_name(name: str) -> str:
    base = os.path.basename(name)
    if base != name or not base.endswith((".vpkg", ".tar.gz")) \
            or base.startswith("."):
        raise ValueError(f"bad package file name: {name!r}")
    return base


def make_forge_server(store_dir: str, port: int = 0,
                      host: str = "127.0.0.1"):
    """The HTTP marketplace over ``store_dir``: a
    ``ThreadingHTTPServer`` (the caller runs ``serve_forever``, in a
    thread or not, and ``shutdown``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    os.makedirs(store_dir, exist_ok=True)

    class Handler(BaseHTTPRequestHandler):
        timeout = 60  # a stalled upload frees its thread and staging

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj: Any) -> None:
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/forge/list":
                return self._json(200, ForgePackage.list_store(store_dir))
            if self.path.startswith("/forge/pkg/"):
                try:
                    fn = _safe_pkg_name(self.path[len("/forge/pkg/"):])
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                full = os.path.join(store_dir, fn)
                if not os.path.isfile(full):
                    return self._json(404, {"error": f"no such package "
                                                     f"{fn}"})
                self.send_response(200)
                self.send_header("Content-Type", "application/gzip")
                self.send_header("Content-Length",
                                 str(os.path.getsize(full)))
                self.end_headers()
                with open(full, "rb") as f:
                    shutil.copyfileobj(f, self.wfile)
                return None
            return self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if not self.path.startswith("/forge/upload/"):
                return self._json(404, {"error": "unknown endpoint"})
            try:
                fn = _safe_pkg_name(self.path[len("/forge/upload/"):])
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = -1
            if not 0 < length <= MAX_UPLOAD:
                return self._json(400, {"error": "bad content length"})
            fd, staging = tempfile.mkstemp(dir=store_dir,
                                           prefix=".upload-")
            try:
                with os.fdopen(fd, "wb") as f:
                    remaining = length
                    while remaining:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            raise ValueError("truncated upload")
                        f.write(chunk)
                        remaining -= len(chunk)
                manifest = ForgePackage.read_manifest(staging)
                os.replace(staging, os.path.join(store_dir, fn))
            except Exception as e:  # noqa: BLE001 — the client's answer
                try:
                    os.unlink(staging)
                except OSError:
                    pass
                return self._json(400, {"error": f"rejected: {e}"})
            manifest["file"] = fn
            return self._json(200, manifest)

    return ThreadingHTTPServer((host, port), Handler)


def _http_error_detail(e) -> str:
    """The server's JSON ``error`` of an ``HTTPError``."""
    try:
        return json.loads(e.read()).get("error", str(e))
    except Exception:  # noqa: BLE001 — best effort
        return str(e)


def publish(pkg_path: str, url: str) -> Dict[str, Any]:
    """Upload a package to a forge server, streamed from disk; returns
    its manifest as the server read it."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    fn = _safe_pkg_name(os.path.basename(pkg_path))
    size = os.path.getsize(pkg_path)
    with open(pkg_path, "rb") as f:
        req = Request(f"{url.rstrip('/')}/forge/upload/{fn}", data=f,
                      headers={"Content-Type": "application/gzip",
                               "Content-Length": str(size)})
        try:
            with urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())
        except HTTPError as e:
            raise RuntimeError(
                f"publish refused: {_http_error_detail(e)}") from e


def _version_key(m: Dict[str, Any]) -> tuple:
    return tuple(int(p) if p.isdigit() else 0
                 for p in str(m.get("version", "0")).split("."))


def fetch(name: str, url: str, dest_dir: str = ".") -> str:
    """Download the newest package named ``name`` into ``dest_dir``;
    returns its path."""
    from urllib.request import urlopen

    base = url.rstrip("/")
    with urlopen(f"{base}/forge/list", timeout=60) as resp:
        listing = json.loads(resp.read())
    matches = [m for m in listing if m.get("name") == name]
    if not matches:
        raise FileNotFoundError(
            f"no package named {name!r} on {url} "
            f"(available: {sorted({m.get('name') for m in listing})})")
    # the listing's "file" comes from the server: check it before it
    # reaches a path or a URL, as the server checks an upload's name
    fn = _safe_pkg_name(max(matches, key=_version_key)["file"])
    os.makedirs(dest_dir, exist_ok=True)
    out_path = os.path.join(dest_dir, fn)
    fd, staging = tempfile.mkstemp(dir=dest_dir, prefix=".fetch-")
    f = os.fdopen(fd, "wb")  # own the fd before anything can raise
    try:
        with urlopen(f"{base}/forge/pkg/{fn}", timeout=300) as r:
            shutil.copyfileobj(r, f)
        f.close()
        ForgePackage.read_manifest(staging)  # validate, or raise
        os.replace(staging, out_path)
    except Exception:
        f.close()
        try:
            os.unlink(staging)
        except OSError:
            pass
        raise
    return out_path


def build_parser():
    import argparse

    p = argparse.ArgumentParser(prog="veles_tpu_torch.forge",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pk = sub.add_parser("pack")
    pk.add_argument("out")
    pk.add_argument("workflow")
    pk.add_argument("configs", nargs="*")
    pk.add_argument("--name", required=True)
    pk.add_argument("--version", default="1.0.0")
    pk.add_argument("--author", default="")
    pk.add_argument("--description", default="")
    pk.add_argument("--snapshot", default=None)
    pi = sub.add_parser("info")
    pi.add_argument("pkg")
    ins = sub.add_parser("install")
    ins.add_argument("pkg")
    ins.add_argument("dest", nargs="?", default="forge_store")
    ls = sub.add_parser("list")
    ls.add_argument("store", nargs="?", default="forge_store")
    srv = sub.add_parser("serve")
    srv.add_argument("store", nargs="?", default="forge_store")
    srv.add_argument("--port", type=int, default=8188)
    srv.add_argument("--host", default="127.0.0.1",
                     help="interface to bind; the upload endpoint has no "
                          "authentication, so binding beyond loopback is "
                          "an explicit choice (e.g. --host 0.0.0.0)")
    pub = sub.add_parser("publish")
    pub.add_argument("pkg")
    pub.add_argument("url")
    ft = sub.add_parser("fetch")
    ft.add_argument("name")
    ft.add_argument("url")
    ft.add_argument("dest", nargs="?", default=".")
    return p


def main(argv=None) -> int:
    from veles_tpu_torch.logger import setup_logging

    setup_logging()
    args = build_parser().parse_args(argv)
    if args.cmd == "pack":
        print(ForgePackage.pack(
            args.out, args.name, args.workflow, args.configs,
            snapshot=args.snapshot, version=args.version,
            author=args.author, description=args.description))
    elif args.cmd == "info":
        print(json.dumps(ForgePackage.read_manifest(args.pkg), indent=2))
    elif args.cmd == "install":
        print(ForgePackage.install(args.pkg, args.dest)["root"])
    elif args.cmd == "list":
        for m in ForgePackage.list_store(args.store):
            print(f"{m['file']}: {m['name']} {m['version']} "
                  f"({m.get('description', '')})")
    elif args.cmd == "serve":
        server = make_forge_server(args.store, args.port, args.host)
        print(f"forge marketplace on port {server.server_address[1]}, "
              f"store={args.store}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    elif args.cmd == "publish":
        m = publish(args.pkg, args.url)
        print(f"published {m['file']}: {m['name']} {m['version']}")
    elif args.cmd == "fetch":
        print(fetch(args.name, args.url, args.dest))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
