"""The forge marketplace of the port (``veles_tpu_torch/forge.py``)
against the reference's (``veles_tpu/forge.py``) on the same HTTP wire:

- publish and fetch across the two packages both ways (the port's
  client to the reference's server, and the reference's client to the
  port's), each fetched file byte for byte the published one, with the
  same manifest, and installable;
- the reference's hardening cases (``tests/test_hardening.py``
  ``TestForgeMarketplace``): an unknown name, a listing that names a
  path outside the destination, uploads with a traversing or wrong name,
  a garbage body or a bad content length, a fetch that fails leaving
  nothing behind, a store listing that survives a bad manifest member,
  the loopback default;
- the seven subcommands of ``python -m veles_tpu_torch.forge``.
"""

import filecmp
import io
import json
import os
import socket
import subprocess
import sys
import tarfile
import threading
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import pytest

from veles_tpu import forge as ref_forge
from veles_tpu_torch import forge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_workflow(tmp_path):
    wf = tmp_path / "wf.py"
    wf.write_text("def run(launcher):\n    pass\n")
    cfg = tmp_path / "cfg.py"
    cfg.write_text("root.demo.n = 1\n")
    return str(wf), str(cfg)


def make_pkg(tmp_path, packer, name="demo", version="1.2.0"):
    wf, cfg = write_workflow(tmp_path)
    snap = tmp_path / "snap.bin"
    snap.write_bytes(os.urandom(300_000))
    out = str(tmp_path / f"{name}.vpkg")
    packer.ForgePackage.pack(out, name, wf, [cfg], snapshot=str(snap),
                             version=version, author="t")
    return out


class Served:
    """A forge server of ``module`` in a thread, shut down on exit."""

    def __init__(self, module, store):
        self.server = module.make_forge_server(str(store), port=0,
                                               host="127.0.0.1")
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("server_mod,client_mod,packer", [
    (forge, ref_forge, ref_forge),
    (ref_forge, forge, forge),
    (forge, forge, forge),
], ids=["reference-client-to-port-server", "port-client-to-reference-server",
        "port-to-port"])
def test_publish_fetch_across_packages(tmp_path, server_mod, client_mod,
                                       packer):
    pkg = make_pkg(tmp_path, packer)
    want = ref_forge.ForgePackage.read_manifest(pkg)
    with Served(server_mod, tmp_path / "store") as s:
        m = client_mod.publish(pkg, s.url)
        assert m["name"] == "demo" and m["file"] == "demo.vpkg"
        assert {k: v for k, v in m.items() if k != "file"} == want
        assert filecmp.cmp(pkg, tmp_path / "store" / "demo.vpkg",
                           shallow=False)
        listed = client_mod.ForgePackage.list_store(str(tmp_path / "store"))
        assert [x["file"] for x in listed] == ["demo.vpkg"]
        got = client_mod.fetch("demo", s.url, str(tmp_path / "dl"))
    assert filecmp.cmp(pkg, got, shallow=False)
    assert forge.ForgePackage.read_manifest(got) == want
    assert os.listdir(tmp_path / "dl") == ["demo.vpkg"]
    inst = forge.ForgePackage.install(got, str(tmp_path / "inst"))
    assert inst["version"] == "1.2.0"
    assert os.path.isfile(os.path.join(inst["root"], "wf.py"))


def test_fetch_takes_the_newest_version(tmp_path):
    store = tmp_path / "store"
    store.mkdir()
    wf, cfg = write_workflow(tmp_path)
    for fn, v in (("m-a.vpkg", "1.9.0"), ("m-b.vpkg", "1.10.0")):
        forge.ForgePackage.pack(str(store / fn), "m", wf, [cfg], version=v)
    with Served(forge, store) as s:
        got = ref_forge.fetch("m", s.url, str(tmp_path / "dl"))
        assert os.path.basename(got) == "m-b.vpkg"
        assert forge.fetch("m", s.url, str(tmp_path / "dl2")).endswith(
            "m-b.vpkg")


def test_unknown_name_names_what_is_there(tmp_path):
    pkg = make_pkg(tmp_path, forge)
    with Served(forge, tmp_path / "store") as s:
        forge.publish(pkg, s.url)
        with pytest.raises(FileNotFoundError, match="available.*demo"):
            forge.fetch("nope", s.url, str(tmp_path / "dl"))
        with pytest.raises(HTTPError):
            urlopen(s.url + "/forge/pkg/absent.vpkg", timeout=10)
    assert not os.path.exists(tmp_path / "dl") or \
        not os.listdir(tmp_path / "dl")


def test_fetch_refuses_a_listing_that_names_another_path(tmp_path,
                                                          monkeypatch):
    listing = json.dumps([{"name": "demo", "version": "1.0.0",
                           "file": "../../escape.vpkg"}]).encode()

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(url, timeout=None):
        assert url.endswith("/forge/list"), \
            "fetch must not ask for a package with an unsafe name"
        return _Resp(listing)

    monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)
    with pytest.raises(ValueError, match="bad package file name"):
        forge.fetch("demo", "http://evil:1", str(tmp_path / "dl"))
    assert not (tmp_path.parent / "escape.vpkg").exists()


def test_uploads_with_bad_names_bodies_or_lengths_leave_nothing(tmp_path):
    pkg = make_pkg(tmp_path, forge)
    store = tmp_path / "store"
    with Served(forge, store) as s:
        for path in ("/forge/upload/../../etc.vpkg",
                     "/forge/upload/notatar.vpkg",
                     "/forge/upload/wrongext.txt",
                     "/forge/upload/.hidden.vpkg"):
            with pytest.raises(HTTPError) as e:
                urlopen(Request(s.url + path, data=b"not a tarball"),
                        timeout=10)
            assert e.value.code in (400, 404)
        for length in ("0", "-5", "junk", str((1 << 31) + 1)):
            req = Request(s.url + "/forge/upload/demo.vpkg", data=b"x",
                          headers={"Content-Length": length})
            with pytest.raises(HTTPError) as e:
                urlopen(req, timeout=10)
            assert e.value.code == 400
            assert "bad content length" in e.value.read().decode()
        # a body that ends before its length: refused, nothing kept
        port = s.server.server_address[1]
        with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
            c.sendall(b"POST /forge/upload/demo.vpkg HTTP/1.1\r\n"
                      b"Host: x\r\nContent-Length: 100000\r\n\r\n"
                      + open(pkg, "rb").read(5000))
            c.shutdown(socket.SHUT_WR)
            answer = b""
            while True:
                chunk = c.recv(65536)
                if not chunk:
                    break
                answer += chunk
        assert b" 400 " in answer.split(b"\r\n")[0], answer[:200]
        assert b"truncated upload" in answer
        assert not any(os.scandir(store)), \
            "rejected uploads must leave nothing in the store"
        assert forge.publish(pkg, s.url)["file"] == "demo.vpkg"
        assert sorted(os.listdir(store)) == ["demo.vpkg"]


def test_a_failed_fetch_leaves_nothing_behind(tmp_path):
    """The server lists a package whose bytes are no package: the fetch
    raises and the destination holds no file."""
    store = tmp_path / "store"
    store.mkdir()
    pkg = make_pkg(tmp_path, forge)
    with Served(forge, store) as s:
        forge.publish(pkg, s.url)
        # the file turns to garbage after the listing was read
        orig = forge.ForgePackage.list_store

        def list_then_spoil(d):
            out = orig(d)
            (store / "demo.vpkg").write_bytes(b"garbage" * 100)
            return out

        forge.ForgePackage.list_store = staticmethod(list_then_spoil)
        try:
            with pytest.raises((tarfile.TarError, OSError, ValueError,
                                KeyError)):
                forge.fetch("demo", s.url, str(tmp_path / "dl"))
        finally:
            forge.ForgePackage.list_store = staticmethod(orig)
    assert os.listdir(tmp_path / "dl") == []


def test_store_listing_survives_a_bad_manifest_member(tmp_path):
    store = tmp_path / "store"
    store.mkdir()
    wf, _ = write_workflow(tmp_path)
    forge.ForgePackage.pack(str(store / "good.vpkg"), "good", wf, [])
    with tarfile.open(str(store / "bad.vpkg"), "w:gz") as tar:
        info = tarfile.TarInfo("manifest.json")
        info.type = tarfile.DIRTYPE
        tar.addfile(info)
    (store / "junk.vpkg").write_bytes(b"not a tarball")
    assert [m["name"] for m in forge.ForgePackage.list_store(str(store))] \
        == ["good"]
    assert forge.ForgePackage.list_store(str(tmp_path / "none")) == []


def test_server_binds_loopback_by_default(tmp_path):
    server = forge.make_forge_server(str(tmp_path / "store"), port=0)
    try:
        assert server.server_address[0] == "127.0.0.1"
    finally:
        server.server_close()


def _cli(*args, cwd):
    p = subprocess.run([sys.executable, "-m", "veles_tpu_torch.forge",
                        *map(str, args)], cwd=cwd, capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr
    return p.stdout.strip()


def test_the_seven_subcommands(tmp_path):
    wf, cfg = write_workflow(tmp_path)
    out = _cli("pack", tmp_path / "x.vpkg", "--name", "x", wf, cfg,
               "--version", "2.0.1", "--description", "demo",
               cwd=tmp_path)
    assert out == str(tmp_path / "x.vpkg")
    info = json.loads(_cli("info", out, cwd=tmp_path))
    assert info == ref_forge.ForgePackage.read_manifest(out)
    assert info["name"] == "x" and info["configs"] == ["cfg.py"]
    root = _cli("install", out, tmp_path / "inst", cwd=tmp_path)
    assert root == str(tmp_path / "inst" / "x-2.0.1")
    assert filecmp.cmp(os.path.join(root, "wf.py"), wf, shallow=False)
    store = tmp_path / "store"
    srv = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch.forge", "serve",
         str(store), "--port", "0"], cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        line = srv.stdout.readline()
        assert line.startswith("forge marketplace on port "), line
        url = f"http://127.0.0.1:{int(line.split()[4].rstrip(','))}"
        assert _cli("publish", out, url, cwd=tmp_path) == \
            "published x.vpkg: x 2.0.1"
        assert _cli("list", store, cwd=tmp_path) == "x.vpkg: x 2.0.1 (demo)"
        got = _cli("fetch", "x", url, tmp_path / "dl", cwd=tmp_path)
        assert got == str(tmp_path / "dl" / "x.vpkg")
        assert filecmp.cmp(got, out, shallow=False)
    finally:
        srv.terminate()
        srv.wait(timeout=30)
