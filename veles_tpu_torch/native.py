"""ctypes bridge to the native C++ inference runtime (``native/``).

The port's copy of ``veles_tpu/native.py``.  The runtime runs on the
host by design: it is the deployment target of an exported model (the
libVeles equivalent), not a fallback of the port.

- :func:`ensure_built` compiles ``native/src/libveles.cc`` into a shared
  library, and ``native/src/veles_infer.cc`` with it into the
  ``veles_infer`` CLI, as the Makefile's ``all`` does and with its
  flags, by calling ``$CXX`` (else ``g++``) itself: no ``make``.  The
  outputs go to the port's ignored ``_build/`` dir (nothing is written
  under ``native/``), each named by a hash of the sources and the
  flags.  Concurrent builders each write a private file and rename it
  into place, so a reader never sees a partial library.  A failed build
  raises with the compiler's output.
- :class:`NativeModel` loads a VTPN file and runs batches on it, with
  the reference's API: ``input_shape``, ``output_size``, ``num_ops``,
  ``run`` and ``close``.  Its first use builds the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
#: the Makefile's CXXFLAGS; the library adds its LDFLAGS (-shared)
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-Iinclude"]
LIB_SRC = ("src/libveles.cc",)
CLI_SRC = ("src/veles_infer.cc", "src/libveles.cc")
HEADER = "include/veles_c.h"

_lib: Optional[ctypes.CDLL] = None
#: what the last build of this process did: compiler, its version line,
#: seconds, and the two outputs' paths
build_info: Dict[str, object] = {}


def compiler() -> str:
    """``$CXX``, else ``g++``, as an absolute path."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found ($CXX, else "
                           f"g++ on PATH): native/ cannot be built")
    return found


def _outputs(build_dir: str) -> Dict[str, str]:
    h = hashlib.sha256()
    for rel in sorted(set(LIB_SRC + CLI_SRC + (HEADER,))):
        with open(os.path.join(NATIVE_DIR, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    h.update(" ".join(CXXFLAGS).encode())
    tag = h.hexdigest()[:16]
    return {"lib": os.path.join(build_dir, f"libveles_tpu-{tag}.so"),
            "cli": os.path.join(build_dir, f"veles_infer-{tag}")}


def ensure_built(build_dir: Optional[str] = None) -> str:
    """Build the library and the CLI into ``build_dir`` (default
    :data:`BUILD_DIR`) unless this hash of the sources is there already;
    return the library's path."""
    out = _outputs(build_dir or BUILD_DIR)
    todo = {k: p for k, p in out.items() if not os.path.isfile(p)}
    if not todo:
        return out["lib"]
    cxx = compiler()
    os.makedirs(os.path.dirname(out["lib"]), exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for kind, path in todo.items():
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        srcs = list(LIB_SRC if kind == "lib" else CLI_SRC)
        cmd = [cxx] + CXXFLAGS + (["-shared"] if kind == "lib" else []) \
            + ["-o", tmp] + srcs
        procs[kind] = (subprocess.Popen(
            cmd, cwd=NATIVE_DIR, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, path, cmd)
    failed = []
    for kind, (proc, tmp, path, cmd) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"native build failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()
    build_info.update(compiler=cxx, version=version[0] if version else "",
                      seconds=time.perf_counter() - t0, **out)
    return out["lib"]


def cli_path(build_dir: Optional[str] = None) -> str:
    """The ``veles_infer`` CLI built beside the library."""
    ensure_built(build_dir)
    return _outputs(build_dir or BUILD_DIR)["cli"]


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.veles_load.restype = ctypes.c_void_p
        lib.veles_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.veles_free.argtypes = [ctypes.c_void_p]
        lib.veles_input_rank.restype = ctypes.c_int
        lib.veles_input_rank.argtypes = [ctypes.c_void_p]
        lib.veles_input_dims.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.veles_output_size.restype = ctypes.c_int64
        lib.veles_output_size.argtypes = [ctypes.c_void_p]
        lib.veles_num_ops.restype = ctypes.c_int
        lib.veles_num_ops.argtypes = [ctypes.c_void_p]
        lib.veles_run.restype = ctypes.c_int
        lib.veles_run.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    return _lib


class NativeModel:
    """A VTPN model executed by the C++ runtime."""

    def __init__(self, path: str) -> None:
        lib = _load_lib()
        err = ctypes.create_string_buffer(256)
        self._handle = lib.veles_load(os.fsencode(path), err, len(err))
        if not self._handle:
            raise ValueError(
                f"veles_load({path!r}): {err.value.decode() or 'failed'}")
        self._lib = lib
        rank = lib.veles_input_rank(self._handle)
        dims = (ctypes.c_int64 * rank)()
        lib.veles_input_dims(self._handle, dims)
        self.input_shape = tuple(int(d) for d in dims)
        self.output_size = int(lib.veles_output_size(self._handle))
        self.num_ops = int(lib.veles_num_ops(self._handle))

    def run(self, x: np.ndarray) -> np.ndarray:
        """Forward a batch: (B, *input_shape) f32 -> (B, output_size)."""
        x = np.ascontiguousarray(x, np.float32)
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(f"input sample shape {x.shape[1:]} != "
                             f"model's {self.input_shape}")
        batch = x.shape[0]
        out = np.empty((batch, self.output_size), np.float32)
        rc = self._lib.veles_run(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(f"veles_run failed with code {rc}")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.veles_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
