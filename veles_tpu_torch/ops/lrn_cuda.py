"""LRN forward: the hand-written Hopper kernel, its build, and its plain
PyTorch version.

Source note.  ``csrc/lrn_fwd.cu`` replaces the Pallas TPU kernel
``veles_tpu/ops/lrn_pallas.py:_fwd_kernel`` (``lrn_fwd``), which
computes ``y = x * (k + alpha * (x*x) @ B) ** -0.75`` over x reshaped
to (rows, C), B = ``band_matrix(C, n)``.  The op is bound by memory: it
must read x once and write y once, 2 * numel * itemsize bytes (74 MB,
about 22 us at 3.35 TB/s, for AlexNet's first norm at batch 64 in
bf16), and its flops are a few per element.  The kernel's design
answers that: one block per tile of whole rows, read from device
memory once with 16-byte loads into shared memory (x and its f32
squares), then one thread per output summing its exactly-n taps from
there; no intermediate touches device memory, and any row count works
(the ragged last tile is masked), where the TPU kernel needed a
multiple-of-8 divisor.  Details are in the ``.cu`` file.

- :func:`lrn_fwd` is the wrapper.  On a CUDA tensor it launches the
  kernel (building it on first use) or raises; on a CPU tensor, and
  only there, it computes :func:`lrn_fwd_plain`.  There is no fallback:
  a failed build or launch raises.  ``lrn_fwd.launches`` counts kernel
  launches and nothing else.
- :func:`lrn_fwd_plain` is the same function as the kernel in PyTorch
  (the banded-matmul form of ``veles_tpu/ops/lrn.py``): the CPU path,
  and the yardstick the kernel is held against on the card.
- :func:`build` compiles the kernel with ``nvcc`` for ``sm_90a`` into
  ``veles_tpu_torch/_build/`` (listed in ``.gitignore``) and binds it
  with ctypes; the library's name carries a hash of the source and the
  flags, so an edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "lrn_fwd.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: one row of x and its f32 squares must fit a block's shared memory
#: (227 KiB, 8 bytes an element in f32)
MAX_CHANNELS = 232448 // 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the library's path and what its build printed (ptxas register and
#: spill lines; empty when an earlier process built it)
build_info: dict = {}


def band_matrix(c: int, n: int, transpose: bool = False) -> np.ndarray:
    """The n-tap window as a C x C 0/1 matrix:
    ``(v @ band)[d] = sum_{j=-n//2}^{n-1-n//2} v[d+j]``.  Exactly n
    taps for both parities of n; ``transpose=True`` is the adjoint
    window (the backward's), which differs from the forward one for
    even n.  Same convention as ``veles_tpu/ops/lrn.py:band_matrix``."""
    half = n // 2
    band = np.zeros((c, c), np.float32)
    for off in range(half - n + 1, half + 1):
        band += np.eye(c, c, off, dtype=np.float32)
    return np.ascontiguousarray(band.T) if transpose else band


@functools.lru_cache(maxsize=16)
def _band_tensor(c: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(band_matrix(c, n)).to(device)


def lrn_fwd_plain(x: torch.Tensor, n: int, k: float, alpha: float,
                  beta: float = 0.75) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x*x in x's dtype, the
    window sum as an f32 matmul with ``band_matrix``, the power and the
    product in f32, the result in x's dtype."""
    c = x.shape[-1]
    xr = x.reshape(-1, c)
    s = (xr * xr).float() @ _band_tensor(c, n, x.device)
    den = k + alpha * s
    if beta == 0.75:
        r = torch.rsqrt(den)
        d = r * torch.sqrt(r)
    else:
        d = den.pow(-beta)
    return (xr.float() * d).to(x.dtype).reshape(x.shape)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/"
            "bin and PATH): the LRN kernel cannot be built")
    return found


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"liblrn_fwd-{digest}.so")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and bind the kernel library.
    Concurrent builders each write a private file and rename it into
    place, so a reader never sees a partial library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        log = ""
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{SOURCE}:\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        fn = lib.veles_lrn_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        build_info.update(path=path, log=log)
        _lib = lib
        return lib


def check_config(c: int, n: int) -> None:
    """The LRN configs the kernel (and so the layer) accepts."""
    if n < 1:
        raise ValueError(f"LRN window n must be >= 1, got {n}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"LRN over {c} channels: the kernel takes "
                         f"1..{MAX_CHANNELS}")


def lrn_fwd(x: torch.Tensor, n: int, k: float, alpha: float,
            beta: float = 0.75) -> torch.Tensor:
    """LRN forward over the last axis of ``x``.  CUDA tensor: the
    kernel, or an exception.  CPU tensor: :func:`lrn_fwd_plain`."""
    if x.device.type == "cpu":
        return lrn_fwd_plain(x, n, k, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_fwd: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"lrn_fwd: dtype {x.dtype} (want float32 or "
                        f"bfloat16)")
    if not x.is_contiguous():
        raise ValueError("lrn_fwd: x must be contiguous (channels last)")
    c = int(x.shape[-1])
    check_config(c, n)
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veles_lrn_fwd(x.data_ptr(), y.data_ptr(), rows, c, n,
                               float(k), float(alpha), float(beta),
                               _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"lrn_fwd kernel launch failed: cudaError "
                           f"{rc} (rows={rows}, C={c}, n={n}, "
                           f"dtype={x.dtype})")
    with _lock:
        lrn_fwd.launches += 1
    return y


lrn_fwd.launches = 0
