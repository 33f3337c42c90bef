"""LRN forward and backward: the hand-written Hopper kernels, their build,
and their plain PyTorch versions.

Source notes.

- ``csrc/lrn_fwd.cu`` replaces the Pallas TPU kernel
  ``veles_tpu/ops/lrn_pallas.py:_fwd_kernel`` (``lrn_fwd``), which
  computes ``y = x * (k + alpha * (x*x) @ B) ** -0.75`` over x reshaped
  to (rows, C), B = ``band_matrix(C, n)``.  The op is bound by memory: it
  must read x once and write y once, 2 * numel * itemsize bytes (149 MB,
  about 44 us at 3.35 TB/s, for AlexNet's first norm at batch 128 in
  bf16), and its flops are a few per element.
- ``csrc/lrn_bwd.cu`` replaces ``veles_tpu/ops/lrn_pallas.py:_bwd_kernel``
  (``lrn_bwd``): ``err_input = e*d - 2*alpha*beta * x * (t @ B^T)`` with
  ``d = den^-beta``, ``t = e*x*den^-(beta+1)`` rounded to the input
  dtype, den recomputed from x, and B^T the adjoint window.  Also bound
  by memory: x and e read once, the result written once, 3 * numel *
  itemsize bytes (223 MB, 66.6 us at 3.35 TB/s, for the first norm at
  batch 128 in bf16), at some 45 instructions an element, which the
  card's instruction rate only just covers.
- Both share one design (``csrc/lrn_common.cuh``).  Vector path, taken
  where C is a multiple of the 16-byte vector (8 bf16, 4 f32), the
  pointers are 16-byte aligned and n <= 5 (every AlexNet
  layer): one pass with no shared memory and no barrier; each lane owns
  one 16-byte vector of channels, loaded and stored whole; the window's
  halo comes from the neighbouring lanes by warp shuffles (for the
  backward, a second round carries t's halo for the adjoint window); a
  warp loads 32 vectors and stores the middle 30, so rows may straddle
  warps; a grid sized from the SM count walks the vectors with two
  tiles' loads in flight per warp.  Row path, any other config: a warp
  or more threads per row and several rows per block, each row's squares
  (and the backward's t and e*d) in shared memory, which bounds C at
  :data:`MAX_CHANNELS` (a row of that width takes a whole block).
  Details are in the ``.cu`` files.

- :func:`lrn_fwd` / :func:`lrn_bwd` are the wrappers.  On a CUDA tensor
  each launches its kernel (building it on first use) or raises; on a
  CPU tensor, and only there, it computes its plain version.  There is
  no fallback: a failed build or launch raises.  ``lrn_fwd.launches``
  and ``lrn_bwd.launches`` count kernel launches and nothing else.
- Each wrapper calls a ``torch.library`` custom op
  (``veles_tpu_torch::lrn_fwd`` / ``lrn_bwd``) with a fake (meta)
  implementation and a member rule (``register_vmap``), the counterpart
  of Pallas's batching rule under the reference's ``jax.vmap``: LRN
  works per pixel across channels, so the rule moves the member axis in
  front and folds it into the rows, ``(P, N, H, W, C)`` into
  ``(P*N*H*W, C)``, and launches ONE kernel for all members.  A batched
  tensor under ``torch.func.vmap`` has no data pointer; the rule hands
  the kernel the plain folded tensor.
- :func:`lrn_fwd_plain` / :func:`lrn_bwd_plain` are the same functions in
  PyTorch (the banded-matmul form of ``veles_tpu/ops/lrn.py``): the CPU
  path, and the yardstick each kernel is held against on the card.
- :func:`build` compiles the kernels with ``nvcc`` for ``sm_90a`` into
  ``veles_tpu_torch/_build/`` (listed in ``.gitignore``), all missing
  ones at once, one ``nvcc`` per source, and binds each with ctypes.
  Each library's name carries a hash of its own source, the shared
  header and the flags, so an edited source rebuilds only its own
  library and never loads a stale one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import numpy as np
import torch

from veles_tpu_torch.analysis import witness

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
#: the header every kernel source includes
COMMON_HEADER = "lrn_common.cuh"
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: kernel name -> the argument types of its C entry ``veles_<name>``
KERNELS = {
    # x, y, rows, C, n, k, alpha, beta, dtype, SMs, stream
    "lrn_fwd": [_P, _P, _LL, _I, _I, _F, _F, _F, _I, _I, _P],
    # x, e, out, rows, C, n, k, alpha, beta, 2*alpha*beta, dtype, SMs,
    # stream
    "lrn_bwd": [_P, _P, _P, _LL, _I, _I, _F, _F, _F, _F, _I, _I, _P],
}

#: the largest C a block's shared memory (227 KiB) admits on the row
#: path of both kernels, where such a row has a block to itself: the
#: backward keeps a row's f32 squares, its t and its e*d, 12 bytes a
#: channel, the forward 4 (the vector path has no limit of its own)
MAX_CHANNELS = 232448 // 12

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: a lock of the port only (the reference has no build step): it
#: guards the build and the launch counts, and nothing is taken under it
_lock = witness.lock("lrn_cuda.build")
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: the library's path, the seconds its build took (0 when an
#: earlier process built it) and what the build printed (ptxas register
#: and spill lines)
build_info: Dict[str, dict] = {}


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


@functools.lru_cache(maxsize=32)
def _band_tensor(c: int, n: int, device: torch.device, dtype: torch.dtype,
                 transpose: bool = False) -> torch.Tensor:
    return torch.from_numpy(band_matrix(c, n, transpose)).to(device, dtype)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f32 and bf16 inputs (the kernels' arithmetic); f64 stays
    f64, so the tests can differentiate the plain forward exactly."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _powers(den: torch.Tensor, beta: float, need_d1: bool):
    """(den^-beta, den^-(beta+1) or None), by the kernels' rule: the
    rsqrt chain for beta = 3/4, the general power otherwise."""
    if beta == 0.75:
        r = torch.rsqrt(den)
        d = r * torch.sqrt(r)
        return d, (d * r * r if need_d1 else None)
    return den.pow(-beta), (den.pow(-beta - 1.0) if need_d1 else None)


def lrn_fwd_plain(x: torch.Tensor, n: int, k: float, alpha: float,
                  beta: float = 0.75) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: x*x in x's dtype,
    the window sum as an f32 matmul with ``band_matrix``, the power and
    the product in f32, the result in x's dtype."""
    c = x.shape[-1]
    acc = _acc_dtype(x)
    xr = x.reshape(-1, c)
    s = (xr * xr).to(acc) @ _band_tensor(c, n, x.device, acc)
    d, _ = _powers(k + alpha * s, beta, need_d1=False)
    return (xr.to(acc) * d).to(x.dtype).reshape(x.shape)


def lrn_bwd_plain(x: torch.Tensor, err: torch.Tensor, n: int, k: float,
                  alpha: float, beta: float = 0.75) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: den recomputed
    as in :func:`lrn_fwd_plain`, ``t = e*x*den^-(beta+1)`` rounded to
    x's dtype, its adjoint window sum as an f32 matmul with the
    transposed band, and ``e*d - 2*alpha*beta*x*wt`` in f32; the result
    in err's dtype."""
    c = x.shape[-1]
    acc = _acc_dtype(x)
    xr = x.reshape(-1, c)
    xf = xr.to(acc)
    ef = err.reshape(-1, c).to(acc)
    s = (xr * xr).to(acc) @ _band_tensor(c, n, x.device, acc)
    d, d1 = _powers(k + alpha * s, beta, need_d1=True)
    t = (ef * xf * d1).to(x.dtype).to(acc)
    wt = t @ _band_tensor(c, n, x.device, acc, transpose=True)
    out = ef * d - (2.0 * alpha * beta) * xf * wt
    return out.to(err.dtype).reshape(err.shape)


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
            "bin and PATH): the LRN kernels cannot be built")
    return found


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where kernel ``name``'s library is built: the name carries a hash
    of its own source, the shared header and the flags."""
    h = hashlib.sha256()
    for path in (source_path(name), os.path.join(CSRC_DIR, COMMON_HEADER)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(*names: str) -> Dict[str, ctypes.CDLL]:
    """Compile (once per source hash) and bind the named kernels' libraries
    (all of :data:`KERNELS` when none is named).  Every missing library
    is compiled at once, one ``nvcc`` process per source.  Concurrent
    builders each write a private file and rename it into place, so a
    reader never sees a partial library."""
    names = names or tuple(KERNELS)
    with _lock:
        todo = [nm for nm in names if nm not in _libs]
        procs = {}
        t0 = time.perf_counter()
        for nm in todo:
            path = library_path(nm)
            if os.path.isfile(path):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, source_path(nm)]
            procs[nm] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for nm, (proc, tmp, path) in procs.items():
            log = proc.communicate()[0]
            build_info[nm] = {"log": log,
                              "seconds": time.perf_counter() - t0}
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{source_path(nm)}:\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
        for nm in todo:
            path = library_path(nm)
            lib = ctypes.CDLL(path)
            fn = getattr(lib, f"veles_{nm}")
            fn.argtypes = KERNELS[nm]
            fn.restype = ctypes.c_int
            info = build_info.setdefault(nm, {"log": "", "seconds": 0.0})
            info["path"] = path
            _libs[nm] = lib
        return {nm: _libs[nm] for nm in names}


def check_config(c: int, n: int) -> None:
    """The LRN configs both kernels (and so the layer) accept."""
    if n < 1:
        raise ValueError(f"LRN window n must be >= 1, got {n}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"LRN over {c} channels: the kernels take "
                         f"1..{MAX_CHANNELS}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The device's SM count, which sizes the vector path's grid."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    for t in ts:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{what}: dtype {t.dtype} (want float32 or "
                            f"bfloat16)")
        if t.dtype != x.dtype or t.shape != x.shape \
                or t.device != x.device:
            raise ValueError(f"{what}: operands differ in dtype, shape or "
                             f"device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous "
                             f"(channels last)")


def _launched(what: str, rc: int, rows: int, c: int, n: int,
              dtype: torch.dtype) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           f"(rows={rows}, C={c}, n={n}, dtype={dtype})")


def _fwd_launch(x: torch.Tensor, n: int, k: float, alpha: float,
                beta: float) -> torch.Tensor:
    """The custom op's body: the kernel for a CUDA tensor (or an
    exception), :func:`lrn_fwd_plain` for a CPU tensor."""
    if x.device.type == "cpu":
        return lrn_fwd_plain(x, n, k, alpha, beta)
    _check_cuda("lrn_fwd", x)
    c = int(x.shape[-1])
    check_config(c, n)
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    lib = build("lrn_fwd")["lrn_fwd"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veles_lrn_fwd(x.data_ptr(), y.data_ptr(), rows, c, n,
                               float(k), float(alpha), float(beta),
                               _DTYPES[x.dtype], _sm_count(x.device.index),
                               stream)
    _launched("lrn_fwd", rc, rows, c, n, x.dtype)
    with _lock:
        lrn_fwd.launches += 1
    return y


@torch.library.custom_op("veles_tpu_torch::lrn_fwd", mutates_args=())
def _lrn_fwd_op(x: torch.Tensor, n: int, k: float, alpha: float,
                beta: float) -> torch.Tensor:
    return _fwd_launch(x, n, k, alpha, beta)


@_lrn_fwd_op.register_fake
def _lrn_fwd_fake(x, n, k, alpha, beta):
    return torch.empty_like(x)


def _members_first(t: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """``t`` with its member axis in front (broadcast to ``size`` members
    when it has none), contiguous: channels stay last, so the kernel
    reads the members as more rows."""
    if bdim is None:
        return t.unsqueeze(0).expand((size,) + tuple(t.shape)).contiguous()
    return t.movedim(bdim, 0).contiguous()


@_lrn_fwd_op.register_vmap
def _lrn_fwd_members(info, in_dims, x, n, k, alpha, beta):
    if in_dims[0] is None:
        return _lrn_fwd_op(x, n, k, alpha, beta), None
    return _lrn_fwd_op(_members_first(x, in_dims[0], info.batch_size),
                       n, k, alpha, beta), 0


def lrn_fwd(x: torch.Tensor, n: int, k: float, alpha: float,
            beta: float = 0.75) -> torch.Tensor:
    """LRN forward over the last axis of ``x``.  CUDA tensor: the
    kernel, or an exception.  CPU tensor: :func:`lrn_fwd_plain`.  Under
    ``torch.func.vmap`` the member rule folds the member axis into the
    rows (one launch for all members)."""
    return _lrn_fwd_op(x, int(n), float(k), float(alpha), float(beta))


lrn_fwd.launches = 0


def _bwd_launch(x: torch.Tensor, err: torch.Tensor, n: int, k: float,
                alpha: float, beta: float) -> torch.Tensor:
    """The custom op's body: the kernel for CUDA tensors (or an
    exception), :func:`lrn_bwd_plain` for CPU tensors."""
    if x.device.type == "cpu" and err.device.type == "cpu":
        return lrn_bwd_plain(x, err, n, k, alpha, beta)
    _check_cuda("lrn_bwd", x, err)
    c = int(x.shape[-1])
    check_config(c, n)
    out = torch.empty_like(err)
    rows = x.numel() // c
    if rows == 0:
        return out
    lib = build("lrn_bwd")["lrn_bwd"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veles_lrn_bwd(x.data_ptr(), err.data_ptr(), out.data_ptr(),
                               rows, c, n, float(k), float(alpha),
                               float(beta), float(2.0 * alpha * beta),
                               _DTYPES[x.dtype], _sm_count(x.device.index),
                               stream)
    _launched("lrn_bwd", rc, rows, c, n, x.dtype)
    with _lock:
        lrn_bwd.launches += 1
    return out


@torch.library.custom_op("veles_tpu_torch::lrn_bwd", mutates_args=())
def _lrn_bwd_op(x: torch.Tensor, err: torch.Tensor, n: int, k: float,
                alpha: float, beta: float) -> torch.Tensor:
    return _bwd_launch(x, err, n, k, alpha, beta)


@_lrn_bwd_op.register_fake
def _lrn_bwd_fake(x, err, n, k, alpha, beta):
    return torch.empty_like(err)


@_lrn_bwd_op.register_vmap
def _lrn_bwd_members(info, in_dims, x, err, n, k, alpha, beta):
    if in_dims[0] is None and in_dims[1] is None:
        return _lrn_bwd_op(x, err, n, k, alpha, beta), None
    p = info.batch_size
    return _lrn_bwd_op(_members_first(x, in_dims[0], p),
                       _members_first(err, in_dims[1], p),
                       n, k, alpha, beta), 0


def lrn_bwd(x: torch.Tensor, err: torch.Tensor, n: int, k: float,
            alpha: float, beta: float = 0.75) -> torch.Tensor:
    """LRN backward: d loss / d x from x and ``err`` = d loss / d y, over
    the last axis.  CUDA tensors: the kernel, or an exception (x and err
    must share dtype, shape and device).  CPU tensors:
    :func:`lrn_bwd_plain`.  Under ``torch.func.vmap`` the member rule
    folds the member axis into the rows, as for :func:`lrn_fwd`."""
    if x.device != err.device:
        # before the dispatcher, which would route a meta operand to the
        # fake implementation
        raise ValueError(f"lrn_bwd: no kernel for operands on {x.device} "
                         f"and {err.device}")
    return _lrn_bwd_op(x, err, int(n), float(k), float(alpha), float(beta))


lrn_bwd.launches = 0
