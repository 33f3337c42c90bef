"""Data sets: real files when present, deterministic synthetic stand-ins
otherwise (the port's own copy).

Counterpart of ``veles_tpu/datasets.py``, computed with the same numpy
calls in the same order, so the same arguments give bitwise the
reference's arrays and byte-identical files:

- ``synthetic_classification``: the procedural classification task
  (per-class templates, shifts, noise, squashed to (0, 1));
- MNIST IDX files (``_read_idx``, ``write_idx``, ``generate_mnist_idx``,
  ``try_load_real_mnist``) under ``<data_dir>/mnist``;
- CIFAR-10 batch files, binary and python-pickle layouts
  (``_read_cifar10_bin``, ``_read_cifar10_py``, ``try_load_real_cifar10``,
  ``generate_cifar10_batches``) under ``<data_dir>/cifar10``; a corrupt
  or foreign set is skipped, counted (``corrupt_cache_count``) and
  warned about once in the log;
- ``cap_real``, ``mnist``, ``cifar10``, ``imagenet``.

``data_dir()`` is ``root.common.data_dir``, default
``~/.veles_tpu/data``, so files placed for the reference are found here
too.  The real-file readers return f32 pixels in [0, 1] (``/255``) and
int32 labels, as the reference's do: the uint8 codec does not fire for
them.  Generate the files with

    python -m veles_tpu_torch.datasets make-mnist-idx [DIR]
    python -m veles_tpu_torch.datasets make-cifar10-batches [DIR]

Not ported: the reference's one-entry synthetic cache, the on-device
generator (``jax.random`` bits that torch cannot reproduce) and the
ImageNet preparation (it decodes with PIL, which the card's machine
lacks).
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
import sys
from typing import Optional, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray]

#: (path-set description, error) per corrupt or foreign file set skipped
#: this run: skipping into the synthetic fallback is allowed, silently
#: never
_corrupt_cache_skips: list = []
_corrupt_cache_warned = False


def corrupt_cache_count() -> int:
    """Corrupt or foreign dataset file sets skipped (and warned about)
    so far this run."""
    return len(_corrupt_cache_skips)


def _note_corrupt_cache(what: str, exc: Exception) -> None:
    global _corrupt_cache_warned
    _corrupt_cache_skips.append((what, f"{type(exc).__name__}: {exc}"))
    if not _corrupt_cache_warned:
        _corrupt_cache_warned = True
        logging.getLogger("veles.datasets").warning(
            "corrupt/foreign pre-placed dataset files skipped: the run "
            "continues on the SYNTHETIC fallback, which is almost never "
            "what you want with real data present: %s (%s). Further "
            "corrupt sets are counted silently "
            "(datasets.corrupt_cache_count()).", what, exc)


def data_dir() -> str:
    from veles_tpu_torch.config import root
    d = root.common.get("data_dir") if "common" in root else None
    return os.path.expanduser(d or "~/.veles_tpu/data")


# -- real MNIST (IDX format), if files are pre-placed ------------------

_MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def write_idx(path: str, array: np.ndarray) -> None:
    """Write an array in IDX format (the MNIST container: big-endian
    magic = dtype 0x08 (ubyte) + ndim, then dims, then raw bytes)."""
    from veles_tpu_torch.snapshotter import atomic_write
    arr = np.ascontiguousarray(array, np.uint8)
    with atomic_write(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def generate_mnist_idx(target_dir: Optional[str] = None,
                       n_train: int = 60000, n_test: int = 10000,
                       seed: int = 28281) -> str:
    """Write the synthetic MNIST stand-in AS REAL IDX FILES under
    ``<data_dir>/mnist`` (or ``target_dir``), so the real-file path runs
    end to end offline.  A complete set already there is left as it is;
    a PARTIAL set is never overwritten."""
    base = target_dir or os.path.join(data_dir(), "mnist")
    os.makedirs(base, exist_ok=True)
    present = [f for f in _MNIST_FILES.values()
               if os.path.exists(os.path.join(base, f))
               or os.path.exists(os.path.join(base, f + ".gz"))]
    if len(present) == len(_MNIST_FILES):
        return base
    if present:
        # NEVER overwrite a partial genuine set with synthetic data —
        # the user must complete or remove it
        missing = sorted(set(_MNIST_FILES.values()) - set(present))
        raise FileExistsError(
            f"{base} holds a partial MNIST IDX set ({present}); "
            f"refusing to overwrite with the synthetic stand-in. "
            f"Add the missing files {missing} or remove the partial "
            f"set.")
    (tx, ty), (vx, vy), _ = synthetic_classification(
        n_train, n_test, (28, 28, 1), n_classes=10, seed=seed)
    write_idx(os.path.join(base, _MNIST_FILES["train_images"]),
              np.round(tx[..., 0] * 255.0))
    write_idx(os.path.join(base, _MNIST_FILES["train_labels"]), ty)
    write_idx(os.path.join(base, _MNIST_FILES["test_images"]),
              np.round(vx[..., 0] * 255.0))
    write_idx(os.path.join(base, _MNIST_FILES["test_labels"]), vy)
    return base


def try_load_real_mnist() -> Optional[Tuple[Split, Split]]:
    base = os.path.join(data_dir(), "mnist")
    paths = {}
    for key, fname in _MNIST_FILES.items():
        for cand in (os.path.join(base, fname),
                     os.path.join(base, fname + ".gz")):
            if os.path.exists(cand):
                paths[key] = cand
                break
        else:
            return None
    tx = _read_idx(paths["train_images"]).astype(np.float32) / 255.0
    ty = _read_idx(paths["train_labels"]).astype(np.int32)
    vx = _read_idx(paths["test_images"]).astype(np.float32) / 255.0
    vy = _read_idx(paths["test_labels"]).astype(np.int32)
    return (tx[..., None], ty), (vx[..., None], vy)


# -- real CIFAR-10 (binary / python-pickle batches), if pre-placed -----

_CIFAR10_TRAIN_BATCHES = [f"data_batch_{i}" for i in range(1, 6)]
_CIFAR10_TEST_BATCH = "test_batch"


def _cifar10_dirs() -> list:
    """Candidate roots for the batch files, in priority order: the
    upstream archive unpacks into cifar-10-batches-{bin,py}; files
    dropped directly under <data_dir>/cifar10 work too."""
    base = os.path.join(data_dir(), "cifar10")
    return [os.path.join(base, "cifar-10-batches-bin"),
            os.path.join(base, "cifar-10-batches-py"),
            base]


def _read_cifar10_bin(path: str) -> Split:
    """One binary-format batch: records of 1 label byte + 3072 image
    bytes (R, G, B planes, 32x32 row-major each)."""
    raw = np.fromfile(path, np.uint8)
    if raw.size == 0 or raw.size % 3073:
        raise ValueError(f"{path}: not a CIFAR-10 binary batch "
                         f"({raw.size} bytes)")
    rec = raw.reshape(-1, 3073)
    y = rec[:, 0].astype(np.int32)
    if y.max(initial=0) > 9:
        # a right-sized garbage/foreign file must trigger the synthetic
        # fallback, not feed labels up to 255 into a 10-class workflow
        raise ValueError(f"{path}: labels outside 0..9 — not CIFAR-10")
    x = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x, np.float32) / np.float32(255.0), y


def _read_cifar10_py(path: str) -> Split:
    """One python-pickle-format batch: dict with b'data' (N, 3072)
    uint8 and b'labels' (the upstream pickles are py2-era, so
    encoding='bytes')."""
    import pickle
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = np.asarray(d[b"data"] if b"data" in d else d["data"],
                      np.uint8)
    labels = d.get(b"labels", d.get("labels")) if hasattr(d, "get") \
        else None
    if data.ndim != 2 or data.shape[1] != 3072 or labels is None:
        raise ValueError(f"{path}: not a CIFAR-10 pickle batch")
    x = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(labels, np.int32)
    if y.size and (y.min() < 0 or y.max() > 9):
        raise ValueError(f"{path}: labels outside 0..9 — not CIFAR-10")
    return np.ascontiguousarray(x, np.float32) / np.float32(255.0), y


def try_load_real_cifar10() -> Optional[Tuple[Split, Split]]:
    """((train_x, train_y), (test_x, test_y)) from pre-placed real
    CIFAR-10 batch files — binary (.bin) or python-pickle layout —
    under ``<data_dir>/cifar10``; None when absent.  Pixels float32 in
    [0, 1], HWC."""
    for root in _cifar10_dirs():
        if not os.path.isdir(root):
            continue
        for suffix, reader in ((".bin", _read_cifar10_bin),
                               ("", _read_cifar10_py)):
            names = [b + suffix for b in _CIFAR10_TRAIN_BATCHES] \
                + [_CIFAR10_TEST_BATCH + suffix]
            paths = [os.path.join(root, n) for n in names]
            if not all(os.path.isfile(p) for p in paths):
                continue
            import pickle
            try:
                splits = [reader(p) for p in paths]
            except (ValueError, KeyError, EOFError, TypeError,
                    OSError, pickle.UnpicklingError) as e:
                # corrupt/foreign files -> synthetic fallback, but
                # COUNTED and warned once per run, never silent
                _note_corrupt_cache(f"cifar10 batch set under {root}",
                                    e)
                continue
            tx = np.concatenate([s[0] for s in splits[:-1]])
            ty = np.concatenate([s[1] for s in splits[:-1]])
            return (tx, ty), splits[-1]
    return None


def generate_cifar10_batches(target_dir: Optional[str] = None,
                             n_train: int = 50000,
                             n_test: int = 10000,
                             seed: int = 32323) -> str:
    """Write the synthetic CIFAR-10 stand-in AS REAL
    BINARY-FORMAT BATCH FILES (data_batch_1..5.bin + test_batch.bin)
    under ``<data_dir>/cifar10/cifar-10-batches-bin`` so the real-file
    loading path is exercisable end-to-end offline — the CIFAR
    analogue of generate_mnist_idx.  Idempotent; a complete genuine
    set is left untouched and a PARTIAL set is never overwritten."""
    base = target_dir or _cifar10_dirs()[0]
    os.makedirs(base, exist_ok=True)
    names = [b + ".bin" for b in _CIFAR10_TRAIN_BATCHES] \
        + [_CIFAR10_TEST_BATCH + ".bin"]
    present = [n for n in names
               if os.path.exists(os.path.join(base, n))]
    if len(present) == len(names):
        return base
    if present:
        missing = sorted(set(names) - set(present))
        raise FileExistsError(
            f"{base} holds a partial CIFAR-10 batch set ({present}); "
            f"refusing to overwrite with the synthetic stand-in. "
            f"Add the missing files {missing} or remove the partial "
            f"set.")
    (tx, ty), (vx, vy), _ = synthetic_classification(
        n_train, n_test, (32, 32, 3), n_classes=10, noise=0.5,
        seed=seed)

    def write_bin(path: str, x: np.ndarray, y: np.ndarray) -> None:
        planes = np.round(x * 255.0).astype(np.uint8) \
            .transpose(0, 3, 1, 2).reshape(len(x), 3072)
        rec = np.empty((len(x), 3073), np.uint8)
        rec[:, 0] = y
        rec[:, 1:] = planes
        rec.tofile(path)

    per = -(-n_train // len(_CIFAR10_TRAIN_BATCHES))
    for i, name in enumerate(_CIFAR10_TRAIN_BATCHES):
        sl = slice(i * per, (i + 1) * per)
        write_bin(os.path.join(base, name + ".bin"), tx[sl], ty[sl])
    write_bin(os.path.join(base, _CIFAR10_TEST_BATCH + ".bin"),
              vx, vy)
    return base


def _class_templates(rng: np.random.Generator, n_classes: int,
                     shape: Tuple[int, ...]) -> np.ndarray:
    """Smooth per-class patterns: low-frequency random fields, upsampled
    bilinearly (rows first, then columns, float32 throughout)."""
    h, w = shape[0], shape[1]
    c = shape[2] if len(shape) > 2 else 1
    coarse = rng.standard_normal((n_classes, max(2, h // 4),
                                  max(2, w // 4), c)).astype(np.float32)
    ys = np.linspace(0, coarse.shape[1] - 1, h)
    xs = np.linspace(0, coarse.shape[2] - 1, w)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, coarse.shape[1] - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, coarse.shape[2] - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    rows = coarse[:, y0] * (1 - wy) + coarse[:, y1] * wy
    return rows[:, :, x0] * (1 - wx) + rows[:, :, x1] * wx


def synthetic_classification(
        n_train: int, n_valid: int, shape: Tuple[int, ...],
        n_classes: int = 10, noise: float = 0.4, max_shift: int = 2,
        seed: int = 20260729, n_test: int = 0,
) -> Tuple[Split, Split, Optional[Split]]:
    """Deterministic image-classification task.

    sample = circular-shifted class template + gaussian noise, values
    squashed to (0, 1).  Returns (train, valid, test-or-None).
    """
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, n_classes, shape)

    def make(n: int) -> Split:
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = templates[y]  # fancy indexing: a fresh array, safe in-place
        if max_shift > 0:
            sh, sw = (rng.integers(-max_shift, max_shift + 1, (2, n)))
            # per-sample circular shift, grouped by shift value (the
            # same values as a per-sample np.roll)
            for axis, shifts in ((1, sh), (2, sw)):
                for s in np.unique(shifts):
                    if s:
                        idx = np.nonzero(shifts == s)[0]
                        x[idx] = np.roll(x[idx], s, axis=axis)
        g = rng.standard_normal(x.shape, dtype=np.float32)
        np.multiply(g, np.float32(noise), out=g)
        x += g
        del g
        # squash into (0,1) like pixel data: sigmoid, in place
        np.negative(x, out=x)
        np.exp(x, out=x)
        x += 1.0
        np.reciprocal(x, out=x)
        if len(shape) == 2:
            x = x[..., 0] if x.shape[-1] == 1 else x
        return np.ascontiguousarray(x, np.float32), y

    train = make(n_train)
    valid = make(n_valid)
    test = make(n_test) if n_test else None
    return train, valid, test


def _main(argv=None) -> int:
    """``python -m veles_tpu_torch.datasets make-mnist-idx|
    make-cifar10-batches [DIR]``: write the synthetic stand-ins as real
    files (the real-file path's input)."""
    import argparse
    p = argparse.ArgumentParser(prog="veles_tpu_torch.datasets")
    sub = p.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make-mnist-idx",
                        help="write MNIST-format IDX files (synthetic "
                             "stand-in) under DIR or the data dir")
    mk.add_argument("dir", nargs="?", default=None)
    mk.add_argument("--n-train", type=int, default=60000)
    mk.add_argument("--n-test", type=int, default=10000)
    mkc = sub.add_parser(
        "make-cifar10-batches",
        help="write CIFAR-10 binary-format batch files (synthetic "
             "stand-in) under DIR or the data dir")
    mkc.add_argument("dir", nargs="?", default=None)
    mkc.add_argument("--n-train", type=int, default=50000)
    mkc.add_argument("--n-test", type=int, default=10000)
    args = p.parse_args(argv)
    if args.cmd == "make-cifar10-batches":
        print(generate_cifar10_batches(args.dir, args.n_train,
                                       args.n_test))
        return 0
    base = generate_mnist_idx(args.dir, args.n_train, args.n_test)
    print(base)
    return 0


def cap_real(real, n_train: int, n_valid: int):
    """Requested sizes act as caps on real files too: a 100-sample
    smoke run must not silently get the full 50k/10k set just because
    files exist.  The single policy point: the module-level data set
    functions and ``loader/synthetic.py``'s ``_RealFileMixin`` both go
    through here."""
    (tx, ty), (vx, vy) = real
    return (tx[:n_train], ty[:n_train]), (vx[:n_valid], vy[:n_valid]), \
        None


def mnist(n_train: int = 60000, n_valid: int = 10000,
          force_synthetic: bool = False):
    """MNIST: real IDX files if present, else synthetic 28x28x1."""
    if not force_synthetic:
        real = try_load_real_mnist()
        if real is not None:
            return cap_real(real, n_train, n_valid)
    return synthetic_classification(
        n_train, n_valid, (28, 28, 1), n_classes=10, seed=28281)


def cifar10(n_train: int = 50000, n_valid: int = 10000,
            force_synthetic: bool = False):
    """CIFAR-10: real batch files if present, else synthetic 32x32x3."""
    if not force_synthetic:
        real = try_load_real_cifar10()
        if real is not None:
            return cap_real(real, n_train, n_valid)
    return synthetic_classification(
        n_train, n_valid, (32, 32, 3), n_classes=10, noise=0.5, seed=32323)


def imagenet(n_train: int = 8192, n_valid: int = 1024,
             image_size: int = 227, n_classes: int = 1000):
    """Synthetic ImageNet stand-in at AlexNet's input resolution.  Sizes
    default small — the benchmark measures images/sec, not accuracy."""
    return synthetic_classification(
        n_train, n_valid, (image_size, image_size, 3),
        n_classes=n_classes, noise=0.5, max_shift=8, seed=227227)


if __name__ == "__main__":
    sys.exit(_main())
