"""The port's data layer against the JAX package's.

Same numpy inputs through ``veles_tpu`` and ``veles_tpu_torch``:

- every normalizer's fitted state, ``affine_params`` and ``apply`` are
  bitwise the reference's (the same numpy calls);
- every ``derive_dequant``'s scale and bias are bitwise the reference's,
  and ``apply_host`` is within 2e-5 of the value span of the host
  normalizer's output (one f32 ulp of the composed affine; the
  reference's own bar); ``quantizable_source`` and ``to_uint8`` follow
  the reference's rules;
- the MNIST IDX and CIFAR-10 binary files that ``python -m
  veles_tpu_torch.datasets`` writes are byte-identical to the
  reference's for the same sizes, and neither overwrites a partial set;
- both readers give the reference's arrays (IDX plain and gzipped;
  CIFAR-10 binary and python-pickle layouts); a corrupt set is counted
  and skipped, not crashed on;
- ``MnistLoader`` and ``Cifar10Loader`` prefer the files, capped by
  ``n_train`` / ``n_valid``, with the reference's class lengths and
  arrays; the loaders' normalization and codec decisions, the residency
  budget at the stored dtype, and snapshot state (an older snapshot
  loads with the defaults).

``root.common.data_dir`` is set in both packages' config trees for a
test and restored after (:func:`data_dir_in_both`).
"""

import contextlib
import gzip
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from veles_tpu import datasets as ref_datasets
from veles_tpu import normalization as ref_normalization
from veles_tpu.backends import JaxDevice
from veles_tpu.config import root as ref_root
from veles_tpu.loader import quantize as ref_quantize
from veles_tpu.loader.fullbatch import ArrayLoader as RefArrayLoader
from veles_tpu.loader.synthetic import Cifar10Loader as RefCifar10Loader
from veles_tpu.loader.synthetic import MnistLoader as RefMnistLoader
from veles_tpu_torch import datasets, normalization
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import quantize
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.loader.synthetic import Cifar10Loader, MnistLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MISSING = object()


@contextlib.contextmanager
def data_dir_in_both(path):
    """``root.common.data_dir = path`` in the reference's and the port's
    config trees, each restored to what it was on exit."""
    saved = []
    for tree in (ref_root, root):
        had = "common" in tree
        old = tree.common.get("data_dir", _MISSING) if had else _MISSING
        saved.append((tree, had, old))
        tree.common.data_dir = str(path)
    try:
        yield str(path)
    finally:
        for tree, had, old in saved:
            if not had:
                del tree.__dict__["common"]
            elif old is _MISSING:
                del tree.common.__dict__["data_dir"]
            else:
                tree.common.data_dir = old


def test_data_dir_is_set_in_both_trees_and_restored(tmp_path):
    before = (ref_root.common.get("data_dir"), "common" in root)
    with data_dir_in_both(tmp_path):
        assert ref_datasets.data_dir() == datasets.data_dir() == str(tmp_path)
    assert (ref_root.common.get("data_dir"), "common" in root) == before
    assert datasets.data_dir() == os.path.expanduser("~/.veles_tpu/data")


# -- normalizers and the codec -------------------------------------------

NORMALIZERS = [("none", {}), ("linear", {}),
               ("linear", {"lo": 0.0, "hi": 1.0}), ("mean_disp", {}), ("pointwise", {}),
               ("external_mean", {"scale": 1.0 / 255.0}),
               ("external_mean", {"mean": "given", "scale": 0.5})]


def _inputs(kind_params, dtype):
    rng = np.random.RandomState(3)
    q = rng.randint(0, 256, (64, 6, 6, 2)).astype(np.uint8)
    q[:, 0, 0, 0] = 17            # a constant feature: std 0, span 0
    x = q if dtype == "uint8" else (q.astype(np.float32) / 255.0
                                    + rng.standard_normal(q.shape)
                                    .astype(np.float32) * 1e-3)
    params = dict(kind_params)
    if params.get("mean") == "given":
        params["mean"] = rng.random_sample((6, 6, 2)).astype(np.float32)
    return x, params


def _bitwise(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _bitwise(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _bitwise(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("kind,params", NORMALIZERS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(NORMALIZERS)])
def test_normalizer_is_bitwise_the_references(kind, params, dtype):
    x, params = _inputs(params, dtype)
    ref = ref_normalization.make_normalizer(kind, **params)
    got = normalization.make_normalizer(kind, **params)
    assert got.kind == ref.kind == kind
    assert (ref.affine_params() is None) == (got.affine_params() is None)
    ref.fit(x[:48])
    got.fit(x[:48])
    _bitwise(ref.state(), got.state())
    _bitwise(ref.affine_params(), got.affine_params())
    _bitwise(ref.apply(x), got.apply(x))


@pytest.mark.parametrize("pre_scale", [1.0, 1.0 / 255.0])
@pytest.mark.parametrize("kind,params", NORMALIZERS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(NORMALIZERS)])
def test_dequant_is_the_references_and_within_an_ulp(kind, params,
                                                     pre_scale):
    q, params = _inputs(params, "uint8")
    norm = normalization.make_normalizer(kind, **params)
    ref_norm = ref_normalization.make_normalizer(kind, **params)
    view = q.astype(np.float32) * np.float32(pre_scale)
    norm.fit(view)
    ref_norm.fit(view)
    dq = quantize.derive_dequant(norm, pre_scale)
    want = ref_quantize.derive_dequant(ref_norm, pre_scale)
    _bitwise((want.scale, want.bias), (dq.scale, dq.bias))
    got = dq.apply_host(q)
    _bitwise(want.apply_host(q), got)
    host = norm.apply(view)
    span = max(float(np.abs(host).max()), 1.0)
    np.testing.assert_allclose(got, host, atol=2e-5 * span)
    assert pickle.loads(pickle.dumps(dq)).nbytes == dq.nbytes == want.nbytes


def test_dequant_edges_follow_the_reference():
    dq = quantize.derive_dequant(None, pre_scale=1.0 / 255.0)
    want = ref_quantize.derive_dequant(None, pre_scale=1.0 / 255.0)
    _bitwise((want.scale, want.bias), (dq.scale, dq.bias))
    assert normalization.make_normalizer("mean_disp").affine_params() is None
    assert quantize.derive_dequant(
        normalization.make_normalizer("linear")) is None
    with pytest.raises(ValueError, match="unknown normalizer"):
        normalization.make_normalizer("whitening")


SOURCES = [np.array([0, 255], np.uint8), np.array([0, 255], np.int64),
           np.array([-1, 3], np.int32), np.array([0, 256], np.int16),
           np.array([0.0, 12.0, 255.0], np.float32),
           np.array([0.5], np.float32), np.array([-1.0], np.float64),
           np.array([], np.float32), np.array([], np.int8),
           np.array([True, False])]


@pytest.mark.parametrize("strict", [True, False])
def test_quantizable_source_and_to_uint8_follow_the_reference(strict):
    for a in SOURCES:
        want = ref_quantize.quantizable_source(a, strict=strict)
        assert quantize.quantizable_source(a, strict=strict) is want, a
        if want:
            _bitwise(ref_quantize.to_uint8(a), quantize.to_uint8(a))
    assert not quantize.quantizable_source(SOURCES[1], strict=True)
    u8 = SOURCES[0]
    assert quantize.to_uint8(u8) is u8
    with pytest.raises(ValueError, match="byte-ranged"):
        quantize.to_uint8(np.array([0.5, 300.0]))


# -- the files -------------------------------------------------------------

def _port_cli(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.datasets"] + list(args),
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


@pytest.mark.parametrize("cmd,names", [
    ("make-mnist-idx", ["t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte",
                        "train-images-idx3-ubyte",
                        "train-labels-idx1-ubyte"]),
    ("make-cifar10-batches", [f"data_batch_{i}.bin" for i in range(1, 6)]
     + ["test_batch.bin"])])
def test_generated_files_are_byte_identical(tmp_path, cmd, names):
    mine, ref = tmp_path / "port", tmp_path / "ref"
    assert _port_cli(cmd, str(mine), "--n-train", "53", "--n-test",
                     "17") == str(mine)
    assert ref_datasets._main([cmd, str(ref), "--n-train", "53",
                               "--n-test", "17"]) == 0
    assert sorted(os.listdir(mine)) == names
    _same_tree(mine, ref)
    # a complete set is left as it is
    stamp = os.path.getmtime(mine / names[0])
    assert _port_cli(cmd, str(mine)) == str(mine)
    assert os.path.getmtime(mine / names[0]) == stamp


@pytest.mark.parametrize("gen", ["generate_mnist_idx",
                                 "generate_cifar10_batches"])
def test_a_partial_set_is_never_overwritten(tmp_path, gen):
    part = tmp_path / "part"
    getattr(datasets, gen)(str(tmp_path / "full"), 20, 10)
    first = sorted(os.listdir(tmp_path / "full"))[0]
    part.mkdir()
    (part / first).write_bytes(b"genuine")
    for mod in (datasets, ref_datasets):
        with pytest.raises(FileExistsError, match="partial"):
            getattr(mod, gen)(str(part), 20, 10)
    assert sorted(os.listdir(part)) == [first]
    assert (part / first).read_bytes() == b"genuine"


def _splits_equal(want, got):
    assert (want is None) == (got is None)
    if want is None:
        return
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        for a, b in zip(w, g):
            _bitwise(a, b)


def test_mnist_reader_gives_the_references_arrays(tmp_path):
    with data_dir_in_both(tmp_path):
        assert datasets.try_load_real_mnist() is None
        base = datasets.generate_mnist_idx(n_train=40, n_test=12)
        assert base == str(tmp_path / "mnist")
        got = datasets.try_load_real_mnist()
        _splits_equal(ref_datasets.try_load_real_mnist(), got)
        (tx, ty), (vx, vy) = got
        assert tx.shape == (40, 28, 28, 1) and tx.dtype == np.float32
        assert vy.shape == (12,) and vy.dtype == np.int32
        assert 0.0 <= tx.min() and tx.max() <= 1.0
        # gzipped files are read the same
        name = "train-images-idx3-ubyte"
        raw = (tmp_path / "mnist" / name).read_bytes()
        os.remove(tmp_path / "mnist" / name)
        with gzip.open(tmp_path / "mnist" / (name + ".gz"), "wb") as f:
            f.write(raw)
        _splits_equal(ref_datasets.try_load_real_mnist(),
                      datasets.try_load_real_mnist())
        _bitwise(datasets.try_load_real_mnist()[0][0], tx)
        for mod in (datasets, ref_datasets):
            _splits_equal(ref_datasets.cap_real(
                ref_datasets.try_load_real_mnist(), 7, 5),
                mod.mnist(7, 5))


def _write_py_batches(base, n=6):
    rng = np.random.RandomState(9)
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
             b"labels": list(rng.randint(0, 10, n))}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)


def test_cifar10_readers_give_the_references_arrays(tmp_path):
    with data_dir_in_both(tmp_path / "bin"):
        datasets.generate_cifar10_batches(n_train=23, n_test=7)
        got = datasets.try_load_real_cifar10()
        _splits_equal(ref_datasets.try_load_real_cifar10(), got)
        (tx, ty), (vx, vy) = got
        assert tx.shape == (23, 32, 32, 3) and vx.shape == (7, 32, 32, 3)
        assert tx.dtype == np.float32 and ty.dtype == np.int32
        _splits_equal(ref_datasets.cifar10(20, 5), datasets.cifar10(20, 5))
    with data_dir_in_both(tmp_path / "py"):
        _write_py_batches(tmp_path / "py" / "cifar10" / "cifar-10-batches-py")
        got = datasets.try_load_real_cifar10()
        _splits_equal(ref_datasets.try_load_real_cifar10(), got)
        assert got[0][0].shape == (30, 32, 32, 3)


@pytest.mark.parametrize("layout", ["bin", "py"])
def test_a_corrupt_cifar10_set_is_counted_not_crashed_on(tmp_path, layout):
    base = tmp_path / "cifar10" / f"cifar-10-batches-{layout}"
    if layout == "bin":
        datasets.generate_cifar10_batches(str(base), 10, 5)
        (base / "data_batch_3.bin").write_bytes(b"\x00" * 3072)
    else:
        _write_py_batches(base)
        (base / "test_batch").write_bytes(b"not a pickle")
    with data_dir_in_both(tmp_path):
        before = datasets.corrupt_cache_count()
        ref_before = ref_datasets.corrupt_cache_count()
        assert datasets.try_load_real_cifar10() is None
        assert ref_datasets.try_load_real_cifar10() is None
        assert datasets.corrupt_cache_count() == before + 1
        assert ref_datasets.corrupt_cache_count() == ref_before + 1
        # the loader falls back to the synthetic stand-in
        ld = Cifar10Loader(None, n_train=12, n_valid=4)
        ld.load_data()
        _bitwise(ld.host_data[4:], datasets.cifar10(12, 4, True)[0][0])


def test_foreign_labels_are_refused(tmp_path):
    path = tmp_path / "data_batch_1.bin"
    rec = np.zeros((2, 3073), np.uint8)
    rec[1, 0] = 200
    rec.tofile(path)
    for mod in (datasets, ref_datasets):
        with pytest.raises(ValueError, match="not CIFAR-10"):
            mod._read_cifar10_bin(str(path))


# -- the loaders -----------------------------------------------------------

LOADERS = [(MnistLoader, RefMnistLoader, "generate_mnist_idx", (30, 14)),
           (Cifar10Loader, RefCifar10Loader, "generate_cifar10_batches",
            (25, 9))]


@pytest.mark.parametrize("cap", [None, (11, 6)])
@pytest.mark.parametrize("port_cls,ref_cls,gen,sizes", LOADERS,
                         ids=["mnist", "cifar10"])
def test_file_loaders_prefer_the_files_and_cap_them(tmp_path, port_cls,
                                                    ref_cls, gen, sizes, cap):
    n_train, n_valid = cap or (1000, 1000)
    with data_dir_in_both(tmp_path):
        getattr(datasets, gen)(None, *sizes)
        ld = port_cls(None, n_train=n_train, n_valid=n_valid)
        ld.load_data()
        ref = ref_cls(None, n_train=n_train, n_valid=n_valid)
        ref.load_data()
    want_lengths = [0, min(n_valid, sizes[1]), min(n_train, sizes[0])]
    assert ld.class_lengths == ref.class_lengths == want_lengths
    _bitwise(ref.original_data.mem, ld.host_data)
    _bitwise(ref.original_labels.mem, ld.host_labels)


@pytest.mark.parametrize("port_cls,ref_cls", [(MnistLoader, RefMnistLoader),
                                              (Cifar10Loader,
                                               RefCifar10Loader)])
def test_file_loaders_without_files_generate_the_stand_in(tmp_path,
                                                          port_cls, ref_cls):
    with data_dir_in_both(tmp_path):
        ld = port_cls(None, n_train=9, n_valid=4)
        ld.load_data()
        ref = ref_cls(None, n_train=9, n_valid=4)
        ref.load_data()
    assert ld.class_lengths == ref.class_lengths == [0, 4, 9]
    _bitwise(ref.original_data.mem, ld.host_data)
    _bitwise(ref.original_labels.mem, ld.host_labels)


def _bytes(n_train=48, n_valid=16, shape=(4, 4, 2), seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n_train + n_valid,) + shape).astype(np.uint8)
    y = rng.randint(0, 3, n_train + n_valid).astype(np.int32)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def _loaders(train, valid, **kw):
    port = ArrayLoader(None, train=train, valid=valid, name="loader", **kw)
    port.initialize(make_device("cpu"))
    ref = RefArrayLoader(None, train=train, valid=valid, name="loader", **kw)
    ref.initialize(device=JaxDevice(platform="cpu"))
    return port, ref


@pytest.mark.parametrize("norm", ["none", "linear", "mean_disp",
                                  "pointwise"])
@pytest.mark.parametrize("quant", ["auto", True, False])
def test_array_loader_post_load_data_is_the_references(norm, quant):
    train, valid = _bytes()
    port, ref = _loaders(train, valid, normalization_type=norm,
                         quantized_ingest=quant, minibatch_size=8)
    assert (port.dequant is None) == (ref.dequant is None) == \
        (quant is False)
    if port.dequant is not None:
        _bitwise((ref.dequant.scale, ref.dequant.bias),
                 (port.dequant.scale, port.dequant.bias))
        assert port.original_data.dtype == torch.uint8
    if norm != "none":
        _bitwise(ref.normalizer.state(), port.normalizer.state())
    # the port holds what the reference holds: the codec's bytes, a
    # normalizer's f32, or (codec off, normalization "none") the stored
    # bytes, which the forward's first op casts
    got = port.device.get(port.original_data)
    _bitwise(ref.original_data.map_read(), got)
    _bitwise(ref.original_labels.map_read().astype(np.int64),
             port.device.get(port.original_labels))
    idx = np.array([3, 0, 60, 17])
    for rows in (idx, slice(2, 9)):
        _bitwise(ref.normalized_host_rows(rows).astype(np.float32),
                 port.normalized_host_rows(rows))


def test_normalizer_fits_on_train_only():
    train, valid = _bytes()
    valid = (np.full_like(valid[0], 255), valid[1])
    train = (np.minimum(train[0], 200).astype(np.uint8), train[1])
    port, _ = _loaders(train, valid, normalization_type="linear")
    assert (port.normalizer.dmin, port.normalizer.dmax) == \
        (float(train[0].min()), 200.0)


def test_quantized_ingest_true_refusals_are_the_references():
    train, valid = _bytes()
    frac = ((train[0] + 0.5).astype(np.float32), train[1])
    for cls in (ArrayLoader, RefArrayLoader):
        ld = cls(None, train=frac, valid=valid, quantized_ingest=True)
        ld.load_data()
        with pytest.raises(ValueError, match="not byte-ranged"):
            ld.post_load_data()
        ld = cls(None, train=(train[0][:0], train[1][:0]), valid=valid,
                 normalization_type="mean_disp")
        ld.load_data()
        with pytest.raises(ValueError, match="needs a TRAIN split"):
            ld.post_load_data()
    # integral floats ride the codec when asked, not by "auto"
    ints = (train[0].astype(np.float32), train[1])
    for quant, dtype in (("auto", np.float32), (True, np.uint8)):
        ld = ArrayLoader(None, train=ints, valid=valid,
                         quantized_ingest=quant)
        ld.load_data()
        ld.post_load_data()
        assert ld.host_data.dtype == dtype


def test_a_byte_set_4x_over_the_float_budget_stays_resident():
    """The budget is charged at the stored dtype's bytes: 16 KiB of
    bytes is resident under a 16 KiB budget, with the codec and with it
    off; the same values stored as f32 (64 KiB) stream."""
    train, valid = _bytes(192, 64, (8, 8, 1))
    budget = 256 * 64
    as_f32 = [(x.astype(np.float32), y) for x, y in (train, valid)]
    f32, _ = _loaders(*as_f32, max_resident_bytes=budget,
                      quantized_ingest=False)
    assert not f32.device_resident and f32.host_data.nbytes == 4 * budget
    for quant in ("auto", False):
        u8, _ = _loaders(train, valid, max_resident_bytes=budget,
                         quantized_ingest=quant)
        assert u8.device_resident and u8.host_data is None
        assert u8.original_data.dtype == torch.uint8
        assert (u8.dequant is None) == (quant is False)
        assert u8.original_data.numel() * \
            u8.original_data.element_size() == budget


def test_loader_state_rides_the_pickle_and_old_snapshots_default():
    train, valid = _bytes()
    ld = ArrayLoader(None, train=train, valid=valid, name="loader",
                     normalization_type="mean_disp",
                     normalization_parameters={})
    ld.initialize(make_device("cpu"))
    back = pickle.loads(pickle.dumps(ld))
    assert back.original_data is None and back.host_data is None
    _bitwise(ld.normalizer.state(), back.normalizer.state())
    _bitwise((ld.dequant.scale, ld.dequant.bias),
             (back.dequant.scale, back.dequant.bias))
    assert (back.quantized_ingest, back._quant_pre_scale) == ("auto", 1.0)
    # a snapshot from before normalization and the codec were ported
    state = ld.__getstate__()
    for key in ("normalization_type", "normalization_parameters",
                "normalizer", "quantized_ingest", "_quant_pre_scale",
                "dequant"):
        del state[key]
    old = ArrayLoader.__new__(ArrayLoader)
    old.__setstate__(state)
    assert (old.normalization_type, old.normalization_parameters,
            old.normalizer, old.quantized_ingest, old._quant_pre_scale,
            old.dequant) == ("none", {}, None, "auto", 1.0, None)
