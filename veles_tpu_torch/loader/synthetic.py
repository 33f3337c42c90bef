"""The synthetic classification loader, and the MNIST and CIFAR-10
loaders over real files.

Counterpart of ``veles_tpu/loader/synthetic.py``
(``SyntheticClassificationLoader``, ``_RealFileMixin``, ``MnistLoader``,
``Cifar10Loader``).  The synthetic data set is fully determined by the
constructor arguments (``shape``, ``n_classes``, split sizes, noise,
shift, seed) and generated by ``veles_tpu_torch/datasets.py``, bitwise
the reference's.  ``MnistLoader`` and ``Cifar10Loader`` read the real
files under the data dir when a complete set is there (``n_train`` and
``n_valid`` cap them), else generate their stand-ins.  The
normalization and codec keys (``normalization_type``,
``normalization_parameters``, ``quantized_ingest``) and the residency
keys pass through to ``FullBatchLoader``.  ``targets_from_data=True``
makes the samples their own regression targets (an autoencoder's),
aliased as ``FullBatchLoader`` describes.

Construction materializes nothing: serving reads only
:attr:`sample_shape`.  The data is made in :meth:`load_data`, which only
the training path's ``initialize`` calls, and then uploaded once or
streamed (``loader/fullbatch.py``).  A snapshot carries only the
generator's arguments (and the fitted normalizer): a resumed run reads
or generates the same data again.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from veles_tpu_torch import datasets
from veles_tpu_torch.loader.base import TEST, TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class SyntheticClassificationLoader(FullBatchLoader):
    def __init__(self, workflow: Any = None, n_train: int = 1000,
                 n_valid: int = 200, n_test: int = 0,
                 shape: Tuple[int, ...] = (28, 28, 1), n_classes: int = 10,
                 noise: float = 0.4, max_shift: int = 2,
                 seed: int = 20260729, targets_from_data: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.gen_args = dict(n_train=n_train, n_valid=n_valid,
                             n_test=n_test, shape=tuple(shape),
                             n_classes=n_classes, noise=noise,
                             max_shift=max_shift, seed=seed)
        self.targets_from_data = targets_from_data

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        self.__dict__.setdefault("targets_from_data", False)

    def _set_targets(self) -> None:
        if self.targets_from_data:
            self.host_targets = self.host_data

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return self.gen_args["shape"]

    def load_data(self) -> None:
        a = self.gen_args
        train, valid, test = datasets.synthetic_classification(
            a["n_train"], a["n_valid"], a["shape"],
            n_classes=a["n_classes"], noise=a["noise"],
            max_shift=a["max_shift"], seed=a["seed"], n_test=a["n_test"])
        xs, ys = [], []
        for klass, split in ((TEST, test), (VALID, valid),
                             (TRAIN, train)):
            if split is None:
                self.class_lengths[klass] = 0
                continue
            self.class_lengths[klass] = len(split[0])
            xs.append(split[0])
            ys.append(split[1])
        self.host_data = np.concatenate(xs, axis=0)
        self.host_labels = np.concatenate(ys, axis=0)
        self._set_targets()


class _RealFileMixin:
    """``load_data`` over a (train, test) split pair from a
    ``datasets.try_load_real_*`` function: the real files, capped, when
    they are there; else the synthetic stand-in."""

    def _load_real_or_synthetic(self, real) -> None:
        if real is None:
            super().load_data()
            return
        # n_train / n_valid cap the real files too: a config asking for
        # a 100-sample run must not silently train on every row
        (tx, ty), (vx, vy), _ = datasets.cap_real(
            real, self.gen_args["n_train"], self.gen_args["n_valid"])
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = len(vx)
        self.class_lengths[TRAIN] = len(tx)
        self.host_data = np.concatenate([vx, tx], axis=0)
        self.host_labels = np.concatenate([vy, ty], axis=0)
        self._set_targets()


class MnistLoader(_RealFileMixin, SyntheticClassificationLoader):
    """Real MNIST IDX files under ``<data_dir>/mnist`` if there, else the
    synthetic 28x28x1 stand-in (seed 28281)."""

    def __init__(self, workflow: Any = None, n_train: int = 60000,
                 n_valid: int = 10000, **kwargs: Any) -> None:
        super().__init__(workflow, n_train=n_train, n_valid=n_valid,
                         shape=(28, 28, 1), seed=28281, **kwargs)

    def load_data(self) -> None:
        self._load_real_or_synthetic(datasets.try_load_real_mnist())


class Cifar10Loader(_RealFileMixin, SyntheticClassificationLoader):
    """Real CIFAR-10 batch files (binary or python-pickle layout) under
    ``<data_dir>/cifar10`` if there, else the synthetic 32x32x3 stand-in
    (noise 0.5, seed 32323)."""

    def __init__(self, workflow: Any = None, n_train: int = 50000,
                 n_valid: int = 10000, **kwargs: Any) -> None:
        kwargs.setdefault("noise", 0.5)
        kwargs.setdefault("seed", 32323)
        super().__init__(workflow, n_train=n_train, n_valid=n_valid,
                         shape=(32, 32, 3), **kwargs)

    def load_data(self) -> None:
        self._load_real_or_synthetic(datasets.try_load_real_cifar10())
