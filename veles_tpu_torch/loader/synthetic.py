"""The synthetic classification loader.

Counterpart of ``veles_tpu/loader/synthetic.py:
SyntheticClassificationLoader``: the data set is fully determined by the
constructor arguments (``shape``, ``n_classes``, split sizes, noise,
shift, seed) and generated by ``veles_tpu_torch/datasets.py``, bitwise
the reference's.  Construction materializes nothing: serving reads only
:attr:`sample_shape`.  The data is generated in :meth:`load_data`, which
only the training path's ``initialize`` calls, and then uploaded once
or streamed (``loader/fullbatch.py``).  A snapshot carries only the
generator's arguments: a resumed run generates the same data again.
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
                 seed: int = 20260729, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.gen_args = dict(n_train=n_train, n_valid=n_valid,
                             n_test=n_test, shape=tuple(shape),
                             n_classes=n_classes, noise=noise,
                             max_shift=max_shift, seed=seed)

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
