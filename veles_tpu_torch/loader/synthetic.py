"""The synthetic classification loader, as serving sees it.

Counterpart of ``veles_tpu/loader/synthetic.py:
SyntheticClassificationLoader``, reduced to its description: it records
the generator arguments (``shape``, ``n_classes``, sizes, seed) and
exposes ``sample_shape``, and materializes no data.  Serving reads only
the sample shape; the reference's hive builds the whole set (4096 x 227
x 227 x 3 for AlexNet) and then frees it.  The data itself arrives with
the training slice.
"""

from __future__ import annotations

from typing import Any, Tuple


class SyntheticClassificationLoader:
    def __init__(self, workflow: Any = None, name: str = "loader",
                 n_train: int = 1000, n_valid: int = 200, n_test: int = 0,
                 shape: Tuple[int, ...] = (28, 28, 1), n_classes: int = 10,
                 noise: float = 0.4, max_shift: int = 2,
                 seed: int = 20260729, minibatch_size: int = 100) -> None:
        self.workflow = workflow
        self.name = name
        self.gen_args = dict(n_train=n_train, n_valid=n_valid,
                             n_test=n_test, shape=tuple(shape),
                             n_classes=n_classes, noise=noise,
                             max_shift=max_shift, seed=seed)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return self.gen_args["shape"]
