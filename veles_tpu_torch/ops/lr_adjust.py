"""Learning-rate schedules.

Counterpart of ``veles_tpu/ops/lr_adjust.py``: the policies (fixed, step,
exp, inv, arbitrary) and ``LearningRateAdjust``, which on every TRAIN
firing writes the fused runner's ``lr_rates``: one (n_gd, 2) row of
ABSOLUTE (weights, bias) rates per minibatch of the superstep, so a
per-iteration schedule stays exact inside a superstep.  With
``by="epoch"``, when the superstep crossed the epoch boundary (always on
its last minibatch: TRAIN is the last class) the loader already counts
the new epoch, and the first k-1 rows belong to the old one.  A
snapshot carries the iteration count and the base rates, and rebuilds
the policy from its name and arguments.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.loader.base import TRAIN

PolicyFn = Callable[[float, int], float]  # (base_lr, t) -> lr

_policies: Dict[str, Callable[..., PolicyFn]] = {}


def policy(name: str):
    def deco(fn):
        _policies[name] = fn
        return fn
    return deco


@policy("fixed")
def fixed_policy() -> PolicyFn:
    return lambda base, t: base


@policy("step")
def step_policy(gamma: float = 0.1, step: int = 10) -> PolicyFn:
    return lambda base, t: base * gamma ** (t // step)


@policy("exp")
def exp_policy(gamma: float = 0.95) -> PolicyFn:
    return lambda base, t: base * gamma ** t


@policy("inv")
def inv_policy(gamma: float = 1e-4, power: float = 0.75) -> PolicyFn:
    return lambda base, t: base * (1.0 + gamma * t) ** (-power)


@policy("arbitrary")
def arbitrary_policy(points: List = ()) -> PolicyFn:
    """Piecewise-constant: points = [(t_from, lr), ...] sorted."""
    pts = sorted(points)

    def fn(base, t):
        lr = base
        for t0, v in pts:
            if t >= t0:
                lr = v
        return lr
    return fn


def make_policy(name: str, **kwargs: Any) -> PolicyFn:
    if name not in _policies:
        raise ValueError(f"unknown lr policy {name!r}; "
                         f"have {sorted(_policies)}")
    return _policies[name](**kwargs)


class LearningRateAdjust:
    """Applies a schedule to every gradient unit, by epoch or by
    iteration; runs between the loader and the fused step."""

    def __init__(self, workflow: Any = None, name: str = "lr_adjust",
                 policy_name: str = "fixed",
                 policy_kwargs: Optional[dict] = None,
                 by: str = "epoch") -> None:
        self.workflow = workflow
        self.name = name
        self.policy_name = policy_name
        self.policy_kwargs = dict(policy_kwargs or {})
        self.policy = make_policy(policy_name, **self.policy_kwargs)
        self.by = by
        self.loader = None
        self.gds: list = []
        self.fused = None
        self._iteration = 0
        self._base_rates: Optional[list] = None

    def __getstate__(self) -> dict:
        return dict(self.__dict__, policy=None)   # a closure

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.policy = make_policy(self.policy_name, **self.policy_kwargs)

    def run(self) -> None:
        if self._base_rates is None:
            self._base_rates = [(gd.learning_rate, gd.learning_rate_bias)
                                for gd in self.gds]
        if self.loader.minibatch_class != TRAIN:
            return
        k = int(self.loader.superstep_k or 1)
        e = self.loader.epoch_number
        ended = bool(self.loader.epoch_ended)

        def t_of(j: int) -> int:
            if self.by == "epoch":
                return e - 1 if (ended and j < k - 1) else e
            return self._iteration + j

        rows = [[[self.policy(base_w, t_of(j)),
                  self.policy(base_b, t_of(j))]
                 for (base_w, base_b) in self._base_rates]
                for j in range(k)]
        self._iteration += k
        # the units (and anything reading them) see the rates of the
        # LAST minibatch of the group
        for gd, row in zip(self.gds, rows[-1]):
            gd.learning_rate, gd.learning_rate_bias = row
        if self.fused is not None:
            self.fused.lr_rates = rows
