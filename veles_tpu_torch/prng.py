"""Named, seeded pseudo-random generator streams (the port's own copy).

Counterpart of ``veles_tpu/prng.py``: ``get(name)`` returns a named
deterministic stream whose seed derives from the base seed
(``seed_all``, the CLI's ``--seed``) and an FNV-1a hash of the name, so
every stream's numpy ``Generator`` draws bitwise what the reference's
draws: weight init (``"weights"``), the epoch shuffle (``"loader"``).

The reference's JAX key chain (``next_key``/``key_at``) has no
counterpart: torch cannot reproduce threefry bits.  In its place
:func:`torch_generator` seeds a ``torch.Generator`` from the same
``(seed, rng_counter, layer)`` triple the reference folds into its keys
(``fold_in(fold_in(key(seed), rc), i)``), so dropout masks are
deterministic within the port but differ from the reference's.

:func:`uniform` is the one seam every other traced draw goes through
(binarization, CD-k sampling, stochastic pooling): f32 uniforms on
``[0, 1)`` for a layer's generator and a Gibbs step ``t``, step ``t > 0``
from a generator keyed by ``(layer's key, t)``, the counterpart of
``fold_in(rng, t)``.  The units write the reference's formulas on top
(Bernoulli ``u < p``, Gumbel ``-log(-log(max(u, tiny)))``), so a test
that replaces :func:`torch_generator` and :func:`uniform` with the
reference's key chain and ``jax.random.uniform`` draws exactly the
reference's uniforms.  Dropout draws through it too.  On a
data-parallel rank each layer's generator is a :class:`RowSlice`: the
draw covers the global minibatch and the rank keeps its rows, so the
ranks together draw what one device draws.  A member-sharded
cohort's places share each minibatch's draws through
:class:`SharedDraws`: made once, copied to every place.

:func:`snapshot_state` / :func:`restore_state` carry every named
stream's numpy state through a snapshot (``snapshotter.py``), so a
resumed run neither re-draws ``"weights"`` nor re-shuffles
``"loader"``; the dropout draws resume through the fused runner's
``rng_counter``, which rides in the snapshot with the runner.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_M64 = (1 << 64) - 1


class RandomStream:
    def __init__(self, name: str, seed: int) -> None:
        self.name = name
        self.seed = seed
        self.numpy: np.random.Generator = np.random.default_rng(seed)

    def __getstate__(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "numpy_state": self.numpy.bit_generator.state}

    def __setstate__(self, state: dict) -> None:
        self.name = state["name"]
        self.seed = state["seed"]
        self.numpy = np.random.default_rng(self.seed)
        self.numpy.bit_generator.state = state["numpy_state"]


_streams: Dict[str, RandomStream] = {}
_default_seed = 1234


def seed_all(seed: int) -> None:
    """Set the base seed and reset every existing stream (CLI --seed)."""
    global _default_seed
    _default_seed = seed
    names = list(_streams)
    _streams.clear()
    for n in names:
        get(n)


def get(name: str = "default", seed: Optional[int] = None) -> RandomStream:
    """The named stream, created on first use.

    Per-stream seeds derive from the base seed and the stream name, so
    streams are independent but fully determined by (base seed, name).
    """
    if name not in _streams:
        if seed is None:
            h = 14695981039346656037
            for ch in name.encode():
                h = ((h ^ ch) * 1099511628211) % (2**64)
            seed = (_default_seed ^ h) % (2**63)
        _streams[name] = RandomStream(name, seed)
    return _streams[name]


def snapshot_state() -> Dict[str, dict]:
    """Every named stream's state (what a snapshot carries)."""
    return {n: s.__getstate__() for n, s in _streams.items()}


def restore_state(state: Dict[str, dict]) -> None:
    """Put back the streams :func:`snapshot_state` took."""
    for n, st in state.items():
        s = RandomStream.__new__(RandomStream)
        s.__setstate__(st)
        _streams[n] = s


def _splitmix64(v: int) -> int:
    """One SplitMix64 step: a bijective 64-bit mixer."""
    v = (v + 0x9E3779B97F4A7C15) & _M64
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _M64
    return v ^ (v >> 31)


def generator_seed(seed: int, counter: int, layer: int) -> int:
    """The seed :func:`torch_generator` uses:
    ``splitmix64(splitmix64(splitmix64(seed) ^ counter) ^ layer)``, cut
    to 63 bits.  Each fold goes through the mixer, so neighbouring
    counters and layers get unrelated seeds."""
    v = _splitmix64(seed & _M64)
    v = _splitmix64(v ^ (counter & _M64))
    v = _splitmix64(v ^ (layer & _M64))
    return v & ((1 << 63) - 1)


class RowSlice:
    """A stochastic layer's generator on one data-parallel rank: every
    draw is made for the GLOBAL minibatch's ``total`` rows and the rank
    keeps rows ``[lo, hi)``, so N ranks together draw what one device
    draws (``uniform`` reads it; the leading axis of a draw is the
    minibatch's)."""

    __slots__ = ("gen", "lo", "hi", "total")

    def __init__(self, gen: torch.Generator, lo: int, hi: int,
                 total: int) -> None:
        self.gen, self.lo, self.hi, self.total = gen, lo, hi, total


def torch_generator(seed: int, counter: int, layer: int,
                    device: torch.device, rows=None):
    """A ``torch.Generator`` on ``device`` for stochastic layer ``layer``
    at the minibatch numbered ``counter`` (the fused runner's
    rng_counter) of a run seeded by ``seed``; with ``rows=(lo, hi,
    total)`` (a data-parallel rank's slice) the :class:`RowSlice` of
    it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, counter, layer))
    return gen if rows is None else RowSlice(gen, *rows)


class SharedDraws:
    """One minibatch's draws made once, on ``device``, and copied to
    every place that asks: a member-sharded cohort's places
    (``ops/population.py``) each run the same layers at the same
    ``(seed, counter)`` and so ask for the same draws in the same order.
    :meth:`generator` stands where :func:`torch_generator` would; a draw
    is made by the first place that asks for it and kept, keyed by
    (layer, Gibbs step, its ordinal among that layer's draws, shape),
    until the counter moves on.  What it hands out is bitwise what
    :func:`torch_generator` on ``device`` draws, on one card or
    several."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self._at = None
        self._gens: Dict[int, torch.Generator] = {}
        self._made: Dict[tuple, torch.Tensor] = {}

    def generator(self, seed: int, counter: int, layer: int
                  ) -> "_SharedGen":
        if self._at != (seed, counter):
            self._at = (seed, counter)
            self._gens.clear()
            self._made.clear()
        return _SharedGen(self, seed, counter, layer)

    def draw(self, g: "_SharedGen", shape, t: int) -> torch.Tensor:
        key = (g.layer, t, g.drawn, tuple(shape))
        g.drawn += 1
        u = self._made.get(key)
        if u is None:
            rng = self._gens.get(g.layer)
            if rng is None:
                rng = self._gens[g.layer] = torch_generator(
                    g.seed, g.counter, g.layer, self.device)
            u = self._made[key] = uniform(rng, shape, self.device, t)
        return u


class _SharedGen:
    """A stochastic layer's generator under :class:`SharedDraws`."""
    __slots__ = ("draws", "seed", "counter", "layer", "drawn")

    def __init__(self, draws: SharedDraws, seed: int, counter: int,
                 layer: int) -> None:
        self.draws, self.seed, self.counter = draws, seed, counter
        self.layer, self.drawn = layer, 0


def uniform(rng, shape, device: torch.device, t: int = 0) -> torch.Tensor:
    """f32 uniforms on ``[0, 1)`` of ``shape`` on ``device``: from the
    layer's generator ``rng`` at Gibbs step ``t == 0``, else from a
    generator keyed by ``(rng's seed, t)``.  On the card ``rng`` is a
    CUDA generator and the draw is made there.  A :class:`RowSlice`
    draws the global minibatch's rows and returns its own."""
    if isinstance(rng, _SharedGen):
        return rng.draws.draw(rng, shape, t).to(device)
    rows = None
    if isinstance(rng, RowSlice):
        rows, rng = rng, rng.gen
        shape = (rows.total,) + tuple(shape[1:])
    if t:
        gen = torch.Generator(device=rng.device)
        gen.manual_seed(_splitmix64(rng.initial_seed() ^ (t & _M64))
                        & ((1 << 63) - 1))
        rng = gen
    u = torch.rand(tuple(shape), generator=rng, device=rng.device,
                   dtype=torch.float32)
    if rows is not None:
        u = u[rows.lo:rows.hi]
    return u.to(device)
