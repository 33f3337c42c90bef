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


def torch_generator(seed: int, counter: int, layer: int,
                    device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for stochastic layer ``layer``
    at the minibatch numbered ``counter`` (the fused runner's
    rng_counter) of a run seeded by ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, counter, layer))
    return gen
