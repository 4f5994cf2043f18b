"""Seeded RNG helpers — the Random class analog (source/util/random.h).

The reference wraps a thread_local std::mt19937; here a numpy Generator
seeded explicitly (functional style: pass the Rng around, no global state),
which makes the star field and scene generation reproducible by
construction — the determinism knob the reference lacks.

A copy of ``gamer_tpu.utils.rng``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import numpy as np


class Rng:
    def __init__(self, seed: int = 5489):  # mt19937 default_seed
        self._g = np.random.Generator(np.random.MT19937(seed))

    def next_double(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return float(self._g.uniform(lo, hi))

    def next_gaussian(self, mean: float, sigma: float) -> float:
        return float(self._g.normal(mean, sigma))

    def next_int(self, lo: int, hi: int) -> int:
        """Inclusive range, like std::uniform_int_distribution."""
        return int(self._g.integers(lo, hi + 1))

    def next_bool(self) -> bool:
        return bool(self._g.integers(0, 2))

    def next_vec3(self, lo: float, hi: float):
        return tuple(float(v) for v in self._g.uniform(lo, hi, size=3))
