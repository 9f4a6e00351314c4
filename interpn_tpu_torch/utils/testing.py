"""Repeatable-randomness helpers for tests and benchmarks.

A copy of `interpn_tpu/utils/testing.py` (numpy only, but importing
`interpn_tpu` would import jax): fixed-seed generators so every run sees
the same data.
"""

from __future__ import annotations

import numpy as np

FIXED_SEED = 20260816


def rng_fixed_seed(seed: int = FIXED_SEED) -> np.random.Generator:
    """A numpy Generator with a fixed seed."""
    return np.random.default_rng(seed)


def randn(rng: np.random.Generator, n: int, dtype=np.float64) -> np.ndarray:
    """Standard-normal samples in the requested dtype."""
    return rng.standard_normal(n).astype(dtype)


def perturbed_monotonic_grid(
    rng: np.random.Generator, lo: float, hi: float, n: int, jitter: float = 0.1
) -> np.ndarray:
    """A monotonically increasing grid: linspace plus bounded noise (the
    rectilinear-test grid construction used throughout the suites)."""
    g = np.linspace(lo, hi, n)
    step = (hi - lo) / max(n - 1, 1)
    g[1:-1] += (rng.random(n - 2) - 0.5) * jitter * step
    assert np.all(np.diff(g) > 0)
    return g
