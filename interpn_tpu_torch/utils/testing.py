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


def unrep_edge_cases(dtype) -> list[tuple[str, float, float, float, bool]]:
    """Adversarial queries of the regular grids' unrepresentable-coordinate
    flag in the numpy float `dtype`: (name, x, start, step, whether
    floor((x - start) / step) falls outside [-2^63, 2^63)). NaN, +-inf, the
    largest finite values, quotients just below and at +-2^63 (step 1 and
    step 2), and a tiny step that pushes an ordinary x out of range."""
    d = np.dtype(dtype).type
    big = d(2.0**63)
    fi = np.finfo(d)
    below = np.nextafter(big, d(0))
    return [
        ("ordinary", d(0.5), d(0), d(1), False),
        ("nan", d(np.nan), d(0), d(1), True),
        ("inf", d(np.inf), d(0), d(1), True),
        ("-inf", d(-np.inf), d(0), d(1), True),
        ("max", fi.max, d(0), d(1), True),
        ("-max", -fi.max, d(0), d(1), True),
        ("below_2^63", below, d(0), d(1), False),
        ("at_2^63", big, d(0), d(1), True),
        ("at_-2^63", -big, d(0), d(1), False),
        ("below_-2^63", np.nextafter(-big, d(-np.inf)), d(0), d(1), True),
        ("below_2^63_step2", below * d(2), d(0), d(2), False),
        ("at_2^63_step2", big * d(2), d(0), d(2), True),
        ("tiny_step", d(1), d(0), fi.tiny, True),
    ]
