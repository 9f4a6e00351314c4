"""The benchmark's reference against an independent float64 NumPy evaluation:
one query at a time, one axis at a time, each 1D interpolant written from
its definition (node values, centred slopes, the quadratic end cells, the
linear continuation), at nodes, inside and outside the grid, for both
`linearize_extrapolation` modes."""

import itertools
import math
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.reference import regular  # noqa: E402


def _hermite(y0, y1, m0, m1, t):
    return ((2 * t**3 - 3 * t**2 + 1) * y0 + (t**3 - 2 * t**2 + t) * m0
            + (-2 * t**3 + 3 * t**2) * y1 + (t**3 - t**2) * m1)


def _end(a, prev, edge, s, linearize):
    """The end cell from node value `a` towards the edge value `edge`, `prev`
    the node on the other side of `a`, at distance s (in steps) from `a`."""
    slope = (edge - prev) / 2
    curve = edge - a - slope  # q(s) = a + slope s + curve s^2, q(1) = edge
    if s > 1 and linearize:
        return edge + (slope + 2 * curve) * (s - 1)
    return a + slope * s + curve * s * s


def cubic_1d(v, x, start, step, linearize):
    d = len(v)
    u = (x - start) / step
    f = math.floor(u)
    if 1 <= f <= d - 3:
        return _hermite(v[f], v[f + 1], (v[f + 1] - v[f - 1]) / 2, (v[f + 2] - v[f]) / 2, u - f)
    if f >= d - 2:
        return _end(v[d - 2], v[d - 3], v[d - 1], u - (d - 2), linearize)
    return _end(v[1], v[2], v[0], 1 - u, linearize)


def linear_1d(v, x, start, step, linearize):
    u = (x - start) / step
    i = min(max(math.floor(u), 0), len(v) - 2)
    return v[i] + (u - i) * (v[i + 1] - v[i])


def numpy_eval(method, table, starts, steps, x, linearize):
    """The tensor product, axis 0 last: interpolate each slice of the
    remaining axes, then along axis 0."""
    one = cubic_1d if method == "cubic" else linear_1d
    if table.ndim == 1:
        return one(table, x[0], starts[0], steps[0], linearize)
    rows = [numpy_eval(method, table[j], starts[1:], steps[1:], x[1:], linearize)
            for j in range(table.shape[0])]
    return one(np.asarray(rows), x[0], starts[0], steps[0], linearize)


def _queries(rng, dims, starts, steps):
    """Nodes, points inside, and points outside by up to three cells."""
    nodes = np.array([[starts[k] + steps[k] * rng.integers(0, d) for k, d in enumerate(dims)]
                      for _ in range(20)])
    stops = np.array(starts) + np.array(steps) * (np.array(dims) - 1)
    inside = rng.uniform(starts, stops, (40, len(dims)))
    span = stops - np.array(starts)
    outside = rng.uniform(np.array(starts) - 3 * np.array(steps),
                          stops + 3 * np.array(steps), (60, len(dims)))
    far = np.array(starts) + span * rng.choice([-0.7, 1.6], (10, len(dims)))
    return np.concatenate([nodes, inside, outside, far])


@pytest.mark.parametrize("method,dims,linearize", [
    *itertools.product(["linear"], [(5,), (4, 6), (3, 5, 4)], [True]),
    *itertools.product(["cubic"], [(4,), (5,), (7, 4), (4, 6, 5), (4, 4, 5, 4)], [True, False]),
])
def test_reference_matches_numpy(method, dims, linearize):
    rng = np.random.default_rng(zlib.crc32(repr((method, dims, linearize)).encode()))
    starts = rng.uniform(-2, 2, len(dims))
    steps = rng.uniform(0.3, 1.7, len(dims))
    table = rng.uniform(-1, 1, dims)
    x = _queries(rng, dims, starts, steps)
    want = np.array([numpy_eval(method, table, starts, steps, q, linearize) for q in x])
    got = regular.evaluate(method, dims, torch.tensor(starts), torch.tensor(steps),
                           torch.tensor(table.reshape(1, -1)), torch.tensor(x.T), linearize)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_reference_reproduces_nodes(method):
    dims = (6, 5, 4)
    rng = np.random.default_rng(7)
    table = rng.uniform(-1, 1, dims)
    grid = np.stack(np.meshgrid(*[np.arange(d) * 0.5 + 1.0 for d in dims], indexing="ij"))
    got = regular.evaluate(method, dims, torch.tensor([1.0] * 3, dtype=torch.float64),
                           torch.tensor([0.5] * 3, dtype=torch.float64),
                           torch.tensor(table.reshape(1, -1)),
                           torch.tensor(grid.reshape(3, -1)))[0]
    np.testing.assert_allclose(got.numpy(), table.ravel(), rtol=0, atol=1e-14)


def test_reference_stack_is_each_table():
    dims = (5, 6)
    rng = np.random.default_rng(3)
    tables = torch.tensor(rng.uniform(-1, 1, (3, 30)))
    obs = torch.tensor(rng.uniform(-1, 4, (2, 50)))
    starts, steps = torch.tensor([0.0, 0.0]), torch.tensor([0.7, 0.5])
    whole = regular.evaluate("cubic", dims, starts, steps, tables, obs)
    for c in range(3):
        one = regular.evaluate("cubic", dims, starts, steps, tables[c:c + 1], obs)[0]
        assert torch.equal(whole[c], one)


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 5 * 2**-12), 0.7],
                     dtype=torch.float32)
    want = [1.0, 1 + 2**-10, 1.0, 1 + 2**-9, -(1 + 2**-10), 0.7001953125]
    assert regular.tf32(x).tolist() == want
