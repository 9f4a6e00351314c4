"""Nearest-neighbor evaluation of the port against the JAX package on the CPU.

Nearest selects a table entry and computes nothing, so every comparison is
exact: the port's gather tree against JAX's gather tree, and the kernel
wrappers (their plain versions on a CPU tensor) against the Pallas kernels
K1 (regular) and K3 (rectilinear) in interpret mode. The lower index wins
the tie (dt == 0.5), and a NaN query selects index 1 of its cell on that
axis, because its dt is NaN and fails `dt <= 0.5`.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import nearest as jnearest
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config, convert
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused
from interpn_tpu_torch.ops import nearest as tnearest

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}
CPU = torch.device("cpu")
BAD = [np.nan, np.inf, -np.inf]
DIMS_1_TO_6 = [(9,), (6, 7), (5, 4, 6), (4, 5, 3, 4), (3, 4, 3, 2, 3), (2, 3, 2, 3, 2, 3)]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _regular(dims, dtype, seed=0, n=500, bad=True):
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd).astype(dtype)
    steps = rng.uniform(0.3, 1.0, nd).astype(dtype)
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    obs = [
        rng.uniform(starts[k] - 2 * steps[k], starts[k] + steps[k] * (dims[k] + 1), n)
        .astype(dtype)
        for k in range(nd)
    ]
    if bad:
        for o in obs:
            o[rng.integers(0, n, 6)] = rng.choice(BAD, 6)
    return starts, steps, vals, obs


def _rectilinear(dims, dtype, seed=0, n=500, bad=True):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    obs = [rng.uniform(g[0] - 1.0, g[-1] + 1.0, n).astype(dtype) for g in grids]
    if bad:
        for o in obs:
            o[rng.integers(0, n, 6)] = rng.choice(BAD, 6)
    return grids, vals, obs


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(arrays, dtype):
    return convert.obs_from_numpy(arrays, device=CPU, dtype=TDTYPE[dtype])


def _port_regular(dims, starts, steps, vals, obs, dtype):
    args = convert.regular_grid_from_numpy(dims, starts, steps, vals, device=CPU,
                                           dtype=TDTYPE[dtype])
    return args, _t(obs, dtype)


@pytest.mark.parametrize("dims", DIMS_1_TO_6, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nearest_regular_matches_jax(dims, dtype):
    starts, steps, vals, obs = _regular(dims, dtype, seed=len(dims))
    want = jnearest.nearest_regular(dims, *_j((starts, steps, vals)), _j(obs))
    args, ob = _port_regular(dims, starts, steps, vals, obs, dtype)
    got = tnearest.nearest_regular(*args, ob)
    assert got.dtype == TDTYPE[dtype] and got.shape == (500,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dims", DIMS_1_TO_6, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nearest_rectilinear_matches_jax(dims, dtype):
    grids, vals, obs = _rectilinear(dims, dtype, seed=len(dims))
    want = jnearest.nearest_rectilinear(_j(grids), jnp.asarray(vals), _j(obs))
    got = tnearest.nearest_rectilinear(_t(grids, dtype), torch.from_numpy(vals), _t(obs, dtype))
    assert got.dtype == TDTYPE[dtype] and got.shape == (500,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tie_selects_the_lower_index(dtype):
    """Queries exactly halfway between two nodes (dt == 0.5 in the dtype)
    select the lower one, on both grid kinds, as JAX does; a hair above
    selects the upper one."""
    x = np.arange(8, dtype=dtype) * dtype(0.5)  # regular and, as an array, rectilinear
    vals = np.arange(8, dtype=dtype) * 10
    mid = ((x[:-1] + x[1:]) / 2).astype(dtype)
    above = np.nextafter(mid, dtype(np.inf))
    q = np.concatenate([mid, above])
    want_idx = np.concatenate([np.arange(7), np.arange(1, 8)])
    args, ob = _port_regular((8,), x[:1], x[1:2] - x[:1], vals, [q], dtype)
    got = tnearest.nearest_regular(*args, ob)
    np.testing.assert_array_equal(got.numpy(), vals[want_idx])
    want = jnearest.nearest_regular((8,), *_j((x[:1], x[1:2] - x[:1], vals)), _j([q]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tnearest.nearest_rectilinear(_t([x], dtype), torch.from_numpy(vals), _t([q], dtype))
    np.testing.assert_array_equal(got.numpy(), vals[want_idx])
    want = jnearest.nearest_rectilinear(_j([x]), jnp.asarray(vals), _j([q]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nan_query_selects_index_one(dtype):
    """A NaN coordinate reads cell 0 with dt = NaN, which fails dt <= 0.5:
    index 1 on that axis, on both grid kinds, as JAX does. +-inf clamp to
    the edge cells and select the outer node."""
    dims = (5, 6)
    vals = np.arange(30, dtype=dtype)
    q0 = np.array([np.nan, np.nan, np.inf, -np.inf, 1.0], dtype)
    q1 = np.array([0.0, 2.0, 2.0, 2.0, np.nan], dtype)
    want_idx = np.array([1 * 6 + 0, 1 * 6 + 2, 4 * 6 + 2, 0 * 6 + 2, 1 * 6 + 1])
    starts, steps = np.zeros(2, dtype), np.ones(2, dtype)
    args, ob = _port_regular(dims, starts, steps, vals, [q0, q1], dtype)
    got = tnearest.nearest_regular(*args, ob)
    np.testing.assert_array_equal(got.numpy(), vals[want_idx])
    want = jnearest.nearest_regular(dims, *_j((starts, steps, vals)), _j([q0, q1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    axes = [np.arange(5, dtype=dtype), np.arange(6, dtype=dtype)]
    got = tnearest.nearest_rectilinear(_t(axes, dtype), torch.from_numpy(vals),
                                       _t([q0, q1], dtype))
    np.testing.assert_array_equal(got.numpy(), vals[want_idx])
    want = jnearest.nearest_rectilinear(_j(axes), jnp.asarray(vals), _j([q0, q1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nearest_grid_nodes_exact(dtype):
    dims = (7, 6, 5)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    idx = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")).reshape(3, -1)
    args, ob = _port_regular(dims, np.zeros(3), np.full(3, 0.5), vals,
                             [i * 0.5 for i in idx], dtype)
    np.testing.assert_array_equal(tnearest.nearest_regular(*args, ob).numpy(), vals)
    axes = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    got = tnearest.nearest_rectilinear(_t(axes, dtype), torch.from_numpy(vals),
                                       _t([a[i] for a, i in zip(axes, idx)], dtype))
    np.testing.assert_array_equal(got.numpy(), vals)


# --- the kernel wrappers: plain versions on the CPU vs K1/K3 in interpret mode ---


@pytest.mark.parametrize("dims", [(9, 11), (9, 11, 7), (6, 5, 4, 7), (4, 5, 4, 5, 4)], ids=str)
def test_fused_nearest_plain_matches_pallas_k1(_interpret_mode, dims):  # noqa: F811
    starts, steps, vals, obs = _regular(dims, np.float32, seed=30 + len(dims), n=700, bad=False)
    want = jv3.eval_regular(dims, *_j((starts, steps, vals)), _j(obs), "nearest", True)
    args, ob = _port_regular(dims, starts, steps, vals, obs, np.float32)
    before = dict(tfused.launches)
    got = tfused.eval_regular(*args, ob, "nearest")
    assert tfused.launches == before  # the CPU runs the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dims", [(9, 11), (9, 11, 7), (6, 5, 4, 7), (4, 5, 4, 5, 4)], ids=str)
def test_fused_nearest_rectilinear_plain_matches_pallas_k3(_interpret_mode, dims):  # noqa: F811
    grids, vals, obs = _rectilinear(dims, np.float32, seed=40 + len(dims), n=700, bad=False)
    want = jv3.eval_rectilinear(_j(grids), jnp.asarray(vals), _j(obs), "nearest", True)
    before = dict(tfused.launches)
    got = tfused.eval_rectilinear(_t(grids, np.float32), torch.from_numpy(vals),
                                  _t(obs, np.float32), "nearest")
    assert tfused.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_nearest_routes_cpu_to_gather(monkeypatch):
    monkeypatch.setattr(tfused, "eval_regular", lambda *a, **k: pytest.fail("kernel on CPU"))
    monkeypatch.setattr(tfused, "eval_rectilinear", lambda *a, **k: pytest.fail("kernel on CPU"))
    dims = (5, 6)
    starts, steps, vals, obs = _regular(dims, np.float64, n=24)
    args, ob = _port_regular(dims, starts, steps, vals, obs, np.float64)
    ob = tuple(o.reshape(4, 6) for o in ob)
    got = tdispatch.nearest_regular(*args, ob)
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), tnearest.nearest_regular(*args, ob).numpy())
    grids, rvals, robs = _rectilinear(dims, np.float64, n=24)
    rg, rv = convert.rectilinear_grid_from_numpy(grids, rvals, device=CPU, dtype=torch.float64)
    np.testing.assert_array_equal(
        tdispatch.nearest_rectilinear(rg, rv, _t(robs, np.float64)).numpy(),
        tnearest.nearest_rectilinear(rg, rv, _t(robs, np.float64)).numpy())
