"""Rectilinear grids: the port's locate, multilinear gather tree, bounds
check and kernel wrappers against the JAX package on the CPU.

Tolerances:
* locate and bounds: exact.
* linear gather tree vs gather tree: f32 rtol=atol=1e-6, f64
  rtol=atol=1e-13 (the same operations in the same order; XLA:CPU may
  contract a multiply-add into an FMA).
* the kernel wrapper (its plain version on a CPU tensor) vs the Pallas
  kernel K2 (`eval_rectilinear_pre`) in interpret mode, exact contraction
  mode: rtol=atol=1e-4, the JAX package's bar against the gather tree in
  tests/test_pallas_v3.py; rtol=5e-4, atol=2e-3 for 5D cubic, as its 5D
  regular case.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import bounds as jbounds
from interpn_tpu.ops import linear as jlinear
from interpn_tpu.ops import locate as jlocate
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config, convert
from interpn_tpu_torch.ops import bounds as tbounds
from interpn_tpu_torch.ops import cubic as tcubic
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused
from interpn_tpu_torch.ops import linear as tlinear
from interpn_tpu_torch.ops import locate as tlocate

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

TOL = {np.float32: dict(rtol=1e-6, atol=1e-6), np.float64: dict(rtol=1e-13, atol=1e-13)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}
CPU = torch.device("cpu")
BAD = [np.nan, np.inf, -np.inf]
DIMS_1_TO_8 = [(9,), (8, 6), (7, 5, 6), (5, 4, 6, 3), (4, 3, 4, 3, 4), (3, 4, 3, 3, 2, 3),
               (3, 2, 3, 2, 3, 2, 3), (2, 3, 2, 2, 3, 2, 2, 3)]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _case(dims, dtype, seed=0, n=500, bad=True):
    """Jittered sorted axes; queries one unit past each side, with NaN and
    +-inf mixed in."""
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


def _port(grids, vals, obs, dtype):
    g, v = convert.rectilinear_grid_from_numpy(grids, vals, device=CPU, dtype=TDTYPE[dtype])
    return g, v, convert.obs_from_numpy(obs, device=CPU, dtype=TDTYPE[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 3, 20, 100])
def test_locate_rectilinear_linear_matches_jax_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    g = np.cumsum(0.2 + rng.random(n)).astype(dtype)
    x = rng.uniform(g[0] - 2, g[-1] + 2, 600).astype(dtype)
    x[:5] = [np.nan, np.inf, -np.inf, 1e30, -1e30]
    x[5 : 5 + n] = g  # every node
    want = jlocate.locate_rectilinear_linear(jnp.asarray(x), jnp.asarray(g))
    got = tlocate.locate_rectilinear_linear(torch.from_numpy(x), torch.from_numpy(g))
    assert got[0].dtype == torch.int32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0][0] == 0  # NaN counts no entry: cell 0, as the reference's bisection


def test_partition_point_pins_nan():
    g = torch.tensor([0.0, 1.0, 2.0])
    x = torch.tensor([float("nan"), -1.0, 0.0, 0.5, 1.0, 5.0, float("inf"), -float("inf")])
    assert tlocate.partition_point(g, x).tolist() == [0, 0, 0, 1, 1, 3, 3, 0]


@pytest.mark.parametrize("dims", DIMS_1_TO_8, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_rectilinear_matches_jax(dims, dtype):
    grids, vals, obs = _case(dims, dtype, seed=len(dims))
    want = np.asarray(jlinear.linear_rectilinear(_j(grids), jnp.asarray(vals), _j(obs)))
    got = tlinear.linear_rectilinear(*_port(grids, vals, obs, dtype))
    assert got.dtype == TDTYPE[dtype] and got.shape == (500,)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_rectilinear_grid_nodes_match_jax(dtype):
    """Every node: bitwise equal to JAX, and within rounding of vals. The
    bisection counts the entries < x, so a node is the t = 1 end of the
    cell below it, where y0 + 1*(y1 - y0) may round away from y1."""
    dims = (9, 8, 7)
    grids, vals, _ = _case(dims, dtype, seed=5, bad=False)
    idx = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")).reshape(3, -1)
    obs = [g[i] for g, i in zip(grids, idx)]
    got = tlinear.linear_rectilinear(*_port(grids, vals, obs, dtype)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jlinear.linear_rectilinear(_j(grids), jnp.asarray(vals), _j(obs))))
    np.testing.assert_allclose(got, vals, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spread", [0.0, 1e-9, 0.3])
def test_check_bounds_rectilinear_matches_jax(dtype, spread):
    grids, _, obs = _case((5, 6, 7), dtype, seed=6, bad=False)
    obs = [np.clip(o, g[0], g[-1]) for o, g in zip(obs, grids)]
    obs[1][0] = grids[1][-1] + spread
    obs[2][1] = grids[2][0] - spread
    for atol in (1e-8, 0.1):
        want = np.asarray(jbounds.check_bounds_rectilinear(
            _j(grids), _j(obs), jnp.asarray(atol, dtype)))
        got = tbounds.check_bounds_rectilinear(
            convert.obs_from_numpy(grids, device=CPU, dtype=TDTYPE[dtype]),
            convert.obs_from_numpy(obs, device=CPU, dtype=TDTYPE[dtype]), atol)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def test_rectilinear_grid_from_numpy():
    grids = [np.arange(3.0), np.arange(4, dtype=np.float32)]
    g, v = convert.rectilinear_grid_from_numpy(grids, np.ones((3, 4)), device=CPU,
                                               dtype=torch.float32)
    assert [t.dtype for t in g] == [torch.float32] * 2 and v.shape == (12,)
    assert [t.tolist() for t in g] == [[0, 1, 2], [0, 1, 2, 3]]


# --- the kernel wrapper: plain version on the CPU vs K2 in interpret mode ------


K2_CASES = [
    ((8, 12), "linear"), ((10, 10, 10), "linear"), ((6, 5, 4, 7), "linear"),
    ((4, 5, 4, 5, 4), "linear"),
] + [(dims, f"cubic-{lin}") for lin in ("linearize", "quadratic")
     for dims in ((8, 12), (8, 9, 10), (6, 5, 4, 7), (4, 5, 4, 5, 4))]


@pytest.mark.parametrize("dims,route", K2_CASES, ids=[f"{r}-{d}" for d, r in K2_CASES])
def test_fused_rectilinear_plain_matches_pallas_k2(_interpret_mode, dims, route):  # noqa: F811
    method, lin = route.split("-")[0], route != "cubic-quadratic"
    tol = dict(rtol=5e-4, atol=2e-3) if method == "cubic" and len(dims) == 5 else \
        dict(rtol=1e-4, atol=1e-4)
    grids, vals, obs = _case(dims, np.float32, seed=50 + len(dims), n=700, bad=False)
    want = np.asarray(jv3.eval_rectilinear_pre(_j(grids), jnp.asarray(vals), _j(obs),
                                               method, lin, 6))
    before = dict(tfused.launches)
    got = tfused.eval_rectilinear(*_port(grids, vals, obs, np.float32), method, lin)
    assert tfused.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_fused_rectilinear_cpu_is_the_gather_tree(method):
    """The wrapper's CPU route is its plain version: the gather tree, but
    for cubic the weights and their contraction, which hold the gather tree
    at f64 rtol=atol=1e-13 and give its NaNs."""
    dims = (6, 5, 7)
    args = _port(*_case(dims, np.float64), np.float64)
    for lin in (True, False):
        got = tfused.eval_rectilinear(*args, method, lin)
        if method == "cubic":
            tree = tcubic.cubic_rectilinear(*args, lin)
            torch.testing.assert_close(got, tree, rtol=1e-13, atol=1e-13, equal_nan=True)
            want = tfused.plain_rectilinear(*args, method, lin)
        else:
            want = getattr(tdispatch, f"_{method}_rect_gather")(*args)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "mutate,exc,msg",
    [
        (lambda g, v, o: ((g[0].reshape(1, -1), *g[1:]), v, o), ValueError, "1-D tensors"),
        (lambda g, v, o: ((g[0][:1], *g[1:]), v, o), ValueError, "at least 2 points"),
        (lambda g, v, o: (g, v[:-1], o), ValueError, "flat"),
        (lambda g, v, o: ((g[0].double(), *g[1:]), v, o), TypeError, "dtype mismatch"),
        (lambda g, v, o: (g, v, o[:2]), ValueError, "one entry per dim"),
        (lambda g, v, o: (g, v, (o[0], o[1][:3], o[2])), ValueError, "one length"),
    ],
    ids=["2-d-grid", "short-axis", "vals-size", "grid-dtype", "obs-count", "ragged-obs"],
)
def test_fused_rectilinear_check_refuses(mutate, exc, msg):
    grids = tuple(torch.arange(float(d)) for d in (4, 5, 6))
    vals = torch.zeros(120)
    obs = tuple(torch.zeros(16) for _ in range(3))
    assert tfused._check_rectilinear(grids, vals, obs) == 16
    with pytest.raises(exc, match=msg):
        tfused._check_rectilinear(*mutate(grids, vals, obs))


def test_dispatch_rectilinear_routes_cpu_to_gather(monkeypatch):
    monkeypatch.setattr(tfused, "eval_rectilinear", lambda *a, **k: pytest.fail("kernel on CPU"))
    dims = (5, 6)
    g, v, ob = _port(*_case(dims, np.float64, n=24), np.float64)
    assert tdispatch._impl(v) == "gather"
    ob = tuple(o.reshape(4, 6) for o in ob)
    got = tdispatch.linear_rectilinear(g, v, ob)
    assert got.shape == (4, 6)
    torch.testing.assert_close(got, tlinear.linear_rectilinear(g, v, ob), rtol=0, atol=0,
                               equal_nan=True)
