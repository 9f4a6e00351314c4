"""Multicubic evaluation of the port against the JAX package on the CPU.

The same numpy inputs go through `interpn_tpu` and `interpn_tpu_torch`.
Tolerances:
* locate, helpers and grid nodes: bitwise. Both packages run the same
  operations in the same order, one rounding each.
* gather tree vs gather tree: f64 rtol=atol=1e-13; f32 rtol=atol=1e-5, since
  XLA:CPU may contract a multiply-add of the Hermite polynomial into an FMA
  where PyTorch's separate kernels cannot, and cubic extrapolation amplifies
  that ulp by |t|^3.
* the kernel wrapper (its plain version on a CPU tensor) vs the Pallas
  kernel K1 in interpret mode, exact contraction mode (passes=6): the JAX
  package's own bars in tests/test_pallas_v3.py, rtol=atol=1e-4 up to 4D and
  rtol=5e-4, atol=2e-3 at 5D, since K1 contracts in another order.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import _chunk as jchunk
from interpn_tpu.ops import _gather as jgather
from interpn_tpu.ops import cubic as jcubic
from interpn_tpu.ops import locate as jlocate
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config, convert
from interpn_tpu_torch.ops import _chunk as tchunk
from interpn_tpu_torch.ops import _gather as tgather
from interpn_tpu_torch.ops import cubic as tcubic
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused
from interpn_tpu_torch.ops import locate as tlocate

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-13, atol=1e-13)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}
CPU = torch.device("cpu")
BAD = [np.nan, np.inf, -np.inf]
DIMS_1_TO_8 = [(9,), (6, 7), (5, 4, 6), (4, 5, 4, 4), (4, 4, 5, 4, 4), (4,) * 6,
               (4,) * 7, (4,) * 8]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _case(dims, dtype, seed=0, n=400, bad=True):
    """A regular grid and n queries reaching two cells past each side, with
    NaN and +-inf mixed in."""
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


def _rect_case(dims, dtype, seed=0, n=400, bad=True):
    """Jittered sorted axes and queries one unit past each side."""
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    obs = [rng.uniform(g[0] - 1.0, g[-1] + 1.0, n).astype(dtype) for g in grids]
    if bad:
        for o in obs:
            o[rng.integers(0, n, 6)] = rng.choice(BAD, 6)
    return grids, vals, obs


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=TDTYPE[dtype])


def _j(a):
    return jnp.asarray(a)


def _close(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL[dtype])


# --- locate ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_locate_regular_cubic_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(1)
    x = rng.uniform(-5, 15, 700).astype(dtype)
    x[:6] = [np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0]
    x[6:26] = np.arange(20) * 0.5  # every node of a step-0.5 grid
    want = jlocate.locate_regular_cubic(_j(x), dtype(0.0), dtype(0.5), 20)
    got = tlocate.locate_regular_cubic(torch.from_numpy(x), _t(0.0, dtype), _t(0.5, dtype), 20)
    assert got.loc.dtype == torch.int32
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert 0 <= got.loc.min() and got.loc.max() <= 16
    # NaN: cell 0 for the index, every mask False
    assert got.loc[0] == 0 and not (got.low[0] or got.high[0] or got.outside[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [4, 5, 20])
def test_locate_rectilinear_cubic_matches_jax_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    g = np.cumsum(0.2 + rng.random(n)).astype(dtype)
    x = rng.uniform(g[0] - 2, g[-1] + 2, 500).astype(dtype)
    x[:3] = BAD
    x[3 : 3 + n] = g  # every node
    (wl, wg), (tl, tg) = (
        jlocate.locate_rectilinear_cubic(_j(x), _j(g)),
        tlocate.locate_rectilinear_cubic(torch.from_numpy(x), torch.from_numpy(g)),
    )
    for name, a, b in zip(tl._fields, tl, wl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for a, b in zip(tg, wg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tl.loc[0] == 0 and bool(tl.low[0])  # NaN counts no entry: the low side


# --- helpers ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_helpers_match_jax_bitwise(dtype):
    rng = np.random.default_rng(2)
    a = [rng.standard_normal(300).astype(dtype) for _ in range(5)]
    h = [(0.1 + rng.random(300)).astype(dtype) for _ in range(2)]
    np.testing.assert_array_equal(
        tcubic._hermite(*map(torch.from_numpy, a)).numpy(),
        np.asarray(jcubic._hermite(*map(_j, a))),
    )
    np.testing.assert_array_equal(
        tcubic._centered_diff_nonuniform(*map(torch.from_numpy, a[:3] + h)).numpy(),
        np.asarray(jcubic._centered_diff_nonuniform(*map(_j, a[:3] + h))),
    )


@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_axis_reduce_matches_jax_bitwise(dtype, lin):
    """One tree node per saturation region, regular and rectilinear."""
    rng = np.random.default_rng(3)
    n = 500
    v = [rng.standard_normal(n).astype(dtype) for _ in range(4)]
    t = rng.uniform(-3, 3, n).astype(dtype)
    t[:4] = [0.0, 1.0, -1.0, 2.0]
    region = rng.integers(0, 5, n)  # outside-low, low, none, high, outside-high
    low, high = region <= 1, region >= 3
    outside = (region == 0) | (region == 4)
    masks = (low, high, outside)
    got = tcubic._axis_reduce_regular(
        tuple(map(torch.from_numpy, v)), torch.from_numpy(t), *map(torch.from_numpy, masks), lin)
    want = jcubic._axis_reduce_regular(tuple(map(_j, v)), _j(t), *map(_j, masks), lin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gc = np.cumsum(0.2 + rng.random((4, n)), axis=0).astype(dtype)
    x = rng.uniform(gc[0] - 1, gc[3] + 1).astype(dtype)
    got = tcubic._axis_reduce_rectilinear(
        tuple(map(torch.from_numpy, v)), torch.from_numpy(x), tuple(map(torch.from_numpy, gc)),
        *map(torch.from_numpy, masks), lin)
    want = jcubic._axis_reduce_rectilinear(
        tuple(map(_j, v)), _j(x), tuple(map(_j, gc)), *map(_j, masks), lin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- gathers and chunking --------------------------------------------------


@pytest.mark.parametrize("dims", [(4,), (5, 6), (4, 5, 6), (4, 4, 5, 4, 4)], ids=str)
def test_gather_corners_matrix_matches_jax(dims):
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(math.prod(dims))
    base = rng.integers(0, math.prod(d - 3 for d in dims), 21).astype(np.int32)
    got = tgather.gather_corners_matrix(torch.from_numpy(vals), torch.from_numpy(base), dims, 4)
    want = jgather.gather_corners_matrix(_j(vals), _j(base), dims, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shaped = tgather.gather_corners_matrix(
        torch.from_numpy(vals), torch.from_numpy(base.reshape(3, 7)), dims, 4)
    assert shaped.shape == (4 ** len(dims), 3, 7)
    np.testing.assert_array_equal(shaped.reshape(got.shape).numpy(), got.numpy())
    got2 = tgather.gather_corners_matrix(torch.from_numpy(vals), torch.from_numpy(base), dims, 2)
    want2 = tgather.gather_corners(torch.from_numpy(vals), torch.from_numpy(base), dims, 2)
    np.testing.assert_array_equal(got2.numpy(), torch.stack(want2).numpy())


def test_chunked_cubic_equals_unchunked(monkeypatch):
    """Chunks of 8192 queries (the floor) give the unchunked result bit for
    bit, regular and rectilinear, and keep the query shape."""
    dims = (4, 5, 4, 4, 5)
    starts, steps, vals, obs = _case(dims, np.float64, seed=5, n=9_000)
    args = convert.regular_grid_from_numpy(dims, starts, steps, vals, device=CPU,
                                           dtype=torch.float64)
    ob = convert.obs_from_numpy(obs, device=CPU, dtype=torch.float64)
    whole = tcubic.cubic_regular(*args, ob, True)
    monkeypatch.setattr(tchunk, "DEFAULT_CHUNK_BYTES", 1)
    np.testing.assert_array_equal(tcubic.cubic_regular(*args, ob, True).numpy(), whole.numpy())
    shaped = tcubic.cubic_regular(*args, tuple(o.reshape(90, 100) for o in ob), True)
    np.testing.assert_array_equal(shaped.reshape(-1).numpy(), whole.numpy())
    grids, rvals, robs = _rect_case(dims, np.float64, seed=5, n=9_000)
    rg = tuple(map(torch.from_numpy, grids))
    rob = tuple(map(torch.from_numpy, robs))
    monkeypatch.setattr(tchunk, "DEFAULT_CHUNK_BYTES", 2 * 1024**3)
    rwhole = tcubic.cubic_rectilinear(rg, torch.from_numpy(rvals), rob, False)
    monkeypatch.setattr(tchunk, "DEFAULT_CHUNK_BYTES", 1)
    np.testing.assert_array_equal(
        tcubic.cubic_rectilinear(rg, torch.from_numpy(rvals), rob, False).numpy(), rwhole.numpy())


def test_chunk_sizes_match_jax():
    """The same chunk length as the JAX package for one temporary size."""
    for row, item, cb in ((4**5, 8, None), (4**8, 4, 1 << 20), (1, 8, 1 << 40)):
        seen = []
        n = 3 * 2**20
        tchunk.chunk_queries(lambda ob: seen.append(ob[0].shape[0]) or ob[0],
                             (torch.zeros(n),), row, item, cb)
        want = max(8192, (cb or jchunk.DEFAULT_CHUNK_BYTES) // (row * item))
        want = 1 << (want.bit_length() - 1)
        assert seen[0] == min(want, n)


# --- gather tree -----------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS_1_TO_8, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_cubic_regular_matches_jax(dims, dtype, lin):
    n = 400 if len(dims) <= 6 else 30
    starts, steps, vals, obs = _case(dims, dtype, seed=len(dims), n=n)
    want = jcubic.cubic_regular(dims, _j(starts), _j(steps), _j(vals),
                                tuple(map(_j, obs)), lin)
    got = tcubic.cubic_regular(dims, _t(starts, dtype), _t(steps, dtype), _t(vals, dtype),
                               tuple(_t(o, dtype) for o in obs), lin)
    assert got.dtype == TDTYPE[dtype] and got.shape == (n,)
    _close(got, want, dtype)


@pytest.mark.parametrize("dims", DIMS_1_TO_8, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_cubic_rectilinear_matches_jax(dims, dtype, lin):
    n = 400 if len(dims) <= 6 else 30
    grids, vals, obs = _rect_case(dims, dtype, seed=len(dims), n=n)
    want = jcubic.cubic_rectilinear(tuple(map(_j, grids)), _j(vals), tuple(map(_j, obs)), lin)
    got = tcubic.cubic_rectilinear(tuple(_t(g, dtype) for g in grids), _t(vals, dtype),
                                   tuple(_t(o, dtype) for o in obs), lin)
    assert got.dtype == TDTYPE[dtype] and got.shape == (n,)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cubic_grid_nodes_bitwise(dtype):
    """Every node of a 12^3 grid, regular and rectilinear, both
    extrapolation modes: equal to vals, and to the JAX gather tree."""
    dims = (12, 12, 12)
    rng = np.random.default_rng(6)
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    idx = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij")).reshape(3, -1)
    axes = [np.cumsum(0.2 + rng.random(12)).astype(dtype) for _ in range(3)]
    for lin in (True, False):
        obs = [(i * 0.5).astype(dtype) for i in idx]
        got = tcubic.cubic_regular(dims, _t(np.zeros(3), dtype), _t(np.full(3, 0.5), dtype),
                                   _t(vals, dtype), tuple(_t(o, dtype) for o in obs), lin)
        np.testing.assert_array_equal(got.numpy(), vals)
        want = jcubic.cubic_regular(dims, _j(np.zeros(3, dtype)), _j(np.full(3, 0.5, dtype)),
                                    _j(vals), tuple(map(_j, obs)), lin)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        obs = [a[i] for a, i in zip(axes, idx)]
        got = tcubic.cubic_rectilinear(tuple(_t(a, dtype) for a in axes), _t(vals, dtype),
                                       tuple(_t(o, dtype) for o in obs), lin)
        np.testing.assert_array_equal(got.numpy(), vals)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cubic_reproduces_a_quadratic(dtype):
    """The natural boundary condition: without linearization cubic
    reproduces a quadratic everywhere, extrapolation included (the JAX
    package's property, `test_pallas_v3.py::test_v3_exact_mode_property_suite`)."""
    x = np.arange(8) * 0.5
    vals = (x[:, None] ** 2 + 0.5 * x[None, :]).ravel().astype(dtype)
    rng = np.random.default_rng(7)
    obs = [rng.uniform(-1.5, 5.0, 300).astype(dtype) for _ in range(2)]
    got = tcubic.cubic_regular((8, 8), _t(np.zeros(2), dtype), _t(np.full(2, 0.5), dtype),
                               _t(vals, dtype), tuple(_t(o, dtype) for o in obs), False)
    want = obs[0].astype(np.float64) ** 2 + 0.5 * obs[1]
    tol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


# --- the kernel wrappers: plain version on the CPU vs K1 cubic in interpret mode ---


@pytest.mark.parametrize("dims,tol", [
    ((8, 12), dict(rtol=1e-4, atol=1e-4)),
    ((8, 8, 8), dict(rtol=1e-4, atol=1e-4)),
    ((6, 5, 4, 7), dict(rtol=1e-4, atol=1e-4)),
    ((4, 5, 4, 5, 4), dict(rtol=5e-4, atol=2e-3)),
], ids=lambda x: str(x) if isinstance(x, tuple) else "")
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_fused_cubic_plain_matches_pallas_k1(_interpret_mode, dims, tol, lin):  # noqa: F811
    starts, steps, vals, obs = _case(dims, np.float32, seed=20 + len(dims), n=700, bad=False)
    want = np.asarray(jv3.eval_regular(dims, _j(starts), _j(steps), _j(vals),
                                       tuple(map(_j, obs)), "cubic", lin, 6))
    args = convert.regular_grid_from_numpy(dims, starts, steps, vals, device=CPU,
                                           dtype=torch.float32)
    before = dict(tfused.launches)
    got = tfused.eval_regular(*args, convert.obs_from_numpy(obs, device=CPU,
                                                            dtype=torch.float32), "cubic", lin)
    assert tfused.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_fused_cubic_cpu_is_the_gather_tree():
    dims = (6, 5, 7)
    starts, steps, vals, obs = _case(dims, np.float64)
    args = convert.regular_grid_from_numpy(dims, starts, steps, vals, device=CPU,
                                           dtype=torch.float64)
    ob = convert.obs_from_numpy(obs, device=CPU, dtype=torch.float64)
    for lin in (True, False):
        torch.testing.assert_close(tfused.eval_regular(*args, ob, "cubic", lin),
                                   tcubic.cubic_regular(*args, ob, lin), rtol=0, atol=0,
                                   equal_nan=True)


def test_fused_cubic_refuses_short_axes():
    """The stencil reads loc+3, so a kernel never sees an axis below 4."""
    dims = (3, 5)
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="at least 4 points"):
        tfused._check(dims, z, z, torch.zeros(15), (torch.zeros(4),) * 2, "cubic")
    with pytest.raises(ValueError, match="at least 4 points"):
        tfused._check_rectilinear((torch.arange(3.0), torch.arange(5.0)), torch.zeros(15),
                                  (torch.zeros(4),) * 2, "cubic")
    assert tfused._check((4, 5), z, z, torch.zeros(20), (torch.zeros(4),) * 2, "cubic") == 4


def test_dispatch_cubic_routes_cpu_to_gather(monkeypatch):
    monkeypatch.setattr(tfused, "eval_regular", lambda *a, **k: pytest.fail("kernel on CPU"))
    monkeypatch.setattr(tfused, "eval_rectilinear", lambda *a, **k: pytest.fail("kernel on CPU"))
    dims = (5, 6)
    starts, steps, vals, obs = _case(dims, np.float64, n=24)
    args = convert.regular_grid_from_numpy(dims, starts, steps, vals, device=CPU,
                                           dtype=torch.float64)
    ob = tuple(o.reshape(4, 6) for o in convert.obs_from_numpy(obs, device=CPU,
                                                                 dtype=torch.float64))
    got = tdispatch.cubic_regular(*args, ob, False)
    assert got.shape == (4, 6)
    torch.testing.assert_close(got, tcubic.cubic_regular(*args, ob, False), rtol=0, atol=0,
                               equal_nan=True)
    grids, rvals, robs = _rect_case(dims, np.float64, n=24)
    rg, rv = convert.rectilinear_grid_from_numpy(grids, rvals, device=CPU, dtype=torch.float64)
    rob = convert.obs_from_numpy(robs, device=CPU, dtype=torch.float64)
    torch.testing.assert_close(tdispatch.cubic_rectilinear(rg, rv, rob, True),
                               tcubic.cubic_rectilinear(rg, rv, rob, True), rtol=0, atol=0,
                               equal_nan=True)
