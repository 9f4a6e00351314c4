"""The port's pchip (`interpn_tpu_torch.ops.pchip`, `interpn(method="pchip")`,
`interpn_stack(method="pchip")`) against the JAX package's on the CPU, with
the same numpy inputs made from a seed.

Both run the same gather tree term for term; against the JAX functions
called op by op the results agree to the last bit here, but the bar is the
repo's: f64 rtol = atol = 1e-13 * max(1, max|vals|), f32 1e-5 * the same;
grid nodes exact. `interpn()` in the JAX package runs a jitted program,
whose multiply-adds XLA:CPU may contract into FMAs; f32 queries far outside
the grid amplify that rounding in the edge cubic, so the queries of those
cases reach a tenth of the span past each edge.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu
import interpn_tpu_torch
import jax.numpy as jnp
from interpn_tpu.ops import pchip as jpchip
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import _chunk
from interpn_tpu_torch.ops import pchip as tpchip

DIMS = [(7,), (6, 7), (5, 6, 4), (4, 5, 4, 6), (4, 5, 4, 4, 5)]
DTYPES = [np.float32, np.float64]
BAR = {np.float32: 1e-5, np.float64: 1e-13}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    with config.device("cpu"):
        yield


def _tol(dtype, vals):
    bar = BAR[dtype] * max(1.0, float(np.max(np.abs(vals))))
    return dict(rtol=bar, atol=bar)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(dims, dtype, seed, n=300, reach=1.0):
    """Regular and rectilinear grids over about [0, 1] per axis, a table,
    and queries inside, `reach` spans past both edges, at nodes and NaN."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-0.5, 0.5, len(dims)).astype(dtype)
    steps = rng.uniform(0.2, 0.6, len(dims)).astype(dtype)
    rect = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    spans = [(float(s), float(s + h * (d - 1))) for s, h, d in zip(starts, steps, dims)]

    def queries(bounds):
        obs = []
        for lo, hi in bounds:
            o = rng.uniform(lo - reach * (hi - lo), hi + reach * (hi - lo), n)
            o[:5] = np.nan
            obs.append(o.astype(dtype))
        return obs

    return (starts, steps, rect, vals, queries(spans),
            queries([(float(g[0]), float(g[-1])) for g in rect]))


def _port_regular(dims, starts, steps, vals, obs):
    return tpchip.pchip_regular(dims, _t(starts), _t(steps), _t(vals),
                                tuple(map(_t, obs))).numpy()


def _jax_regular(dims, starts, steps, vals, obs):
    return np.asarray(jpchip.pchip_regular(dims, jnp.asarray(starts), jnp.asarray(steps),
                                           jnp.asarray(vals), [jnp.asarray(o) for o in obs]))


def _port_rect(grids, vals, obs):
    return tpchip.pchip_rectilinear(tuple(map(_t, grids)), _t(vals), tuple(map(_t, obs))).numpy()


def _jax_rect(grids, vals, obs):
    return np.asarray(jpchip.pchip_rectilinear([jnp.asarray(g) for g in grids],
                                               jnp.asarray(vals), [jnp.asarray(o) for o in obs]))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", DTYPES)
def test_pchip_matches_jax(dims, dtype):
    """Both grid kinds, 1-5D (5D is the matrix tree), inside, beyond both
    edges by a whole span and NaN, against the JAX functions."""
    starts, steps, rect, vals, obs_reg, obs_rect = _case(dims, dtype, seed=len(dims))
    got = _port_regular(dims, starts, steps, vals, obs_reg)
    assert got.dtype == dtype and got.shape == (300,)
    np.testing.assert_allclose(got, _jax_regular(dims, starts, steps, vals, obs_reg),
                               **_tol(dtype, vals))
    got = _port_rect(rect, vals, obs_rect)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, _jax_rect(rect, vals, obs_rect), **_tol(dtype, vals))
    assert np.isnan(got[:5]).all()


@pytest.mark.parametrize("dims", DIMS[:4], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", DTYPES)
def test_pchip_nodes_exact(dims, dtype):
    """Every grid node reproduces its table value exactly: rectilinear
    axes of any spacing, a regular grid whose nodes are exact in binary."""
    _, _, rect, vals, _, _ = _case(dims, dtype, seed=3)
    mesh = [m.ravel() for m in np.meshgrid(*rect, indexing="ij")]
    np.testing.assert_array_equal(_port_rect(rect, vals, mesh), vals)
    axes = [(0.5 * np.arange(d) - 1.0).astype(dtype) for d in dims]
    mesh = [m.ravel() for m in np.meshgrid(*axes, indexing="ij")]
    starts = np.full(len(dims), -1.0, dtype)
    steps = np.full(len(dims), 0.5, dtype)
    np.testing.assert_array_equal(_port_regular(dims, starts, steps, vals, mesh), vals)


def test_pchip_5d_chunks_match_whole(monkeypatch):
    """4^5 > LIST_MAX_VERTS: the matrix tree over query chunks gives the
    unchunked result bit for bit, and the JAX package's within the bar."""
    dims = (4, 4, 4, 4, 5)
    _, _, rect, vals, _, _ = _case(dims, np.float32, seed=9)
    rng = np.random.default_rng(10)
    obs = [rng.uniform(g[0] - 0.2, g[-1] + 0.2, 20_000).astype(np.float32) for g in rect]
    whole = _port_rect(rect, vals, obs)
    monkeypatch.setattr(_chunk, "DEFAULT_CHUNK_BYTES", 1)  # chunks of 8192 queries
    assert _chunk.chunk_len(4**5, 4) == 8192
    np.testing.assert_array_equal(_port_rect(rect, vals, obs), whole)
    np.testing.assert_allclose(whole, _jax_rect(rect, vals, obs), **_tol(np.float32, vals))


def test_pchip_axis_order_is_last_axis_first():
    """pchip is nonlinear in the table, so the order of the axes is part of
    the function: the port reduces the last axis first, as the JAX package
    and scipy, and the other order differs here by far more than the bar."""
    rng = np.random.default_rng(11)
    gx = np.cumsum(0.1 + rng.random(6))
    gy = np.cumsum(0.1 + rng.random(7))
    v = rng.random((6, 7))
    obs = [rng.uniform(gx[1], gx[-2], 50), rng.uniform(gy[1], gy[-2], 50)]
    got = _port_rect([gx, gy], v.ravel(), obs)
    np.testing.assert_allclose(got, _jax_rect([gx, gy], v.ravel(), obs), **_tol(np.float64, v))
    x_first = _port_rect([gy, gx], v.T.ravel(), obs[::-1])  # axis 0 reduced first
    assert np.max(np.abs(got - x_first)) > 1e-6


def test_pchip_1d_clamp_branches():
    """The edge slope's zero and 3*m0 clamps and the interior slope's zero
    at sign changes and flats, in 1D on both grid kinds, against the JAX
    package and scipy's PchipInterpolator."""
    import scipy.interpolate as si

    rng = np.random.default_rng(0)
    g = np.cumsum(0.1 + rng.random(9))
    y = np.array([0.0, 1.0, 1.0, 2.0, -1.0, -1.0, 0.5, 3.0, 2.9])
    q = rng.uniform(g[0] - 1.0, g[-1] + 1.0, 500)
    got = _port_rect([g], y, [q])
    np.testing.assert_allclose(got, _jax_rect([g], y, [q]), **_tol(np.float64, y))
    ref = si.PchipInterpolator(g, y, extrapolate=True)(q)
    assert np.max(np.abs(got - ref) / np.maximum(1.0, np.abs(ref))) < 1e-12
    x = np.linspace(0.0, 2.0, 9)
    got = _port_regular((9,), np.zeros(1), np.array([x[1]]), y, [q])
    np.testing.assert_allclose(got, _jax_regular((9,), np.zeros(1), np.array([x[1]]), y, [q]),
                               **_tol(np.float64, y))
    # (h0, h1, m0, m1) per lane: zeroed, clamped to 3*m0, kept, kept
    h0 = np.array([1.0, 1.0, 0.5, 2.0])
    h1 = np.array([1.0, 1.0, 0.5, 0.1])
    m0 = np.array([1.0, 1.0, -2.0, 0.5])
    m1 = np.array([5.0, -10.0, 3.0, 0.0])
    got = tpchip._edge_slope(*map(_t, (h0, h1, m0, m1))).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpchip._edge_slope(*map(jnp.asarray, (h0, h1, m0, m1)))))
    np.testing.assert_array_equal(got[:3], [0.0, 3.0, -4.5])


def test_pchip_slopes_on_signed_zeros_nan_and_inf():
    """torch.sign and jnp.sign agree on +-0, NaN and +-inf as the slopes
    compare them: both slope functions give the JAX package's values, NaN
    where it gives NaN, on every pair of these differences."""
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -3.0, np.nan, np.inf, -np.inf])
    ml, mr = (a.ravel() for a in np.meshgrid(special, special, indexing="ij"))
    h = np.ones_like(ml)
    for fn in ("_interior_slope", "_edge_slope"):
        got = getattr(tpchip, fn)(*map(_t, (h, 2 * h, ml, mr))).numpy()
        want = np.asarray(getattr(jpchip, fn)(*map(jnp.asarray, (h, 2 * h, ml, mr))))
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_interpn_pchip_matches_jax(kind, dtype):
    """`interpn(method="pchip")` on both grid kinds, into a new array and
    into the caller's `out`, against the JAX package's."""
    dims = (5, 6, 4)
    starts, steps, rect, vals, obs_reg, obs_rect = _case(dims, dtype, seed=4, reach=0.1)
    if kind == "regular":
        grids = [s + h * np.arange(d, dtype=dtype) for s, h, d in zip(starts, steps, dims)]
        obs = obs_reg
    else:
        grids, obs = rect, obs_rect
    table = vals.reshape(dims)
    want = interpn_tpu.interpn(obs, grids, table, method="pchip")
    got = interpn_tpu_torch.interpn(obs, grids, table, method="pchip")
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, **_tol(dtype, vals))
    out = np.zeros(len(obs[0]), dtype)
    ret = interpn_tpu_torch.interpn(obs, grids, table, method="pchip", out=out)
    assert np.shares_memory(ret, out)
    np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_interpn_stack_pchip_matches_jax(kind, dtype):
    """`interpn_stack(method="pchip")` against the JAX package's, and each
    row bitwise the port's single-table call."""
    dims = (6, 5, 4)
    nch = 3
    starts, steps, rect, _, obs_reg, obs_rect = _case(dims, dtype, seed=5, reach=0.1)
    stack = np.random.default_rng(6).standard_normal((nch, *dims)).astype(dtype)
    if kind == "regular":
        grids = [s + h * np.arange(d, dtype=dtype) for s, h, d in zip(starts, steps, dims)]
        obs = obs_reg
    else:
        grids, obs = rect, obs_rect
    obs2 = [o.reshape(20, 15) for o in obs]
    got = interpn_tpu_torch.interpn_stack(obs2, grids, stack, method="pchip")
    assert got.shape == (nch, 20, 15) and got.dtype == dtype
    np.testing.assert_allclose(got, interpn_tpu.interpn_stack(obs2, grids, stack, method="pchip"),
                               **_tol(dtype, stack))
    for c in range(nch):
        single = interpn_tpu_torch.interpn(obs2, grids, stack[c], method="pchip")
        np.testing.assert_array_equal(got[c], single)


def test_stack_rows_bitwise_at_5d():
    """The matrix tree of a stack: each row is the single table's result."""
    dims = (4, 4, 5, 4, 4)
    _, _, rect, _, _, obs = _case(dims, np.float64, seed=7)
    stack = np.random.default_rng(8).standard_normal((2, math.prod(dims)))
    got = tpchip.pchip_rectilinear_stack(tuple(map(_t, rect)), _t(stack),
                                         tuple(map(_t, obs))).numpy()
    for c in range(2):
        np.testing.assert_array_equal(got[c], _port_rect(rect, stack[c], obs))


def _bad_calls():
    """(id, call(mod)) pairs that both packages must refuse alike."""
    f32 = np.float32
    x3, x5 = np.arange(3.0), np.arange(5.0)
    rect5 = np.cumsum(np.arange(1.0, 6.0))
    return [
        ("short-regular", lambda m: m.interpn([np.zeros(3)], [x3], np.zeros(3), method="pchip")),
        ("short-rect", lambda m: m.interpn([np.zeros(3)], [x3**1.5], np.zeros(3),
                                           method="pchip")),
        ("obs-f32", lambda m: m.interpn([np.zeros(3, f32)], [x5], np.zeros(5), method="pchip")),
        ("grid-f32", lambda m: m.interpn([np.zeros(3)], [rect5.astype(f32)], np.zeros(5),
                                         method="pchip")),
        ("out-f32", lambda m: m.interpn([np.zeros(3)], [x5], np.zeros(5), method="pchip",
                                        out=np.zeros(3, f32))),
        ("vals-size", lambda m: m.interpn([np.zeros(3)], [rect5], np.zeros(4), method="pchip")),
        ("out-size", lambda m: m.interpn([np.zeros(3)], [x5], np.zeros(5), method="pchip",
                                         out=np.zeros(4))),
        ("bounds", lambda m: m.interpn([np.array([9.0])], [x5], np.zeros(5), method="pchip",
                                       check_bounds=True)),
        ("stack-short", lambda m: m.interpn_stack([np.zeros(3)], [x3], np.zeros((2, 3)),
                                                  method="pchip")),
        ("stack-short-rect", lambda m: m.interpn_stack([np.zeros(3)], [x3**1.5],
                                                       np.zeros((2, 3)), method="pchip")),
        ("stack-obs-f32", lambda m: m.interpn_stack([np.zeros(3, f32)], [x5], np.zeros((2, 5)),
                                                    method="pchip")),
        ("stack-bounds", lambda m: m.interpn_stack([np.array([-1.0])], [rect5],
                                                   np.zeros((2, 5)), method="pchip",
                                                   check_bounds=True)),
    ]


@pytest.mark.parametrize("call", [c for _, c in _bad_calls()], ids=[i for i, _ in _bad_calls()])
def test_pchip_errors_match_jax(call):
    with pytest.raises((AssertionError, TypeError, ValueError)) as want:
        call(interpn_tpu)
    with pytest.raises(want.type) as got:
        call(interpn_tpu_torch)
    assert str(got.value) == str(want.value)


def test_pchip_gradient_matches_jax():
    """Reverse mode through the port's tree against the JAX package's JVP
    of its tree, on the queries of a 2D rectilinear grid."""
    import jax

    _, _, rect, vals, _, obs = _case((6, 7), np.float64, seed=12, reach=0.1)
    obs = [o[5:] for o in obs]
    obs_t = tuple(_t(o).requires_grad_() for o in obs)
    y = tpchip.pchip_rectilinear(tuple(map(_t, rect)), _t(vals), obs_t)
    got = torch.autograd.grad(y.sum(), obs_t)
    grids_j = [jnp.asarray(g) for g in rect]
    for k in range(2):
        tangents = [jnp.ones_like(o) if j == k else jnp.zeros_like(o)
                    for j, o in enumerate(map(jnp.asarray, obs))]
        _, want = jax.jvp(lambda *o: jpchip.pchip_rectilinear(grids_j, jnp.asarray(vals), o),
                          tuple(map(jnp.asarray, obs)), tuple(tangents))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
