"""Global B-splines (cubic_spline, quintic): the port's host preparation,
gather tree, kernel wrappers, routes and `interpn()` arms against the JAX
package on the CPU.

Tolerances:
* knots and coefficients: bitwise (the same numpy and scipy arithmetic).
* gather tree vs gather tree: f64 rtol=atol=1e-13, f32 rtol=atol=1e-5 (the
  same operations in the same order; XLA:CPU may contract a multiply-add
  into an FMA).
* the kernel wrapper (its plain version on a CPU tensor) vs the Pallas
  kernels K4 (`_eval_bspline_knots`) and K2's spline use
  (`_eval_bspline_pre`) in interpret mode: f32 rtol=2e-5, the bar of
  tests/test_stack.py, with atol=2e-5 times the largest coefficient, since
  the kernels' error scales with the coefficients (tests/test_bspline_engines.py).
* gradients: f64 rtol=atol=1e-12 against `jax.vjp` of the JAX gather tree
  (the vals gradient is a scatter, summed in another order).
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu
import jax
import jax.numpy as jnp

from interpn_tpu.ops import bspline as jbspline
from interpn_tpu.ops import pallas_v3 as jv3
import interpn_tpu_torch
from interpn_tpu_torch import config, convert
from interpn_tpu_torch.ops import bspline as tbspline
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-13, atol=1e-13)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}
CPU = torch.device("cpu")
CASES = [(3, (9,)), (3, (8, 7, 6)), (5, (7, 8)), (5, (6, 7, 6)), (3, (5, 4, 6, 4))]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _case(k, dims, seed=0, n=400, ext=0.2, bad=True, nch=None):
    """Jittered ascending axes, a random table (trailing channel axis when
    nch is given), queries ext of the span past each side, NaN and +-inf
    mixed in."""
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    vals = rng.standard_normal((math.prod(dims),) if nch is None else (math.prod(dims), nch))
    obs = []
    for g in grids:
        span = g[-1] - g[0]
        o = rng.uniform(g[0] - ext * span, g[-1] + ext * span, n)
        if bad:
            o[rng.integers(0, n, 6)] = rng.choice([np.nan, np.inf, -np.inf], 6)
        obs.append(o)
    return grids, vals, obs


def _port(knots, coeffs, obs, dtype):
    kt, ct = convert.bspline_from_numpy(knots, coeffs, device=CPU, dtype=TDTYPE[dtype])
    return kt, ct, convert.obs_from_numpy(obs, device=CPU, dtype=TDTYPE[dtype])


def _jax(knots, coeffs, obs, dtype):
    return (tuple(jnp.asarray(t, dtype) for t in knots), jnp.asarray(coeffs, dtype),
            tuple(jnp.asarray(o, dtype) for o in obs))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **tol, equal_nan=True)


# --- host preparation ---------------------------------------------------------------


@pytest.mark.parametrize("k,dims", CASES, ids=str)
@pytest.mark.parametrize("nch", [None, 3])
def test_prep_bitwise_equal_to_jax(k, dims, nch):
    grids, vals, _ = _case(k, dims, seed=k + len(dims), nch=nch)
    want_knots, want_coeffs = jbspline.prep_bspline(grids, vals, k)
    got_knots, got_coeffs = tbspline.prep_bspline(grids, vals, k)
    assert len(got_knots) == len(want_knots)
    for got, want in zip(got_knots, want_knots):
        np.testing.assert_array_equal(got, want)
    assert got_coeffs.shape == want_coeffs.shape == vals.shape
    np.testing.assert_array_equal(got_coeffs, want_coeffs)


def test_prep_cache_keys_by_content():
    grids, vals, _ = _case(3, (6, 7))
    tbspline._PREP_CACHE.clear()
    tbspline._PREP_ORDER.clear()
    first = tbspline.prep_bspline_cached(grids, vals, 3)
    assert tbspline.prep_bspline_cached([g.copy() for g in grids], vals.copy(), 3) is first
    assert tbspline.prep_bspline_cached(grids, vals, 5) is not first
    assert tbspline.prep_bspline_cached(grids, vals + 1, 3) is not first
    for i in range(tbspline._PREP_MAX + 2):
        tbspline.prep_bspline_cached(grids, vals + i + 2, 3)
    assert len(tbspline._PREP_CACHE) == len(tbspline._PREP_ORDER) == tbspline._PREP_MAX


@pytest.mark.parametrize("call", [
    lambda m: m.not_a_knot_knots(np.arange(6.0), 4),
    lambda m: m.prep_bspline([np.arange(5.0), np.arange(6.0)], np.zeros(30), 5),
], ids=["even-degree", "short-axis"])
def test_prep_errors_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jbspline)
    with pytest.raises(ValueError) as got:
        call(tbspline)
    assert str(got.value) == str(want.value)


# --- device evaluation: the gather tree ---------------------------------------------


@pytest.mark.parametrize("k,dims", CASES, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_locs_weights_match_jax(k, dims, dtype):
    grids, vals, obs = _case(k, dims, seed=3)
    knots, coeffs = jbspline.prep_bspline(grids, vals, k)
    kt, _, ob = _port(knots, coeffs, obs, dtype)
    kj, _, oj = _jax(knots, coeffs, obs, dtype)
    got = tbspline.spline_locs_weights(kt, ob, k)
    want = jbspline.spline_locs_weights(kj, oj, k)
    for (gl, gw), (wl, ww), o in zip(got, want, obs):
        assert gl.dtype == torch.int32
        # the port pins a NaN query's span to k; jax may put it at the end
        np.testing.assert_array_equal(gl.numpy()[np.isnan(o)], 0)
        finite = ~np.isnan(o)
        np.testing.assert_array_equal(gl.numpy()[finite], np.asarray(wl)[finite])
        for a, b in zip(gw, ww):
            np.testing.assert_allclose(a.numpy()[finite], np.asarray(b)[finite], **TOL[dtype])


@pytest.mark.parametrize("k,dims", CASES, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_matches_jax(k, dims, dtype):
    grids, vals, obs = _case(k, dims, seed=4)
    knots, coeffs = jbspline.prep_bspline(grids, vals, k)
    got = tbspline.bspline_gather(*_port(knots, coeffs, obs, dtype), k)
    want = jbspline._bspline_gather(*_jax(knots, coeffs, obs, dtype), k)
    assert got.dtype == TDTYPE[dtype] and got.shape == (400,)
    _close(got.numpy(), want, TOL[dtype])


def test_gather_chunks_and_keeps_query_shape(monkeypatch):
    grids, vals, obs = _case(5, (7, 6, 8), seed=5, n=600)
    knots, coeffs = tbspline.prep_bspline(grids, vals, 5)
    kt, ct, ob = _port(knots, coeffs, obs, np.float64)
    whole = tbspline.bspline_gather(kt, ct, ob, 5)
    monkeypatch.setattr("interpn_tpu_torch.ops._chunk.DEFAULT_CHUNK_BYTES", 216 * 8 * 8192)
    chunked = tbspline.bspline_gather(kt, ct, tuple(o.reshape(20, 30) for o in ob), 5)
    assert chunked.shape == (20, 30)
    torch.testing.assert_close(chunked.reshape(-1), whole, rtol=0, atol=0, equal_nan=True)


def test_nodes_reproduced():
    """The interpolating spline passes through the table at every node
    (the coefficients are solved, so within 1e-11, the JAX package's bar)."""
    grids, vals, _ = _case(3, (7, 6, 6), seed=6)
    for k in (3, 5):
        knots, coeffs = tbspline.prep_bspline(grids, vals, k)
        mesh = np.meshgrid(*grids, indexing="ij")
        kt, ct, ob = _port(knots, coeffs, [m.ravel() for m in mesh], np.float64)
        np.testing.assert_allclose(tbspline.bspline_gather(kt, ct, ob, k).numpy(), vals,
                                   rtol=1e-11, atol=1e-11)


# --- the kernel wrappers against the Pallas kernels K4 and K2 ---------------------------


@pytest.mark.parametrize("k,dims", [(3, (8, 7, 6)), (5, (7, 8)), (3, (6, 9))], ids=str)
@pytest.mark.parametrize("engine", ["_eval_bspline_knots", "_eval_bspline_pre"])
def test_fused_plain_matches_pallas_k4_k2(_interpret_mode, k, dims, engine):
    grids, vals, obs = _case(k, dims, seed=10 + k, bad=False)
    knots, coeffs = jbspline.prep_bspline(grids, vals, k)
    kj, cj, oj = _jax(knots, coeffs, obs, np.float32)
    want = np.asarray(getattr(jv3, engine)(kj, cj, oj, k))
    got = tfused.eval_bspline(*_port(knots, coeffs, obs, np.float32), k)
    cs = max(float(np.abs(coeffs).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * cs)


def test_fused_bspline_refuses():
    kt, ct, ob = _port(*tbspline.prep_bspline([np.arange(6.0)] * 2, np.zeros(36), 3),
                       [np.zeros(4)] * 2, np.float64)
    with pytest.raises(ValueError, match="spline degree"):
        tfused.eval_bspline(kt, ct, ob, 4)
    with pytest.raises(ValueError, match="one device"):
        tfused.eval_bspline(kt, ct.to("meta"), ob, 3)
    assert tfused._check_common((6, 6), ct, ob, kt, 4, False) == 4
    with pytest.raises(ValueError, match="at least 7 points"):
        tfused._check_common((6, 6), ct, ob, kt, 7, False)
    with pytest.raises(ValueError, match=r"\(nch, 36\)"):
        tfused._check_common((6, 6), ct, ob, kt, 4, True)


# --- routes and gradients ---------------------------------------------------------------


def test_dispatch_routes_cpu_to_gather(monkeypatch):
    monkeypatch.setattr(tfused, "eval_bspline", lambda *a, **k: pytest.fail("kernel on CPU"))
    grids, vals, obs = _case(3, (6, 7), seed=7, n=24)
    kt, ct, ob = _port(*tbspline.prep_bspline(grids, vals, 3), obs, np.float64)
    ob = tuple(o.reshape(4, 6) for o in ob)
    got = tdispatch.bspline_eval(kt, ct, ob, 3)
    assert got.shape == (4, 6)
    torch.testing.assert_close(got, tbspline.bspline_gather(kt, ct, ob, 3), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("k", [3, 5])
def test_kernel_route_grads_match_jax(k):
    """The route as dispatch builds it for a CUDA tensor (the wrapper
    forward, the gather tree's VJP backward), run on the CPU, against
    jax.vjp of the JAX gather tree: gradients for the coefficients and the
    queries."""
    grids, vals, obs = _case(k, (7, 6, 8), seed=8, n=300, bad=False)
    knots, coeffs = tbspline.prep_bspline(grids, vals, k)
    cot = np.random.default_rng(9).standard_normal(300)
    kt = tuple(torch.from_numpy(t) for t in knots)
    leaves = [torch.tensor(a, requires_grad=True) for a in (coeffs, *obs)]
    out = tdispatch.KernelRoute.apply(
        tdispatch.Route(
            lambda c, *ob: tfused.eval_bspline(kt, c, ob, k),
            lambda c, *ob: tbspline.bspline_gather(kt, c, ob, k),
            0, False, None, False),
        *leaves,
    )
    out.backward(torch.from_numpy(cot))
    kj = tuple(jnp.asarray(t) for t in knots)
    _, vjp = jax.vjp(lambda c, *ob: jbspline._bspline_gather(kj, c, ob, k),
                     *(jnp.asarray(a) for a in (coeffs, *obs)))
    for got, want in zip(leaves, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


# --- interpn(method="cubic_spline" | "quintic") -------------------------------------------


@pytest.mark.parametrize("method", ["cubic_spline", "quintic"])
@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpn_splines_match_jax(method, kind, dtype):
    rng = np.random.default_rng(11)
    dims = (7, 8, 6)
    if kind == "regular":
        grids = [np.linspace(-1.0, 2.0, d).astype(dtype) for d in dims]
    else:
        grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(dims).astype(dtype)
    obs = [rng.uniform(g[0] - 0.3, g[-1] + 0.3, (10, 5)).astype(dtype) for g in grids]
    want = interpn_tpu.interpn(obs, grids, vals, method=method)
    got = interpn_tpu_torch.interpn(obs, grids, vals, method=method)
    assert got.dtype == want.dtype and got.shape == want.shape == (10, 5)
    # f32 rounding differences scale with the coefficients, which exceed the
    # data on short random axes (the tolerance of tests/test_bspline_engines.py)
    _, coeffs = tbspline.prep_bspline(grids, vals.ravel(), 3 if method == "cubic_spline" else 5)
    cs = max(float(np.abs(coeffs).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype]["rtol"], atol=TOL[dtype]["atol"] * cs)
    out = np.zeros((10, 5), dtype)
    interpn_tpu_torch.interpn(obs, grids, vals, method=method, out=out)
    np.testing.assert_array_equal(out, got)


def _bad_spline_calls():
    f64 = np.float64
    g6 = [np.arange(6.0), np.arange(7.0)]
    ob = [np.full(3, 0.5), np.full(3, 0.5)]

    def call(mod, grids=g6, vals=None, obs=ob, method="cubic_spline", **kw):
        if vals is None:
            vals = np.zeros([len(g) for g in grids], f64)
        return mod.interpn(obs, grids, vals, method=method, **kw)

    return [
        ("short-axis", lambda m: call(m, grids=[np.arange(3.0), np.arange(7.0)])),
        ("quintic-short-axis", lambda m: call(m, method="quintic",
                                              grids=[np.arange(5.0), np.arange(7.0)])),
        ("obs-dtype", lambda m: call(m, obs=[o.astype(np.float32) for o in ob])),
        ("grid-dtype", lambda m: call(m, grids=[g6[0].astype(np.float32), g6[1]])),
        ("out-dtype", lambda m: call(m, out=np.zeros(3, np.float32))),
        ("obs-count", lambda m: call(m, obs=ob[:1])),
        ("obs-length", lambda m: call(m, obs=[ob[0], np.full(4, 0.5)])),
        ("vals-size", lambda m: call(m, vals=np.zeros(41))),
        ("not-increasing", lambda m: call(m, grids=[np.array([1.0, 0.5, 2, 3, 4, 5]), g6[1]])),
        ("int-vals", lambda m: call(m, vals=np.zeros((6, 7), np.int64))),
        ("bounds", lambda m: call(m, obs=[np.full(3, 9.0), ob[1]], check_bounds=True)),
    ]


@pytest.mark.parametrize("call", [c for _, c in _bad_spline_calls()],
                         ids=[i for i, _ in _bad_spline_calls()])
def test_interpn_spline_errors_match_jax(call):
    with pytest.raises((AssertionError, TypeError, ValueError)) as want:
        call(interpn_tpu)
    with pytest.raises(want.type) as got:
        call(interpn_tpu_torch)
    assert str(got.value) == str(want.value)


def test_pchip_is_not_ported_yet():
    """Kept under its name from before pchip was ported: `interpn()` now
    takes method="pchip" and gives the JAX package's values."""
    x = np.linspace(0.0, 1.0, 6)
    vals = np.sin(3.0 * x)
    obs = [np.array([-0.1, 0.25, 0.5, 1.2])]
    np.testing.assert_allclose(
        interpn_tpu_torch.interpn(obs, [x], vals, method="pchip"),
        interpn_tpu.interpn(obs, [x], vals, method="pchip"), **TOL[np.float64])
