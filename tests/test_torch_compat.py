"""`interpn_tpu_torch.compat` against scipy.interpolate and the JAX
package's `compat` on the CPU.

Mirrors `tests/test_compat.py`: every behavioral case against scipy itself
at its bars (1e-12; `slinear` 1e-11; the cubic family exact on a quadratic
to 1e-8; the f32 opt-in within 5e-5 of the f64 result's scale), and the
same inputs through the JAX package's `compat` (f64 rtol=atol=1e-12,
nearest bitwise), with every error message.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import scipy.interpolate as si

from interpn_tpu import compat as jcompat

import interpn_tpu_torch as itt
from interpn_tpu_torch import compat, config

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _grid(rng, n):
    g = np.sort(rng.uniform(-2.0, 2.0, n))
    while np.any(np.diff(g) <= 1e-3):
        g = np.sort(rng.uniform(-2.0, 2.0, n))
    return g


def _make(rng, ndims, npts=6):
    grids = tuple(_grid(rng, npts + i) for i in range(ndims))
    return grids, rng.standard_normal(tuple(g.size for g in grids))


def _against_jax(got, method, *args, **kw):
    want = jcompat.RegularGridInterpolator(*args[:2], method=method, **kw)(args[2])
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ndims", [1, 2, 3, 4])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_interior_matches_scipy(ndims, method):
    rng = np.random.default_rng(1234 + ndims)
    grids, vals = _make(rng, ndims)
    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    xi = rng.uniform(lo + 0.05, hi - 0.05, (200, ndims))
    ours = compat.RegularGridInterpolator(grids, vals, method=method)(xi)
    np.testing.assert_allclose(ours, si.RegularGridInterpolator(grids, vals, method=method)(xi),
                               **TOL)
    _against_jax(ours, method, grids, vals, xi)


@pytest.mark.parametrize("method", ["linear", "nearest", "slinear", "hermite", "pchip",
                                    "cubic", "quintic"])
def test_every_method_matches_the_jax_compat(method, monkeypatch):
    """Extrapolating, with a NaN and a trailing channel axis of 3."""
    # each channel against the single-table call on the torch route
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    rng = np.random.default_rng(5)
    grids, vals = _make(rng, 3, npts=7)
    xi = rng.uniform([g[0] - 0.3 for g in grids], [g[-1] + 0.3 for g in grids], (150, 3))
    xi[4, 1] = np.nan
    kw = dict(bounds_error=False, fill_value=None)
    ours = compat.RegularGridInterpolator(grids, vals, method=method, **kw)(xi)
    _against_jax(ours, method, grids, vals, xi, **kw)
    assert np.isnan(ours[4]) and np.isfinite(np.delete(ours, 4)).all()
    stacked = rng.standard_normal(vals.shape + (3,))
    ours = compat.RegularGridInterpolator(grids, stacked, method=method, **kw)(xi)
    assert ours.shape == (150, 3)
    _against_jax(ours, method, grids, stacked, xi, **kw)
    for c in range(3):  # each channel the single-table call's bits
        one = compat.RegularGridInterpolator(grids, stacked[..., c], method=method, **kw)(xi)
        np.testing.assert_array_equal(ours[:, c], one)


@pytest.mark.parametrize("method", ["linear", "nearest", "hermite", "pchip", "quintic"])
def test_trailing_channels_on_a_regular_grid_keep_each_row(method, monkeypatch):
    """On evenly spaced axes too, each channel of a stack is the
    single-channel call's bits: the stack takes the rectilinear route the
    single-table classes take."""
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")  # the single-table torch route
    rng = np.random.default_rng(17)
    grids = tuple(np.linspace(0.0, 1.0, 7) for _ in range(3))
    stacked = rng.standard_normal((7, 7, 7, 4))
    xi = rng.uniform(-0.1, 1.1, (90, 3))
    kw = dict(bounds_error=False, fill_value=None)
    ours = compat.RegularGridInterpolator(grids, stacked, method=method, **kw)(xi)
    for c in range(4):
        one = compat.RegularGridInterpolator(grids, stacked[..., c], method=method, **kw)(xi)
        np.testing.assert_array_equal(ours[:, c], one)


def test_descending_axes_match_scipy():
    rng = np.random.default_rng(7)
    grids, vals = _make(rng, 2)
    gdesc = (grids[0][::-1].copy(), grids[1])
    vdesc = np.flip(vals, axis=0)
    xi = rng.uniform([g.min() for g in grids], [g.max() for g in grids], (50, 2))
    ours = compat.RegularGridInterpolator(gdesc, vdesc)
    theirs = si.RegularGridInterpolator(gdesc, vdesc)
    np.testing.assert_allclose(ours(xi), theirs(xi), **TOL)
    np.testing.assert_array_equal(ours.grid[0], grids[0])


def test_linear_extrapolation_matches_scipy():
    rng = np.random.default_rng(11)
    grids, vals = _make(rng, 2)
    xi = np.array([[grids[0][0] - 0.7, grids[1][-1] + 0.3], [0.0, 0.0]])
    kw = dict(bounds_error=False, fill_value=None)
    np.testing.assert_allclose(compat.RegularGridInterpolator(grids, vals, **kw)(xi),
                               si.RegularGridInterpolator(grids, vals, **kw)(xi), **TOL)


def test_fill_value_and_nan_semantics_match_scipy():
    rng = np.random.default_rng(3)
    grids, vals = _make(rng, 2)
    xi = np.array([[grids[0][0] - 1.0, 0.0], [np.nan, 0.0], [grids[0][2], grids[1][2]]])
    for fill in (np.nan, -9.0):
        kw = dict(bounds_error=False, fill_value=fill)
        np.testing.assert_allclose(compat.RegularGridInterpolator(grids, vals, **kw)(xi),
                                   si.RegularGridInterpolator(grids, vals, **kw)(xi), **TOL)


def _same_error(make_ours, make_theirs):
    with pytest.raises(ValueError) as e_theirs:
        make_theirs()
    with pytest.raises(ValueError) as e_ours:
        make_ours()
    assert str(e_ours.value) == str(e_theirs.value)


def test_bounds_error_message_matches_scipy():
    grids = (np.arange(4.0), np.arange(4.0))
    vals = np.arange(16.0).reshape(4, 4)
    xi = np.array([[1.0, 9.0]])
    _same_error(lambda: compat.RegularGridInterpolator(grids, vals)(xi),
                lambda: si.RegularGridInterpolator(grids, vals)(xi))
    with pytest.raises(ValueError):
        compat.RegularGridInterpolator(grids, vals)(np.array([[np.nan, 1.0]]))


@pytest.mark.parametrize(
    "bad",
    [
        dict(points=(np.array([0.0, 1.0, 1.0, 3.0]),), values=np.arange(4.0)),
        dict(points=(np.arange(4.0).reshape(2, 2),), values=np.arange(4.0).reshape(2, 2)),
        dict(points=(np.arange(4.0),), values=np.arange(5.0)),
        dict(points=(np.arange(3.0),), values=np.arange(3.0), method="cubic"),
        dict(points=(np.arange(4.0),), values=np.arange(4.0), method="foo"),
        dict(points=(np.arange(4.0), np.arange(3.0)), values=np.arange(4.0)),
        dict(points=(np.arange(1.0),), values=np.zeros(1), method="slinear"),
        dict(points=(np.arange(4.0),), values=np.arange(4.0), bounds_error=False,
             fill_value="x"),
    ],
)
def test_constructor_error_messages_match_scipy(bad):
    _same_error(lambda: compat.RegularGridInterpolator(**bad),
                lambda: si.RegularGridInterpolator(**bad))
    _same_error(lambda: compat.RegularGridInterpolator(**bad),
                lambda: jcompat.RegularGridInterpolator(**bad))


def test_undefined_method_raises_and_quintic_is_supported():
    with pytest.raises(ValueError, match="is not defined"):
        compat.RegularGridInterpolator((np.arange(8.0),), np.arange(8.0), method="makima")
    rgi = compat.RegularGridInterpolator((np.arange(8.0),), np.arange(8.0) ** 2,
                                         method="quintic", bounds_error=False,
                                         fill_value=None)
    np.testing.assert_allclose(rgi(np.array([2.5, 9.0])), [6.25, 81.0])
    compat.RegularGridInterpolator((np.arange(8.0),), np.arange(8.0), method="hermite")


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_slinear_matches_scipy(ndims):
    rng = np.random.default_rng(77 + ndims)
    grids, vals = _make(rng, ndims)
    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    xi = rng.uniform(lo - 0.3, hi + 0.3, (200, ndims))
    kw = dict(bounds_error=False, fill_value=None)
    theirs = si.RegularGridInterpolator(grids, vals, method="slinear", **kw)(xi)
    ours = compat.RegularGridInterpolator(grids, vals, method="slinear", **kw)
    np.testing.assert_allclose(ours(xi), theirs, rtol=1e-11, atol=1e-11)
    base = compat.RegularGridInterpolator(grids, vals, **kw)
    np.testing.assert_allclose(base(xi, method="slinear"), theirs, rtol=1e-11, atol=1e-11)


def test_xi_shapes_match_scipy():
    grids = (np.arange(4.0), np.arange(4.0))
    vals = np.arange(16.0).reshape(4, 4)
    ours = compat.RegularGridInterpolator(grids, vals)
    theirs = si.RegularGridInterpolator(grids, vals)
    t = (np.array([1.0, 2.0]), np.array([0.5, 1.5]))
    np.testing.assert_allclose(ours(t), theirs(t))
    p = np.array([1.0, 0.5])
    assert ours(p).shape == theirs(p).shape == (1,)
    np.testing.assert_allclose(ours(p), theirs(p))
    b = np.tile(p, (3, 5, 1))
    assert ours(b).shape == theirs(b).shape == (3, 5)
    _same_error(lambda: ours(np.ones((3, 3))), lambda: theirs(np.ones((3, 3))))
    _same_error(lambda: ours((np.ones(2),) * 3), lambda: theirs((np.ones(2),) * 3))
    g1 = compat.RegularGridInterpolator((np.arange(4.0),), np.arange(4.0))
    s1 = si.RegularGridInterpolator((np.arange(4.0),), np.arange(4.0))
    np.testing.assert_allclose(g1([1.5, 2.5]), s1([1.5, 2.5]))


def test_per_call_method_override_matches_scipy():
    grids = (np.arange(4.0),)
    vals = np.array([0.0, 1.0, 4.0, 9.0])
    xi = np.array([1.2, 2.7])
    np.testing.assert_allclose(compat.RegularGridInterpolator(grids, vals)(xi, method="nearest"),
                               si.RegularGridInterpolator(grids, vals)(xi, method="nearest"))


def test_trailing_value_dims_match_scipy():
    rng = np.random.default_rng(21)
    grids, _ = _make(rng, 2)
    vals = rng.standard_normal(tuple(g.size for g in grids) + (3, 2))
    xi = rng.uniform([g[0] for g in grids], [g[-1] for g in grids], (40, 2))
    ro = compat.RegularGridInterpolator(grids, vals)(xi)
    rt = si.RegularGridInterpolator(grids, vals)(xi)
    assert ro.shape == rt.shape == (40, 3, 2)
    np.testing.assert_allclose(ro, rt, **TOL)
    xib = np.array([[grids[0][0] - 1.0, 0.0], [np.nan, 0.0]])
    kw = dict(bounds_error=False, fill_value=-5.0)
    np.testing.assert_allclose(compat.RegularGridInterpolator(grids, vals, **kw)(xib),
                               si.RegularGridInterpolator(grids, vals, **kw)(xib), **TOL)


def test_pchip_and_cubic_against_scipy():
    """pchip against scipy's RGI at 1e-12; cubic against scipy's own
    interpolating bicubic spline (FITPACK, s=0: the not-a-knot spline),
    since scipy's RGI solves its system iteratively."""
    rng = np.random.default_rng(31)
    grids, vals = _make(rng, 2)
    xi = rng.uniform([g[0] for g in grids], [g[-1] for g in grids], (100, 2))
    ours = compat.RegularGridInterpolator(grids, vals, method="pchip")(xi)
    np.testing.assert_allclose(
        ours, si.RegularGridInterpolator(grids, vals, method="pchip")(xi), **TOL)
    ours = compat.RegularGridInterpolator(grids, vals, method="cubic")(xi)
    theirs = si.RectBivariateSpline(*grids, vals, kx=3, ky=3, s=0)(xi[:, 0], xi[:, 1],
                                                                    grid=False)
    np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["cubic", "hermite"])
def test_cubic_family_exact_on_quadratic(method):
    rng = np.random.default_rng(5)
    grids, _ = _make(rng, 2)
    gx, gy = np.meshgrid(*grids, indexing="ij")
    vals = gx**2 + 0.5 * gx * gy - gy**2
    xi = rng.uniform([g[0] for g in grids], [g[-1] for g in grids], (100, 2))
    out = compat.RegularGridInterpolator(grids, vals, method=method)(xi)
    expect = xi[:, 0] ** 2 + 0.5 * xi[:, 0] * xi[:, 1] - xi[:, 1] ** 2
    np.testing.assert_allclose(out, expect, rtol=1e-8, atol=1e-8)
    if method == "hermite":
        model = itt.MulticubicRectilinear.new(list(grids), vals.reshape(-1),
                                              linearize_extrapolation=False)
        direct = model.eval([np.ascontiguousarray(xi[:, i]) for i in range(2)])
        np.testing.assert_array_equal(out, direct)


def test_spline_bitwise_the_interpn_entry():
    """cubic and quintic evaluate the coefficients interpn() solves, bit
    for bit."""
    rng = np.random.default_rng(9)
    grids, vals = _make(rng, 3, npts=7)
    xi = rng.uniform([g[0] for g in grids], [g[-1] for g in grids], (80, 3))
    for method, name in (("cubic", "cubic_spline"), ("quintic", "quintic")):
        ours = compat.RegularGridInterpolator(grids, vals, method=method)(xi)
        entry = itt.interpn([xi[:, i].copy() for i in range(3)], list(grids), vals,
                            method=name)
        np.testing.assert_array_equal(ours, entry)


def test_interpn_function_matches_scipy():
    grids = (np.arange(4.0), np.arange(4.0))
    vals = np.arange(16.0).reshape(4, 4)
    xi = np.array([[1.0, 0.5], [2.5, 2.5]])
    np.testing.assert_allclose(compat.interpn(grids, vals, xi), si.interpn(grids, vals, xi))
    _same_error(lambda: compat.interpn((np.arange(4.0),), np.arange(4.0), np.array([9.0])),
                lambda: si.interpn((np.arange(4.0),), np.arange(4.0), np.array([9.0])))


def test_float32_values_promote_to_float64_like_scipy():
    g = (np.arange(4.0),)
    v32 = np.arange(4.0, dtype=np.float32)
    ro = compat.RegularGridInterpolator(g, v32)(np.array([1.5]))
    rt = si.RegularGridInterpolator(g, v32)(np.array([1.5]))
    assert ro.dtype == rt.dtype == np.float64
    np.testing.assert_allclose(ro, rt)


def test_complex_values_refused():
    with pytest.raises(ValueError, match="complex values are not supported"):
        compat.RegularGridInterpolator((np.arange(4.0),), np.arange(4.0) + 1j)


def test_linearize_extrapolation_warns_for_non_hermite_methods():
    grids = (np.linspace(0, 1, 5), np.linspace(0, 1, 6))
    vals = np.zeros((5, 6))
    with pytest.warns(UserWarning, match="applies only to method='hermite'"):
        compat.RegularGridInterpolator(grids, vals, method="cubic", linearize_extrapolation=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        compat.RegularGridInterpolator(grids, vals, method="hermite",
                                       linearize_extrapolation=True)
        compat.RegularGridInterpolator(grids, vals, method="cubic")


def test_hermite_linearized_matches_the_jax_compat():
    rng = np.random.default_rng(13)
    grids, vals = _make(rng, 2)
    xi = rng.uniform([g[0] - 0.5 for g in grids], [g[-1] + 0.5 for g in grids], (60, 2))
    kw = dict(bounds_error=False, fill_value=None, linearize_extrapolation=True)
    ours = compat.RegularGridInterpolator(grids, vals, method="hermite", **kw)(xi)
    _against_jax(ours, "hermite", grids, vals, xi, **kw)


def test_numpy_inputs_need_a_device(monkeypatch):
    """Without a card and without a request for the CPU, evaluation raises
    as raw does."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rgi = compat.RegularGridInterpolator((np.arange(4.0),), np.arange(4.0), method="pchip")
    with config.device(None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rgi(np.array([1.5]))


class TestDtypeOptIn:
    def _case(self, ndims=3, npts=8, n=257, seed=9):
        rng = np.random.default_rng(seed)
        grids = tuple(np.sort(rng.uniform(0, 1, npts)) for _ in range(ndims))
        grids = tuple(np.linspace(0, 1, npts) + 0.3 * g / npts for g in grids)
        vals = rng.normal(size=(npts,) * ndims)
        xi = rng.uniform(-0.1, 1.1, size=(n, ndims))
        return grids, vals, xi

    @pytest.mark.parametrize(
        "method", ["linear", "nearest", "slinear", "hermite", "cubic", "quintic", "pchip"])
    def test_f32_matches_f64_and_outputs_f32(self, method):
        npts = 8 if method != "quintic" else 9
        grids, vals, xi = self._case(npts=npts)
        kw = dict(method=method, bounds_error=False, fill_value=None)
        r64 = compat.RegularGridInterpolator(grids, vals, **kw)(xi)
        f32 = compat.RegularGridInterpolator(grids, vals, dtype=np.float32, **kw)
        r32 = f32(xi)
        assert r32.dtype == np.float32 and f32.values.dtype == np.float32
        scale = np.max(np.abs(r64)) + 1.0
        if method == "nearest":
            assert np.mean(np.abs(r64 - r32) / scale < 1e-6) > 0.95
        else:
            np.testing.assert_allclose(r32, r64, atol=5e-5 * scale)
        want = jcompat.RegularGridInterpolator(grids, vals, dtype=np.float32, **kw)(xi)
        np.testing.assert_allclose(r32, want, atol=5e-5 * scale)

    def test_fill_value_and_nan_in_f32(self):
        grids, vals, xi = self._case()
        xi[0] = 3.0
        xi[1, 0] = np.nan
        r = compat.RegularGridInterpolator(grids, vals, bounds_error=False, fill_value=7.5,
                                           dtype=np.float32)(xi)
        assert r.dtype == np.float32 and r[0] == np.float32(7.5) and np.isnan(r[1])

    def test_trailing_channels_f32(self):
        rng = np.random.default_rng(3)
        grids = (np.linspace(0, 1, 6), np.linspace(0, 1, 7))
        vals = rng.normal(size=(6, 7, 3))
        xi = rng.uniform(0, 1, size=(50, 2))
        r64 = compat.RegularGridInterpolator(grids, vals)(xi)
        r32 = compat.RegularGridInterpolator(grids, vals, dtype=np.float32)(xi)
        assert r32.shape == (50, 3) and r32.dtype == np.float32
        np.testing.assert_allclose(r32, r64, atol=1e-5)

    def test_interpn_dtype_passthrough(self):
        grids, vals, _ = self._case(ndims=2)
        assert compat.interpn(grids, vals, np.array([[0.4, 0.6]]),
                              dtype=np.float32).dtype == np.float32

    def test_bad_dtype_rejected(self):
        grids, vals, _ = self._case(ndims=2)
        for dt in (np.int32, np.float16):
            with pytest.raises(ValueError) as e_ours:
                compat.RegularGridInterpolator(grids, vals, dtype=dt)
            with pytest.raises(ValueError) as e_jax:
                jcompat.RegularGridInterpolator(grids, vals, dtype=dt)
            assert str(e_ours.value) == str(e_jax.value)

    def test_f32_spline_fit_stays_f64(self):
        grids, vals, xi = self._case()
        rgi = compat.RegularGridInterpolator(grids, vals, method="cubic", dtype=np.float32)
        rgi(xi[np.all((xi >= 0) & (xi <= 1), axis=1)])
        knots, coeffs = rgi._splines[3]
        assert coeffs.dtype == np.float32 and all(t.dtype == np.float32 for t in knots)
        # the JAX package's fit on the same float32 grid and table, bit for bit
        theirs = jcompat.RegularGridInterpolator(grids, vals, method="cubic", dtype=np.float32)
        theirs(xi[:1].clip(0, 1))
        np.testing.assert_array_equal(coeffs, theirs._splines[3][1])
