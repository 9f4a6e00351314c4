"""The port's `raw` shims and `interpn()` against the JAX package's, on the
CPU: values, in-place `out`, placement and every error string.

The JAX package's shims send small numpy batches to its native C++ engine,
which contracts multiply-adds into FMAs; these tests turn that engine off
(INTERPN_TPU_NATIVE=0) so both sides run the gather tree. Its jitted program
may still contract a multiply-add into an FMA, which moves a result by an
ulp of the intermediate sums: against the JAX shims the bar is f32 rtol=1e-6
with atol=1e-5 (results near zero, tables of magnitude ~10), f64
rtol=atol=1e-13. Against the JAX gather tree called eagerly, which runs op
by op, the f32 bar is rtol=atol=1e-6.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import interpn_tpu
import interpn_tpu_torch
import jax.numpy as jnp
from interpn_tpu.ops import cubic as jcubic
from interpn_tpu.ops import linear as jlinear
from interpn_tpu.ops import nearest as jnearest
from interpn_tpu_torch import config
from interpn_tpu_torch import raw as traw

ROOT = Path(__file__).resolve().parent.parent

TOL = {np.float32: dict(rtol=1e-6, atol=1e-6), np.float64: dict(rtol=1e-13, atol=1e-13)}
TOL_JIT = {np.float32: dict(rtol=1e-6, atol=1e-5), np.float64: TOL[np.float64]}
SUFFIX = {np.float32: "f32", np.float64: "f64"}


@pytest.fixture(autouse=True)
def _jax_gather_path(monkeypatch):
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's numpy inputs compute on the card by default; these tests
    ask for the CPU."""
    with config.device("cpu"):
        yield


def _grid(dims, dtype, seed=0, n=700):
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd).astype(dtype)
    steps = rng.uniform(0.3, 1.0, nd).astype(dtype)
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    obs = [
        rng.uniform(starts[k] - steps[k], starts[k] + steps[k] * dims[k], n).astype(dtype)
        for k in range(nd)
    ]
    return np.array(dims), starts, steps, vals, obs


def _linear(mod, dtype):
    return getattr(mod.raw, f"interpn_linear_regular_{SUFFIX[dtype]}")


def _bounds(mod, dtype):
    return getattr(mod.raw, f"check_bounds_regular_{SUFFIX[dtype]}")


# --- values and in-place out -------------------------------------------------


@pytest.mark.parametrize("dims", [(9,), (7, 5), (7, 5, 6), (4, 3, 4, 3, 2, 3, 2, 3)],
                         ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_linear_numpy_matches_jax(dims, dtype):
    dims, starts, steps, vals, obs = _grid(dims, dtype)
    want = np.zeros(700, dtype)
    _linear(interpn_tpu, dtype)(dims, starts, steps, vals, obs, want)
    out = np.zeros(700, dtype)
    ret = _linear(interpn_tpu_torch, dtype)(dims, starts, steps, vals, obs, out)
    assert ret is out
    np.testing.assert_allclose(out, want, **TOL_JIT[dtype])
    eager = jlinear.linear_regular(
        tuple(dims), jnp.asarray(starts), jnp.asarray(steps), jnp.asarray(vals),
        tuple(jnp.asarray(o) for o in obs),
    )
    np.testing.assert_allclose(out, np.asarray(eager), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_linear_tensors_in_place(dtype):
    dims, starts, steps, vals, obs = _grid((7, 5, 6), dtype, seed=1)
    want = np.zeros(700, dtype)
    _linear(interpn_tpu_torch, dtype)(dims, starts, steps, vals, obs, want)
    out = torch.zeros(700, dtype=getattr(torch, np.dtype(dtype).name))
    ret = _linear(interpn_tpu_torch, dtype)(
        torch.from_numpy(dims), torch.from_numpy(starts), torch.from_numpy(steps),
        torch.from_numpy(vals), [torch.from_numpy(o) for o in obs], out,
    )
    assert ret is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_raw_linear_out_shape_and_strided_obs():
    dims, starts, steps, vals, obs = _grid((7, 5), np.float64, seed=2, n=24)
    want = np.zeros(24)
    traw.interpn_linear_regular_f64(dims, starts, steps, vals, obs, want)
    out = np.zeros((4, 6))
    strided = [torch.from_numpy(np.repeat(o, 2))[::2] for o in obs]
    traw.interpn_linear_regular_f64(dims, starts, steps, vals, strided, out)
    np.testing.assert_array_equal(out.ravel(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_check_bounds_matches_jax(dtype):
    dims, starts, steps, vals, obs = _grid((5, 6, 7), dtype, seed=3)
    seen = set()
    for atol in (1e-8, 0.5, 2.0):
        want = np.zeros(3, bool)
        _bounds(interpn_tpu, dtype)(dims, starts, steps, obs, atol, want)
        seen.add(tuple(want))
        out = np.zeros(3, bool)
        assert _bounds(interpn_tpu_torch, dtype)(dims, starts, steps, obs, atol, out) is out
        np.testing.assert_array_equal(out, want)
        tout = torch.zeros(3, dtype=torch.bool)
        _bounds(interpn_tpu_torch, dtype)(
            dims, torch.from_numpy(starts), torch.from_numpy(steps),
            [torch.from_numpy(o) for o in obs], atol, tout,
        )
        np.testing.assert_array_equal(tout.numpy(), want)
    assert len(seen) > 1  # the atols straddle the queries' overshoot


# --- placement -----------------------------------------------------------------


def test_numpy_inputs_go_to_the_default_device(monkeypatch):
    """Numpy inputs go to the card when there is one, to the requested
    device when the caller asks, and raise without either."""
    assert traw._device(np.zeros(2), np.zeros(3)) == torch.device("cpu")  # the fixture's request
    with config.device(None):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        assert traw._device(np.zeros(2)) == torch.device("cuda", 0)
        with config.device("meta"):
            assert traw._device(np.zeros(2)) == torch.device("meta")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
            traw._device(np.zeros(2))
        dims, starts, steps, vals, obs = _grid((7, 5), np.float32, n=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            traw.interpn_linear_regular_f32(dims, starts, steps, vals, obs, np.zeros(8, np.float32))
        # tensors compute where they live, whatever is requested
        t = [torch.from_numpy(a) for a in (starts, steps, vals)]
        out = torch.zeros(8)
        traw.interpn_linear_regular_f32(dims, *t, [torch.from_numpy(o) for o in obs], out)


def test_tensors_must_share_a_device():
    dims, starts, steps, vals, obs = _grid((7, 5), np.float32, n=8)
    obs_t = [torch.from_numpy(obs[0]), torch.from_numpy(obs[1]).to("meta")]
    with pytest.raises(ValueError, match="share a device"):
        traw.interpn_linear_regular_f32(dims, starts, steps, vals, obs_t, np.zeros(8, np.float32))


# --- errors: the same type and message from both packages ----------------------


def _bad_calls():
    """(id, call(mod)) pairs that both packages must refuse alike."""
    f32, f64 = np.float32, np.float64

    def lin(mod, dtype, *, dims=(4, 5), steps=None, vals=None, obs=None, out=None, n=6):
        d, st, sp, v, ob = _grid(dims, dtype, seed=4, n=n)
        return _linear(mod, dtype)(
            d, st, sp if steps is None else steps, v if vals is None else vals,
            ob if obs is None else obs, np.zeros(n, dtype) if out is None else out,
        )

    nan_obs = [np.array([0.5, np.nan], f32), np.array([0.5, 0.5], f32)]
    inf_obs = [np.array([0.5, np.inf]), np.array([0.5, 0.5])]
    return [
        ("dims>8", lambda m: lin(m, f64, dims=(2,) * 9)),
        ("short-axis", lambda m: lin(m, f64, dims=(4, 1))),
        ("zero-step", lambda m: lin(m, f32, steps=np.array([0.5, 0.0], f32))),
        ("negative-step", lambda m: lin(m, f64, steps=np.array([-0.5, 1.0]))),
        ("vals-size", lambda m: lin(m, f64, vals=np.zeros(19))),
        ("obs-length", lambda m: lin(m, f64, out=np.zeros(5))),
        ("obs-count", lambda m: lin(m, f64, obs=[np.zeros(6)])),
        ("vals-dtype", lambda m: lin(m, f32, vals=np.zeros(20))),
        ("out-dtype", lambda m: lin(m, f64, out=np.zeros(6, f32))),
        ("obs-list", lambda m: lin(m, f64, obs=[[0.0] * 6, np.zeros(6)])),
        ("nan-query", lambda m: lin(m, f32, obs=nan_obs, n=2)),
        ("inf-query", lambda m: lin(m, f64, obs=inf_obs, n=2)),
        ("bounds-out-dtype", lambda m: _bounds(m, f64)(
            np.array([4, 5]), np.zeros(2), np.ones(2), [np.zeros(3)] * 2, 1e-8,
            np.zeros(2))),
        ("bounds-out-size", lambda m: _bounds(m, f64)(
            np.array([4, 5]), np.zeros(2), np.ones(2), [np.zeros(3)] * 2, 1e-8,
            np.zeros(3, bool))),
        ("bounds-obs-dtype", lambda m: _bounds(m, f32)(
            np.array([4, 5]), np.zeros(2, f32), np.ones(2, f32), [np.zeros(3)] * 2,
            1e-8, np.zeros(2, bool))),
    ]


@pytest.mark.parametrize("call", [c for _, c in _bad_calls()], ids=[i for i, _ in _bad_calls()])
def test_errors_match_jax(call):
    with pytest.raises((AssertionError, TypeError)) as want:
        call(interpn_tpu)
    with pytest.raises(want.type) as got:
        call(interpn_tpu_torch)
    assert str(got.value) == str(want.value)


# --- interpn() -----------------------------------------------------------------


def _axes(dims, dtype, seed=5):
    rng = np.random.default_rng(seed)
    grids = [(np.arange(d) * 0.25 * (k + 1) - 1.0).astype(dtype) for k, d in enumerate(dims)]
    vals = rng.standard_normal(dims).astype(dtype)
    obs = [rng.uniform(g[0] - 0.3, g[-1] + 0.3, 50).astype(dtype) for g in grids]
    return grids, vals, obs


@pytest.mark.parametrize("dims", [(6, 7), (5, 4, 6)], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpn_matches_jax(dims, dtype):
    grids, vals, obs = _axes(dims, dtype)
    want = interpn_tpu.interpn(obs, grids, vals, method="linear")
    got = interpn_tpu_torch.interpn(obs, grids, vals, method="linear")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL_JIT[dtype])


def test_interpn_writes_caller_out():
    grids, vals, obs = _axes((6, 7), np.float64)
    want = interpn_tpu.interpn([o.reshape(5, 10) for o in obs], grids, vals)
    buf = np.zeros((10, 5)).T  # not C-contiguous: ravel() copies
    ret = interpn_tpu_torch.interpn([o.reshape(5, 10) for o in obs], grids, vals, out=buf)
    assert ret is buf
    np.testing.assert_allclose(buf, want, **TOL[np.float64])


def test_interpn_check_bounds():
    grids, vals, obs = _axes((6, 7), np.float64)
    for mod in (interpn_tpu, interpn_tpu_torch):
        with pytest.raises(ValueError, match="^Observation points violate interpolator bounds$"):
            mod.interpn(obs, grids, vals, check_bounds=True)
    inside = [np.clip(o, g[0], g[-1]) for o, g in zip(obs, grids)]
    np.testing.assert_allclose(
        interpn_tpu_torch.interpn(inside, grids, vals, check_bounds=True),
        interpn_tpu.interpn(inside, grids, vals, check_bounds=True),
        **TOL[np.float64],
    )


def test_interpn_refusals():
    grids, vals, obs = _axes((6, 7), np.float64)
    rect = [np.cumsum(np.arange(1.0, 7.0)), grids[1]]
    for g in (grids, rect):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            interpn_tpu_torch.interpn(obs, g, vals, method="pchip")
        # the splines are ported: the JAX package's values, not a refusal
        for method in ("cubic_spline", "quintic"):
            np.testing.assert_allclose(interpn_tpu_torch.interpn(obs, g, vals, method=method),
                                       interpn_tpu.interpn(obs, g, vals, method=method),
                                       **TOL[np.float64])
    for mod in (interpn_tpu, interpn_tpu_torch):
        with pytest.raises(AssertionError, match="only for float32 and float64"):
            mod.interpn(obs, grids, vals.astype(np.int64))
    with pytest.raises(ValueError) as want:
        interpn_tpu.interpn(obs, grids, vals, method="bogus")
    with pytest.raises(ValueError) as got:
        interpn_tpu_torch.interpn(obs, grids, vals, method="bogus")
    assert str(got.value) == str(want.value)


# --- the other twelve raw functions and every interpn() method -----------------

# Cubic through the JAX package's jitted shims may differ by FMA contraction
# in XLA:CPU; the bar there is f32 rtol=atol=1e-5.
TOL_CUBIC = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: TOL[np.float64]}
METHODS = ["linear", "cubic", "nearest"]


def _rect_grid(dims, dtype, seed=6, n=300):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    obs = [rng.uniform(g[0] - 1.0, g[-1] + 1.0, n).astype(dtype) for g in grids]
    return grids, vals, obs


def _raw(mod, method, kind, dtype):
    return getattr(mod.raw, f"interpn_{method}_{kind}_{SUFFIX[dtype]}")


def _lins(method):
    return [(True,), (False,)] if method == "cubic" else [()]


def _same(got, want, method, dtype):
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL_CUBIC[dtype])


def _jax_eager(method, kind, grid, lin, obs):
    """The JAX gather tree called op by op (no jit, so no FMA contraction):
    `grid` is (dims, starts, steps, vals) or (grids, vals)."""
    mod = {"linear": jlinear, "cubic": jcubic, "nearest": jnearest}[method]
    j = [jnp.asarray(a) for a in grid[1:]] if kind == "regular" else None
    if kind == "regular":
        args = (tuple(int(d) for d in grid[0]), *j)
    else:
        args = (tuple(jnp.asarray(g) for g in grid[0]), jnp.asarray(grid[1]))
    return np.asarray(getattr(mod, f"{method}_{kind}")(
        *args, tuple(jnp.asarray(o) for o in obs), *lin))


@pytest.mark.parametrize("dims", [(5,), (6, 7), (5, 4, 6), (4, 5, 4, 4, 5)],
                         ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", METHODS)
def test_raw_rectilinear_matches_jax(dims, dtype, method):
    """Against the JAX shims at TOL_JIT for linear (exact for nearest), and
    against the JAX gather tree called eagerly for every method: deep cubic
    extrapolation amplifies the jitted program's FMA differences."""
    grids, vals, obs = _rect_grid(dims, dtype)
    for lin in _lins(method):
        out = np.zeros(300, dtype)
        assert _raw(interpn_tpu_torch, method, "rectilinear", dtype)(
            grids, vals, *lin, obs, out) is out
        _same(out, _jax_eager(method, "rectilinear", (grids, vals), lin, obs), method, dtype)
        if method != "cubic":
            want = np.zeros(300, dtype)
            _raw(interpn_tpu, method, "rectilinear", dtype)(grids, vals, *lin, obs, want)
            np.testing.assert_allclose(out, want, **TOL_JIT[dtype])


@pytest.mark.parametrize("dims", [(9,), (6, 7), (5, 4, 6), (4, 5, 4, 4, 5)],
                         ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["cubic", "nearest"])
def test_raw_regular_matches_jax(dims, dtype, method):
    dims, starts, steps, vals, obs = _grid(dims, dtype, seed=7, n=300)
    for lin in _lins(method):
        out = torch.zeros(300, dtype=getattr(torch, np.dtype(dtype).name))
        assert _raw(interpn_tpu_torch, method, "regular", dtype)(
            torch.from_numpy(dims), torch.from_numpy(starts), torch.from_numpy(steps),
            torch.from_numpy(vals), *lin, [torch.from_numpy(o) for o in obs], out) is out
        grid = (dims, starts, steps, vals)
        _same(out.numpy(), _jax_eager(method, "regular", grid, lin, obs), method, dtype)
        want = np.zeros(300, dtype)
        _raw(interpn_tpu, method, "regular", dtype)(dims, starts, steps, vals, *lin, obs, want)
        _same(out.numpy(), want, method, dtype)


@pytest.mark.parametrize("method", METHODS)
def test_raw_rectilinear_nonfinite_queries_never_raise(method):
    """Rectilinear shims bisect and never raise the unrepresentable-value
    error; NaN and +-inf give what the JAX package gives."""
    grids, vals, obs = _rect_grid((6, 7), np.float64, n=6)
    obs[0][:3] = [np.nan, np.inf, -np.inf]
    for lin in _lins(method):
        want = np.zeros(6)
        _raw(interpn_tpu, method, "rectilinear", np.float64)(grids, vals, *lin, obs, want)
        out = np.zeros(6)
        _raw(interpn_tpu_torch, method, "rectilinear", np.float64)(grids, vals, *lin, obs, out)
        np.testing.assert_allclose(out, want, equal_nan=True, **TOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_check_bounds_rectilinear_matches_jax(dtype):
    grids, vals, obs = _rect_grid((5, 6, 7), dtype, seed=8)
    seen = set()
    for atol in (1e-8, 0.5, 2.0):
        want = np.zeros(3, bool)
        getattr(interpn_tpu.raw, f"check_bounds_rectilinear_{SUFFIX[dtype]}")(
            grids, obs, atol, want)
        seen.add(tuple(want))
        out = np.zeros(3, bool)
        fn = getattr(traw, f"check_bounds_rectilinear_{SUFFIX[dtype]}")
        assert fn(grids, obs, atol, out) is out
        np.testing.assert_array_equal(out, want)
    assert len(seen) > 1


def _bad_calls_new():
    """Refusals of the twelve functions ported after linear regular."""
    f32, f64 = np.float32, np.float64

    def reg(mod, method, dtype, *, dims=(4, 5), vals=None, obs=None, n=6):
        d, st, sp, v, ob = _grid(dims, dtype, seed=9, n=n)
        lin = (True,) if method == "cubic" else ()
        return _raw(mod, method, "regular", dtype)(
            d, st, sp, v if vals is None else vals, *lin, ob if obs is None else obs,
            np.zeros(n, dtype))

    def rect(mod, method, dtype, *, dims=(4, 5), grids=None, vals=None, obs=None, out=None,
             n=6):
        g, v, ob = _rect_grid(dims, dtype, seed=9, n=n)
        lin = (False,) if method == "cubic" else ()
        return _raw(mod, method, "rectilinear", dtype)(
            g if grids is None else grids, v if vals is None else vals, *lin,
            ob if obs is None else obs, np.zeros(n, dtype) if out is None else out)

    def bounds(mod, dtype, grids, obs, out):
        return getattr(mod.raw, f"check_bounds_rectilinear_{SUFFIX[dtype]}")(
            grids, obs, 1e-8, out)

    nan_obs = [np.array([0.5, np.nan]), np.array([0.5, 0.5])]
    inf_obs = [np.array([0.5, np.inf], f32), np.array([0.5, 0.5], f32)]
    down = np.array([1.0, 0.5, 2.0, 3.0])
    g45 = [np.arange(4.0), np.arange(5.0)]
    return [
        ("cubic-short-axis", lambda m: reg(m, "cubic", f64, dims=(4, 3))),
        ("cubic-dims>8", lambda m: reg(m, "cubic", f32, dims=(4,) * 9, n=1)),
        ("cubic-nan-query", lambda m: reg(m, "cubic", f64, obs=nan_obs, n=2)),
        ("cubic-vals-dtype", lambda m: reg(m, "cubic", f32, vals=np.zeros(20))),
        ("nearest-dims>6", lambda m: reg(m, "nearest", f64, dims=(2,) * 7)),
        ("nearest-inf-query", lambda m: reg(m, "nearest", f32, obs=inf_obs, n=2)),
        ("nearest-short-axis", lambda m: reg(m, "nearest", f64, dims=(1, 5))),
        ("rect-linear-short-axis", lambda m: rect(m, "linear", f64, grids=[np.zeros(1), g45[1]],
                                                  vals=np.zeros(5))),
        ("rect-cubic-short-axis", lambda m: rect(m, "cubic", f64, dims=(3, 5))),
        ("rect-cubic-not-increasing", lambda m: rect(m, "cubic", f64, grids=[down, g45[1]])),
        ("rect-linear-dims>8", lambda m: rect(m, "linear", f32, dims=(2,) * 9, n=1)),
        ("rect-nearest-dims>6", lambda m: rect(m, "nearest", f64, dims=(2,) * 7)),
        ("rect-vals-size", lambda m: rect(m, "linear", f64, vals=np.zeros(19))),
        ("rect-obs-count", lambda m: rect(m, "nearest", f64, obs=[np.zeros(6)])),
        ("rect-obs-length", lambda m: rect(m, "cubic", f64, out=np.zeros(5))),
        ("rect-grid-dtype", lambda m: rect(m, "linear", f32, grids=g45)),
        ("rect-out-dtype", lambda m: rect(m, "nearest", f64, out=np.zeros(6, f32))),
        ("rect-grid-list", lambda m: rect(m, "cubic", f64, grids=[[0.0, 1, 2, 3], g45[1]])),
        ("rect-bounds-out-dtype", lambda m: bounds(m, f64, g45, [np.zeros(3)] * 2, np.zeros(2))),
        ("rect-bounds-out-size", lambda m: bounds(m, f64, g45, [np.zeros(3)] * 2,
                                                  np.zeros(3, bool))),
        ("rect-bounds-empty-grid", lambda m: bounds(m, f64, [np.zeros(0), g45[1]],
                                                    [np.zeros(3)] * 2, np.zeros(2, bool))),
        ("rect-bounds-obs-dtype", lambda m: bounds(m, f32, [g.astype(f32) for g in g45],
                                                   [np.zeros(3)] * 2, np.zeros(2, bool))),
    ]


@pytest.mark.parametrize("call", [c for _, c in _bad_calls_new()],
                         ids=[i for i, _ in _bad_calls_new()])
def test_new_functions_errors_match_jax(call):
    with pytest.raises((AssertionError, TypeError)) as want:
        call(interpn_tpu)
    with pytest.raises(want.type) as got:
        call(interpn_tpu_torch)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpn_every_method_matches_jax(method, kind, dtype):
    if kind == "regular":
        grids, vals, obs = _axes((6, 7, 5), dtype, seed=10)
    else:
        grids, vals, obs = _rect_grid((6, 7, 5), dtype, seed=10, n=50)
        vals = vals.reshape(6, 7, 5)
    for lin in (True, False) if method == "cubic" else (True,):
        kw = dict(method=method, linearize_extrapolation=lin)
        want = interpn_tpu.interpn(obs, grids, vals, **kw)
        got = interpn_tpu_torch.interpn(obs, grids, vals, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        _same(got, want, method, dtype)


def test_interpn_check_bounds_rectilinear():
    grids, vals, obs = _rect_grid((6, 7), np.float64, n=50)
    for mod in (interpn_tpu, interpn_tpu_torch):
        with pytest.raises(ValueError, match="^Observation points violate interpolator bounds$"):
            mod.interpn(obs, grids, vals.reshape(6, 7), method="cubic", check_bounds=True)
    inside = [np.clip(o, g[0], g[-1]) for o, g in zip(obs, grids)]
    np.testing.assert_allclose(
        interpn_tpu_torch.interpn(inside, grids, vals.reshape(6, 7), check_bounds=True),
        interpn_tpu.interpn(inside, grids, vals.reshape(6, 7), check_bounds=True),
        **TOL[np.float64],
    )


# --- the port never imports jax ------------------------------------------------


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import interpn_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(interpn_tpu_torch.__path__,\n"
        "                                               'interpn_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('ops.bspline', 'ops.stack', 'ops.fused', 'utils.profiling'):\n"
        "    assert 'interpn_tpu_torch.' + name in names, name\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'interpn_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
