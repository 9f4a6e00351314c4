"""Stacked tables (nch tables on one grid): the port's `ops.stack`, the
stack kernel wrappers and `interpn_stack` against the JAX package on the CPU.

Tolerances:
* the port's per-channel gather trees vs the JAX package's: f64
  rtol=atol=1e-13, f32 rtol=atol=1e-5 (the same operations in the same
  order; XLA:CPU may contract a multiply-add into an FMA); nearest exact.
* the kernel wrappers (their plain versions on a CPU tensor) vs the Pallas
  stack kernels K5 (`eval_regular_stack`), K6 (`eval_rectilinear_stack`)
  and K7 (`eval_bspline_stack`) in interpret mode: f32 rtol=atol=2e-5, the
  bar of tests/test_stack.py (atol times the largest coefficient for the
  splines, as tests/test_bspline_engines.py scales it).
* gradients: f64 rtol=atol=1e-12 against `jax.vjp` of the vmapped JAX
  gather tree.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu
import jax
import jax.numpy as jnp

from interpn_tpu import ops as jops
from interpn_tpu.ops import bspline as jbspline
from interpn_tpu.ops import pallas_v3 as jv3
import interpn_tpu_torch
from interpn_tpu_torch import config, convert
from interpn_tpu_torch import ops as tops
from interpn_tpu_torch.ops import bspline as tbspline
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-13, atol=1e-13)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}
CPU = torch.device("cpu")
METHODS = ["linear", "cubic", "nearest"]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _case(kind, dims, nch, dtype, seed=0, n=300, bad=True, ext=1 / 3):
    """(grid numpy arrays, (nch, prod) tables, queries) with `ext` of a
    grid past each side and NaN and +-inf mixed in; `grid` is
    (starts, steps) for a regular grid, the axes for a rectilinear one."""
    rng = np.random.default_rng(seed)
    if kind == "regular":
        starts, steps = rng.uniform(-1, 1, len(dims)), rng.uniform(0.3, 1.0, len(dims))
        axes = [s + h * np.arange(d) for s, h, d in zip(starts, steps, dims)]
        grid = (starts.astype(dtype), steps.astype(dtype))
    else:
        axes = [np.cumsum(0.2 + rng.random(d)) for d in dims]
        grid = tuple(a.astype(dtype) for a in axes)
    vals = rng.standard_normal((nch, math.prod(dims))).astype(dtype)
    obs = []
    for a in axes:
        span = a[-1] - a[0]
        o = rng.uniform(a[0] - ext * span, a[-1] + ext * span, n)
        if bad:
            o[rng.integers(0, n, 5)] = rng.choice([np.nan, np.inf, -np.inf], 5)
        obs.append(o.astype(dtype))
    return grid, vals, obs


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _port_stack(kind, method, dims, grid, vals, obs, lin=True):
    extra = (lin,) if method == "cubic" else ()
    if kind == "regular":
        fn = getattr(tops, f"{method}_regular_stack")
        return fn(dims, *_t(grid), torch.from_numpy(vals), _t(obs), *extra)
    fn = getattr(tops, f"{method}_rectilinear_stack")
    return fn(_t(grid), torch.from_numpy(vals), _t(obs), *extra)


def _jax_stack(kind, method, dims, grid, vals, obs, lin=True):
    extra = (lin,) if method == "cubic" else ()
    if kind == "regular":
        fn = getattr(jops, f"{method}_regular_stack")
        return np.asarray(fn(dims, *_j(grid), jnp.asarray(vals), _j(obs), *extra))
    fn = getattr(jops, f"{method}_rectilinear_stack")
    return np.asarray(fn(_j(grid), jnp.asarray(vals), _j(obs), *extra))


def _close(got, want, method, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL[dtype])


# --- the six stack functions --------------------------------------------------------


@pytest.mark.parametrize("dims", [(9,), (8, 6), (7, 5, 6), (5, 4, 6, 4)], ids=str)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stacks_match_jax(dims, method, kind, dtype):
    grid, vals, obs = _case(kind, dims, 3, dtype, seed=len(dims))
    for lin in (True, False) if method == "cubic" else (True,):
        got = _port_stack(kind, method, dims, grid, vals, obs, lin)
        assert got.shape == (3, 300)
        _close(got, _jax_stack(kind, method, dims, grid, vals, obs, lin), method, dtype)


@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
def test_stack_channel_is_single_table(kind):
    """Each row of a stack is the single-table evaluation of its table."""
    dims = (7, 5, 6)
    grid, vals, obs = _case(kind, dims, 4, np.float64, seed=3)
    for method in METHODS:
        got = _port_stack(kind, method, dims, grid, vals, obs)
        for c in range(4):
            extra = (True,) if method == "cubic" else ()
            if kind == "regular":
                one = getattr(tops, f"{method}_regular")(
                    dims, *_t(grid), torch.from_numpy(vals[c]), _t(obs), *extra)
            else:
                one = getattr(tops, f"{method}_rectilinear")(
                    _t(grid), torch.from_numpy(vals[c]), _t(obs), *extra)
            torch.testing.assert_close(got[c], one, rtol=0, atol=0, equal_nan=True)


def test_stack_routes_cpu_to_gather_and_keeps_shape(monkeypatch):
    for name in ("eval_regular_stack", "eval_rectilinear_stack", "eval_bspline_stack"):
        monkeypatch.setattr(tfused, name, lambda *a, **k: pytest.fail("kernel on CPU"))
    dims = (6, 5)
    grid, vals, obs = _case("regular", dims, 2, np.float64, seed=4, n=24)
    ob = tuple(o.reshape(4, 6) for o in _t(obs))
    got = tops.cubic_regular_stack(dims, *_t(grid), torch.from_numpy(vals), ob, False)
    assert got.shape == (2, 4, 6)
    want = tfused.plain_regular_stack(dims, *_t(grid), torch.from_numpy(vals), ob, "cubic",
                                      False)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# --- the kernel wrappers against the Pallas stack kernels K5, K6, K7 ------------------


@pytest.mark.parametrize("dims", [(8, 12), (10, 10, 10), (6, 5, 4, 7)], ids=str)
@pytest.mark.parametrize("method", METHODS)
def test_fused_stack_plain_matches_pallas_k5(_interpret_mode, dims, method):
    grid, vals, obs = _case("regular", dims, 3, np.float32, seed=1, bad=False, ext=0.1)
    want = np.asarray(jv3.eval_regular_stack(dims, *_j(grid), jnp.asarray(vals), _j(obs),
                                             method, True))
    got = tfused.eval_regular_stack(dims, *_t(grid), torch.from_numpy(vals), _t(obs), method)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("method", METHODS)
def test_fused_stack_plain_matches_pallas_k6(_interpret_mode, method):
    grid, vals, obs = _case("rectilinear", (9, 8, 7), 3, np.float32, seed=5, bad=False,
                            ext=0.1)
    want = np.asarray(jv3.eval_rectilinear_stack(_j(grid), jnp.asarray(vals), _j(obs),
                                                 method, True))
    got = tfused.eval_rectilinear_stack(_t(grid), torch.from_numpy(vals), _t(obs), method)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _spline_stack(k, dims, nch, seed, n=300, ext=0.2):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    vals = rng.standard_normal((nch, math.prod(dims)))
    knots, coeffs = tbspline.prep_bspline(grids, np.ascontiguousarray(vals.T), k)
    obs = [rng.uniform(g[0] - ext * (g[-1] - g[0]), g[-1] + ext * (g[-1] - g[0]), n)
           for g in grids]
    return grids, vals, knots, np.ascontiguousarray(coeffs.T), obs


@pytest.mark.parametrize("k,dims", [(3, (8, 7, 6)), (5, (7, 8))], ids=str)
@pytest.mark.parametrize("in_kernel", [True, False], ids=["k7-knots", "k6-pre"])
def test_fused_bspline_stack_plain_matches_pallas(_interpret_mode, monkeypatch, k, dims,
                                                  in_kernel):
    """K7 builds the weights in the kernel, K6 takes them from XLA; the TPU
    picks by knot length (`_spline_use_pre`), here forced both ways."""
    monkeypatch.setattr(jv3, "_spline_use_pre", lambda *_: not in_kernel)
    _, _, knots, coeffs, obs = _spline_stack(k, dims, 3, seed=k)
    want = np.asarray(jv3.eval_bspline_stack(
        tuple(jnp.asarray(t, jnp.float32) for t in knots), jnp.asarray(coeffs, jnp.float32),
        tuple(jnp.asarray(o, jnp.float32) for o in obs), k))
    kt, ct = convert.bspline_from_numpy(knots, coeffs, device=CPU, dtype=torch.float32)
    got = tfused.eval_bspline_stack(kt, ct, convert.obs_from_numpy(obs, device=CPU,
                                                                   dtype=torch.float32), k)
    cs = max(float(np.abs(coeffs).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * cs)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bspline_eval_stack_matches_jax(k, dtype):
    _, _, knots, coeffs, obs = _spline_stack(k, (7, 6, 8), 3, seed=10 + k)
    kt, ct = convert.bspline_from_numpy(knots, coeffs, device=CPU, dtype=TDTYPE[dtype])
    got = tops.bspline_eval_stack(kt, ct, convert.obs_from_numpy(obs, device=CPU,
                                                                 dtype=TDTYPE[dtype]), k)
    want = np.asarray(jbspline.bspline_eval_stack(
        tuple(jnp.asarray(t, dtype) for t in knots), jnp.asarray(coeffs, dtype),
        tuple(jnp.asarray(o, dtype) for o in obs), k))
    _close(got, want, "cubic_spline", dtype)


def test_fused_stack_refuses():
    dims = (4, 5)
    st, sp = torch.zeros(2), torch.ones(2)
    ob = (torch.zeros(6),) * 2
    assert tfused._check(dims, st, sp, torch.zeros(3, 20), ob, "linear", True) == 6
    with pytest.raises(ValueError, match=r"vals must be \(nch, 20\)"):
        tfused._check(dims, st, sp, torch.zeros(60), ob, "linear", True)
    with pytest.raises(ValueError, match="vals must be flat with 20 entries"):
        tfused._check(dims, st, sp, torch.zeros(3, 20), ob)
    with pytest.raises(ValueError, match="method must be one of"):
        tfused.eval_regular_stack(dims, st, sp, torch.zeros(3, 20), ob, "quintic")


# --- gradients ------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_stack_kernel_route_grads_match_jax(method):
    """The stack route as built for a CUDA tensor (wrapper forward, the
    per-channel gather tree's VJP backward), run on the CPU, against jax.vjp
    of the JAX package's stack on the CPU (a vmapped gather tree)."""
    dims = (6, 5, 7)
    grid, vals, obs = _case("rectilinear", dims, 3, np.float64, seed=6, bad=False)
    cot = np.random.default_rng(7).standard_normal((3, 300))
    lin = (False,) if method == "cubic" else ()
    leaves = [torch.tensor(a, requires_grad=True) for a in (*grid, vals, *obs)]
    out = tdispatch.KernelRoute.apply(
        tdispatch.Route(
            lambda *a: tfused.eval_rectilinear_stack(a[:3], a[3], a[4:], method, *lin),
            lambda *a: tfused.gather_rectilinear_stack(a[:3], a[3], a[4:], method, *lin),
            3, True, None, False),
        *leaves,
    )
    out.backward(torch.from_numpy(cot))
    fn = getattr(jops, f"{method}_rectilinear_stack")
    _, vjp = jax.vjp(lambda *a: fn(a[:3], a[3], a[4:], *lin), *_j((*grid, vals, *obs)))
    for got, want in zip(leaves, vjp(jnp.asarray(cot))):
        got = np.zeros_like(want) if got.grad is None else got.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)


# --- interpn_stack ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest", "cubic_spline", "quintic"])
@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpn_stack_matches_jax(method, kind, dtype):
    rng = np.random.default_rng(17)
    if kind == "regular":
        grids = [np.linspace(0.0, 1.0, 8).astype(dtype), np.linspace(-1.0, 2.0, 9).astype(dtype)]
    else:
        grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in (8, 9)]
    vals = rng.standard_normal((4, 8, 9)).astype(dtype)
    obs = [rng.uniform(g[0] - 0.1, g[-1] + 0.1, (5, 5)).astype(dtype) for g in grids]
    for lin in (True, False) if method == "cubic" else (True,):
        kw = dict(method=method, linearize_extrapolation=lin)
        want = interpn_tpu.interpn_stack(obs, grids, vals, **kw)
        got = interpn_tpu_torch.interpn_stack(obs, grids, vals, **kw)
        assert got.shape == want.shape == (4, 5, 5) and got.dtype == want.dtype
        if method == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL[dtype])
        # (nch, prod(dims)) tables give the same
        flat = interpn_tpu_torch.interpn_stack(obs, grids, vals.reshape(4, -1), **kw)
        np.testing.assert_array_equal(flat, got)


def _bad_stack_calls():
    x = np.linspace(0.0, 1.0, 6)
    vals = np.zeros((2, 36))
    obs = [np.full(4, 0.5), np.full(4, 0.5)]
    return [
        ("bounds", lambda m: m.interpn_stack([np.full(4, 2.0), obs[1]], [x, x], vals,
                                             check_bounds=True)),
        ("bounds-rectilinear", lambda m: m.interpn_stack(
            [np.full(4, 2.0), obs[1]], [x, x ** 2], vals, check_bounds=True)),
        ("vals-size", lambda m: m.interpn_stack(obs, [x, x], np.zeros((2, 35)))),
        ("vals-1d", lambda m: m.interpn_stack(obs, [x, x], np.zeros(36))),
        ("obs-count", lambda m: m.interpn_stack(obs[:1], [x, x], vals)),
        ("obs-dtype", lambda m: m.interpn_stack([o.astype(np.float32) for o in obs], [x, x],
                                                vals)),
        ("int-vals", lambda m: m.interpn_stack(obs, [x, x], vals.astype(np.int32))),
        ("spline-short-axis", lambda m: m.interpn_stack(obs, [x, x[:5]], np.zeros((2, 30)),
                                                        method="quintic")),
        ("unknown-method", lambda m: m.interpn_stack(obs, [x, x], vals, method="spline")),
    ]


@pytest.mark.parametrize("call", [c for _, c in _bad_stack_calls()],
                         ids=[i for i, _ in _bad_stack_calls()])
def test_interpn_stack_errors_match_jax(call):
    with pytest.raises((AssertionError, TypeError, ValueError)) as want:
        call(interpn_tpu)
    with pytest.raises(want.type) as got:
        call(interpn_tpu_torch)
    assert str(got.value) == str(want.value)


def test_interpn_stack_pchip_is_not_ported_yet():
    """Kept under its name from before pchip was ported: `interpn_stack()`
    now takes method="pchip" and gives the JAX package's values."""
    x = np.linspace(0.0, 1.0, 6)
    vals = np.stack([np.sin(3.0 * x), np.cos(2.0 * x)])
    obs = [np.array([-0.1, 0.25, 0.5, 1.2])]
    np.testing.assert_allclose(
        interpn_tpu_torch.interpn_stack(obs, [x], vals, method="pchip"),
        interpn_tpu.interpn_stack(obs, [x], vals, method="pchip"), **TOL[np.float64])
