"""The port's native CPU engine (`interpn_tpu_torch.native`) against the JAX
package's (`interpn_tpu.native`) on the CPU.

Both build the same sources (the port's copies are byte for byte the JAX
package's) with the same g++ command, so on one host their results are
bitwise equal: the six evaluators at 1-4D, f32 and f64, both cubic
extrapolation modes, and both bounds checks, called directly and through
each package's `raw` from numpy. Beyond that: mirrors of
`tests/test_native.py` (the switch variables, dimensions the engine does
not take, extreme coordinates, threads bitwise one thread, the fastcall
layer refusing other dtypes), the port's routing rule (the CPU device or
INTERPN_TPU_NATIVE_THRESHOLD; tensors keep their routes; no fallback from
the card), the build's key, and the classes' prepared call: made once,
bitwise `raw`, dropped by a copy.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import interpn_tpu as it
from interpn_tpu import native as jnative

import interpn_tpu_torch as itt
from interpn_tpu_torch import config, native, raw

SUFFIX = {np.float32: "f32", np.float64: "f64"}
EVALUATORS = [(m, g) for m in ("linear", "cubic", "nearest") for g in ("regular", "rectilinear")]

pytestmark = pytest.mark.skipif(not native.available(), reason="the native engine did not build")


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    for var in ("INTERPN_TPU_NATIVE", "INTERPN_TPU_NATIVE_THRESHOLD"):
        monkeypatch.delenv(var, raising=False)
    with config.device("cpu"):
        yield


def _case(method, kind, ndims, dtype, seed=0, n=400):
    """(grid args of the native call, obs): a regular grid's (dims, starts,
    steps) or a rectilinear one's axes, a table, queries inside and out."""
    rng = np.random.default_rng(seed + 10 * ndims)
    npts = 5 if method == "cubic" else 4
    dims = [npts + int(rng.integers(0, 3)) for _ in range(ndims)]
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    if kind == "regular":
        starts = rng.uniform(-2, 2, ndims).astype(dtype)
        steps = rng.uniform(0.3, 1.5, ndims).astype(dtype)
        grid = (dims, starts, steps)
        lo = starts.astype(np.float64)
        hi = lo + steps * (np.asarray(dims) - 1)
    else:
        axes = [(np.cumsum(0.2 + rng.random(d)) + rng.uniform(-3, 3)).astype(dtype) for d in dims]
        grid = (axes,)
        lo = np.array([a[0] for a in axes], np.float64)
        hi = np.array([a[-1] for a in axes], np.float64)
    obs = [rng.uniform(lo[k] - 2, hi[k] + 2, n).astype(dtype) for k in range(ndims)]
    return grid, vals, obs


def _call(pkg, method, kind, grid, vals, obs, out, lin=True):
    """pkg.native.<method>_<kind>(...) with the package's argument order."""
    fn = getattr(pkg, f"{method}_{kind}")
    extra = (bool(lin),) if method == "cubic" else ()
    if kind == "regular":
        return fn(*grid, vals, *extra, obs, out)
    return fn(grid[0], vals, *extra, obs, out)


def _raw(pkg, method, kind, grid, vals, obs, out, lin=True):
    fn = getattr(pkg.raw, f"interpn_{method}_{kind}_{SUFFIX[out.dtype.type]}")
    extra = (bool(lin),) if method == "cubic" else ()
    if kind == "regular":
        return fn(list(grid[0]), grid[1], grid[2], vals, *extra, obs, out)
    return fn(grid[0], vals, *extra, obs, out)


# --- the sources and the build -----------------------------------------------------------


@pytest.mark.parametrize("name", ["interpn_native.cpp", "fastcall.c"])
def test_sources_are_the_jax_packages_byte_for_byte(name):
    from pathlib import Path

    ours = Path(native.__file__).with_name(name).read_bytes()
    theirs = Path(jnative.__file__).with_name(name).read_bytes()
    assert ours == theirs


def test_builds_into_the_ports_build_directory_keyed_by_host(monkeypatch):
    """The library lives in interpn_tpu_torch/_build/, built with the JAX
    loader's flags, named by the source, the flags and the host's CPU
    features; another CPU gives another name."""
    path = native.library_path()
    assert native.available() and path.exists()
    assert path.parent == native.BUILD_DIR and path.parent.parent.name == "interpn_tpu_torch"
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-funroll-loops", "-ffp-contract=fast",
                                "-std=c++17", "-shared", "-fPIC", "-pthread")
    monkeypatch.setattr(native, "host_tag", lambda: "another|cpu")
    assert native.library_path() != path
    assert isinstance(native.fastcall_available(), bool)


# --- bitwise against the JAX engine ------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ndims", [1, 2, 3, 4])
@pytest.mark.parametrize("method,kind", EVALUATORS)
def test_evaluators_bitwise_the_jax_engine(method, kind, ndims, dtype):
    for lin in ((True, False) if method == "cubic" else (True,)):
        grid, vals, obs = _case(method, kind, ndims, dtype)
        ours, theirs = np.full(len(obs[0]), np.nan, dtype), np.full(len(obs[0]), np.nan, dtype)
        assert _call(native, method, kind, grid, vals, obs, ours, lin)
        assert _call(jnative, method, kind, grid, vals, obs, theirs, lin)
        np.testing.assert_array_equal(ours, theirs)
        # the same through both packages' raw from numpy (the CPU device here)
        ours_raw, theirs_raw = np.zeros_like(ours), np.zeros_like(ours)
        assert _raw(itt, method, kind, grid, vals, obs, ours_raw, lin) is ours_raw
        _raw(it, method, kind, grid, vals, obs, theirs_raw, lin)
        np.testing.assert_array_equal(ours_raw, ours)
        np.testing.assert_array_equal(theirs_raw, ours)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
@pytest.mark.parametrize("atol", [0.0, 0.5])
def test_bounds_checks_bitwise_the_jax_engine(kind, atol, dtype):
    for ndims in (1, 2, 3, 4):
        grid, _, obs = _case("linear", kind, ndims, dtype, n=50)
        inside = [np.clip(o, o.min() + 3, o.max() - 3) for o in obs]
        for q in (obs, inside):
            ours = np.zeros(ndims, bool)
            theirs = np.zeros(ndims, bool)
            bounds = getattr(native, f"check_bounds_{kind}")
            jbounds = getattr(jnative, f"check_bounds_{kind}")
            if kind == "regular":
                assert bounds(*grid, q, atol, ours, dtype)
                assert jbounds(*grid, q, atol, theirs, dtype)
            else:
                assert bounds(grid[0], q, atol, ours, dtype)
                assert jbounds(grid[0], q, atol, theirs, dtype)
            np.testing.assert_array_equal(ours, theirs)
            via_raw = np.zeros(ndims, bool)
            fn = getattr(raw, f"check_bounds_{kind}_{SUFFIX[dtype]}")
            if kind == "regular":
                fn(list(grid[0]), grid[1], grid[2], q, atol, via_raw)
            else:
                fn(grid[0], q, atol, via_raw)
            np.testing.assert_array_equal(via_raw, ours)


# --- mirrors of tests/test_native.py ----------------------------------------------------


def test_switch_variables(monkeypatch):
    """INTERPN_TPU_NATIVE=0 turns the engine off, =always on for every
    batch on any device; the CPU device takes it for every batch; the
    threshold asks for it below n whatever the device."""
    assert native.use_native(10) and native.use_native(10**9)
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    assert not native.use_native(10)
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "always")
    with config.device("cuda"):
        assert native.use_native(10**9)
    monkeypatch.delenv("INTERPN_TPU_NATIVE")
    with config.device("cuda"):
        assert not native.use_native(10)
        monkeypatch.setenv("INTERPN_TPU_NATIVE_THRESHOLD", "4096")
        assert native.use_native(4095)
        assert not native.use_native(4096)
    assert native.use_native(10**9)  # the CPU device: every batch


def test_disabled_engine_takes_the_plain_path(monkeypatch):
    """With INTERPN_TPU_NATIVE=0 raw from numpy runs the torch tree on the
    CPU, which the engine's calls never see."""
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "linear_regular", lambda *a: pytest.fail("native called"))
    grid, vals, obs = _case("linear", "regular", 2, np.float64)
    out = np.zeros(len(obs[0]))
    _raw(itt, "linear", "regular", grid, vals, obs, out)
    want = itt.ops.linear_regular(tuple(grid[0]), torch.from_numpy(grid[1]),
                                  torch.from_numpy(grid[2]), torch.from_numpy(vals),
                                  tuple(torch.from_numpy(o) for o in obs))
    np.testing.assert_array_equal(out, want.numpy())


def test_unsupported_ndims_falls_back():
    """More axes than the engine takes: False, so the caller's path serves
    (raw refuses >8D with the reference's error first)."""
    out = np.zeros(1)
    assert not native.linear_regular([2] * 9, np.zeros(9), np.ones(9), np.zeros(2**9),
                                     [np.zeros(1)] * 9, out)
    assert not native.nearest_rectilinear([np.arange(2.0)] * 7, np.zeros(2**7),
                                          [np.zeros(1)] * 7, out)


@pytest.mark.parametrize("kind", ["regular", "rectilinear"])
def test_ragged_bounds_queries_take_the_plain_path(kind):
    """Bounds queries of unequal lengths: the engine declines and the torch
    version on the CPU answers, as the JAX package's device path does."""
    obs = [np.array([0.5, 9.0, 1.0]), np.array([0.5])]
    ours, theirs = np.zeros(2, bool), np.zeros(2, bool)
    if kind == "regular":
        args = ([4, 4], np.zeros(2), np.ones(2))
        assert not native.check_bounds_regular(*args, obs, 0.0, ours.copy(), np.float64)
        raw.check_bounds_regular_f64(*args, obs, 0.0, ours)
        it.raw.check_bounds_regular_f64(*args, obs, 0.0, theirs)
    else:
        axes = [np.arange(4.0)] * 2
        assert not native.check_bounds_rectilinear(axes, obs, 0.0, ours.copy(), np.float64)
        raw.check_bounds_rectilinear_f64(axes, obs, 0.0, ours)
        it.raw.check_bounds_rectilinear_f64(axes, obs, 0.0, theirs)
    np.testing.assert_array_equal(ours, theirs)
    assert list(ours) == [True, False]


def test_cubic_extreme_coordinates():
    """Queries whose cell index fits an int64 clamp to the edge cell, as the
    torch tree does; past 2^63, NaN and inf raise the reference's error,
    from the engine and from raw."""
    vals = np.arange(8.0)  # a ramp: cubic reproduces it
    for q in (-3e18, 3e18):
        out = np.zeros(1)
        assert native.cubic_regular([8], np.zeros(1), np.ones(1), vals, True, [np.array([q])],
                                    out)
        plain = itt.ops.cubic_regular((8,), torch.zeros(1, dtype=torch.float64),
                                      torch.ones(1, dtype=torch.float64), torch.from_numpy(vals),
                                      (torch.tensor([q], dtype=torch.float64),), True)
        np.testing.assert_allclose(out, plain.numpy(), rtol=1e-12)
    for q in (-1e300, 1e300, np.nan, np.inf):
        with pytest.raises(AssertionError, match="Unrepresentable coordinate value"):
            native.cubic_regular([8], np.zeros(1), np.ones(1), vals, True, [np.array([q])],
                                 np.zeros(1))
        with pytest.raises(AssertionError, match="Unrepresentable coordinate value"):
            raw.interpn_cubic_regular_f64([8], np.zeros(1), np.ones(1), vals, True,
                                          [np.array([q])], np.zeros(1))


def test_threads_bitwise_one_thread():
    """Threads take contiguous ranges of the queries with the same math:
    bitwise the one-thread result, an uneven split included."""
    rng = np.random.default_rng(31)
    vals = rng.standard_normal(12**3)
    n = 100_003
    obs = [rng.uniform(-1.0, 12.0, n) for _ in range(3)]
    grids = [np.sort(rng.uniform(0, 12, 12)) for _ in range(3)]
    try:
        native.set_threads(1)
        one = np.zeros(n)
        assert native.cubic_regular([12] * 3, np.zeros(3), np.ones(3), vals, True, obs, one)
        one_rect = np.zeros(n)
        assert native.linear_rectilinear(grids, vals, obs, one_rect)
        for threads in (2, 4, 16):
            native.set_threads(threads)
            got = np.full(n, np.nan)
            assert native.cubic_regular([12] * 3, np.zeros(3), np.ones(3), vals, True, obs, got)
            np.testing.assert_array_equal(got, one)
            got = np.full(n, np.nan)
            assert native.linear_rectilinear(grids, vals, obs, got)
            np.testing.assert_array_equal(got, one_rect)
    finally:
        native.set_threads(None)


def test_fastcall_refuses_other_dtypes():
    """Integer queries or `out` are never reinterpreted as floats by the
    prepared call: the class raises the reference's TypeError, float input
    still evaluates."""
    m = itt.MultilinearRegular.new([4], np.zeros(1), np.ones(1), 2.0 * np.arange(4.0))
    with pytest.raises(TypeError):
        m.eval([np.array([1, 3])])
    with pytest.raises(TypeError):
        m.eval([np.array([1.0, 3.0])], np.zeros(2, dtype=np.int64))
    np.testing.assert_array_equal(m.eval([np.array([1.0, 3.0])]), [2.0, 6.0])


# --- the routing rule -------------------------------------------------------------------


def _count_native(monkeypatch):
    calls = []
    real = native.linear_regular
    monkeypatch.setattr(native, "linear_regular", lambda *a: calls.append(1) or real(*a))
    return calls


def test_tensors_keep_their_routes(monkeypatch):
    """CPU tensors, an `out` tensor, or a non-contiguous numpy `out` never
    reach the engine, on the CPU device too."""
    calls = _count_native(monkeypatch)
    grid, vals, obs = _case("linear", "regular", 2, np.float64)
    n = len(obs[0])
    t = [torch.from_numpy(o) for o in obs]
    raw.interpn_linear_regular_f64(grid[0], grid[1], grid[2], vals, t, np.zeros(n))
    plain = torch.zeros(n, dtype=torch.float64)
    raw.interpn_linear_regular_f64(grid[0], grid[1], grid[2], vals, obs, plain)
    strided = np.zeros(2 * n)[::2]
    raw.interpn_linear_regular_f64(grid[0], grid[1], grid[2], vals, obs, strided)
    assert calls == []
    np.testing.assert_array_equal(strided, plain.numpy())
    out = np.zeros(n)
    raw.interpn_linear_regular_f64(grid[0], grid[1], grid[2], vals, obs, out)
    assert calls == [1]
    np.testing.assert_allclose(out, plain.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the route where there is no card")
def test_threshold_asks_for_the_cpu_and_nothing_falls_back(monkeypatch):
    """With the card as the device (the default), a numpy batch leaves the
    card's route only below INTERPN_TPU_NATIVE_THRESHOLD; at or above it
    the card's route serves, and here, with no card, it raises instead of
    falling back to the CPU."""
    grid, vals, obs = _case("linear", "regular", 2, np.float64, n=10)
    with config.device(None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _raw(itt, "linear", "regular", grid, vals, obs, np.zeros(10))
        monkeypatch.setenv("INTERPN_TPU_NATIVE_THRESHOLD", "11")
        out = np.zeros(10)
        _raw(itt, "linear", "regular", grid, vals, obs, out)
        want = np.zeros(10)
        _call(jnative, "linear", "regular", grid, vals, obs, want)
        np.testing.assert_array_equal(out, want)
        monkeypatch.setenv("INTERPN_TPU_NATIVE_THRESHOLD", "10")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _raw(itt, "linear", "regular", grid, vals, obs, np.zeros(10))


# --- the classes' prepared call -----------------------------------------------------------


def _model(method, kind, dtype, lin=True):
    grid, vals, obs = _case(method, kind, 3, dtype, seed=3)
    cls = {"linear": "Multilinear", "cubic": "Multicubic", "nearest": "Nearest"}[method]
    cls = getattr(itt, f"{cls}{kind.capitalize()}")
    extra = {"linearize_extrapolation": lin} if method == "cubic" else {}
    model = cls.new(*((list(grid[0]), grid[1], grid[2]) if kind == "regular" else grid), vals,
                    **extra)
    return model, grid, vals, obs


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("method,kind", EVALUATORS)
def test_class_eval_prepares_once_bitwise_raw(monkeypatch, method, kind, dtype):
    """eval from numpy on the CPU device runs one prepared call, made at
    the first eval and kept, bitwise raw (the engine) and the JAX class."""
    name = f"prepare_{method}_{kind}"
    made = []
    real = getattr(native, name)
    monkeypatch.setattr(native, name, lambda *a: made.append(1) or real(*a))
    model, grid, vals, obs = _model(method, kind, dtype)
    first = model.eval(obs)
    out = np.zeros_like(first)
    assert model.eval(obs, out) is out
    assert made == [1]
    want = np.zeros_like(first)
    _raw(itt, method, kind, grid, vals, obs, want)
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(out, want)
    jmodel = getattr(it, type(model).__name__).model_validate_json(model.model_dump_json())
    np.testing.assert_array_equal(jmodel.eval(obs), want)


def test_copies_drop_the_prepared_call():
    """A copy makes its own prepared call from its own fields: one made
    with update= evaluates its new table, not the old one."""
    model, grid, vals, obs = _model("linear", "regular", np.float64)
    before = model.eval(obs)
    assert model._dev._native
    doubled = model.model_copy(update={"vals": model.vals.model_copy(update={"data": 2 * vals})})
    assert doubled._dev is None
    np.testing.assert_array_equal(doubled.eval(obs), 2 * before)
    assert copy.deepcopy(model)._dev is None and copy.copy(model)._dev is None
    np.testing.assert_array_equal(model.eval(obs), before)


def test_spline_classes_have_no_prepared_call(monkeypatch):
    """The spline methods have no native engine (JAX models/spline.py):
    eval from numpy runs their torch path on the CPU."""
    x = np.linspace(0.0, 3.0, 6)
    vals = np.add.outer(x, x ** 2).ravel()
    model = itt.TensorSplineRegular.new([6, 6], np.zeros(2), np.full(2, x[1]), vals,
                                        method="cubic_spline")
    obs = [np.array([0.3, 1.7]), np.array([2.2, 0.1])]
    np.testing.assert_allclose(model.eval(obs), obs[0] + obs[1] ** 2, atol=1e-12)
    assert model._dev._native is False
