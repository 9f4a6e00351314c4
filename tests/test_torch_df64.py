"""The double-float f64 engine (K8's plain version, `ops/df64.py`) against
the JAX package's `pallas_df64` on the CPU, in interpret mode, and the
INTERPN_TPU_F64 routing.

Tolerances:
* weights: `weights_f64` against `pallas_df64._weights_jit`: locations
  bitwise; the float64 weights within 5e-15 (about 20 ulp) of each axis's
  largest weight magnitude, not bitwise, since XLA:CPU contracts `start + step * loc` and
  the Hermite node's multiply-adds into FMAs where torch rounds each
  operation (the float32 hi parts agree bitwise for over 99% of entries).
* values: rtol = atol = 1e-13 against the JAX engine on flat shapes and
  5e-12 on the shapes the TPU serves with its looped kernel (another order
  of the same double-float steps; `tests/test_pallas_df64.py:124`). Even
  on identical inputs the two are not bitwise equal: interpret mode runs
  the Pallas kernel through XLA:CPU, which contracts the cross terms of the
  double-float steps into FMAs.
* against the port's gather trees: the JAX package's bars, 1e-13 linear and
  1e-12 cubic (`tests/test_pallas_df64.py:55,66`).
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from jax.experimental import pallas as pl

from interpn_tpu.ops import pallas_df64 as jdf
from interpn_tpu_torch import config, convert
from interpn_tpu_torch.ops import bspline, cubic, df64, dispatch, fused, linear

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu_interpret(monkeypatch):
    """Pallas in interpret mode for this test only; numpy inputs on the
    CPU."""
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    with config.device("cpu"):
        yield


def _regular(dims, seed, n=300, depth=2.0):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(dims))
    steps = rng.uniform(0.3, 1.0, len(dims))
    vals = rng.standard_normal(math.prod(dims))
    obs = [rng.uniform(starts[k] - depth * steps[k], starts[k] + steps[k] * (dims[k] - 1 + depth),
                       n) for k in range(len(dims))]
    return starts, steps, vals, obs


def _rect(dims, seed, n=300):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    vals = rng.standard_normal(math.prod(dims))
    obs = [rng.uniform(g[0] - 1, g[-1] + 1, n) for g in grids]
    return grids, vals, obs


def _t(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


REG = [((8, 12), "linear", True, 1e-13),
       ((10, 10, 10), "cubic", True, 1e-13), ((8, 8, 8), "cubic", False, 1e-13),
       ((6,) * 6, "cubic", True, 5e-12)]  # lead 7776 > 2048: the TPU's looped kernel


@pytest.mark.parametrize("dims,method,lin,tol", REG, ids=[f"{m}-{lin}-{len(d)}d"
                                                         for d, m, lin, _ in REG])
def test_plain_matches_jax_regular(dims, method, lin, tol):
    # two cells past each side in 2-3D, as the JAX package's tests; half a
    # cell from 4D up, where the extrapolated stencil terms grow as |t|^3 per
    # axis and carry the double-float error with them
    starts, steps, vals, obs = _regular(dims, seed=len(dims), depth=2.0 if len(dims) <= 3 else 0.5)
    if math.prod(dims[:-1]) > jdf._MAX_UNROLL_LEAD:
        assert tol == 5e-12
    want = np.asarray(jdf.eval_regular(dims, *_j((starts, steps, vals)), _j(obs), method, lin))
    before = dict(fused.launches)
    got = df64.eval_regular(dims, *_t((starts, steps, vals)), _t(obs), method, lin).numpy()
    assert fused.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    args = (dims, *_t((starts, steps, vals)), _t(obs))
    gather = (linear.linear_regular(*args) if method == "linear"
              else cubic.cubic_regular(*args, lin)).numpy()
    bar = 1e-13 if method == "linear" else 1e-12
    np.testing.assert_allclose(got, gather, rtol=bar * (tol / 1e-13), atol=bar * (tol / 1e-13))


@pytest.mark.parametrize("method,lin", [("linear", True), ("cubic", True), ("cubic", False)])
def test_plain_matches_jax_rectilinear(method, lin):
    dims = (9, 8, 10)
    grids, vals, obs = _rect(dims, seed=7)
    want = np.asarray(jdf.eval_rectilinear(_j(grids), jnp.asarray(vals), _j(obs), method, lin))
    got = df64.eval_rectilinear(_t(grids), torch.from_numpy(vals), _t(obs), method, lin).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    gather = (linear.linear_rectilinear(_t(grids), torch.from_numpy(vals), _t(obs))
              if method == "linear" else
              cubic.cubic_rectilinear(_t(grids), torch.from_numpy(vals), _t(obs), lin)).numpy()
    bar = 1e-13 if method == "linear" else 1e-12
    np.testing.assert_allclose(got, gather, rtol=bar, atol=bar)


@pytest.mark.parametrize("k,dims", [(3, (9, 8, 7)), (5, (8, 9))], ids=str)
def test_plain_matches_jax_bspline(k, dims):
    rng = np.random.default_rng(k + len(dims))
    axes = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    knots, coeffs = bspline.prep_bspline(axes, rng.standard_normal(math.prod(dims)), k)
    obs = [rng.uniform(a[0], a[-1], 300) for a in axes]
    want = np.asarray(jdf.eval_bspline(_j(knots), jnp.asarray(coeffs), _j(obs), k))
    kt, ct = convert.bspline_from_numpy(knots, coeffs, device=CPU, dtype=torch.float64)
    got = df64.eval_bspline(kt, ct, _t(obs), k).numpy()
    # the JAX package's bar for its spline engine: 1e-13 of the largest
    # coefficient inside the grid (tests/test_bspline_engines.py:63)
    cs = max(float(np.abs(coeffs).max()), 1.0)
    assert np.abs(got - want).max() <= 1e-13 * cs
    gather = bspline.bspline_gather(kt, ct, _t(obs), k).numpy()
    assert np.abs(got - gather).max() <= 1e-13 * cs


@pytest.mark.parametrize("kind,method,lin", [("regular", "linear", True),
                                             ("regular", "cubic", False),
                                             ("rectilinear", "linear", True),
                                             ("rectilinear", "cubic", True)])
def test_weights_match_jax(kind, method, lin):
    dims = (9, 8, 10)
    n = 300
    if kind == "regular":
        starts, steps, _, obs = _regular(dims, seed=11)
        want = jdf._weights_jit(dims, method, lin, n, *_j((starts, steps)), (), _j(obs))
        got = df64.weights_f64(dims, *_t((starts, steps)), None, _t(obs), method, lin)
    else:
        grids, _, obs = _rect(dims, seed=11)
        want = jdf._weights_jit(dims, method, lin, n, jnp.zeros(3), jnp.ones(3), _j(grids),
                                _j(obs))
        got = df64.weights_f64(dims, None, None, _t(grids), _t(obs), method, lin)
    locs, wh, wl, wsum = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), locs[:, :n])
    # hi parts bitwise where the float64 weights round alike; the float64
    # weights within 5e-15 of each axis's largest weight magnitude (XLA:CPU
    # contracts `start + step * loc` and the Hermite terms into FMAs)
    assert np.mean(got[1].numpy() == wh[:, :n]) > 0.99
    w64 = (wh.astype(np.float64) + wl)[:, :n]
    got64 = got[1].numpy().astype(np.float64) + got[2].numpy()
    fp = df64.FOOTPRINT[method]
    scale = np.repeat(np.abs(w64).reshape(3, fp, n).max(axis=1), fp, axis=0)
    assert np.all(np.abs(got64 - w64) <= 5e-15 * np.maximum(scale, 1.0))
    axis_scale = np.maximum(np.abs(w64).reshape(3, fp, n).max(axis=1), 1.0).sum(axis=0)
    assert np.all(np.abs(got[3].numpy() - wsum[:n]) <= 5e-15 * axis_scale)


CONTRACT = [((8, 12), "linear", 1e-13), ((10, 10, 10), "cubic", 1e-13), ((8, 9, 7), 5, 1e-13),
            ((6,) * 6, "cubic", 5e-12)]


@pytest.mark.parametrize("dims,method,tol", CONTRACT, ids=str)
def test_plain_contraction_matches_pallas_k8(dims, method, tol):
    """`plain_df64` and `_pallas_df64` on the same locs, weights and split
    table (queries up to one cell past each side, inside the grid for the
    spline, held at the spline bar as `test_plain_matches_jax_bspline`): the
    contraction alone."""
    fp = df64.FOOTPRINT[method]
    starts, steps, vals, obs = _regular(dims, seed=fp, n=256, depth=0.0 if method == 5 else 1.0)
    if method == 5:
        knots, vals = bspline.prep_bspline(
            [starts[k] + steps[k] * np.arange(d) for k, d in enumerate(dims)], vals, 5)
        locs, wh, wl, _ = df64.spline_weights_f64(_t(knots), _t(obs), 5)
        dims = tuple(len(t) - 6 for t in knots)
    else:
        locs, wh, wl, _ = df64.weights_f64(dims, *_t((starts, steps)), None, _t(obs), method)
    vh, vl, _ = df64.table_split(vals)
    oh, ol = df64.plain_df64(dims, fp, locs, wh, wl, vh, vl)
    n = 256
    pad = (-n) % jdf._tq_for(dims)
    padded = [jnp.pad(jnp.asarray(a.numpy()), ((0, 0), (0, pad))) for a in (locs, wh, wl)]
    lead = math.prod(dims[:-1])
    jh, jl = jdf._pallas_df64(dims, fp, *padded, jnp.asarray(vh.numpy()).reshape(lead, -1),
                              jnp.asarray(vl.numpy()).reshape(lead, -1))
    want = np.asarray(jh)[0, :n].astype(np.float64) + np.asarray(jl)[0, :n]
    got = oh.double().numpy() + ol.numpy()
    scale = max(float(np.abs(vals).max()), 1.0) if method == 5 else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_split_and_primitives_match_jax():
    """`split_f64` and the double-float primitives, op for op."""
    rng = np.random.default_rng(2)
    a64 = rng.standard_normal(500) * 10.0 ** rng.integers(-6, 6, 500)
    hi, lo = df64.split_f64(torch.from_numpy(a64))
    jhi, jlo = jdf._split_f64(jnp.asarray(a64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    x = [rng.standard_normal(500).astype(np.float32) for _ in range(6)]
    for name, nargs in (("_two_sum", 2), ("_two_prod", 2), ("_df_norm", 2), ("_df_add", 4),
                        ("_df_mul", 4), ("_df_madd", 6)):
        got = getattr(df64, name)(*(torch.from_numpy(v) for v in x[:nargs]))
        want = getattr(jdf, name)(*(jnp.asarray(v) for v in x[:nargs]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_table_split_cached_by_content_and_version():
    v = np.random.default_rng(3).standard_normal(400)
    a = df64.table_split(v)
    assert df64.table_split(v.copy()) is a
    v2 = v.copy()
    v2[7] = np.inf
    assert df64.table_split(v2)[2] is False
    t = torch.from_numpy(v.copy())
    b = df64.table_split(t)
    assert df64.table_split(t.reshape(-1)) is b  # a fresh view of one table
    t[3] += 1.0  # an in-place update bumps the version
    c = df64.table_split(t)
    assert c is not b
    np.testing.assert_allclose(c[0].double().numpy() + c[1].numpy(), t.numpy(),
                               rtol=1e-14, atol=0)


# --- routing --------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Every kernel wrapper patched to count and run its plain version, and
    CPU tensors taken for CUDA ones: which kernel a call reaches."""
    calls = []

    def wrap(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    from interpn_tpu_torch.ops import i8

    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    monkeypatch.setattr(df64, "contract", wrap("df64", df64.plain_df64))
    monkeypatch.setattr(i8, "contract", wrap("i8", i8.plain_i8))
    for name in ("eval_regular", "eval_rectilinear", "eval_bspline"):
        monkeypatch.setattr(fused, name, wrap(name, getattr(fused, name)))
    return calls


def _route_calls(dtype=torch.float64, finite=True):
    starts, steps, vals, obs = _regular((6, 5, 7), seed=1, n=64)
    grids, _, robs = _rect((6, 5, 7), seed=1, n=64)
    if not finite:
        vals[3] = np.nan
    st, sp, v = (torch.from_numpy(a).to(dtype) for a in (starts, steps, vals))
    ob = tuple(torch.from_numpy(o).to(dtype) for o in obs)
    g = tuple(torch.from_numpy(a).to(dtype) for a in grids)
    rob = tuple(torch.from_numpy(o).to(dtype) for o in robs)
    knots, coeffs = bspline.prep_bspline(grids, np.ones(210), 3)
    if not finite:
        coeffs[3] = np.inf
    kt, ct = convert.bspline_from_numpy(knots, coeffs, device=CPU, dtype=dtype)
    return {
        "linear_regular": lambda: dispatch.linear_regular((6, 5, 7), st, sp, v, ob),
        "cubic_regular": lambda: dispatch.cubic_regular((6, 5, 7), st, sp, v, ob, False),
        "nearest_regular": lambda: dispatch.nearest_regular((6, 5, 7), st, sp, v, ob),
        "linear_rectilinear": lambda: dispatch.linear_rectilinear(g, v, rob),
        "cubic_rectilinear": lambda: dispatch.cubic_rectilinear(g, v, rob, True),
        "bspline": lambda: dispatch.bspline_eval(kt, ct, rob, 3),
    }


NATIVE = {"linear_regular": "eval_regular", "cubic_regular": "eval_regular",
          "nearest_regular": "eval_regular", "linear_rectilinear": "eval_rectilinear",
          "cubic_rectilinear": "eval_rectilinear", "bspline": "eval_bspline"}


@pytest.mark.parametrize("mode", [None, "auto", "gather", "DF64"])
def test_unforced_modes_keep_the_native_kernels(counted, monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("INTERPN_TPU_F64", raising=False)
    else:
        monkeypatch.setenv("INTERPN_TPU_F64", mode)
    assert dispatch.f64_engine() == "auto"
    for name, call in _route_calls().items():
        counted.clear()
        call()
        assert counted == [NATIVE[name]], name


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_forced_engines_route(counted, monkeypatch, engine):
    monkeypatch.setenv("INTERPN_TPU_F64", engine)
    for name, call in _route_calls().items():
        counted.clear()
        out = call()
        if name == "nearest_regular":
            want = [NATIVE[name]]
        elif name == "bspline" or engine == "df64":
            want = ["df64"]
        else:
            want = ["i8"]
        assert counted == want, name
        assert out.dtype == torch.float64 and out.shape == (64,)
    for dtype, finite in ((torch.float32, True), (torch.float64, False)):
        for name, call in _route_calls(dtype, finite).items():
            counted.clear()
            call()
            assert counted == [NATIVE[name]], (name, dtype, finite)


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_forced_engines_leave_cpu_tensors_on_the_gather_tree(monkeypatch, engine):
    from interpn_tpu_torch.ops import i8

    monkeypatch.setenv("INTERPN_TPU_F64", engine)
    monkeypatch.setattr(df64, "contract", lambda *a: pytest.fail("K8 on a CPU tensor"))
    monkeypatch.setattr(i8, "contract", lambda *a: pytest.fail("K9 on a CPU tensor"))
    for name, call in _route_calls().items():
        torch.testing.assert_close(call(), _route_calls()[name](), rtol=0, atol=0)


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_forced_engines_cache_numpy_tables_by_content(counted, monkeypatch, engine):
    """raw and interpn() make a fresh tensor of a numpy table on every
    call; the engine's cache keys it by content, so the table is split or
    decomposed once and no copy of it is kept."""
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")  # the engines' route from numpy
    from interpn_tpu_torch import interpn, raw
    from interpn_tpu_torch.ops import i8

    monkeypatch.setenv("INTERPN_TPU_F64", engine)
    preps = []
    route = dispatch.f64_route
    monkeypatch.setattr(dispatch, "f64_route", lambda *a: preps.append(route(*a)) or preps[-1])
    for cache in (df64._SPLITS, i8._PREPS):
        monkeypatch.setattr(cache, "entries", {})
    starts, steps, vals, obs = _regular((6, 5, 7), seed=7, n=64)
    grids = [starts[k] + steps[k] * np.arange(d) for k, d in enumerate((6, 5, 7))]
    for _ in range(2):
        raw.interpn_cubic_regular_f64(np.array([6, 5, 7]), starts, steps, vals.copy(), True,
                                      obs, np.zeros(64))
        interpn(obs, grids, vals.copy(), method="cubic_spline")
    assert counted == [engine, "df64"] * 2
    assert [p[0] for p in preps] == [engine, "df64"] * 2
    if engine == "i8":
        assert preps[2][1]["prep"] is preps[0][1]["prep"]
    # one preparation a table, kept across the calls: the table's split
    # (df64) or decomposition (i8), and the spline coefficients' split
    assert len(df64._SPLITS.entries) == (2 if engine == "df64" else 1)
    assert len(i8._PREPS.entries) == (engine == "i8")
    for cache in (df64._SPLITS, i8._PREPS):
        assert all(e[0] is None for k, e in cache.entries.items() if k[0] == "h")


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_forced_engine_grads_are_the_gather_trees(counted, monkeypatch, engine):
    """Under a forced engine the backward is the gather tree's VJP, as on
    every kernel route."""
    monkeypatch.setenv("INTERPN_TPU_F64", engine)
    starts, steps, vals, obs = _regular((6, 5, 7), seed=4, n=64)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (starts, steps, vals, *obs)]
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(64))
    out = dispatch.cubic_regular((6, 5, 7), *leaves[:3], leaves[3:], True)
    assert counted[-1] == ("df64" if engine == "df64" else "i8")
    out.backward(cot)
    cubic.cubic_regular((6, 5, 7), *ref[:3], ref[3:], True).backward(cot)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-13, atol=1e-13)


ENTRY_CASES = [("regular", (8, 12), "linear", 1e-13), ("regular", (10, 10, 10), "cubic", 1e-13),
               ("rectilinear", (9, 8, 10), "cubic", 1e-13), ("regular", (6,) * 6, "cubic", 5e-12),
               ("bspline", (9, 8, 10), 3, 1e-13)]


@pytest.mark.parametrize("kind,dims,method,tol", ENTRY_CASES, ids=str)
def test_entries_on_cpu_run_the_plain_chain(kind, dims, method, tol):
    """K8's entries (`eval_regular`, `eval_rectilinear`, `eval_bspline`) on
    CPU tensors are the plain chain bit for bit, launch nothing, and hold
    the JAX engine's bar (the spline's scaled by its largest coefficient,
    queries inside the grid, as `test_plain_matches_jax_bspline`)."""
    rng = np.random.default_rng(sum(dims))
    vals = rng.standard_normal(math.prod(dims))
    before = dict(fused.launches)
    scale = 1.0
    if kind == "regular":
        starts, steps, vals, obs = _regular(dims, seed=sum(dims), n=120, depth=1.0)
        args = (dims, *_t((starts, steps, vals)), _t(obs), method, True)
        got, plain = df64.eval_regular(*args), df64.plain_regular(*args)
        want = jdf.eval_regular(dims, *_j((starts, steps, vals)), _j(obs), method, True)
    elif kind == "rectilinear":
        grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
        obs = [rng.uniform(g[0], g[-1], 120) for g in grids]
        args = (_t(grids), torch.from_numpy(vals), _t(obs), method, True)
        got, plain = df64.eval_rectilinear(*args), df64.plain_rectilinear(*args)
        want = jdf.eval_rectilinear(_j(grids), jnp.asarray(vals), _j(obs), method)
    else:
        grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
        knots, coeffs = bspline.prep_bspline(grids, vals, method)
        obs = [rng.uniform(g[0], g[-1], 120) for g in grids]
        args = (_t(knots), torch.from_numpy(coeffs), _t(obs), method)
        got, plain = df64.eval_bspline(*args), df64.plain_bspline(*args)
        want = jdf.eval_bspline(_j(knots), jnp.asarray(coeffs), _j(obs), method)
        scale = max(float(np.abs(coeffs).max()), 1.0)
    assert fused.launches == before
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol * scale)
