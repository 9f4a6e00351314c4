"""The port's factorized products (`interpn_tpu_torch.ops.factorized`) and
INTERPN_TPU_IMPL on the CPU.

The factorized functions against the JAX package's on the same seeded numpy
inputs, directly and through each package's dispatch under
INTERPN_TPU_IMPL=factorized, at `tests/test_factorized.py`'s own tolerances
(rtol = atol 1e-12, cubic 1e-11, nearest exact), and against the port's
gather tree likewise; the chunked query loop; the IEEE float32 guard. Then
the routing of INTERPN_TPU_IMPL=gather|factorized|pallas for one table,
stacks and B-splines, with the device's choice taken as the card's
(`dispatch._on_card`), and a serving export under each: plain torch
operations and no custom op under gather and factorized.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (x64)
import jax.numpy as jnp
from interpn_tpu.ops import dispatch as jdispatch
from interpn_tpu.ops import factorized as jfz

import interpn_tpu_torch as itt
from interpn_tpu_torch import aot, config, ops
from interpn_tpu_torch.ops import cubic, dispatch, fused, library, linear, nearest
from interpn_tpu_torch.ops import factorized as fz

TOL = {"linear": dict(rtol=1e-12, atol=1e-12), "cubic": dict(rtol=1e-11, atol=1e-11),
       "nearest": dict(rtol=0, atol=0)}
KERNEL_OPS = {library.overload(n) for n in library.NAMES}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv(dispatch.IMPL_ENV, raising=False)
    monkeypatch.delenv(dispatch.F64_ENV, raising=False)
    with config.device("cpu"):
        yield


def _case(ndims, min_pts, seed, n=300):
    """`tests/test_factorized.py::_case`: numpy (dims, starts, steps, grids,
    vals, obs, rectilinear obs)."""
    rng = np.random.default_rng(seed)
    dims = tuple(int(rng.integers(min_pts, min_pts + 3)) for _ in range(ndims))
    starts = rng.uniform(-2, 2, ndims)
    steps = rng.uniform(0.3, 1.5, ndims)
    grids = tuple(np.cumsum(0.2 + rng.random(d)) + rng.uniform(-3, 3) for d in dims)
    vals = rng.standard_normal(int(np.prod(dims)))
    obs = tuple(rng.uniform(starts[k] - 3, starts[k] + steps[k] * (dims[k] + 3), n)
                for k in range(ndims))
    obs_r = tuple(rng.uniform(g[0] - 2, g[-1] + 2, n) for g in grids)
    return dims, starts, steps, grids, vals, obs, obs_r


def _t(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _args(kind, method, case, pkg):
    """The arguments of `<method>_<kind>_factorized` (before cubic's
    `linearize`) as `pkg` ("torch" or "jax") takes them."""
    dims, starts, steps, grids, vals, obs, obs_r = case
    conv = _t if pkg == "torch" else _j
    v = conv([vals])[0]
    if kind == "regular":
        st, sp = conv([starts, steps])
        args = (dims, st, sp, v, conv(obs))
    else:
        args = (conv(grids), v, conv(obs_r))
    return args


FAMILIES = [(k, m) for k in ("regular", "rectilinear") for m in ("linear", "cubic", "nearest")]


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("kind,method", FAMILIES)
def test_factorized_matches_jax_factorized(kind, method, ndims):
    case = _case(ndims, 4 if method == "cubic" else 2, 42 + ndims + 10 * len(method))
    for lin in ((True, False) if method == "cubic" else ((),)):
        extra = (lin,) if method == "cubic" else ()
        name = f"{method}_{kind}_factorized"
        got = getattr(fz, name)(*_args(kind, method, case, "torch"), *extra)
        want = getattr(jfz, name)(*_args(kind, method, case, "jax"), *extra)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[method])


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("kind,method", FAMILIES)
def test_dispatch_under_factorized_matches_jax(monkeypatch, kind, method, ndims):
    """`ops.<method>_<kind>` under INTERPN_TPU_IMPL=factorized is the
    factorized function, and matches the JAX dispatch under the same
    setting; f32 too, at the f32 bars against the f64 result."""
    monkeypatch.setenv(dispatch.IMPL_ENV, "factorized")
    case = _case(ndims, 4 if method == "cubic" else 2, 7 + ndims)
    extra = (False,) if method == "cubic" else ()
    targs = _args(kind, method, case, "torch")
    got = getattr(ops, f"{method}_{kind}")(*targs, *extra)
    jargs = _args(kind, method, case, "jax")
    want = getattr(jdispatch, f"{method}_{kind}")(*jargs, *extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[method])
    np.testing.assert_array_equal(
        got.numpy(), getattr(fz, f"{method}_{kind}_factorized")(*targs, *extra).numpy())
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in targs]
    f32 = [tuple(x.float() for x in a) if isinstance(a, tuple) and isinstance(a[0], torch.Tensor)
           else a for a in f32]
    got32 = getattr(ops, f"{method}_{kind}")(*f32, *extra)
    assert got32.dtype == torch.float32
    if method != "nearest":  # a float32 locate may pick the other node at a midpoint
        np.testing.assert_allclose(got32.double().numpy(), got.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("kind,method", FAMILIES)
def test_factorized_matches_the_gather_tree(kind, method, ndims):
    case = _case(ndims, 4 if method == "cubic" else 2, 62 + ndims)
    targs = _args(kind, method, case, "torch")
    gather = {"linear": linear, "cubic": cubic, "nearest": nearest}[method]
    for lin in ((True, False) if method == "cubic" else ((),)):
        extra = (lin,) if method == "cubic" else ()
        got = getattr(fz, f"{method}_{kind}_factorized")(*targs, *extra)
        want = getattr(gather, f"{method}_{kind}")(*targs, *extra)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[method])


def test_high_dim_cubic_matches_jax():
    """5D cubic, and the leading axes joined into one product (20 x 20 x
    5 x 5: two axes joined)."""
    rng = np.random.default_rng(9)
    for dims in ((4,) * 5, (20, 20, 5, 5)):
        nd = len(dims)
        starts, steps = rng.uniform(-1, 1, nd), rng.uniform(0.5, 1.5, nd)
        vals = rng.standard_normal(int(np.prod(dims)))
        obs = tuple(rng.uniform(-1, 7, 50) for _ in range(nd))
        got = fz.cubic_regular_factorized(dims, *_t([starts, steps, vals]), _t(obs), True)
        want = jfz.cubic_regular_factorized(dims, *_j([starts, steps, vals]), _j(obs), True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["cubic"])
    assert fz._split_point((20, 20, 5, 5)) == jfz._split_point((20, 20, 5, 5)) == 2
    for dims in ((64,) * 3, (20,) * 4, (4,) * 8, (100, 100), (5,)):
        assert fz._split_point(dims) == jfz._split_point(dims)
        assert fz._max_row_width(dims) == jfz._max_row_width(dims)


def test_chunked_query_loop(monkeypatch):
    """Tiny chunks (the floor, 8192 queries) over a count that does not
    divide: the same result as one chunk, and the JAX package's."""
    rng = np.random.default_rng(3)
    dims = (5, 5)
    vals = rng.standard_normal(25)
    n = 8192 * 2 + 1234
    obs = tuple(rng.uniform(-1, 6, n) for _ in range(2))
    whole = fz.linear_regular_factorized(dims, torch.zeros(2, dtype=torch.float64),
                                         torch.ones(2, dtype=torch.float64),
                                         torch.from_numpy(vals), _t(obs))
    monkeypatch.setattr(fz, "_CHUNK_BYTES", 1)
    chunked = fz.linear_regular_factorized(dims, torch.zeros(2, dtype=torch.float64),
                                           torch.ones(2, dtype=torch.float64),
                                           torch.from_numpy(vals), _t(obs))
    assert chunked.shape == (n,)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    want = jfz.linear_regular_factorized(dims, jnp.zeros(2), jnp.ones(2), jnp.asarray(vals),
                                         _j(obs))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL["linear"])


def test_shaped_queries_keep_their_shape():
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.standard_normal(25))
    obs = _t(rng.uniform(-1, 6, (7, 13)) for _ in range(2))
    st, sp = torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    out = fz.linear_regular_factorized((5, 5), st, sp, vals, obs)
    flat = fz.linear_regular_factorized((5, 5), st, sp, vals, tuple(o.reshape(-1) for o in obs))
    assert out.shape == (7, 13)
    np.testing.assert_array_equal(out.reshape(-1).numpy(), flat.numpy())


def test_refuses_tf32(monkeypatch):
    """float32 products stay IEEE: with TF32 allowed the factorized call
    raises rather than round to TF32 on the card."""
    vals = torch.ones(16, dtype=torch.float32)
    obs = (torch.zeros(4), torch.zeros(4))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        fz.linear_regular_factorized((4, 4), torch.zeros(2), torch.ones(2), vals, obs)


def test_nonfinite_entry_poisons_every_result():
    """The documented caveat: one inf in the table makes every factorized
    result NaN or inf, where the gather tree reads only the stencil."""
    vals = torch.arange(64.0, dtype=torch.float64)
    vals[63] = torch.inf
    st, sp = torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64)
    obs = (torch.full((5,), 0.5, dtype=torch.float64),) * 3
    assert not torch.isfinite(fz.linear_regular_factorized((4,) * 3, st, sp, vals, obs)).any()
    assert torch.isfinite(linear.linear_regular((4,) * 3, st, sp, vals, obs)).all()


# --- INTERPN_TPU_IMPL ---------------------------------------------------------------------


class _Card:
    """A stand-in with a CUDA device, for `_impl`."""

    device = torch.device("cuda")


@pytest.mark.parametrize("mode,want", [(None, "kernel"), ("auto", "kernel"),
                                       ("pallas", "kernel"), ("gather", "gather"),
                                       ("factorized", "gather"), ("bogus", "kernel")])
def test_impl_reads_the_variable_at_each_call(monkeypatch, mode, want):
    if mode is not None:
        monkeypatch.setenv(dispatch.IMPL_ENV, mode)
    assert dispatch.impl_mode() == (mode if mode in ("gather", "factorized") else "auto")
    assert dispatch._impl(_Card()) == want
    assert dispatch._impl(torch.zeros(1)) == "gather"


def _spy(monkeypatch):
    """Record the kernel ops, the gather trees, the factorized functions and
    the regular stack's per-channel gather tree that a call runs."""
    seen = []

    def spy(real, tag):
        return lambda *a: seen.append(tag) or real(*a)

    for name in library.NAMES:
        monkeypatch.setattr(library, name, spy(getattr(library, name), f"op:{name}"))
    for table in (dispatch._REGULAR_GATHER, dispatch._RECT_GATHER,
                  dispatch._FACTORIZED_REGULAR, dispatch._FACTORIZED_RECT):
        tag = "factorized" if table in (dispatch._FACTORIZED_REGULAR,
                                        dispatch._FACTORIZED_RECT) else "gather"
        for method, real in list(table.items()):
            monkeypatch.setitem(table, method, spy(real, tag))
    monkeypatch.setattr(fused, "plain_regular_stack",
                        spy(fused.plain_regular_stack, "gather_stack"))
    dispatch.kernel_route.cache_clear()
    return seen


@pytest.mark.parametrize("mode", [None, "pallas", "gather", "factorized"])
def test_routes_on_the_card(monkeypatch, mode):
    """With the device's choice the card's: unset or pallas, one table,
    stacks and splines take their kernel op; gather, every family its
    gather tree; factorized, one table its factorized products and stacks
    and splines their gather trees. The results agree at the bars."""
    monkeypatch.setattr(dispatch, "_on_card", lambda vals: True)
    if mode is not None:
        monkeypatch.setenv(dispatch.IMPL_ENV, mode)
    seen = _spy(monkeypatch)
    try:
        dims, starts, steps, grids, vals, obs, obs_r = _case(3, 4, 5)
        st, sp, v = _t([starts, steps, vals])
        ob = _t(obs)
        ref = cubic.cubic_regular(dims, st, sp, v, ob, True)
        for method in ("linear", "cubic", "nearest"):
            lin = (True,) if method == "cubic" else ()
            seen.clear()
            got = getattr(ops, f"{method}_regular")(dims, st, sp, v, ob, *lin)
            want = {None: ["op:regular"], "pallas": ["op:regular"], "gather": ["gather"],
                    "factorized": ["factorized"]}[mode]
            assert seen == want, (method, seen)
            if method == "cubic":
                np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL["cubic"])
            seen.clear()
            getattr(ops, f"{method}_rectilinear")(_t(grids), v, _t(obs_r), *lin)
            assert seen == [w.replace("regular", "rectilinear") for w in want], seen
        stack = torch.stack([v, 2 * v])
        seen.clear()
        got = ops.linear_regular_stack(dims, st, sp, stack, ob)
        # the kernel op runs its plain version on these CPU tensors
        assert seen == (["op:regular_stack", "gather_stack"] if mode in (None, "pallas")
                        else ["gather_stack"]), seen
        np.testing.assert_allclose(got[1].numpy(), 2 * got[0].numpy(), rtol=1e-13, atol=1e-13)
        knots, coeffs = ops.prep_bspline([np.arange(d, dtype=np.float64) for d in dims],
                                         vals, 3)
        kt, ct = itt.convert.bspline_from_numpy(knots, coeffs, device="cpu",
                                                dtype=torch.float64)
        seen.clear()
        ops.bspline_eval(kt, ct, ob, 3)
        assert seen == (["op:bspline"] if mode in (None, "pallas") else []), seen
    finally:
        dispatch.kernel_route.cache_clear()


@pytest.mark.parametrize("mode,op", [(None, True), ("gather", False), ("factorized", False)])
def test_export_under_each_mode(monkeypatch, mode, op):
    """A serving export on the card's route holds the kernel op under the
    default; under gather or factorized plain torch operations and no
    custom op, and serves bitwise the model's eval_torch."""
    monkeypatch.setattr(dispatch, "_on_card", lambda vals: True)
    if mode is not None:
        monkeypatch.setenv(dispatch.IMPL_ENV, mode)
    x = np.linspace(0.0, 2.0, 6)
    vals = np.add.outer(np.cos(x), x * x).ravel()
    model = itt.MulticubicRegular.new([6, 6], np.zeros(2), np.full(2, x[1]), vals)
    blob = aot.export_eval(model, 16)
    import io

    _, off = aot._read(blob, len(aot._MAGIC))
    program = torch.export.load(io.BytesIO(aot._read(blob, off)[0]))
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert any(t in KERNEL_OPS for t in targets) == op, targets
    obs = [np.linspace(-0.5, 2.5, 11)] * 2
    np.testing.assert_array_equal(aot.load(blob).eval_torch(obs).numpy(),
                                  model.eval_torch(obs).numpy())
