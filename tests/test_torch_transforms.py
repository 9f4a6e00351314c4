"""`torch.func` over the port's kernel routes, against JAX's transforms.

`ops.dispatch.KernelRoute` runs a route's kernel wrapper forward (on a CPU
tensor its plain version stands in for the kernel, and the stack plain
version for the stack kernel) and the gather tree's derivatives. Here it
is driven directly on CPU tensors, as `ops.dispatch` builds it for a CUDA
tensor (`kernel_route`), under `grad`, `vjp`, `jvp`, `jacrev`, `jacfwd` and
`vmap` (table batched, queries batched, both, grid batched), on linear,
cubic and nearest on both grid kinds and the B-splines of degree 3 and 5,
f32 and f64, against `jax.vjp` / `jax.jvp` / `jax.jacrev` / `jax.vmap` of
the JAX package's `ops` on the same inputs: f64 rtol=atol=1e-12, f32
rtol 1e-5 and atol 1e-5 times the result's largest magnitude.
Spies on the route's callables show that a batched table takes one stack
call, batched queries one kernel call, and that the gather tree never runs
forward under vmap. The last tests mirror `tests/test_transforms.py`.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax
import jax.numpy as jnp
from interpn_tpu import ops as jops

from interpn_tpu_torch import config
from interpn_tpu_torch.ops import bspline as tbspline
from interpn_tpu_torch.ops import df64 as tdf64
from interpn_tpu_torch.ops import dispatch

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}
DIMS = (6, 7, 6)
N = 40
B = 3
CASES = ["regular-linear", "regular-cubic", "regular-nearest", "rectilinear-linear",
         "rectilinear-cubic", "rectilinear-nearest", "bspline-3", "bspline-5"]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _case(case, dtype, n=N, seed=0):
    """(route, jax function, numpy inputs (*params, vals, *obs)), the
    inputs in `dtype`."""
    family, method = case.split("-")
    rng = np.random.default_rng(seed + CASES.index(case))
    nd = len(DIMS)
    if family == "regular":
        starts = rng.uniform(-1, 1, nd)
        steps = rng.uniform(0.3, 1.0, nd)
        params = [starts, steps]
        lo, hi = starts - steps, starts + steps * np.array(DIMS)
    else:
        grids = [np.cumsum(0.2 + rng.random(d)) for d in DIMS]
        lo = np.array([g[0] - 0.5 for g in grids])
        hi = np.array([g[-1] + 0.5 for g in grids])
    vals = rng.standard_normal(math.prod(DIMS))
    lin = (method == "cubic" and family == "rectilinear",) if method == "cubic" else ()
    if family == "bspline":
        k = int(method)
        params, vals = tbspline.prep_bspline(grids, vals, k)
        route = dispatch.kernel_route("bspline", k, nd)

        def jfn(*a):
            return jops.bspline_eval(a[:nd], a[nd], a[nd + 1:], k)
    elif family == "regular":
        route = dispatch.kernel_route("regular", method, DIMS, *lin)
        jop = getattr(jops, f"{method}_regular")

        def jfn(st, sp, v, *ob):
            return jop(DIMS, st, sp, v, ob, *lin)
    else:
        params = grids
        route = dispatch.kernel_route("rectilinear", method, nd, *lin)
        jop = getattr(jops, f"{method}_rectilinear")

        def jfn(*a):
            return jop(a[:nd], a[nd], a[nd + 1:], *lin)
    obs = [rng.uniform(lo[i], hi[i], n) for i in range(nd)]
    arrays = [np.asarray(a, dtype=dtype) for a in (*params, vals, *obs)]
    return route, jfn, arrays


def _apply(route):
    return lambda *a: dispatch.KernelRoute.apply(route, *a)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, dtype, what):
    """Within the dtype's bar; f32's atol is taken relative to the largest
    magnitude of the result (float32 keeps about 7 digits of its largest
    term, and the quintic's derivatives on a standard normal table reach
    1e3)."""
    want = np.asarray(want)
    tol = dict(TOL[dtype])
    if dtype == np.float32 and want.size:
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, err_msg=what, **tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vjp_and_grad_match_jax(case, dtype):
    route, jfn, arrays = _case(case, dtype)
    cot = np.random.default_rng(1).standard_normal(N).astype(dtype)
    out, vjp_fn = torch.func.vjp(_apply(route), *_t(arrays))
    jout, jvjp = jax.vjp(jfn, *_j(arrays))
    _close(out, jout, dtype, "forward")
    for i, (g, w) in enumerate(zip(vjp_fn(torch.from_numpy(cot)), jvjp(jnp.asarray(cot)))):
        _close(g, w, dtype, f"vjp input {i}")
    # grad into the table and the queries at once
    nv = len(arrays) - len(DIMS) - 1
    t = _t(arrays)

    def loss(v, *ob):
        return _apply(route)(*t[:nv], v, *ob).square().sum()

    grads = torch.func.grad(loss, argnums=tuple(range(1 + len(DIMS))))(t[nv], *t[nv + 1:])
    # JAX's gradient of the sum of squares: its VJP of 2 * the result
    want = jvjp(2 * jout)[nv:]
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, w, dtype, f"grad argument {i}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jvp_matches_jax(case, dtype):
    route, jfn, arrays = _case(case, dtype)
    rng = np.random.default_rng(2)
    tangents = [rng.standard_normal(a.shape).astype(dtype) for a in arrays]
    out, tan = torch.func.jvp(_apply(route), tuple(_t(arrays)), tuple(_t(tangents)))
    jout, jtan = jax.jvp(jfn, tuple(_j(arrays)), tuple(_j(tangents)))
    _close(out, jout, dtype, "primal")
    _close(tan, jtan, dtype, "tangent")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jacrev_and_jacfwd_match_jax(case, dtype):
    route, jfn, arrays = _case(case, dtype, n=6)
    nv = len(arrays) - len(DIMS) - 1
    t, jt = _t(arrays), _j(arrays)

    def f(v, o0):
        return _apply(route)(*t[:nv], v, o0, *t[nv + 2:])

    def jf(v, o0):
        return jfn(*jt[:nv], v, o0, *jt[nv + 2:])

    want = jax.jacrev(jf, argnums=(0, 1))(jt[nv], jt[nv + 1])
    for name, jac in (("jacrev", torch.func.jacrev), ("jacfwd", torch.func.jacfwd)):
        got = jac(f, argnums=(0, 1))(t[nv], t[nv + 1])
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, dtype, f"{name} argument {i}")


def _batched(case, dtype, what):
    """(route, jfn, arrays, in_dims): `what` of the inputs batched by B
    along a leading axis."""
    route, jfn, arrays = _case(case, dtype)
    nv = len(arrays) - len(DIMS) - 1
    rng = np.random.default_rng(3)
    dims = [None] * len(arrays)
    batch = []
    if what in ("table", "both"):
        batch.append(nv)
    if what in ("queries", "both"):
        batch += list(range(nv + 1, len(arrays)))
    if what == "grid":
        batch.append(0)  # starts, axis 0's grid or knots, shifted per item
    for i in batch:
        a = arrays[i]
        if i == nv:
            items = [a] + [rng.standard_normal(a.shape) for _ in range(B - 1)]
        elif i > nv:
            items = [a] + [rng.permutation(a) for _ in range(B - 1)]
        else:
            items = [a + 0.25 * b for b in range(B)]
        arrays[i] = np.stack(items).astype(dtype)
        dims[i] = 0
    return route, jfn, arrays, tuple(dims)


@pytest.mark.parametrize("what", ["table", "queries", "both", "grid"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vmap_matches_jax_and_keeps_each_row(case, dtype, what):
    route, jfn, arrays, in_dims = _batched(case, dtype, what)
    got = torch.func.vmap(_apply(route), in_dims=in_dims)(*_t(arrays))
    want = jax.vmap(jfn, in_axes=in_dims)(*_j(arrays))
    assert got.shape == (B, N)
    _close(got, want, dtype, f"vmap over the {what}")
    t = _t(arrays)
    for b in range(B):
        row = _apply(route)(*(x if d is None else x[b] for x, d in zip(t, in_dims)))
        torch.testing.assert_close(got[b], row, rtol=0, atol=0)


def _spied(route, calls):
    """The route with every callable, its stack route's too, counting its
    calls in `calls` under its name."""
    def spy(name, fn):
        def run(*a):
            calls.append(name)
            return fn(*a)
        return run

    stack = route.stack._replace(kernel=spy("stack", route.stack.kernel),
                                 gather=spy("stack gather", route.stack.gather))
    return route._replace(kernel=spy("kernel", route.kernel),
                          gather=spy("gather", route.gather), stack=stack)


@pytest.mark.parametrize("case", CASES)
def test_vmap_launches(case):
    """A batched table takes one stack call; batched queries one kernel
    call; the table and the queries batched together one kernel call per
    item; the gather tree never runs forward."""
    for what, want in (("table", ["stack"]), ("queries", ["kernel"]),
                       ("both", ["kernel"] * B), ("grid", ["kernel"] * B)):
        route, _, arrays, in_dims = _batched(case, np.float64, what)
        calls = []
        torch.func.vmap(_apply(_spied(route, calls)), in_dims=in_dims)(*_t(arrays))
        assert calls == want, what


@pytest.mark.parametrize("case", ["regular-cubic", "rectilinear-linear", "bspline-3"])
def test_vmap_over_stacks(case):
    """A batch of B stacks of nch tables is one stack call over B * nch
    tables; batched queries over a stack one stack call, each row the
    unbatched stack call's."""
    route, _, arrays = _case(case, np.float64)
    nv = len(arrays) - len(DIMS) - 1
    nch = 4
    rng = np.random.default_rng(4)
    stacks = torch.from_numpy(rng.standard_normal((B, nch, arrays[nv].size)))
    t = _t(arrays)
    calls = []
    stack = _spied(route, calls).stack
    got = torch.func.vmap(lambda v: _apply(stack)(*t[:nv], v, *t[nv + 1:]))(stacks)
    assert calls == ["stack"] and got.shape == (B, nch, N)
    for b in range(B):
        torch.testing.assert_close(got[b], _apply(route.stack)(*t[:nv], stacks[b], *t[nv + 1:]),
                                   rtol=0, atol=0)
    obs = torch.stack([t[nv + 1], t[nv + 1].flip(0)])
    calls.clear()
    got = torch.func.vmap(lambda o: _apply(stack)(*t[:nv], stacks[0], o, *t[nv + 2:]))(obs)
    assert calls == ["stack"] and got.shape == (2, nch, N)
    torch.testing.assert_close(got[1], _apply(route.stack)(*t[:nv], stacks[0], obs[1],
                                                           *t[nv + 2:]), rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_grad_of_vmap_and_vmap_of_grad(case):
    """The transforms nest: grad through the stack route of a vmapped call
    and vmap over the grad of the single-table call agree."""
    route, _, arrays, in_dims = _batched(case, np.float64, "table")
    nv = len(arrays) - len(DIMS) - 1
    t = _t(arrays)

    def one(v):
        return _apply(route)(*t[:nv], v, *t[nv + 1:]).square().sum()

    outer = torch.func.grad(lambda vs: torch.func.vmap(
        lambda v: _apply(route)(*t[:nv], v, *t[nv + 1:]))(vs).square().sum())(t[nv])
    inner = torch.func.vmap(torch.func.grad(one))(t[nv])
    torch.testing.assert_close(outer, inner, rtol=1e-12, atol=1e-12)


@pytest.fixture
def engines(monkeypatch):
    """CPU tensors taken for CUDA ones, INTERPN_TPU_F64=df64, and K8's
    contraction counting its calls: which engine a call reaches."""
    calls = []
    contract = tdf64.contract

    def count(*a):
        calls.append("df64")
        return contract(*a)

    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    monkeypatch.setattr(tdf64, "contract", count)
    monkeypatch.setenv("INTERPN_TPU_F64", "df64")
    return calls


@pytest.mark.parametrize("case", ["regular-linear", "rectilinear-cubic", "bspline-5"])
def test_forced_engine_under_transforms(engines, case):
    """Under INTERPN_TPU_F64=df64 a vmapped call takes K8 once per batch
    item (a stack does not take the engine) and a differentiated one once,
    each as the call without a transform: the route decision (the table's
    split and finiteness, cached by its data pointer) runs on plain
    tensors."""
    route, jfn, arrays, in_dims = _batched(case, np.float64, "table")
    nv = len(arrays) - len(DIMS) - 1
    t = _t(arrays)
    got = torch.func.vmap(_apply(route), in_dims=in_dims)(*t)
    assert engines == ["df64"] * B
    for b in range(B):
        engines.clear()
        row = _apply(route)(*t[:nv], t[nv][b], *t[nv + 1:])
        assert engines == ["df64"]
        torch.testing.assert_close(got[b], row, rtol=0, atol=0)
    engines.clear()
    g = torch.func.grad(lambda v: _apply(route)(*t[:nv], v, *t[nv + 1:]).sum())(t[nv][0])
    assert engines == ["df64"]
    jt = _j(arrays)
    want = jax.grad(lambda v: jnp.sum(jfn(*jt[:nv], v, *jt[nv + 1:])))(jt[nv][0])
    _close(g, want, np.float64, "grad into the table")


# --- mirrors of tests/test_transforms.py, through the ops on the kernel route -----------


@pytest.fixture
def kernel_route(monkeypatch):
    """The ops take their kernel route (KernelRoute) on CPU tensors."""
    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")


def _grid2(f):
    x = np.linspace(0.0, 4.0, 5)
    xg, yg = np.meshgrid(x, x, indexing="ij")
    return torch.from_numpy(f(xg, yg).ravel())


ZEROS, ONES = torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)


def test_grad_wrt_query_linear(kernel_route):
    vals = _grid2(lambda x, y: 3.0 * x - 2.0 * y)

    def f(px, py):
        return dispatch.linear_regular((5, 5), ZEROS, ONES, vals, (px[None], py[None]))[0]

    g = torch.func.grad(f, argnums=(0, 1))
    for px, py in [(0.3, 1.7), (2.5, 3.1), (-1.2, 5.4)]:
        gx, gy = g(torch.tensor(px, dtype=torch.float64), torch.tensor(py, dtype=torch.float64))
        np.testing.assert_allclose([float(gx), float(gy)], [3.0, -2.0], atol=1e-12)


def test_grad_wrt_query_cubic_quadratic(kernel_route):
    vals = _grid2(lambda x, y: x**2 + y**2)

    def f(px, py):
        return dispatch.cubic_regular((5, 5), ZEROS, ONES, vals, (px[None], py[None]), False)[0]

    g = torch.func.grad(f, argnums=(0, 1))
    for px, py in [(0.4, 1.6), (2.3, 3.3), (-0.7, 4.9)]:
        gx, gy = g(torch.tensor(px, dtype=torch.float64), torch.tensor(py, dtype=torch.float64))
        np.testing.assert_allclose([float(gx), float(gy)], [2 * px, 2 * py], atol=1e-9)


def test_grad_wrt_vals_is_corner_weights(kernel_route):
    obs = (torch.tensor([1.3], dtype=torch.float64), torch.tensor([2.6], dtype=torch.float64))

    def f(vals):
        return dispatch.linear_regular((5, 5), ZEROS, ONES, vals, obs)[0]

    w = torch.func.grad(f)(torch.zeros(25, dtype=torch.float64))
    assert float(w.sum()) == pytest.approx(1.0, abs=1e-12)
    assert int((w != 0).sum()) == 4  # the 2^2 stencil


def test_vmap_over_value_grids(kernel_route, monkeypatch):
    """Seven channels on 5^3 in one vmap, one stack call; each row the
    single-table call bit for bit."""
    from interpn_tpu_torch.ops import fused

    calls = []
    stack = fused.eval_regular_stack
    monkeypatch.setattr(fused, "eval_regular_stack",
                        lambda *a, **k: calls.append(1) or stack(*a, **k))
    rng = np.random.default_rng(0)
    channels = torch.from_numpy(rng.standard_normal((7, 125)))
    starts, steps = torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64)
    obs = tuple(torch.from_numpy(rng.uniform(-1, 5, 50)) for _ in range(3))
    out = torch.func.vmap(
        lambda v: dispatch.cubic_regular((5, 5, 5), starts, steps, v, obs, True))(channels)
    assert out.shape == (7, 50) and calls == [1]
    single = dispatch.cubic_regular((5, 5, 5), starts, steps, channels[3], obs, True)
    torch.testing.assert_close(out[3], single, rtol=0, atol=0)
    want = jax.vmap(lambda v: jops.cubic_regular(
        (5, 5, 5), jnp.zeros(3), jnp.ones(3), v, tuple(jnp.asarray(o.numpy()) for o in obs),
        True))(jnp.asarray(channels.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_grad_composition(kernel_route):
    """value and gradient at once, and a second transform over the first."""
    vals = _grid2(lambda x, y: np.sin(x) * np.cos(y))

    def f(px, py):
        return dispatch.cubic_regular((5, 5), ZEROS, ONES, vals, (px[None], py[None]), True)[0]

    px, py = torch.tensor(1.5, dtype=torch.float64), torch.tensor(2.5, dtype=torch.float64)
    (gx, gy), v = torch.func.grad_and_value(f, argnums=(0, 1))(px, py)
    assert all(math.isfinite(float(a)) for a in (v, gx, gy))
    # gradients of a batch of points through vmap(grad)
    xs = torch.tensor([0.5, 1.5, 3.25], dtype=torch.float64)
    gxs = torch.func.vmap(torch.func.grad(f), in_dims=(0, None))(xs, py)
    assert float(gxs[1]) == float(gx)
    want = jax.grad(lambda x, y: jops.cubic_regular(
        (5, 5), jnp.zeros(2), jnp.ones(2), jnp.asarray(vals.numpy()), (x[None], y[None]),
        True)[0])(jnp.asarray(1.5), jnp.asarray(2.5))
    np.testing.assert_allclose(float(gx), float(want), rtol=1e-12, atol=1e-12)
