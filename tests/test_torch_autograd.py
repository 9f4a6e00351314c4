"""Gradients of the port's kernel routes against JAX on the CPU.

`ops.dispatch.KernelRoute` runs a kernel wrapper forward (its plain version
on a CPU tensor) and the vector-Jacobian product of the gather tree
backward. Its gradients for vals, the queries and the grid parameters are
held against `jax.vjp` of the JAX gather tree with the same cotangent: f64
rtol=atol=1e-12 (the same products and sums, accumulated in another order
by the scatter of the vals gradient), f32 rtol=atol=1e-5. Nearest has zero
gradients for the queries and one-hot gradients for vals.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax
import jax.numpy as jnp

from interpn_tpu.ops import cubic as jcubic
from interpn_tpu.ops import linear as jlinear
from interpn_tpu.ops import nearest as jnearest
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import cubic as tcubic
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused
from interpn_tpu_torch.ops import linear as tlinear
from interpn_tpu_torch.ops import nearest as tnearest

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _case(dims, dtype, n, seed):
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd).astype(dtype)
    steps = rng.uniform(0.3, 1.0, nd).astype(dtype)
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    obs = [
        rng.uniform(starts[k] - steps[k], starts[k] + steps[k] * dims[k], n).astype(dtype)
        for k in range(nd)
    ]
    cot = rng.standard_normal(n).astype(dtype)
    return starts, steps, vals, obs, cot


def _jax_grads(dims, starts, steps, vals, obs, cot):
    def f(st, sp, v, *ob):
        return jlinear.linear_regular(dims, st, sp, v, ob)

    args = [jnp.asarray(a) for a in (starts, steps, vals, *obs)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_grads(fn, dims, starts, steps, vals, obs, cot):
    args = [torch.tensor(a, requires_grad=True) for a in (starts, steps, vals, *obs)]
    out = fn(dims, *args[:3], tuple(args[3:]))
    out.backward(torch.from_numpy(cot))
    return [a.grad.numpy() for a in args]


def _kernel_fn(dims, st, sp, v, ob):
    """The linear kernel route as dispatch builds it for a CUDA tensor."""
    return tdispatch.KernelRoute.apply(
        lambda *a: tfused.eval_regular(dims, a[0], a[1], a[2], a[3:]),
        lambda *a: tlinear.linear_regular(dims, a[0], a[1], a[2], a[3:]),
        st, sp, v, *ob,
    )


@pytest.mark.parametrize("dims", [(9,), (6, 7), (5, 4, 6), (3, 4, 3, 3)],
                         ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_function_grads_match_jax(dims, dtype):
    case = _case(dims, dtype, n=300, seed=len(dims))
    want = _jax_grads(dims, *case)
    before = dict(tfused.launches)
    got = _torch_grads(_kernel_fn, dims, *case)
    assert tfused.launches == before
    names = ["starts", "steps", "vals"] + [f"obs[{k}]" for k in range(len(dims))]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL[dtype])


def test_dispatch_grads_equal_kernel_function_grads():
    """The CPU route (autograd through the gather tree) and the kernel
    route's Function give the same gradients."""
    dims = (5, 4, 6)
    case = _case(dims, np.float64, n=200, seed=7)
    a = _torch_grads(_kernel_fn, dims, *case)
    b = _torch_grads(tdispatch.linear_regular, dims, *case)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_kernel_function_gradcheck():
    dims = (4, 5)
    starts, steps, vals, obs, _ = _case(dims, np.float64, n=12, seed=8)
    args = [torch.tensor(a, requires_grad=True) for a in (starts, steps, vals, *obs)]
    assert torch.autograd.gradcheck(lambda *a: _kernel_fn(dims, *a[:3], a[3:]), args)


# --- cubic and nearest on regular grids, every method on rectilinear grids ----

# (JAX gather tree, port plain version, extra args) per route; the port's
# plain version runs forward, as the kernel wrapper does on a CPU tensor
REGULAR = {
    "cubic-lin": (jcubic.cubic_regular, tcubic.cubic_regular, (True,)),
    "cubic-quad": (jcubic.cubic_regular, tcubic.cubic_regular, (False,)),
    "nearest": (jnearest.nearest_regular, tnearest.nearest_regular, ()),
}
RECTILINEAR = {
    "linear": (jlinear.linear_rectilinear, tlinear.linear_rectilinear, ()),
    "cubic-lin": (jcubic.cubic_rectilinear, tcubic.cubic_rectilinear, (True,)),
    "cubic-quad": (jcubic.cubic_rectilinear, tcubic.cubic_rectilinear, (False,)),
    "nearest": (jnearest.nearest_rectilinear, tnearest.nearest_rectilinear, ()),
}


def _route_grads(fn, arrays, cot):
    args = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*args).backward(torch.from_numpy(cot))
    return [np.zeros_like(a) if t.grad is None else t.grad.numpy()
            for a, t in zip(arrays, args)]


@pytest.mark.parametrize("route", list(REGULAR))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_regular_kernel_route_grads_match_jax(route, dtype):
    jfn, tfn, extra = REGULAR[route]
    dims = (5, 4, 6)
    starts, steps, vals, obs, cot = _case(dims, dtype, n=300, seed=11)
    arrays = (starts, steps, vals, *obs)

    def kernel_route(st, sp, v, *ob):
        method = route.split("-")[0]
        return tdispatch.KernelRoute.apply(
            lambda *a: tfused.eval_regular(dims, *a[:3], a[3:], method, *extra),
            lambda *a: tfn(dims, *a[:3], a[3:], *extra),
            st, sp, v, *ob,
        )

    _, vjp = jax.vjp(lambda st, sp, v, *ob: jfn(dims, st, sp, v, ob, *extra),
                     *[jnp.asarray(a) for a in arrays])
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    before = dict(tfused.launches)
    got = _route_grads(kernel_route, arrays, cot)
    assert tfused.launches == before
    names = ["starts", "steps", "vals"] + [f"obs[{k}]" for k in range(3)]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL[dtype])
    if route == "nearest":
        assert all(not g.any() for g in got[3:])  # no gradient for the queries


@pytest.mark.parametrize("route", list(RECTILINEAR))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rectilinear_kernel_route_grads_match_jax(route, dtype):
    jfn, tfn, extra = RECTILINEAR[route]
    dims = (5, 4, 6)
    rng = np.random.default_rng(12)
    grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    obs = [rng.uniform(g[0] - 0.5, g[-1] + 0.5, 300).astype(dtype) for g in grids]
    cot = rng.standard_normal(300).astype(dtype)
    arrays = (*grids, vals, *obs)

    def kernel_route(*a):
        method = route.split("-")[0]
        return tdispatch.KernelRoute.apply(
            lambda *b: tfused.eval_rectilinear(b[:3], b[3], b[4:], method, *extra),
            lambda *b: tfn(b[:3], b[3], b[4:], *extra),
            *a,
        )

    _, vjp = jax.vjp(lambda *a: jfn(a[:3], a[3], a[4:], *extra),
                     *[jnp.asarray(a) for a in arrays])
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    got = _route_grads(kernel_route, arrays, cot)
    names = [f"grids[{k}]" for k in range(3)] + ["vals"] + [f"obs[{k}]" for k in range(3)]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL[dtype])


def test_nearest_vals_gradient_is_one_hot():
    """Each query's cotangent lands on the one table entry it selected."""
    dims = (5, 4, 6)
    starts, steps, vals, obs, cot = _case(dims, np.float64, n=50, seed=13)
    args = [torch.tensor(a, requires_grad=True) for a in (starts, steps, vals, *obs)]
    out = tdispatch.KernelRoute.apply(
        lambda *a: tfused.eval_regular(dims, *a[:3], a[3:], "nearest"),
        lambda *a: tnearest.nearest_regular(dims, *a[:3], a[3:]),
        *args,
    )
    out.backward(torch.from_numpy(cot))
    # the selected entry of each query, found by value (vals are distinct)
    hit = np.searchsorted(np.sort(vals), out.detach().numpy())
    order = np.argsort(vals)
    want = np.zeros_like(vals)
    np.add.at(want, order[hit], cot)
    np.testing.assert_array_equal(args[2].grad.numpy(), want)
