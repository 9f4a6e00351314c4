"""Gradients of the port's kernel path against JAX on the CPU.

`ops.dispatch.LinearRegularKernel` runs the fused wrapper forward (the plain
version on a CPU tensor) and the vector-Jacobian product of the gather tree
backward. Its gradients for vals, obs, starts and steps are held against
`jax.vjp` of the JAX gather tree with the same cotangent: f64
rtol=atol=1e-12 (the same products and sums, accumulated in another order
by the scatter of the vals gradient), f32 rtol=atol=1e-5.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax
import jax.numpy as jnp

from interpn_tpu.ops import linear as jlinear
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}


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
    return tdispatch.LinearRegularKernel.apply(dims, st, sp, v, *ob)


@pytest.mark.parametrize("dims", [(9,), (6, 7), (5, 4, 6), (3, 4, 3, 3)],
                         ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_function_grads_match_jax(dims, dtype):
    case = _case(dims, dtype, n=300, seed=len(dims))
    want = _jax_grads(dims, *case)
    before = tfused.launches
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
    assert torch.autograd.gradcheck(
        lambda *a: tdispatch.LinearRegularKernel.apply(dims, *a), args
    )
