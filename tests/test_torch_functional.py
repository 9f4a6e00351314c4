"""`interpn_tpu_torch.functional.TorchInterpolator` against the JAX
package's `JaxInterpolator` on the CPU.

Mirrors `tests/test_functional.py`: each method on both grid kinds against
`JaxInterpolator` on the same inputs (f64 rtol=atol=1e-12), `from_model`
for each class, vmap over tables, grad into the table and the queries, the
errors, and pchip under the transforms. The JAX package's `jit` argument
without retrace and `scan` carry have no counterpart (the port does not
trace; `torch.func` has no `scan`). With the ops on their kernel route, a
vmap over tables is one stack call whose rows are the single-table calls'
bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import interpn_tpu as it
import jax
import jax.numpy as jnp
from interpn_tpu.functional import JaxInterpolator

import interpn_tpu_torch as itt
from interpn_tpu_torch import config
from interpn_tpu_torch.functional import TorchInterpolator
from interpn_tpu_torch.ops import dispatch, fused

TOL = dict(rtol=1e-12, atol=1e-12)
METHODS = ["linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic"]


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield


def _grids(ndims, regular, rng, n=6):
    x = np.linspace(0.0, 1.0, n)
    grids = []
    for _ in range(ndims):
        g = x.copy()
        if not regular:
            g = np.sort(rng.uniform(0.0, 1.0, n))
            g[0], g[-1] = 0.0, 1.0
            while np.any(np.diff(g) <= 1e-3):
                g = np.sort(rng.uniform(0.0, 1.0, n))
                g[0], g[-1] = 0.0, 1.0
        grids.append(g)
    return grids


def _mk(ndims, method, regular, rng, n=6):
    """(TorchInterpolator, JaxInterpolator, obs) on the same grid and table."""
    grids = _grids(ndims, regular, rng, n)
    vals = rng.standard_normal([n] * ndims)
    obs = [rng.uniform(-0.2, 1.2, 257) for _ in range(ndims)]
    if regular:
        args = ([n] * ndims, [g[0] for g in grids], [g[1] - g[0] for g in grids], vals)
        return (TorchInterpolator.regular(*args, method=method),
                JaxInterpolator.regular(*args, method=method), obs)
    return (TorchInterpolator.rectilinear(grids, vals, method=method),
            JaxInterpolator.rectilinear(grids, vals, method=method), obs)


def _obs(obs):
    return [torch.from_numpy(o) for o in obs]


@pytest.mark.parametrize("regular", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_matches_jax_interpolator(method, regular):
    rng = np.random.default_rng(42)
    itp, jitp, obs = _mk(3, method, regular, rng)
    got = itp(_obs(obs))
    assert got.shape == (257,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(jitp(obs)), **TOL)
    # numpy queries, shaped queries
    np.testing.assert_array_equal(itp(obs).numpy(), got.numpy())
    shaped = itp([o.reshape(1, 257) for o in _obs(obs)])
    assert shaped.shape == (1, 257)


def test_matches_model_classes(monkeypatch):
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")  # the classes' torch route
    rng = np.random.default_rng(42)
    for regular in (True, False):
        for method, name in (("linear", "Multilinear"), ("cubic", "Multicubic"),
                             ("nearest", "Nearest")):
            itp, _, obs = _mk(3, method, regular, rng)
            kind = "Regular" if regular else "Rectilinear"
            cls = getattr(itt, f"{name}{kind}")
            leaves, _ = pytree.tree_flatten(itp)
            if regular:
                model = cls.new([6] * 3, leaves[0].numpy(), leaves[1].numpy(),
                                leaves[2].numpy())
            else:
                model = cls.new([g.numpy() for g in leaves[:-1]], leaves[-1].numpy())
            np.testing.assert_array_equal(itp(obs).numpy(), model.eval(obs))


def test_vmap_over_tables():
    rng = np.random.default_rng(3)
    itp, jitp, obs = _mk(2, "linear", True, rng)
    nch = 4
    tables = rng.standard_normal((nch, itp.vals.shape[0]))
    leaves, spec = pytree.tree_flatten(itp)
    batched = pytree.tree_unflatten(leaves[:-1] + [torch.from_numpy(tables)], spec)
    out = torch.func.vmap(lambda i, o: i(o), in_dims=(itp.batch_axes(), None))(
        batched, _obs(obs))
    assert out.shape == (nch, len(obs[0]))
    jleaves, jdef = jax.tree_util.tree_flatten(jitp)
    jbatched = jax.tree_util.tree_unflatten(jdef, jleaves[:-1] + [jnp.asarray(tables)])
    want = jax.vmap(lambda i, o: i(o), in_axes=(jitp.batch_axes(), None))(
        jbatched, [jnp.asarray(o) for o in obs])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    for c in range(nch):
        single = pytree.tree_unflatten(leaves[:-1] + [torch.from_numpy(tables[c])], spec)
        torch.testing.assert_close(out[c], single(obs), rtol=0, atol=0)


@pytest.fixture
def on_kernel_route(monkeypatch):
    """The ops take their kernel route on CPU tensors, the stack wrappers
    counting their calls."""
    calls = []
    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    for name in ("eval_regular_stack", "eval_rectilinear_stack", "eval_bspline_stack"):
        fn = getattr(fused, name)
        monkeypatch.setattr(fused, name,
                            lambda *a, fn=fn, name=name, **k: calls.append(name) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("regular", [True, False])
@pytest.mark.parametrize("method", ["linear", "cubic", "nearest", "cubic_spline", "quintic"])
def test_vmap_over_tables_is_one_stack_call(on_kernel_route, method, regular):
    rng = np.random.default_rng(5)
    itp, _, obs = _mk(3, method, regular, rng)
    leaves, spec = pytree.tree_flatten(itp)
    tables = torch.from_numpy(rng.standard_normal((8, leaves[-1].shape[0])))
    batched = pytree.tree_unflatten(leaves[:-1] + [tables], spec)
    out = torch.func.vmap(lambda i, o: i(o), in_dims=(itp.batch_axes(), None))(
        batched, _obs(obs))
    assert len(on_kernel_route) == 1 and out.shape == (8, 257)
    for c in range(8):
        single = pytree.tree_unflatten(leaves[:-1] + [tables[c]], spec)
        torch.testing.assert_close(out[c], single(_obs(obs)), rtol=0, atol=0)
    # a batch of query sets on one table: one kernel call, no stack call
    on_kernel_route.clear()
    qs = [torch.stack([o, o.flip(0)]) for o in _obs(obs)]
    out = torch.func.vmap(lambda i, o: i(o), in_dims=(None, 0))(itp, qs)
    assert on_kernel_route == [] and out.shape == (2, 257)
    torch.testing.assert_close(out[1], itp([q[1] for q in qs]), rtol=0, atol=0)


@pytest.mark.parametrize("route", ["gather", "kernel"])
def test_grad_flows_to_table_and_obs(monkeypatch, route):
    if route == "kernel":
        monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    rng = np.random.default_rng(7)
    itp, jitp, obs = _mk(2, "cubic", True, rng)
    sub = [o[:31] for o in obs]
    obs_t = _obs(sub)

    def loss(itp):
        return itp(obs_t).square().sum()

    g = torch.func.grad(loss)(itp)
    assert isinstance(g, TorchInterpolator) and g.vals.shape == itp.vals.shape
    jg = jax.grad(lambda i: jnp.sum(i([jnp.asarray(o) for o in sub]) ** 2))(jitp)
    for a, b in zip(pytree.tree_flatten(g)[0], jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # finite-difference spot check on one table entry
    eps = 1e-6
    leaves, spec = pytree.tree_flatten(itp)
    e = torch.zeros_like(itp.vals)
    e[10] = eps

    def at(v):
        return float(loss(pytree.tree_unflatten(leaves[:-1] + [v], spec)))

    fd = (at(itp.vals + e) - at(itp.vals - e)) / (2 * eps)
    np.testing.assert_allclose(float(g.vals[10]), fd, rtol=1e-4, atol=1e-7)

    go = torch.func.grad(lambda o0: itp([o0, obs_t[1]]).sum())(obs_t[0])
    jgo = jax.grad(lambda o0: jnp.sum(jitp([o0, jnp.asarray(sub[1])])))(jnp.asarray(sub[0]))
    np.testing.assert_allclose(go.numpy(), np.asarray(jgo), **TOL)
    assert bool((go != 0).any())


@pytest.mark.parametrize("method", ["linear", "quintic"])
def test_jvp_into_table(method):
    rng = np.random.default_rng(8)
    itp, jitp, obs = _mk(2, method, False, rng)
    tangent = rng.standard_normal(itp.vals.shape[0])
    leaves, spec = pytree.tree_flatten(itp)
    jleaves, jdef = jax.tree_util.tree_flatten(jitp)
    _, tan = torch.func.jvp(
        lambda v: pytree.tree_unflatten(leaves[:-1] + [v], spec)(obs),
        (itp.vals,), (torch.from_numpy(tangent),))
    _, jtan = jax.jvp(lambda v: jax.tree_util.tree_unflatten(jdef, jleaves[:-1] + [v])(obs),
                      (jitp.vals,), (jnp.asarray(tangent),))
    np.testing.assert_allclose(tan.numpy(), np.asarray(jtan), **TOL)


@pytest.mark.parametrize(
    "name,args,method",
    [
        ("MultilinearRegular", "reg", "linear"),
        ("MulticubicRegular", "reg", "cubic"),
        ("NearestRegular", "reg", "nearest"),
        ("MultilinearRectilinear", "rect", "linear"),
        ("MulticubicRectilinear", "rect", "cubic"),
        ("NearestRectilinear", "rect", "nearest"),
        ("TensorSplineRegular", "reg", "pchip"),
        ("TensorSplineRegular", "reg", "cubic_spline"),
        ("TensorSplineRectilinear", "rect", "quintic"),
        ("TensorSplineRectilinear", "rect", "pchip"),
    ],
)
def test_from_model(name, args, method):
    rng = np.random.default_rng(11)
    n = 6
    vals = rng.standard_normal(n * n)
    kw = {"method": method} if name.startswith("TensorSpline") else {}
    if args == "reg":
        grid = ([n, n], np.zeros(2), np.full(2, 0.2), vals)
    else:
        g = np.linspace(0.0, 1.0, n) ** 1.3
        grid = ([g, g], vals)
    model = getattr(itt, name).new(*grid, **kw)
    jmodel = getattr(it, name).new(*grid, **kw)
    itp = TorchInterpolator.from_model(model)
    assert itp.method == method
    obs = [rng.uniform(0.05, 0.9, 65) for _ in range(2)]
    got = itp(obs).numpy()
    np.testing.assert_allclose(got, np.asarray(JaxInterpolator.from_model(jmodel)(obs)), **TOL)
    np.testing.assert_allclose(got, model.eval([np.ascontiguousarray(o) for o in obs]), **TOL)


def test_errors():
    with pytest.raises(ValueError, match="is not defined"):
        TorchInterpolator.regular([4], [0.0], [1.0], np.zeros(4), method="foo")
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        TorchInterpolator.regular([4] * 7, np.zeros(7), np.ones(7), np.zeros(4**7),
                                  method="nearest")
    itp = TorchInterpolator.regular([4, 4], np.zeros(2), np.ones(2), np.zeros(16))
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        itp([np.zeros(3)])
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        itp([np.zeros(3), np.zeros(4)])


def test_spline_construction_under_a_transform_raises():
    grids = [np.linspace(0.0, 1.0, 7)] * 2
    vals = torch.from_numpy(np.random.default_rng(1).standard_normal(49))
    obs = [torch.full((3,), 0.5, dtype=torch.float64)] * 2

    def build(v):
        return TorchInterpolator.rectilinear(grids, v, method="cubic_spline")(obs).sum()

    with pytest.raises(TypeError, match="needs concrete table values"):
        torch.func.grad(build)(vals)
    with pytest.raises(TypeError, match="needs concrete table values"):
        torch.func.vmap(build)(vals.expand(2, 49))
    with pytest.raises(TypeError, match="needs concrete table values"):
        build(vals.clone().requires_grad_())
    # built outside, the coefficients take the transform
    itp = TorchInterpolator.rectilinear(grids, vals, method="cubic_spline")
    g = torch.func.grad(lambda i: i(obs).sum())(itp)
    assert g.vals.shape == itp.vals.shape and bool((g.vals != 0).any())


def test_pchip_method_matches_ops_and_transforms():
    """pchip goes through ops.pchip (a gather tree on every device) and
    composes with vmap over tables and grad like the other methods."""
    from interpn_tpu import ops as jops
    from interpn_tpu_torch import ops as tops

    rng = np.random.default_rng(23)
    grids = [np.sort(rng.uniform(0.0, 1.0, n)) for n in (6, 7)]
    vals = rng.random(42)
    itp = TorchInterpolator.rectilinear(grids, vals, method="pchip")
    obs = [rng.uniform(-0.1, 1.1, 50) for _ in range(2)]
    ref = np.asarray(jops.pchip_rectilinear(grids, vals, obs))
    got = itp(obs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13)
    tg = tuple(torch.from_numpy(g) for g in grids)
    torch.testing.assert_close(got, tops.pchip_rectilinear(tg, torch.from_numpy(vals),
                                                           tuple(_obs(obs))), rtol=0, atol=0)
    stack = np.stack([vals, vals[::-1].copy()])
    batched = torch.func.vmap(
        lambda v, o: TorchInterpolator.rectilinear(grids, v, method="pchip")(o),
        in_dims=(0, None))(torch.from_numpy(stack), _obs(obs))
    np.testing.assert_allclose(batched[0].numpy(), ref, rtol=1e-13)
    ref1 = np.asarray(jops.pchip_rectilinear(grids, stack[1], obs))
    np.testing.assert_allclose(batched[1].numpy(), ref1, rtol=1e-13)
    g = torch.func.grad(lambda i: i(obs).sum())(itp)
    jg = jax.grad(lambda v: jnp.sum(JaxInterpolator.rectilinear(grids, v, method="pchip")(
        [jnp.asarray(o) for o in obs])))(jnp.asarray(vals))
    np.testing.assert_allclose(g.vals.numpy(), np.asarray(jg), **TOL)


def test_float32_table_and_repr():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(36).astype(np.float32)
    itp = TorchInterpolator.regular([6, 6], [0.0, 0.0], [0.2, 0.2], vals)
    assert itp.vals.dtype == torch.float32 and itp.grid_arrays[0].dtype == torch.float32
    obs = [rng.uniform(0, 1, 9) for _ in range(2)]
    assert itp(obs).dtype == torch.float32
    jitp = JaxInterpolator.regular([6, 6], np.zeros(2, np.float32),
                                   np.full(2, 0.2, np.float32), vals)
    np.testing.assert_allclose(itp(obs).numpy(), np.asarray(
        jitp([o.astype(np.float32) for o in obs])), rtol=1e-5, atol=1e-5)
    assert repr(itp) == "TorchInterpolator(linear, regular, dims=(6, 6), vals=(36,))"
