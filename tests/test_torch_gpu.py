"""The Hopper kernels on the card: against their plain versions, at grid
nodes, through the entry points, and under autograd.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernels run the plain versions' operations in the same order with no
FMA contraction, so the two are compared bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu_torch
from interpn_tpu_torch import config, convert
from interpn_tpu_torch.ops import cubic, dispatch, fused, linear, nearest

pytestmark = pytest.mark.gpu

DIMS = [(50,), (20, 20), (20, 20, 20), (12,) * 4, (8,) * 5, (6,) * 6, (5,) * 7, (4,) * 8]
BAD = [np.nan, np.inf, -np.inf]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _n(dims, n):
    """Fewer queries for the wide cubic stencils of 7-8D, whose plain
    version gathers 4^N values per query."""
    return n if len(dims) <= 6 else n // 10


def _obs(rng, lo, hi, n):
    o = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), n)
    o[rng.integers(0, n, 16)] = rng.choice(BAD, 16)
    return o


def _case(dims, dtype, device, n, seed=0):
    """Grid on [0, dim-1]*step per axis; queries uniform over the grid plus
    half a grid beyond each side, with NaN and +-inf mixed in."""
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd)
    steps = rng.uniform(0.3, 1.0, nd)
    vals = rng.standard_normal(math.prod(dims))
    obs = [_obs(rng, starts[k], starts[k] + steps[k] * (dims[k] - 1), n) for k in range(nd)]
    grid = convert.regular_grid_from_numpy(
        dims, starts, steps, vals, device=device, dtype=dtype
    )
    return (*grid, convert.obs_from_numpy(obs, device=device, dtype=dtype))


def _rect_case(dims, dtype, device, n, seed=0):
    """Jittered sorted axes; queries as `_case`."""
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    vals = rng.standard_normal(math.prod(dims))
    obs = [_obs(rng, g[0], g[-1], n) for g in grids]
    grids_t, vals_t = convert.rectilinear_grid_from_numpy(grids, vals, device=device, dtype=dtype)
    return grids_t, vals_t, convert.obs_from_numpy(obs, device=device, dtype=dtype)


def _equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _launched(kernel, fn):
    before = fused.launches[kernel]
    out = fn()
    assert fused.launches[kernel] == before + 1
    return out


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_equals_plain(cuda, dims, dtype):
    args = _case(dims, dtype, cuda, n=100_000, seed=len(dims))
    got = _launched("regular_linear", lambda: fused.eval_regular(*args))
    _equal(got, linear.linear_regular(*args))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_cubic_kernel_equals_plain(cuda, dims, dtype, lin):
    args = _case(dims, dtype, cuda, n=_n(dims, 20_000), seed=len(dims))
    got = _launched("regular_cubic", lambda: fused.eval_regular(*args, "cubic", lin))
    _equal(got, cubic.cubic_regular(*args, lin))


@pytest.mark.parametrize("dims", DIMS[:6], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_nearest_kernel_equals_plain(cuda, dims, dtype):
    args = _case(dims, dtype, cuda, n=100_000, seed=len(dims))
    got = _launched("regular_nearest", lambda: fused.eval_regular(*args, "nearest"))
    _equal(got, nearest.nearest_regular(*args))


RECT_CASES = [
    (dims, method, lin)
    for method, lin in (("linear", True), ("cubic", True), ("cubic", False), ("nearest", True))
    for dims in (DIMS[:6] if method == "nearest" else DIMS)
]


@pytest.mark.parametrize("dims,method,lin", RECT_CASES,
                         ids=[f"{m}-{lin}-{len(d)}d" for d, m, lin in RECT_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_kernel_equals_plain(cuda, dims, dtype, method, lin):
    grids, vals, obs = _rect_case(dims, dtype, cuda, n=_n(dims, 20_000), seed=len(dims))
    got = _launched(f"rectilinear_{method}",
                    lambda: fused.eval_rectilinear(grids, vals, obs, method, lin))
    if method == "cubic":
        want = cubic.cubic_rectilinear(grids, vals, obs, lin)
    elif method == "linear":
        want = linear.linear_rectilinear(grids, vals, obs)
    else:
        want = nearest.nearest_rectilinear(grids, vals, obs)
    _equal(got, want)


def _nodes(n=20):
    return np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij")).reshape(3, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_grid_nodes_exact(cuda, dtype):
    dims = (20, 20, 20)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(8000)
    grid = convert.regular_grid_from_numpy(
        dims, np.zeros(3), np.full(3, 0.5), vals, device=cuda, dtype=dtype
    )
    idx = _nodes()
    obs = convert.obs_from_numpy([i * 0.5 for i in idx], device=cuda, dtype=dtype)
    got = fused.eval_regular(*grid, obs)
    torch.testing.assert_close(got, linear.linear_regular(*grid, obs), rtol=0, atol=0)
    interior = torch.from_numpy(np.all(idx <= 18, axis=0)).to(cuda)
    assert torch.equal(got[interior], grid[3][interior])
    # cubic (both modes) and nearest reproduce every node, edges included
    for method, lin in (("cubic", True), ("cubic", False), ("nearest", True)):
        assert torch.equal(fused.eval_regular(*grid, obs, method, lin), grid[3]), method


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_grid_nodes_exact(cuda, dtype):
    rng = np.random.default_rng(4)
    axes = [np.cumsum(0.2 + rng.random(20)) for _ in range(3)]
    vals = rng.standard_normal(8000)
    grids, vals_t = convert.rectilinear_grid_from_numpy(axes, vals, device=cuda, dtype=dtype)
    idx = _nodes()
    obs = tuple(g[torch.from_numpy(i).to(cuda)] for g, i in zip(grids, idx))
    for method, lin in (("cubic", True), ("cubic", False), ("nearest", True)):
        got = fused.eval_rectilinear(grids, vals_t, obs, method, lin)
        assert torch.equal(got, vals_t), method


def test_kernel_empty_batch_and_refusals(cuda):
    dims, st, sp, v, ob = _case((4, 5), torch.float32, cuda, n=8)
    before = dict(fused.launches)
    empty = tuple(o[:0] for o in ob)
    assert fused.eval_regular(dims, st, sp, v, empty).shape == (0,)
    assert fused.eval_rectilinear((st, sp), v[:4], empty[:1] * 2).shape == (0,)
    assert fused.launches == before
    with pytest.raises(ValueError, match="one device"):
        fused.eval_regular(dims, st, sp, v, (ob[0].cpu(), ob[1]))
    with pytest.raises(TypeError, match="dtype mismatch"):
        fused.eval_regular(dims, st, sp, v.double(), ob)
    with pytest.raises(ValueError, match="at least 4 points"):
        fused.eval_regular((3, 5), st, sp, v[:15], ob, "cubic")


def test_dispatch_launches_one_kernel_per_call(cuda):
    """Every `ops` evaluator on CUDA tensors launches its own kernel once and
    no other, and keeps the query shape."""
    reg = _case((6, 5, 7), torch.float32, cuda, n=1000, seed=9)
    reg = (*reg[:4], tuple(o.reshape(10, 100) for o in reg[4]))
    grids, vals, obs = _rect_case((6, 5, 7), torch.float32, cuda, n=1000, seed=9)
    calls = {
        "regular_linear": lambda: dispatch.linear_regular(*reg),
        "regular_cubic": lambda: dispatch.cubic_regular(*reg, True),
        "regular_nearest": lambda: dispatch.nearest_regular(*reg),
        "rectilinear_linear": lambda: dispatch.linear_rectilinear(grids, vals, obs),
        "rectilinear_cubic": lambda: dispatch.cubic_rectilinear(grids, vals, obs, False),
        "rectilinear_nearest": lambda: dispatch.nearest_rectilinear(grids, vals, obs),
    }
    for kernel, call in calls.items():
        fused.reset_launches()
        out = call()
        assert out.device.type == "cuda", kernel
        assert out.shape == ((10, 100) if kernel.startswith("regular") else (1000,)), kernel
        assert fused.launches == {k: int(k == kernel) for k in fused.launches}, kernel


def test_default_device_is_cuda(cuda):
    assert config.default_device().type == "cuda"
    with config.device("cpu"):
        assert config.default_device() == torch.device("cpu")


def _entry_cases(rng):
    """(kernel, call(obs) -> numpy result, plain numpy result) per path."""
    x = (np.arange(20) * 0.5).astype(np.float32)  # exactly regular
    axes = [np.sort(np.linspace(0, 9.5, 20) + np.r_[0, rng.uniform(-0.1, 0.1, 18), 0])
            .astype(np.float32) for _ in range(3)]
    vals = rng.standard_normal(8000).astype(np.float32)
    dims, starts, steps = np.array([20] * 3), np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    raw = interpn_tpu_torch.raw
    cases = []
    for method in ("linear", "cubic", "nearest"):
        lin = (True,) if method == "cubic" else ()
        reg = getattr(raw, f"interpn_{method}_regular_f32")
        rect = getattr(raw, f"interpn_{method}_rectilinear_f32")
        cases.append((f"regular_{method}", x, lambda ob, out, f=reg, a=lin:
                      f(dims, starts, steps, vals, *a, ob, out)))
        cases.append((f"rectilinear_{method}", axes, lambda ob, out, f=rect, a=lin:
                      f(axes, vals, *a, ob, out)))
    return vals, cases


def test_entry_points_launch_the_kernels(cuda):
    """raw from numpy (the default device is the card), raw from CUDA
    tensors and interpn(): one launch each, the same values as the CPU."""
    rng = np.random.default_rng(4)
    n = 1000
    obs = [rng.uniform(-0.5, 10.5, n).astype(np.float32) for _ in range(3)]
    vals, cases = _entry_cases(rng)
    for kernel, axes, call in cases:
        method = kernel.split("_")[1]
        grids = [axes] * 3 if isinstance(axes, np.ndarray) else axes
        with config.device("cpu"):
            want = interpn_tpu_torch.interpn(obs, grids, vals.reshape(20, 20, 20), method=method)
        out = np.zeros(n, np.float32)
        _launched(kernel, lambda: call(obs, out))
        tout = torch.zeros(n, device=cuda)
        _launched(kernel, lambda: call([torch.from_numpy(o).to(cuda) for o in obs], tout))
        got = _launched(kernel, lambda: interpn_tpu_torch.interpn(
            obs, grids, vals.reshape(20, 20, 20), method=method))
        for r in (out, tout.cpu().numpy(), got):
            np.testing.assert_allclose(r, want, rtol=1e-6, atol=1e-6, err_msg=kernel)


def _grads(leaves):
    """Each leaf's gradient on the CPU; None (no path from the output, as
    for nearest's queries under autograd on the CPU) reads as zeros, the
    kernel route's gradient there."""
    return [torch.zeros_like(t).cpu() if t.grad is None else t.grad.cpu() for t in leaves]


def test_kernel_grads_equal_cpu_grads(cuda):
    dims = (5, 4, 6)
    cpu_args = _case(dims, torch.float64, "cpu", n=500, seed=5)
    cpu_args = (*cpu_args[:4], tuple(torch.nan_to_num(o, posinf=9.0, neginf=-9.0)
                                     for o in cpu_args[4]))
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal(500))
    routes = {
        "linear": lambda *a: dispatch.linear_regular(dims, *a[:3], a[3:]),
        "cubic": lambda *a: dispatch.cubic_regular(dims, *a[:3], a[3:], False),
        "nearest": lambda *a: dispatch.nearest_regular(dims, *a[:3], a[3:]),
    }
    for name, route in routes.items():
        grads = {}
        for dev in ("cpu", cuda):
            leaves = [t.detach().to(dev).requires_grad_()
                      for t in (*cpu_args[1:4], *cpu_args[4])]
            route(*leaves).backward(cot.to(dev))
            grads[str(dev)] = _grads(leaves)
        for a, b in zip(grads["cpu"], grads[str(cuda)]):
            torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12, msg=name)


def test_rectilinear_grads_equal_cpu_grads(cuda):
    dims = (5, 4, 6)
    grids, vals, obs = _rect_case(dims, torch.float64, "cpu", n=500, seed=7)
    obs = tuple(torch.nan_to_num(o, posinf=9.0, neginf=-9.0) for o in obs)
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal(500))
    for method in ("linear", "cubic", "nearest"):
        route = getattr(dispatch, f"{method}_rectilinear")
        extra = (True,) if method == "cubic" else ()
        grads = {}
        for dev in ("cpu", cuda):
            leaves = [t.detach().to(dev).requires_grad_() for t in (*grids, vals, *obs)]
            route(leaves[:3], leaves[3], leaves[4:], *extra).backward(cot.to(dev))
            grads[str(dev)] = _grads(leaves)
        for a, b in zip(grads["cpu"], grads[str(cuda)]):
            torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12, msg=method)
