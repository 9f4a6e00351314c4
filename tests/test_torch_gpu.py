"""The Hopper kernels on the card: against their plain versions, at grid
nodes, through the entry points, and under autograd; and the device timer.

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
from interpn_tpu_torch.ops import bspline, cubic, dispatch, fused, linear, nearest, stack
from interpn_tpu_torch.utils import profiling

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


# --- B-splines (K4) and stacks (K5-K7) -------------------------------------------


def _spline_case(dims, k, dtype, device, n, nch=None, seed=0):
    """A not-a-knot spline fitted on jittered axes; queries as `_case`."""
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    shape = (math.prod(dims),) if nch is None else (math.prod(dims), nch)
    knots, coeffs = bspline.prep_bspline(grids, rng.standard_normal(shape), k)
    if nch is not None:
        coeffs = np.ascontiguousarray(coeffs.T)
    obs = [_obs(rng, g[0], g[-1], n) for g in grids]
    kt, ct = convert.bspline_from_numpy(knots, coeffs, device=device, dtype=dtype)
    return kt, ct, convert.obs_from_numpy(obs, device=device, dtype=dtype)


def _spline_n(dims, k):
    """Queries for a plain version that gathers (k+1)^N values per query."""
    return max(64, min(20_000, 2**26 // (k + 1) ** len(dims)))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bspline_kernel_equals_plain(cuda, dims, k, dtype):
    dims = tuple(max(d, k + 1) for d in dims)
    kt, ct, obs = _spline_case(dims, k, dtype, cuda, _spline_n(dims, k), seed=len(dims))
    got = _launched(f"bspline_k{k}", lambda: fused.eval_bspline(kt, ct, obs, k))
    _equal(got, bspline.bspline_gather(kt, ct, obs, k))


STACK_DIMS = [(50,), (12, 9), (10, 8, 9), (7, 6, 5, 6)]


@pytest.mark.parametrize("dims", STACK_DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("nch", [1, 3, 8])
@pytest.mark.parametrize("method,lin", [("linear", True), ("cubic", True), ("cubic", False),
                                        ("nearest", True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_stack_kernels_equal_plain(cuda, dims, nch, method, lin, dtype):
    rng = np.random.default_rng(nch)
    dims_, st, sp, _, ob = _case(dims, dtype, cuda, n=20_000, seed=len(dims))
    vals = torch.as_tensor(rng.standard_normal((nch, math.prod(dims))), dtype=dtype,
                           device=cuda)
    got = _launched(f"regular_{method}_stack",
                    lambda: fused.eval_regular_stack(dims_, st, sp, vals, ob, method, lin))
    _equal(got, fused.plain_regular_stack(dims_, st, sp, vals, ob, method, lin))
    # one table of a stack is the single-table kernel's result
    _equal(got[0], fused.eval_regular(dims_, st, sp, vals[0], ob, method, lin))
    grids, _, ob = _rect_case(dims, dtype, cuda, n=20_000, seed=len(dims))
    got = _launched(f"rectilinear_{method}_stack",
                    lambda: fused.eval_rectilinear_stack(grids, vals, ob, method, lin))
    _equal(got, fused.plain_rectilinear_stack(grids, vals, ob, method, lin))
    _equal(got[-1], fused.eval_rectilinear(grids, vals[-1], ob, method, lin))


@pytest.mark.parametrize("dims", STACK_DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("nch", [1, 3, 8])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bspline_stack_kernel_equals_plain(cuda, dims, nch, k, dtype):
    dims = tuple(max(d, k + 1) for d in dims)
    kt, ct, obs = _spline_case(dims, k, dtype, cuda, _spline_n(dims, k), nch=nch, seed=nch)
    got = _launched(f"bspline_k{k}_stack", lambda: fused.eval_bspline_stack(kt, ct, obs, k))
    _equal(got, fused.plain_bspline_stack(kt, ct, obs, k))
    _equal(got[0], fused.eval_bspline(kt, ct[0], obs, k))


def test_new_routes_launch_their_kernels(cuda):
    """The spline and stack evaluators on CUDA tensors launch their own
    kernel once and no other, and keep the query shape."""
    kt, ct, obs = _spline_case((6, 7, 5), 3, torch.float32, cuda, n=1000)
    _, cs, _ = _spline_case((6, 7, 5), 3, torch.float32, cuda, n=1000, nch=4)
    obs = tuple(o.reshape(10, 100) for o in obs)
    dims, st, sp, _, ob = _case((6, 5, 7), torch.float32, cuda, n=1000)
    grids, _, rob = _rect_case((6, 5, 7), torch.float32, cuda, n=1000)
    vals = torch.ones(4, 210, device=cuda)
    calls = {
        "bspline_k3": (lambda: dispatch.bspline_eval(kt, ct, obs, 3), (10, 100)),
        "bspline_k3_stack": (lambda: stack.bspline_eval_stack(kt, cs, obs, 3), (4, 10, 100)),
        "regular_cubic_stack": (lambda: stack.cubic_regular_stack(dims, st, sp, vals, ob, False),
                                (4, 1000)),
        "rectilinear_nearest_stack": (lambda: stack.nearest_rectilinear_stack(grids, vals, rob),
                                      (4, 1000)),
    }
    for kernel, (call, shape) in calls.items():
        fused.reset_launches()
        out = call()
        assert out.device.type == "cuda" and out.shape == shape, kernel
        assert fused.launches == {k: int(k == kernel) for k in fused.launches}, kernel


def test_spline_and_stack_entry_points_on_the_card(cuda):
    """interpn(cubic_spline | quintic) and interpn_stack from numpy run on the
    card by default and give the CPU's values."""
    rng = np.random.default_rng(12)
    x = np.linspace(0.0, 5.0, 9)
    vals = rng.standard_normal((3, 9, 9))
    obs = [rng.uniform(-0.5, 5.5, 500) for _ in range(2)]
    for method in ("cubic_spline", "quintic", "linear", "cubic", "nearest"):
        with config.device("cpu"):
            want = interpn_tpu_torch.interpn_stack(obs, [x, x], vals, method=method)
        fused.reset_launches()
        got = interpn_tpu_torch.interpn_stack(obs, [x, x], vals, method=method)
        assert sum(fused.launches.values()) == 1, method
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=method)
        if method in ("cubic_spline", "quintic"):
            single = interpn_tpu_torch.interpn(obs, [x, x], vals[1], method=method)
            np.testing.assert_allclose(single, want[1], rtol=1e-12, atol=1e-12)


def test_spline_and_stack_grads_equal_cpu_grads(cuda):
    kt, ct, obs = _spline_case((5, 6, 7), 3, torch.float64, "cpu", n=300)
    obs = tuple(torch.nan_to_num(o, posinf=9.0, neginf=-9.0) for o in obs)
    cs = torch.stack([ct, 2 * ct])
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 300)))
    routes = {
        "bspline": (lambda *a: dispatch.bspline_eval(a[:3], a[3], a[4:], 3), ct, cot[0]),
        "bspline_stack": (lambda *a: stack.bspline_eval_stack(a[:3], a[3], a[4:], 3), cs, cot),
    }
    for name, (route, table, c) in routes.items():
        grads = {}
        for dev in ("cpu", cuda):
            leaves = [t.detach().to(dev).requires_grad_() for t in (*kt, table, *obs)]
            route(*leaves).backward(c.to(dev))
            grads[str(dev)] = _grads(leaves)
        for a, b in zip(grads["cpu"], grads[str(cuda)]):
            torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12, msg=name)


# --- the device timer -----------------------------------------------------------------


def test_timer_never_fails_a_sound_pass(cuda):
    """200 timings of a 20-launch pass in one process: every one returns a
    positive time, the kernel's from events behind a head start that held,
    the profiler's within its three tries."""
    args = _case((20, 20, 20), torch.float32, cuda, n=100_000)
    batches = [args[4]] * 20

    def call(ob):
        return fused.eval_regular(*args[:4], ob)

    for _ in range(200):
        t = profiling.cuda_time(call, batches)
        assert t.device_ms > 0 and t.loop_ms > 0 and t.ahead
        p = profiling.profiled_time(call, batches)
        assert p.device_ms is not None and p.device_ms > 0
        assert p.tries <= profiling.PROFILER_TRIES and 0 < p.events <= 20 and p.per_call == 1


def test_timer_lets_exceptions_through(cuda):
    def boom(_):
        raise KeyError("from the timed function")

    for timer in (profiling.cuda_time, profiling.profiled_time):
        with pytest.raises(KeyError, match="from the timed function"):
            timer(boom, [0] * 4)
