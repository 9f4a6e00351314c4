"""The Hopper kernel on the card: against its plain version, at grid nodes,
through the entry points, and under autograd.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernel runs the plain version's operations in the same order with no
FMA contraction, so the two are compared bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu_torch
from interpn_tpu_torch import convert
from interpn_tpu_torch.ops import dispatch, fused, linear

pytestmark = pytest.mark.gpu

DIMS = [(50,), (20, 20), (20, 20, 20), (12,) * 4, (8,) * 5, (6,) * 6, (5,) * 7, (4,) * 8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dims, dtype, device, n, seed=0):
    """Grid on [0, dim-1]*step per axis; queries uniform over the grid plus
    half a grid beyond each side, with NaN and +-inf mixed in."""
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd)
    steps = rng.uniform(0.3, 1.0, nd)
    vals = rng.standard_normal(math.prod(dims))
    obs = []
    for k in range(nd):
        span = steps[k] * (dims[k] - 1)
        o = rng.uniform(starts[k] - 0.5 * span, starts[k] + 1.5 * span, n)
        o[rng.integers(0, n, 16)] = rng.choice([np.nan, np.inf, -np.inf], 16)
        obs.append(o)
    grid = convert.regular_grid_from_numpy(
        dims, starts, steps, vals, device=device, dtype=dtype
    )
    return (*grid, convert.obs_from_numpy(obs, device=device, dtype=dtype))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_equals_plain(cuda, dims, dtype):
    args = _case(dims, dtype, cuda, n=100_000, seed=len(dims))
    before = fused.launches
    got = fused.eval_regular(*args)
    assert fused.launches == before + 1
    want = linear.linear_regular(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_grid_nodes_exact(cuda, dtype):
    dims = (20, 20, 20)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(8000)
    grid = convert.regular_grid_from_numpy(
        dims, np.zeros(3), np.full(3, 0.5), vals, device=cuda, dtype=dtype
    )
    idx = np.stack(np.meshgrid(*[np.arange(20)] * 3, indexing="ij")).reshape(3, -1)
    obs = convert.obs_from_numpy([i * 0.5 for i in idx], device=cuda, dtype=dtype)
    got = fused.eval_regular(*grid, obs)
    torch.testing.assert_close(got, linear.linear_regular(*grid, obs), rtol=0, atol=0)
    interior = torch.from_numpy(np.all(idx <= 18, axis=0)).to(cuda)
    assert torch.equal(got[interior], grid[3][interior])


def test_kernel_empty_batch_and_refusals(cuda):
    dims, st, sp, v, ob = _case((4, 5), torch.float32, cuda, n=8)
    before = fused.launches
    empty = tuple(o[:0] for o in ob)
    assert fused.eval_regular(dims, st, sp, v, empty).shape == (0,)
    assert fused.launches == before
    with pytest.raises(ValueError, match="one device"):
        fused.eval_regular(dims, st, sp, v, (ob[0].cpu(), ob[1]))
    with pytest.raises(TypeError, match="dtype mismatch"):
        fused.eval_regular(dims, st, sp, v.double(), ob)


def test_entry_points_launch_the_kernel(cuda):
    dims = np.array([20, 20, 20])
    rng = np.random.default_rng(4)
    x = (np.arange(20) * 0.5).astype(np.float32)  # exactly regular
    vals = rng.standard_normal(8000).astype(np.float32)
    obs = [rng.uniform(-0.5, 10.5, 1000).astype(np.float32) for _ in range(3)]
    starts = np.zeros(3, np.float32)
    steps = np.full(3, x[1] - x[0], np.float32)
    want = linear.linear_regular(
        *convert.regular_grid_from_numpy(dims, starts, steps, vals, device="cpu",
                                         dtype=torch.float32),
        convert.obs_from_numpy(obs, device="cpu", dtype=torch.float32),
    ).numpy()

    before = fused.launches
    with torch.device(cuda):
        out = np.zeros(1000, np.float32)
        interpn_tpu_torch.raw.interpn_linear_regular_f32(dims, starts, steps, vals, obs, out)
        got = interpn_tpu_torch.interpn(obs, [x] * 3, vals.reshape(20, 20, 20))
    assert fused.launches == before + 2
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    tout = torch.zeros(1000, device=cuda)
    interpn_tpu_torch.raw.interpn_linear_regular_f32(
        dims, torch.from_numpy(starts).to(cuda), torch.from_numpy(steps).to(cuda),
        torch.from_numpy(vals).to(cuda), [torch.from_numpy(o).to(cuda) for o in obs], tout,
    )
    assert fused.launches == before + 3
    np.testing.assert_allclose(tout.cpu().numpy(), want, rtol=1e-6, atol=1e-6)


def test_kernel_grads_equal_cpu_grads(cuda):
    dims = (5, 4, 6)
    cpu_args = _case(dims, torch.float64, "cpu", n=500, seed=5)
    cpu_args = (*cpu_args[:4], tuple(torch.nan_to_num(o, posinf=9.0, neginf=-9.0)
                                     for o in cpu_args[4]))
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal(500))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (*cpu_args[1:4], *cpu_args[4])]
        out = dispatch.linear_regular(dims, *leaves[:3], tuple(leaves[3:]))
        out.backward(cot.to(dev))
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cpu"], grads[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12)
