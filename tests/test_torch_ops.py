"""The port's tensor functions against the JAX package on the CPU.

Same inputs, made from numpy seeds, go through `interpn_tpu` and
`interpn_tpu_torch`. Tolerances:
* gather tree vs gather tree: f32 rtol=atol=1e-6, f64 rtol=atol=1e-13. Both
  packages run the same operations in the same order; XLA:CPU may contract
  a multiply-add into an FMA where PyTorch's separate kernels cannot, which
  moves a result by an ulp.
* grid nodes: bitwise, since at t in {0, 1} every lerp is exact or the same
  single rounding in both.
* the fused wrapper (plain version on the CPU) vs the Pallas kernel K1 in
  interpret mode: rtol=2e-4, atol=1e-3, the JAX package's own bar
  (tests/test_pallas_v3.py), since K1 sums in another order.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp
from jax.experimental import pallas as pl

from interpn_tpu import utils as jutils
from interpn_tpu.ops import bounds as jbounds
from interpn_tpu.ops import linear as jlinear
from interpn_tpu.ops import locate as jlocate
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config, convert
from interpn_tpu_torch import utils as tutils
from interpn_tpu_torch.ops import _gather as tgather
from interpn_tpu_torch.ops import bounds as tbounds
from interpn_tpu_torch.ops import dispatch as tdispatch
from interpn_tpu_torch.ops import fused as tfused
from interpn_tpu_torch.ops import linear as tlinear
from interpn_tpu_torch.ops import locate as tlocate

from . import oracle

TOL = {np.float32: dict(rtol=1e-6, atol=1e-6), np.float64: dict(rtol=1e-13, atol=1e-13)}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    """Numpy inputs would go to the card by default; these tests ask for the
    CPU."""
    with config.device("cpu"):
        yield

DIMS_1_TO_8 = [(9,), (8, 6), (7, 5, 6), (5, 4, 6, 3), (4, 3, 4, 3, 4), (3, 4, 3, 3, 2, 3),
               (3, 2, 3, 2, 3, 2, 3), (2, 3, 2, 2, 3, 2, 2, 3)]


def _case(dims, dtype, seed=0, n=700):
    """A grid and n queries, a tenth of them outside the grid on each side."""
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd).astype(dtype)
    steps = rng.uniform(0.3, 1.0, nd).astype(dtype)
    vals = rng.standard_normal(math.prod(dims)).astype(dtype)
    obs = [
        rng.uniform(
            starts[k] - 0.2 * steps[k] * dims[k],
            starts[k] + 1.2 * steps[k] * (dims[k] - 1),
            n,
        ).astype(dtype)
        for k in range(nd)
    ]
    return starts, steps, vals, obs


def _jax(dims, starts, steps, vals, obs):
    return np.asarray(
        jlinear.linear_regular(
            dims, jnp.asarray(starts), jnp.asarray(steps), jnp.asarray(vals),
            tuple(jnp.asarray(o) for o in obs),
        )
    )


def _torch_args(dims, starts, steps, vals, obs, dtype):
    grid = convert.regular_grid_from_numpy(
        dims, starts, steps, vals, device=CPU, dtype=TDTYPE[dtype]
    )
    return (*grid, convert.obs_from_numpy(obs, device=CPU, dtype=TDTYPE[dtype]))


# --- utils -----------------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS_1_TO_8)
@pytest.mark.parametrize("footprint", [2, 4])
def test_utils_match_jax(dims, footprint):
    assert tutils.c_strides(dims) == jutils.c_strides(dims)
    assert tutils.nvals(dims) == jutils.nvals(dims)
    np.testing.assert_array_equal(
        tutils.corner_offsets(dims, footprint), jutils.corner_offsets(dims, footprint)
    )


def test_gather_corners_vertex_order():
    """Vertex i of the stencil holds dim k's offset in bit k."""
    dims = (4, 3, 5)
    vals = torch.arange(math.prod(dims), dtype=torch.float64)
    base = torch.tensor([0, 1 * 15 + 1 * 5 + 2], dtype=torch.int32)
    corners = tgather.gather_corners(vals, base, dims, 2)
    grid = vals.reshape(dims)
    for i, c in enumerate(corners):
        bits = [(i >> k) & 1 for k in range(3)]
        assert c[0] == grid[tuple(bits)]
        assert c[1] == grid[1 + bits[0], 1 + bits[1], 2 + bits[2]]


# --- locate ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_locate_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(1)
    x = rng.uniform(-5, 15, 700).astype(dtype)
    x[:6] = [np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0]
    x[6:26] = np.arange(20) * 0.5  # every node of a step-0.5 grid
    start, step = dtype(0.0), dtype(0.5)
    jl, jt = jlocate.locate_regular_linear(jnp.asarray(x), start, step, 20)
    tl, tt = tlocate.locate_regular_linear(
        torch.from_numpy(x), torch.tensor(start), torch.tensor(step), 20
    )
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))  # NaN == NaN here
    assert 0 <= tl.min() and tl.max() <= 18


# --- gather tree -----------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS_1_TO_8, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_tree_matches_jax(dims, dtype):
    starts, steps, vals, obs = _case(dims, dtype, seed=len(dims))
    want = _jax(dims, starts, steps, vals, obs)
    got = tlinear.linear_regular(*_torch_args(dims, starts, steps, vals, obs, dtype))
    assert got.dtype == TDTYPE[dtype] and got.shape == (700,)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_nodes_bitwise(dtype):
    """Every node of a 20^3 step-0.5 grid: bitwise equal to the JAX gather
    tree, and equal to vals wherever no index is the last on its axis."""
    dims = (20, 20, 20)
    rng = np.random.default_rng(2)
    starts = np.zeros(3, dtype)
    steps = np.full(3, 0.5, dtype)
    vals = rng.standard_normal(8000).astype(dtype)
    idx = np.stack(np.meshgrid(*[np.arange(20)] * 3, indexing="ij")).reshape(3, -1)
    obs = [(i * 0.5).astype(dtype) for i in idx]
    want = _jax(dims, starts, steps, vals, obs)
    got = tlinear.linear_regular(*_torch_args(dims, starts, steps, vals, obs, dtype))
    np.testing.assert_array_equal(got.numpy(), want)
    interior = np.all(idx <= 18, axis=0)
    np.testing.assert_array_equal(got.numpy()[interior], vals[interior])


@pytest.mark.parametrize("ndims", range(2, 9))
def test_gather_tree_matches_oracle(ndims):
    dims = tuple([4, 3][k % 2] for k in range(ndims))
    starts, steps, vals, obs = _case(dims, np.float64, seed=10 + ndims, n=60)
    got = tlinear.linear_regular(*_torch_args(dims, starts, steps, vals, obs, np.float64))
    want = [
        oracle.linear_regular(dims, starts, steps, vals, [o[i] for o in obs])
        for i in range(60)
    ]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nonfinite_queries_match_jax(dtype):
    """NaN, +-inf and 1e30 give what JAX gives (NaN, except 1e30 in f64,
    which stays finite), with no index error: NaN maps to cell 0 before the
    int cast."""
    dims = (10, 10, 10)
    starts, steps, vals, obs = _case(dims, dtype, seed=4, n=20)
    bad = [np.nan, np.inf, -np.inf, 1e30]
    for k in range(3):
        obs[k][:4] = bad
    obs[0][4:8] = bad  # one bad axis among good ones
    want = _jax(dims, starts, steps, vals, obs)
    got = tlinear.linear_regular(*_torch_args(dims, starts, steps, vals, obs, dtype))
    assert np.all(np.isnan(want[: 4 if dtype == np.float32 else 3]))
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TOL[dtype])


def test_gather_tree_keeps_query_shape():
    dims = (5, 6)
    starts, steps, vals, obs = _case(dims, np.float64, n=24)
    obs2 = [o.reshape(4, 6) for o in obs]
    args = _torch_args(dims, starts, steps, vals, obs, np.float64)
    got = tlinear.linear_regular(*args[:4], tuple(o.reshape(4, 6) for o in args[4]))
    np.testing.assert_allclose(
        got.numpy(), _jax(dims, starts, steps, vals, obs2), rtol=1e-13, atol=1e-13
    )


# --- fused wrapper (plain version on the CPU) vs K1 in interpret mode --------


@pytest.fixture
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


@pytest.mark.parametrize("dims", [(8, 12), (10, 10, 10), (6, 5, 4, 7)], ids=str)
def test_fused_plain_matches_pallas_k1(_interpret_mode, dims):
    starts, steps, vals, obs = _case(dims, np.float32, seed=20 + len(dims))
    want = np.asarray(
        jv3.eval_regular(
            dims, jnp.asarray(starts), jnp.asarray(steps), jnp.asarray(vals),
            tuple(jnp.asarray(o) for o in obs), "linear", True, 6,
        )
    )
    before = dict(tfused.launches)
    got = tfused.eval_regular(*_torch_args(dims, starts, steps, vals, obs, np.float32))
    assert tfused.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)


def test_fused_cpu_is_the_gather_tree():
    dims = (7, 5, 6)
    args = _torch_args(dims, *_case(dims, np.float32), np.float32)
    torch.testing.assert_close(
        tfused.eval_regular(*args), tlinear.linear_regular(*args), rtol=0, atol=0
    )


def _cuda_like_args(dtype=torch.float32, dims=(4, 5, 6), n=16):
    """Tensors that pass for kernel inputs, for the wrapper's checks."""
    nd = len(dims)
    return (
        dims,
        torch.zeros(nd, dtype=dtype),
        torch.ones(nd, dtype=dtype),
        torch.zeros(math.prod(dims), dtype=dtype),
        tuple(torch.zeros(n, dtype=dtype) for _ in dims),
    )


def test_fused_check_accepts_kernel_inputs():
    assert tfused._check(*_cuda_like_args()) == 16
    assert tfused._check(*_cuda_like_args(torch.float64, (2,) * 8, 0)) == 0


@pytest.mark.parametrize(
    "mutate,exc,msg",
    [
        (lambda a: ((2,) * 9, *a[1:]), ValueError, "ndims"),
        (lambda a: ((1, 5, 6), *a[1:]), ValueError, "at least 2 points"),
        (lambda a: ((2**16, 2**15, 6), *a[1:]), ValueError, "int64"),
        (lambda a: (*a[:3], a[3][:-1], a[4]), ValueError, "flat"),
        (lambda a: (*a[:3], a[3].half(), a[4]), TypeError, "float32 or float64"),
        (lambda a: (*a[:3], a[3].double(), a[4]), TypeError, "dtype mismatch"),
        (lambda a: (*a[:4], (a[4][0], a[4][1][:3], a[4][2])), ValueError, "one length"),
        (lambda a: (*a[:4], (a[4][0], torch.zeros(32)[::2], a[4][2])), ValueError,
         "contiguous"),
        (lambda a: (*a[:4], a[4][:2]), ValueError, "one entry per dim"),
    ],
    ids=["ndims", "short-axis", "grid-int32", "vals-size", "half", "mixed-dtype",
         "ragged-obs", "strided-obs", "obs-count"],
)
def test_fused_check_refuses(mutate, exc, msg):
    with pytest.raises(exc, match=msg):
        tfused._check(*mutate(_cuda_like_args()))


def test_fused_refuses_mixed_devices_and_other_methods():
    dims, st, sp, v, ob = _cuda_like_args()
    with pytest.raises(ValueError, match="one device"):
        tfused.eval_regular(dims, st.to("meta"), sp, v, ob)
    with pytest.raises(ValueError, match="no kernel for device"):
        tfused.eval_regular(
            dims, st.to("meta"), sp.to("meta"), v.to("meta"),
            tuple(o.to("meta") for o in ob),
        )
    with pytest.raises(ValueError, match="method must be one of"):
        tfused.eval_regular(dims, st, sp, v, ob, method="pchip")
    with pytest.raises(ValueError, match="method must be one of"):
        tfused.eval_rectilinear((st, sp, st), v, ob, method="quintic")


def test_dispatch_routes_cpu_to_gather(monkeypatch):
    monkeypatch.setattr(
        tfused, "eval_regular", lambda *a, **k: pytest.fail("kernel on a CPU tensor")
    )
    dims = (7, 5, 6)
    args = _torch_args(dims, *_case(dims, np.float64), np.float64)
    assert tdispatch._impl(args[3]) == "gather"
    torch.testing.assert_close(
        tdispatch.linear_regular(*args), tlinear.linear_regular(*args), rtol=0, atol=0
    )


# --- bounds ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spread", [0.0, 1e-9, 0.3])
def test_check_bounds_matches_jax(dtype, spread):
    dims = (5, 6, 7)
    rng = np.random.default_rng(6)
    starts = rng.uniform(-1, 1, 3).astype(dtype)
    steps = rng.uniform(0.3, 1, 3).astype(dtype)
    hi = starts + steps * (np.array(dims) - 1)
    obs = [rng.uniform(starts[k], hi[k], 50).astype(dtype) for k in range(3)]
    obs[1][0] = hi[1] + spread
    for atol in (1e-8, 0.1):
        want = np.asarray(
            jbounds.check_bounds_regular(
                dims, jnp.asarray(starts), jnp.asarray(steps),
                tuple(jnp.asarray(o) for o in obs), jnp.asarray(atol, dtype),
            )
        )
        got = tbounds.check_bounds_regular(
            dims, torch.from_numpy(starts), torch.from_numpy(steps),
            tuple(torch.from_numpy(o) for o in obs), atol,
        )
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
