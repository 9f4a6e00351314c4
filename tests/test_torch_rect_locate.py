"""The guided locate of K2 linear and K3 (one rectilinear table, linear and
nearest; `csrc/rectilinear.cuh::guided_count`) on the CPU.

A kernel cannot run here, so a numpy model of the locate, step for step in
the table's dtype, stands in for it: each axis's 2 dim uniform buckets over
[g[0], g[dim-1]], bucket(x) = floor((x - g[0]) * scale) clamped to the
buckets in floating point, the bucket starts built with that same function
(`GuidedAxes::build`), and a bisection of x's bucket alone. It is held,
exactly, against `torch.searchsorted(side="left")` (the port's
`ops/locate.py::partition_point`, NaN counting 0) and the JAX package's
`interpn_tpu/ops/locate.py::locate_rectilinear_linear`, in f32 and f64, on
jittered, geometric, two-point, long, over-cap, far-offset and
repeated-knot axes, at every knot, one ulp either side of it, every cell's
midpoint, NaN, +-inf, +-0 and points far outside the grid. The wrapper's
CPU path (`fused.eval_rectilinear`, its plain version) runs on the same
queries against the JAX K3 (`pallas_v3.eval_rectilinear`, interpret mode,
exact) and K2 (`eval_rectilinear_pre`, rtol = atol = 1e-4), and against
the JAX gather trees. The route (`fused.rectilinear_route`) and the C
side's shared-memory sums are held at and one row over each cap.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import linear as jlinear
from interpn_tpu.ops import locate as jlocate
from interpn_tpu.ops import nearest as jnearest
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import fused
from interpn_tpu_torch.ops.locate import partition_point

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

F32, F64 = torch.float32, torch.float64
NP = {F32: np.float32, F64: np.float64}
AXES = ["jittered", "geometric", "two_point", "long", "over_cap", "far_offset", "repeated"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _axis(kind, npd, seed=0):
    """A sorted grid column of `kind` in the numpy dtype `npd`: 20 jittered
    points; 20 geometric ones (ratio 1.3, so the finest buckets hold several
    knots); two points; 1000 and 3000 jittered points (the latter's guide
    above COLUMN_BYTES: the kernel bisects it direct); 20 points at 1e4,
    0.005 to 0.015 apart, a few f32 ulps, so that a bucket holds a few
    representable queries; 20 points with repeated knots."""
    rng = np.random.default_rng(seed)
    if kind == "jittered":
        g = np.linspace(0.0, 10.0, 20)
        g[1:-1] += rng.uniform(-0.3, 0.3, 18) * (g[1] - g[0])
    elif kind == "geometric":
        g = np.cumsum(1.3 ** np.arange(20)) / 10.0
    elif kind == "two_point":
        g = np.array([-0.5, 2.0])
    elif kind == "long":
        g = np.cumsum(0.2 + rng.random(1000))
    elif kind == "over_cap":
        g = np.cumsum(0.2 + rng.random(3000))
    elif kind == "far_offset":
        g = 1e4 + 1e-2 * np.cumsum(0.5 + rng.random(20))
    else:
        g = np.repeat(np.cumsum(0.5 + rng.random(10)), 2)
    return np.sort(g.astype(npd))


def _queries(g):
    """Every knot, one ulp either side of each, every cell's midpoint, NaN,
    +-inf, +-0, points far outside the grid and a few inside."""
    npd = g.dtype.type
    big = np.finfo(npd).max
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, big, -big,
                         g[0] - 1e3 * (g[-1] - g[0] + 1), g[-1] + 1e3 * (g[-1] - g[0] + 1)],
                        dtype=npd)
    mid = (g[:-1] + (g[1:] - g[:-1]) * npd(0.5)).astype(npd)
    inside = np.linspace(g[0], g[-1], 37).astype(npd)
    return np.concatenate([g, np.nextafter(g, npd(np.inf)), np.nextafter(g, npd(-np.inf)),
                           mid, specials, inside]).astype(npd)


# --- the numpy model of the kernel's guided locate ----------------------------------


def _bucket(x, lo, scale, m):
    """`bucket_of`: floor((x - lo) * scale), clamped to [0, m - 1] in the
    dtype (fmax drops a NaN) before the conversion."""
    npd = type(lo)
    with np.errstate(invalid="ignore", over="ignore"):
        u = np.floor((x - lo) * scale)
    return np.fmin(np.fmax(u, npd(0)), npd(m - 1)).astype(np.int64)


def _guide(g):
    """`GuidedAxes::build` for one column: (lo, scale, first), first[c] the
    knots whose bucket is below c, c = 0..m, m = 2 dim; each knot j writes
    j into the starts after knot j - 1's bucket up to its own."""
    npd = g.dtype.type
    dim = len(g)
    m = 2 * dim
    lo = g[0]
    with np.errstate(divide="ignore", over="ignore"):
        scale = npd(m) / (g[-1] - lo)
    b = _bucket(g, lo, scale, m)
    first = np.full(m + 1, -1, np.int64)
    for j in range(dim + 1):
        start = 0 if j == 0 else b[j - 1] + 1
        stop = m if j == dim else b[j]
        first[start:stop + 1] = j
    assert (first >= 0).all()  # every start written
    return lo, scale, first


def guided_count(g, x):
    """`guided_count` over every query of x: the knots of the buckets below
    x's and a bisection of x's own bucket. Returns (count, widest bucket)."""
    lo, scale, first = _guide(g)
    b = _bucket(x, lo, scale, 2 * len(g))
    at = first[b]
    count = first[b + 1] - at
    widest = int(count.max())
    while (count > 0).any():
        half = count >> 1
        probe = np.minimum(at + half, len(g) - 1)
        with np.errstate(invalid="ignore"):
            less = (count > 0) & (g[probe] < x)
        at = np.where(less, at + half + 1, at)
        count = np.where(less, count - half - 1, np.where(count > 0, half, 0))
    return at, widest


@pytest.mark.parametrize("kind", AXES)
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_guided_count_is_partition_point(kind, dtype):
    """The model counts exactly the knots below x, as the port's
    `partition_point` (searchsorted side left, NaN counting 0), and gives
    the JAX package's cell."""
    g = _axis(kind, NP[dtype], seed=len(kind))
    if kind == "over_cap":
        assert fused.guide_bytes((len(g),), dtype) > fused.COLUMN_BYTES
    x = _queries(g)
    got, widest = guided_count(g, x)
    want = partition_point(torch.from_numpy(g), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    loc = np.clip(got - 1, 0, len(g) - 2)
    jloc, _, _ = jlocate.locate_rectilinear_linear(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_array_equal(loc, np.asarray(jloc))
    if kind == "jittered":
        assert widest <= 2  # a knot or two a bucket: at most two compares
    if kind == "geometric":
        assert widest > 2  # the finest buckets hold several knots


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_guided_count_on_random_queries(dtype):
    """100k random queries on each axis kind, with NaN and +-inf mixed in."""
    rng = np.random.default_rng(7)
    for kind in AXES:
        g = _axis(kind, NP[dtype], seed=len(kind))
        span = g[-1] - g[0] + 1
        x = rng.uniform(g[0] - span, g[-1] + span, 100_000).astype(NP[dtype])
        x[rng.integers(0, x.size, 50)] = rng.choice([np.nan, np.inf, -np.inf], 50)
        got, _ = guided_count(g, x)
        want = partition_point(torch.from_numpy(g), torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_bucket_is_monotone_where_f32_rounds_coarsely():
    """On the far-offset axis a bucket holds a few f32 values; the buckets
    stay monotone in x, so no margin of buckets is needed."""
    g = _axis("far_offset", np.float32)
    lo, scale, _ = _guide(g)
    x = np.sort(np.concatenate([_queries(g)[np.isfinite(_queries(g))],
                                np.nextafter(g, np.float32(np.inf))]))
    b = _bucket(x, lo, scale, 2 * len(g))
    assert (np.diff(b) >= 0).all()


# --- the wrapper's CPU path on the same queries against the JAX kernels ---------------


def _grid(axes_kinds, npd, n, seed):
    """Axes of the kinds, a random table and n queries an axis drawn from
    each axis's adversarial set."""
    rng = np.random.default_rng(seed)
    axes = [_axis(k, npd, seed=seed + i) for i, k in enumerate(axes_kinds)]
    vals = rng.standard_normal(math.prod(len(a) for a in axes)).astype(npd)
    obs = [rng.choice(_queries(a), n) for a in axes]
    return axes, vals, obs


GRIDS = [("jittered", "geometric", "two_point"), ("long", "two_point"),
         ("geometric", "jittered"), ("far_offset", "jittered")]


@pytest.mark.parametrize("kinds", GRIDS, ids="-".join)
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_plain_version_matches_the_jax_gather_tree(kinds, method, dtype):
    """`fused.eval_rectilinear` on CPU tensors (its plain version) equals the
    JAX gather tree bit for bit on the adversarial queries."""
    npd = NP[dtype]
    axes, vals, obs = _grid(kinds, npd, 400, seed=3)
    got = fused.eval_rectilinear(tuple(torch.from_numpy(a) for a in axes),
                                 torch.from_numpy(vals), tuple(torch.from_numpy(o) for o in obs),
                                 method)
    fn = jlinear.linear_rectilinear if method == "linear" else jnearest.nearest_rectilinear
    want = np.asarray(fn(tuple(map(jnp.asarray, axes)), jnp.asarray(vals),
                         tuple(map(jnp.asarray, obs))))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kinds", GRIDS, ids="-".join)
def test_nearest_matches_the_jax_k3(_interpret_mode, kinds):  # noqa: F811
    """Nearest (f32, the JAX K3's dtype) equals the JAX K3 in interpret mode
    exactly on the adversarial queries."""
    axes, vals, obs = _grid(kinds, np.float32, 300, seed=5)
    got = fused.eval_rectilinear(tuple(torch.from_numpy(a) for a in axes),
                                 torch.from_numpy(vals), tuple(torch.from_numpy(o) for o in obs),
                                 "nearest")
    want = jv3.eval_rectilinear(tuple(map(jnp.asarray, axes)), jnp.asarray(vals),
                                tuple(map(jnp.asarray, obs)), "nearest", True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kinds", GRIDS, ids="-".join)
def test_linear_matches_the_jax_k2(_interpret_mode, kinds):  # noqa: F811
    """Linear (f32) within rtol = atol = 1e-4 of the JAX K2 in interpret mode
    on the adversarial queries that are finite and within a grid's span of
    it: K2 contracts precomputed corner weights (1 - t, t), whose products
    cancel where t is far from [0, 1], and give NaN at t = +-inf where the
    lerp tree gives an infinity."""
    axes, vals, obs = _grid(kinds, np.float32, 300, seed=9)
    near = np.ones(300, bool)
    for a, o in zip(axes, obs):
        span = a[-1] - a[0]
        near &= np.isfinite(o) & (o >= a[0] - span) & (o <= a[-1] + span)
    obs = [o[near] for o in obs]
    got = fused.eval_rectilinear(tuple(torch.from_numpy(a) for a in axes),
                                 torch.from_numpy(vals), tuple(torch.from_numpy(o) for o in obs),
                                 "linear")
    want = jv3.eval_rectilinear_pre(tuple(map(jnp.asarray, axes)), jnp.asarray(vals),
                                    tuple(map(jnp.asarray, obs)), "linear", True, 6)
    assert near.sum() > 150
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --- the route and the shared memory the C side sums -------------------------------


def _c_smem(route, dims, dtype):
    """The dynamic shared memory `Rect::launch` asks for on the guided
    routes (csrc/rectilinear.cuh): the table and its offset from a 16-byte
    boundary rounded up to 16 on kStaged, then each column and its 2 dim + 1
    bucket starts."""
    item = torch.empty((), dtype=dtype).element_size()
    guide = sum(d * item + (2 * d + 1) * 4 for d in dims)
    if route == "staged":
        return (math.prod(dims) * item + 31) // 16 * 16 + guide
    return guide


def _reserve(route):
    """`reserve_of` in csrc/regular.cuh."""
    return fused.STAGE_BYTES + 16 if route == "staged" else fused.COLUMN_BYTES


def _over(dims, budget):
    """The first d0 (dims[0] replaced) whose `budget(dims)` is over the cap,
    by doubling then bisection."""
    lo, hi = dims[0], 2 * dims[0]
    while budget((hi, *dims[1:])):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if budget((mid, *dims[1:])) else (lo, mid)
    return hi


@pytest.mark.parametrize("ndims", range(1, 9))
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_lerp_table_route_at_each_cap(ndims, dtype, method):
    """One linear or nearest table: staged (f32 linear) while table and guide
    fit STAGE_BYTES, guided while the guide fits COLUMN_BYTES (but an f32
    linear table above L1_BYTES from 3D direct), else direct; the route
    picked always fits the C side's reservation, and one row over each cap
    takes the next route."""
    rest = (2,) * (ndims - 1)
    item = torch.empty((), dtype=dtype).element_size()
    f32_linear = method == "linear" and dtype == F32

    def fits(route):
        return lambda dims: _c_smem(route, dims, dtype) <= _reserve(route)

    def in_l1(dims):
        return math.prod(dims) * item <= fused.L1_BYTES

    for cap in (fits("staged"), in_l1, fits("guided")):
        top = _over((2, *rest), cap)
        for d0 in (2, top - 1, top):
            dims = (d0, *rest)
            route = fused.rectilinear_route(dims, dtype, method)
            if f32_linear and fits("staged")(dims):
                want = "staged"
            elif f32_linear and ndims >= 3 and not in_l1(dims):
                want = "direct"
            else:
                want = "guided" if fits("guided")(dims) else "direct"
            assert route == want, (dims, route)
            if route != "direct":
                assert _c_smem(route, dims, dtype) <= _reserve(route)
    assert fused.rectilinear_route((20,) * 3, dtype, method) == (
        "staged" if f32_linear else "guided")
    assert fused.rectilinear_route((1000, 1000), dtype, method) == "guided"
    assert fused.rectilinear_route((100,) * 3, dtype, method) == (
        "direct" if f32_linear else "guided")
    assert fused.rectilinear_route((3000,) * 2, dtype, method) == "direct"
