"""The Hopper kernels on the card: against their plain versions, at grid
nodes, through the entry points, and under autograd; and the device timer.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernels run the plain versions' operations in the same order with no
FMA contraction, so the two are compared bit for bit.
"""

import math
import threading

import numpy as np
import pytest
import torch

import interpn_tpu_torch
from interpn_tpu_torch import config, convert, raw
from interpn_tpu_torch.models import MulticubicRegular, MultilinearRegular, NearestRegular
from interpn_tpu_torch.ops import (bspline, cubic, df64, dispatch, fused, i8, linear, nearest, stack,
                                   unrep)
from interpn_tpu_torch.utils import profiling
from interpn_tpu_torch.utils.testing import unrep_edge_cases

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


def _cap_dims(dtype, ndims, over):
    """A table of exactly STAGE_BYTES (one row more where `over`)."""
    at = fused.STAGE_BYTES // torch.empty((), dtype=dtype).element_size()
    dims = {1: (at,), 2: (at // 256, 256), 3: (at // 1024, 32, 32)}[ndims]
    return (dims[0] + over, *dims[1:])


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("over", [False, True], ids=["at_cap", "over_cap"])
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_routes_around_the_stage_cap(cuda, ndims, over, method, dtype):
    """K1 on a table of exactly the staging cap's bytes and one row over
    it: f32 linear staged, then quads; nearest, and f64, direct on both."""
    dims = _cap_dims(dtype, ndims, over)
    route = fused.regular_route(dims, dtype, method)
    f32_linear = method == "linear" and dtype == torch.float32
    assert route == ("quads" if over else "staged") if f32_linear else route == "direct"
    args = _case(dims, dtype, cuda, n=50_000, seed=ndims)
    fused.reset_launches()
    got = fused.eval_regular(*args, method)
    assert fused.launches[f"regular_{method}"] == 1
    assert fused.launches[fused.PACK] == int(route == "quads")
    _equal(got, fused.plain_regular(*args, method))


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dims", [(3,), (7, 9), (20, 20, 20)], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_staged_table_at_an_unaligned_offset(cuda, dims, offset, dtype):
    """A table that is a view `offset` entries into its storage: f32 linear
    stages it with its unaligned head and tail loaded apart from the bulk
    copy (f64 and nearest read it direct), and the staged route forced on
    f64 copies it the same way."""
    dims_, st, sp, vals, ob = _case(dims, dtype, cuda, n=20_000, seed=offset)
    storage = torch.zeros(offset + vals.numel() + 5, dtype=dtype, device=cuda)
    view = storage[offset:offset + vals.numel()]
    view.copy_(vals)
    assert view.data_ptr() % 16 != 0
    for method in ("linear", "nearest"):
        got = fused.eval_regular(dims_, st, sp, view, ob, method)
        _equal(got, fused.plain_regular(dims_, st, sp, view, ob, method))
        _equal(got, fused.eval_regular(dims_, st, sp, vals, ob, method))
    staged = fused._launch("fused_regular", "regular_linear", (0, 1, fused._is_f64(view)),
                           dims_, view, ob, ob[0].shape[0], False, st.data_ptr(),
                           sp.data_ptr(), None, route="staged")
    _equal(staged, fused.plain_regular(dims_, st, sp, view, ob))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_quads_at_100_cubed(cuda, dtype):
    """The bench's 100^3 table: linear f32 packs it (one pack a call) and
    reads quads, f64 reads it direct, as nearest does; all bitwise, the
    pack (f32 and f64) equal to plain_pack."""
    args = _case((100,) * 3, dtype, cuda, n=200_000, seed=3)
    dims, vals = args[0], args[3]
    quads = fused.regular_route(dims, dtype, "linear") == "quads"
    assert quads == (dtype == torch.float32)
    fused.reset_launches()
    got = fused.eval_regular(*args)
    assert fused.launches["regular_linear"] == 1 and fused.launches[fused.PACK] == quads
    _equal(got, linear.linear_regular(*args))
    _equal(fused.pack(dims, vals), fused.plain_pack(dims, vals))
    assert fused.regular_route(dims, dtype, "nearest") == "direct"
    _equal(fused.eval_regular(*args, "nearest"), nearest.nearest_regular(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_staged_grid_fits_the_shared_memory(cuda, dtype):
    """At the staging cap the shared memory admits two 1024-thread blocks
    an SM: the grid holds as many as the registers allow, at least one;
    every route's grid fits at least one block, a stack's too."""
    for nd in range(1, 9):
        for stacked in (False, True):
            info = fused.regular_info("linear", dtype, nd, "staged", stacked)
            warp_regs = -(-info["registers"] * 32 // 256) * 256  # allocated per warp in 256s
            by_registers = 65536 // (warp_regs * 32)
            assert info["blocks_per_sm"] == min(2, by_registers) >= 1, (nd, stacked, info)
        for method, route in (("linear", "quads"), ("linear", "direct"), ("nearest", "direct"),
                              ("cubic", "direct")):
            assert fused.regular_info(method, dtype, nd, route)["blocks_per_sm"] >= 1
            if route == "direct":
                assert fused.regular_info(method, dtype, nd, route, True)["blocks_per_sm"] >= 1
        for method in ("linear", "nearest"):
            info = fused.regular_info(method, dtype, nd, "interleaved", True)
            assert info["blocks_per_sm"] >= 1
        cubic = ["staged"] + (["taps"] if nd == 2 else ["tap_lanes"] if nd >= 3 else [])
        for route in cubic:
            assert fused.regular_info("cubic", dtype, nd, route)["blocks_per_sm"] >= 1


def test_staged_sizes_alternate_across_threads(cuda):
    """Two host threads, each on its own stream, alternate staged tables of
    two sizes (one above the default 48 KB of dynamic shared memory, one
    below) through the same instantiation: every launch succeeds and every
    result is bitwise the plain version's."""
    cases = [_case(dims, torch.float32, cuda, n=20_000, seed=i)
             for i, dims in enumerate(((160, 160), (60, 60)))]
    assert [fused.regular_route(c[0], torch.float32, "linear") for c in cases] == ["staged"] * 2
    assert math.prod(cases[0][0]) * 4 > 48 * 1024 > math.prod(cases[1][0]) * 4
    want = [fused.plain_regular(*c) for c in cases]
    errors = []

    def work(first):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                for i in range(40):
                    k = (first + i) % 2
                    got = fused.eval_regular(*cases[k])
                    stream.synchronize()
                    _equal(got, want[k])
        except Exception as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(first,)) for first in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_cubic_kernel_equals_plain(cuda, dims, dtype, lin):
    args = _case(dims, dtype, cuda, n=_n(dims, 20_000), seed=len(dims))
    got = _launched("regular_cubic", lambda: fused.eval_regular(*args, "cubic", lin))
    _equal(got, cubic.cubic_regular(*args, lin))


def _cubic_cap_dims(ndims, dtype):
    """Tables (d0, 4, ..., 4) at each cap of the cubic route and one row
    over it: the table at STAGE_BYTES and at L1_BYTES, the pack at
    TAP_BYTES (those that a 4-row table does not already exceed)."""
    rest = 4 ** (ndims - 1)
    item = torch.empty((), dtype=dtype).element_size()
    at = [fused.STAGE_BYTES // (rest * item), fused.L1_BYTES // (rest * item),
          fused.TAP_BYTES // (4 * rest * item) + 3]
    return [(d, *(4,) * (ndims - 1)) for d in sorted({d for a in at for d in (a, a + 1)
                                                      if d >= 4})]


@pytest.mark.parametrize("ndims", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_cubic_routes_around_the_caps(cuda, ndims, dtype):
    """K1 cubic on tables at and one row over each cap of its route, both
    extrapolation modes: bitwise the plain version; on the taps routes the
    cubic pack launched once a call, and equal to plain_cubic_pack."""
    for dims in _cubic_cap_dims(ndims, dtype):
        args = _case(dims, dtype, cuda, n=min(20_000, 2**24 // 4**ndims), seed=ndims)
        route = fused.regular_route(dims, dtype, "cubic")
        for lin in (True, False):
            fused.reset_launches()
            got = fused.eval_regular(*args, "cubic", lin)
            assert fused.launches["regular_cubic"] == 1
            assert fused.launches[fused.CUBIC_PACK] == int(route in fused.TAP_ROUTES)
            _equal(got, fused.plain_regular(*args, "cubic", lin))
        if route in fused.TAP_ROUTES:
            _equal(fused.cubic_pack(dims, args[3]), fused.plain_cubic_pack(dims, args[3]))


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dims", [(7, 9), (20,) * 3, (30,) * 3, (12,) * 4],
                         ids=lambda d: f"{d[0]}^{len(d)}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_cubic_table_at_an_unaligned_offset(cuda, dims, offset, dtype):
    """A cubic table that is a view `offset` entries into its storage, on
    the route its size picks (the table staged with its unaligned head and
    tail, or packed from the view): bitwise the plain version and the
    same table aligned."""
    dims_, st, sp, vals, ob = _case(dims, dtype, cuda, n=20_000, seed=offset)
    storage = torch.zeros(offset + vals.numel() + 5, dtype=dtype, device=cuda)
    view = storage[offset:offset + vals.numel()]
    view.copy_(vals)
    assert view.data_ptr() % 16 != 0
    for lin in (True, False):
        got = fused.eval_regular(dims_, st, sp, view, ob, "cubic", lin)
        _equal(got, fused.plain_regular(dims_, st, sp, view, ob, "cubic", lin))
        _equal(got, fused.eval_regular(dims_, st, sp, vals, ob, "cubic", lin))


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
] + [  # one linear or nearest table at and one row over each cap of its route
    (f"caps-{nd}d", method, True) for method in ("linear", "nearest") for nd in (1, 2, 3, 8)
] + [((2, 20, 2), m, True) for m in ("linear", "nearest")] + [
    ((1000, 1000), m, True) for m in ("linear", "nearest")]


def _lerp_cap_dims(ndims, dtype):
    """Tables (d0, 4, ..., 4) at and one row over each cap of one linear or
    nearest table's route: table and guide within STAGE_BYTES (staged), the
    table within L1_BYTES (guided f32 linear from 3D), the guide within
    COLUMN_BYTES (guided)."""
    item = torch.empty((), dtype=dtype).element_size()
    rest = (4,) * (ndims - 1)
    out = set()
    for fits in (lambda dims: fused.guide_fits("staged", dims, dtype),
                 lambda dims: math.prod(dims) * item <= fused.L1_BYTES,
                 lambda dims: fused.guide_fits("guided", dims, dtype)):
        d0 = 2
        while fits((d0, *rest)):
            d0 += 1
        out |= {(d, *rest) for d in (d0 - 1, d0) if d >= 2}
    return sorted(out)


def _adversarial(grids, n, seed):
    """n queries an axis from every knot, one ulp either side of it, every
    midpoint, NaN, +-inf, +-0 and points far outside the grid."""
    rng = np.random.default_rng(seed)
    obs = []
    for g in grids:
        a = g.cpu().numpy()
        npd = a.dtype.type
        big = np.finfo(npd).max
        pool = np.concatenate([
            a, np.nextafter(a, npd(np.inf)), np.nextafter(a, npd(-np.inf)),
            (a[:-1] + (a[1:] - a[:-1]) * npd(0.5)).astype(npd),
            np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, big, -big], dtype=npd)])
        obs.append(torch.as_tensor(rng.choice(pool, n), device=g.device))
    return tuple(obs)


def _rect_id(dims, method, lin):
    """caps-<n>d, <n>d for DIMS, the shape of any other table."""
    shape = dims if isinstance(dims, str) or dims in DIMS else "x".join(map(str, dims))
    return f"{method}-{lin}-{shape if isinstance(shape, str) else f'{len(dims)}d'}"


@pytest.mark.parametrize("dims,method,lin", RECT_CASES, ids=[_rect_id(*c) for c in RECT_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_kernel_equals_plain(cuda, dims, dtype, method, lin):
    """Every kernel through the wrapper (one launch) bitwise equal to the
    plain version; a linear or nearest table (K2 linear, K3) also on every
    route that takes it (direct, guided, and staged for linear, within their
    caps; over a cap the launch raises), on random and on adversarial
    queries."""
    tables = _lerp_cap_dims(int(dims[5:-1]), dtype) if isinstance(dims, str) else [dims]
    for dims in tables:
        grids, vals, obs = _rect_case(dims, dtype, cuda, n=_n(dims, 20_000), seed=len(dims))
        for ob in (obs, _adversarial(grids, 20_000, len(dims))):
            got = _launched(f"rectilinear_{method}",
                            lambda: fused.eval_rectilinear(grids, vals, ob, method, lin))
            if method == "cubic":  # the weights and their contraction
                want = fused.plain_rectilinear(grids, vals, ob, method, lin)
                _equal(got, want)
                break
            fn = linear.linear_rectilinear if method == "linear" else nearest.nearest_rectilinear
            want = fn(grids, vals, ob)
            _equal(got, want)
            cols = (fused._VOIDP * len(dims))(*(g.data_ptr() for g in grids))
            for route in ("direct", "guided", *(("staged",) if method == "linear" else ())):
                def on():
                    return fused._relaid_launch("rectilinear", route, fused.RECT_LAYOUTS, dims,
                                                vals, ob, method, True, ob[0].shape[0], False,
                                                cols)
                if route == "direct" or fused.guide_fits(route, dims, dtype):
                    _equal(on(), want)
                else:
                    _over_cap_raises(on)


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
    cols = (fused._VOIDP * 3)(*(g.data_ptr() for g in grids))
    for route in ("direct", "guided"):  # nearest on each of its routes
        got = fused._relaid_launch("rectilinear", route, fused.RECT_LAYOUTS, (20,) * 3, vals_t,
                                   obs, "nearest", True, obs[0].shape[0], False, cols)
        assert torch.equal(got, vals_t), route


def _rect_grid(dims, dtype, device, seed):
    """Jittered sorted axes of `dims` on the device."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(np.cumsum(0.2 + rng.random(d)), dtype=dtype, device=device)
                 for d in dims)


def _rect_obs(grids, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(_obs(rng, float(g[0]), float(g[-1]), n), dtype=g.dtype,
                                 device=g.device) for g in grids)


def _spoil(vals, seed):
    """A copy of the table (or stack) with a NaN, +inf and -inf inside."""
    rng = np.random.default_rng(seed)
    out = vals.clone().reshape(-1)
    spots = torch.as_tensor(rng.choice(out.numel(), 3, replace=False), device=vals.device)
    out[spots] = torch.tensor([math.nan, math.inf, -math.inf], dtype=vals.dtype,
                              device=vals.device)
    return out.reshape(vals.shape)


@pytest.mark.parametrize("ndims", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_cubic_routes_around_the_caps(cuda, ndims, dtype):
    """K2 cubic on tables at and one row over each cap of its route
    (`fused.rectilinear_route`: staged, the cubic pack, direct), both
    extrapolation modes, on a random table and on the same
    table with a NaN and infinities inside: bitwise the plain version (where
    a contraction is not finite, the gather tree's value); the cubic pack
    launched once a call on the taps routes."""
    for dims in _cubic_cap_dims(ndims, dtype):
        grids = _rect_grid(dims, dtype, cuda, seed=ndims)
        obs = _rect_obs(grids, min(20_000, 2**24 // 4**ndims), seed=ndims)
        vals = torch.as_tensor(np.random.default_rng(ndims).standard_normal(math.prod(dims)),
                               dtype=dtype, device=cuda)
        route = fused.rectilinear_route(dims, dtype, "cubic")
        for table, lin in ((vals, True), (vals, False), (_spoil(vals, ndims), True)):
            fused.reset_launches()
            got = fused.eval_rectilinear(grids, table, obs, "cubic", lin)
            want = {"rectilinear_cubic": 1,
                    fused.RECT_CUBIC_PACK: int(route in fused.TAP_ROUTES)}
            assert fused.launches == {k: want.get(k, 0) for k in fused.launches}, dims
            _equal(got, fused.plain_rectilinear(grids, table, obs, "cubic", lin))


@pytest.mark.parametrize("route", ["staged", "taps", "direct"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_cubic_every_route_at_20_cubed(cuda, route, dtype):
    """Each cubic route of K2's entry on the same 20^3 table: bitwise the
    plain version, at the grid's nodes the table itself, and where the
    table holds a NaN or an infinity the gather tree's value."""
    dims = (20, 20, 20)
    grids = _rect_grid(dims, dtype, cuda, seed=5)
    vals = torch.as_tensor(np.random.default_rng(5).standard_normal(8000), dtype=dtype,
                           device=cuda)
    cols = (fused._VOIDP * 3)(*(g.data_ptr() for g in grids))

    def on_route(table, obs, lin):
        return fused._relaid_launch("rectilinear", route, fused.RECT_LAYOUTS, dims, table,
                                    obs, "cubic", lin, obs[0].shape[0], False, cols)

    obs = _rect_obs(grids, 20_000, seed=6)
    spoilt = _spoil(vals, 6)
    for lin in (True, False):
        _equal(on_route(vals, obs, lin), fused.plain_rectilinear(grids, vals, obs, "cubic", lin))
        got = on_route(spoilt, obs, lin)
        _equal(got, fused.plain_rectilinear(grids, spoilt, obs, "cubic", lin))
        tree = cubic.cubic_rectilinear(grids, spoilt, obs, lin)
        off = ~torch.isfinite(got)
        _equal(got[off], tree[off])
        nodes = tuple(g[torch.from_numpy(i).to(cuda)] for g, i in zip(grids, _nodes()))
        assert torch.equal(on_route(vals, nodes, lin), vals), (route, lin)


@pytest.mark.parametrize("n,nch", [(20, 1), (20, 3), (20, 4), (20, 8), (40, 3), (40, 8)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_cubic_stacks(cuda, n, nch, lin, dtype):
    """K6 cubic on 20^3 stacks of 1, 3, 4 and 8 tables, and on 40^3 stacks
    of 3 and 8: staged while the stack fits STAGE_BYTES, a table at a time
    while each table does, else interleaved from 8 f32 or 4 f64 tables,
    else direct; bitwise against the plain version (one weight build for
    every table) and, table by table, against K2; with a NaN and infinities
    in some tables."""
    dims = (n, n, n)
    grids = _rect_grid(dims, dtype, cuda, seed=nch)
    obs = _rect_obs(grids, 20_000, seed=nch)
    vals = torch.as_tensor(np.random.default_rng(nch).standard_normal((nch, n**3)),
                           dtype=dtype, device=cuda)
    route = fused.rectilinear_route(dims, dtype, "cubic", nch)
    size = n**3 * vals.element_size()
    if size * nch <= fused.STAGE_BYTES:
        assert route == "staged"
    elif size <= fused.STAGE_BYTES:
        assert route == "staged_tables"
    else:
        # at 3D f64 stacks of 4 are interleaved too
        assert route == ("interleaved" if nch * vals.element_size() >= 32 else "direct")
    for table in (vals, _spoil(vals, nch)):
        fused.reset_launches()
        got = fused.eval_rectilinear_stack(grids, table, obs, "cubic", lin)
        want = {"rectilinear_cubic_stack": 1, fused.RECT_INTERLEAVE: int(route == "interleaved")}
        assert fused.launches == {k: want.get(k, 0) for k in fused.launches}
        _equal(got, fused.plain_rectilinear_stack(grids, table, obs, "cubic", lin))
        for c in range(nch):
            _equal(got[c], fused.eval_rectilinear(grids, table[c], obs, "cubic", lin))


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("nch", [None, 3], ids=["table", "stack3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_cubic_staged_at_an_unaligned_offset(cuda, offset, nch, dtype):
    """A staged table or stack that is a view `offset` entries into its
    storage: bitwise the plain version and the same values aligned."""
    dims = (12, 10, 9)
    grids = _rect_grid(dims, dtype, cuda, seed=offset)
    obs = _rect_obs(grids, 20_000, seed=offset)
    shape = (nch, 1080) if nch else (1080,)
    vals = torch.as_tensor(np.random.default_rng(offset).standard_normal(shape), dtype=dtype,
                           device=cuda)
    storage = torch.zeros(offset + vals.numel() + 5, dtype=dtype, device=cuda)
    view = storage[offset:offset + vals.numel()].view(shape)
    view.copy_(vals)
    assert fused.rectilinear_route(dims, dtype, "cubic", nch) == "staged"
    kern = fused.eval_rectilinear_stack if nch else fused.eval_rectilinear
    plain = fused.plain_rectilinear_stack if nch else fused.plain_rectilinear
    for lin in (True, False):
        got = kern(grids, view, obs, "cubic", lin)
        _equal(got, plain(grids, view, obs, "cubic", lin))
        _equal(got, kern(grids, vals, obs, "cubic", lin))


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype,nch", [(torch.float32, 4), (torch.float64, 3)],
                         ids=["float32-stack4", "float64-stack3"])
def test_rectilinear_cubic_staged_tables_at_unaligned_offsets(cuda, offset, dtype, nch):
    """A stack a table at a time (`staged_tables`) whose tables' bytes are
    no multiple of 16 (21^3 entries), so that most tables start off a
    16-byte boundary and their copies load an unaligned head and tail
    apart from the `cp.async` middle, aligned and as a view `offset` entries
    into its storage: bitwise the plain version and the same values
    aligned, with a NaN and infinities in some tables."""
    dims = (21, 21, 21)
    assert math.prod(dims) * torch.finfo(dtype).bits // 8 % 16 != 0
    grids = _rect_grid(dims, dtype, cuda, seed=offset)
    obs = _rect_obs(grids, 20_000, seed=offset)
    vals = torch.as_tensor(np.random.default_rng(offset).standard_normal((nch, 21**3)),
                           dtype=dtype, device=cuda)
    assert fused.rectilinear_route(dims, dtype, "cubic", nch) == "staged_tables"
    for table in (vals, _spoil(vals, offset)):
        storage = torch.zeros(offset + table.numel() + 5, dtype=dtype, device=cuda)
        view = storage[offset:offset + table.numel()].view(table.shape)
        view.copy_(table)
        for lin in (True, False):
            got = fused.eval_rectilinear_stack(grids, view, obs, "cubic", lin)
            _equal(got, fused.plain_rectilinear_stack(grids, view, obs, "cubic", lin))
            _equal(got, fused.eval_rectilinear_stack(grids, table, obs, "cubic", lin))


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
    # the cubic table's route lays it out first (the cubic pack, once a call)
    taps = fused.regular_route((6, 5, 7), torch.float32, "cubic") in fused.TAP_ROUTES
    for kernel, call in calls.items():
        fused.reset_launches()
        out = call()
        assert out.device.type == "cuda", kernel
        assert out.shape == ((10, 100) if kernel.startswith("regular") else (1000,)), kernel
        want = {kernel: 1, fused.CUBIC_PACK: int(taps and kernel == "regular_cubic")}
        assert fused.launches == {k: want.get(k, 0) for k in fused.launches}, kernel


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
        if kernel == "rectilinear_cubic":
            # interpn() on the CPU runs the gather tree; the kernel's own
            # function on the CPU is its plain version, the weight
            # contraction, which holds the tree at the f32 bar
            plain = fused.eval_rectilinear(
                [torch.from_numpy(a) for a in axes], torch.from_numpy(vals),
                [torch.from_numpy(o) for o in obs], "cubic", True).numpy()
            np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-4)
            want = plain
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


@pytest.mark.parametrize("nch", [1, 3, 4, 8])
@pytest.mark.parametrize("method,lin", [("linear", True), ("cubic", True), ("cubic", False),
                                        ("nearest", True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_stacks_around_the_stage_cap(cuda, nch, method, lin, dtype):
    """K5 on 20^3 stacks of 1, 3, 4 and 8 tables: f32 linear staged up to 3
    tables (the whole stack within the cap, read table by table), linear
    and nearest interleaved from 8 f32 or 4 f64 tables, cubic staged in
    groups of tables, the rest direct; bitwise against the plain
    version and, table by table, against the single-table kernel."""
    rng = np.random.default_rng(nch)
    dims, st, sp, _, ob = _case((20, 20, 20), dtype, cuda, n=20_000, seed=nch)
    vals = torch.as_tensor(rng.standard_normal((nch, 8000)), dtype=dtype, device=cuda)
    interleaved = fused.regular_route(dims, dtype, method, nch) == "interleaved"
    assert interleaved == (method != "cubic" and nch * vals.element_size() >= 32)
    fused.reset_launches()
    got = fused.eval_regular_stack(dims, st, sp, vals, ob, method, lin)
    want = {f"regular_{method}_stack": 1, fused.INTERLEAVE: int(interleaved)}
    assert fused.launches == {k: want.get(k, 0) for k in fused.launches}
    _equal(got, fused.plain_regular_stack(dims, st, sp, vals, ob, method, lin))
    for c in range(nch):
        _equal(got[c], fused.eval_regular(dims, st, sp, vals[c], ob, method, lin))


@pytest.mark.parametrize("nch", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_interleave_equals_plain(cuda, nch, dtype):
    """The interleaved route's layout kernel alone: (prod(dims), nch) with a
    corner's channels side by side, equal to plain_interleave, one launch."""
    rng = np.random.default_rng(nch)
    for entries in (1, 50, 8000, 65536):
        vals = torch.as_tensor(rng.standard_normal((nch, entries)), dtype=dtype, device=cuda)
        fused.reset_launches()
        got = fused.interleave(vals)
        assert fused.launches[fused.INTERLEAVE] == 1
        _equal(got, fused.plain_interleave(vals))


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


def _at_offset(vals, offset):
    """`vals` as a view `offset` entries into a larger storage."""
    storage = torch.zeros(offset + vals.numel() + 5, dtype=vals.dtype, device=vals.device)
    view = storage[offset:offset + vals.numel()].view(vals.shape)
    view.copy_(vals)
    return view


def _stack_routes(dims, dtype, kernel):
    """Every route of a K5 cubic (`kernel` "regular") or K7 ("bspline")
    stack that takes these tables: staged groups (each table within
    GROUP_BYTES), the cubic packs of K5 (taps at 2D, tap lanes from 3D, at
    any size, so wherever the rule admits them), interleaved (K7),
    direct."""
    routes = ["direct"]
    if math.prod(dims) * torch.empty((), dtype=dtype).element_size() <= fused.GROUP_BYTES:
        routes.append("staged_groups")
    if kernel == "regular" and len(dims) >= 2:
        routes.append("taps" if len(dims) == 2 else "tap_lanes")
    if kernel == "bspline":
        routes.append("interleaved")
    return routes


def _on_stack_route(dims, st, sp, vals, ob, lin, route):
    """K5 cubic through `fused._relaid_launch` on `route`, with the buffer of
    its layout (the stack's cubic packs on the taps routes)."""
    return fused._relaid_launch("regular", route, fused.STACK_LAYOUTS, dims, vals, ob, "cubic",
                                lin, ob[0].shape[0], True, st.data_ptr(), sp.data_ptr())


# stacks of 1 to 6 groups of 20^3 and 21^3 tables: 7 f32 and 3 f64 20^3
# tables fit GROUP_BYTES, 6 f32 and 3 f64 21^3 ones
STACKS = [1, 3, 4, 8, 9, 17]


@pytest.mark.parametrize("n", [20, 21], ids=lambda n: f"{n}^3")
@pytest.mark.parametrize("nch", STACKS)
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_cubic_stack_routes(cuda, n, nch, offset, dtype):
    """K5 cubic on every route that takes the stack (the wrapper's, one
    launch and no layout kernel; the C entry splits the stack into groups
    by its size), in both extrapolation modes, on 20^3 and
    21^3 tables (bytes no multiple of 16) aligned and as a view at an odd
    offset, with a NaN, +inf and -inf in the tables: bitwise against the
    plain version, each row against K1 on its table."""
    dims, st, sp, _, ob = _case((n,) * 3, dtype, cuda, n=20_000, seed=nch + n)
    rng = np.random.default_rng(nch)
    vals = torch.as_tensor(rng.standard_normal((nch, n**3)), dtype=dtype, device=cuda)
    vals.view(-1)[torch.as_tensor(rng.choice(vals.numel(), 3, replace=False), device=cuda)] = (
        torch.tensor(BAD, dtype=dtype, device=cuda))
    vals = _at_offset(vals, offset) if offset else vals
    assert fused.regular_route(dims, dtype, "cubic", nch) == "staged_groups"
    for lin in (True, False):
        want = fused.plain_regular_stack(dims, st, sp, vals, ob, "cubic", lin)
        rows = [fused.eval_regular(dims, st, sp, vals[c], ob, "cubic", lin) for c in range(nch)]
        fused.reset_launches()
        _equal(fused.eval_regular_stack(dims, st, sp, vals, ob, "cubic", lin), want)
        assert fused.launches == {k: int(k == "regular_cubic_stack") for k in fused.launches}
        for r in _stack_routes(dims, dtype, "regular"):
            got = _on_stack_route(dims, st, sp, vals, ob, lin, r)
            _equal(got, want)
            for c in range(nch):
                _equal(got[c], rows[c])


# tables just above GROUP_BYTES (229,376 bytes) at 2-5D: the f64 2D and 3D
# ones within L1_BYTES, which the rule leaves direct in a stack of one
PACKED_STACK_DIMS = {torch.float32: [(240, 240), (39,) * 3, (16, 16, 16, 15), (9,) * 5],
                     torch.float64: [(170, 170), (31,) * 3, (13, 13, 13, 14), (8,) * 5]}


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=["2d", "3d", "4d", "5d"])
@pytest.mark.parametrize("nch", [1, 3, 8, 9])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_cubic_stack_packed_routes(cuda, which, nch, offset, dtype):
    """K5 cubic on stacks of tables just above GROUP_BYTES, aligned and as a
    view at an odd offset, with a NaN, +inf and -inf in the tables, both
    extrapolation modes: the wrapper's route (the tables' cubic packs, one
    lane a query at 2D and four from 3D, but direct for one f64 table
    within L1_BYTES at 2D and 3D)
    one K5 launch and, where it packs, one launch of the stack's pack and
    none of K1's; every route bitwise against the plain version and the
    direct route, each row against K1 on its table; the stack's pack alone
    equal to `plain_cubic_stack_pack`."""
    dims = PACKED_STACK_DIMS[dtype][which]
    item = torch.empty((), dtype=dtype).element_size()
    assert math.prod(dims) * item > fused.GROUP_BYTES
    dims, st, sp, _, ob = _case(dims, dtype, cuda, n=10_000, seed=nch + len(dims))
    rng = np.random.default_rng(nch + offset)
    vals = torch.as_tensor(rng.standard_normal((nch, math.prod(dims))), dtype=dtype,
                           device=cuda)
    vals.view(-1)[torch.as_tensor(rng.choice(vals.numel(), 3, replace=False), device=cuda)] = (
        torch.tensor(BAD, dtype=dtype, device=cuda))
    vals = _at_offset(vals, offset) if offset else vals
    route = fused.regular_route(dims, dtype, "cubic", nch)
    in_l1 = dtype == torch.float64 and len(dims) <= 3 and nch == 1
    assert route == ("direct" if in_l1 else "taps" if len(dims) == 2 else "tap_lanes")
    for lin in (True, False):
        want = fused.plain_regular_stack(dims, st, sp, vals, ob, "cubic", lin)
        rows = [fused.eval_regular(dims, st, sp, vals[c], ob, "cubic", lin) for c in range(nch)]
        direct = _on_stack_route(dims, st, sp, vals, ob, lin, "direct")
        _equal(direct, want)
        fused.reset_launches()
        _equal(fused.eval_regular_stack(dims, st, sp, vals, ob, "cubic", lin), want)
        packs = {"regular_cubic_stack": 1, fused.CUBIC_STACK_PACK: int(route != "direct")}
        assert fused.launches == {k: packs.get(k, 0) for k in fused.launches}
        for r in _stack_routes(dims, dtype, "regular"):
            got = _on_stack_route(dims, st, sp, vals, ob, lin, r)
            _equal(got, want)
            _equal(got, direct)
            for c in range(nch):
                _equal(got[c], rows[c])
    fused.reset_launches()
    packed = fused.cubic_stack_pack(dims, vals.contiguous())
    assert fused.launches[fused.CUBIC_STACK_PACK] == 1
    _equal(packed, fused.plain_cubic_stack_pack(dims, vals.contiguous()))


@pytest.mark.parametrize("nch", STACKS)
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bspline_stack_routes(cuda, nch, k, offset, dtype):
    """K7 on every route that takes the stack, on 21^3 coefficient tables
    (bytes no multiple of 16) aligned and at an odd offset: the wrapper's
    route one launch (and the interleave one where it interleaves); every
    route bitwise against the plain version, each row against K4."""
    dims = (21,) * 3
    kt, ct, obs = _spline_case(dims, k, dtype, cuda, 20_000, nch=nch, seed=nch + k)
    ct = _at_offset(ct, offset) if offset else ct.contiguous()
    want = fused.plain_bspline_stack(kt, ct, obs, k)
    rows = [fused.eval_bspline(kt, ct[c], obs, k) for c in range(nch)]
    route = fused.bspline_route(dims, dtype, k, nch)
    fused.reset_launches()
    _equal(fused.eval_bspline_stack(kt, ct, obs, k), want)
    layout = fused.BSPLINE_LAYOUTS.get(route)
    assert fused.launches == {name: int(name in (f"bspline_k{k}_stack", layout))
                              for name in fused.launches}
    knots = (fused._VOIDP * 3)(*(t.data_ptr() for t in kt))
    for r in _stack_routes(dims, dtype, "bspline"):
        work = torch.empty(ct.numel(), dtype=dtype, device=cuda) if r == "interleaved" else None
        got = fused._launch("fused_bspline_stack", f"bspline_k{k}_stack",
                            (k, fused._is_f64(ct)), dims, ct, obs, obs[0].shape[0], True, knots,
                            None if work is None else work.data_ptr(), route=r)
        _equal(got, want)
        for c in range(nch):
            _equal(got[c], rows[c])


def _spoil_flat(vals, rng):
    """A NaN, +inf and -inf at random entries of each table of `vals`."""
    flat = vals.reshape(-1)
    spots = rng.choice(flat.numel(), 3 * max(1, flat.numel() // vals.shape[-1]), replace=False)
    flat[torch.as_tensor(spots, device=vals.device)] = torch.tensor(
        BAD * (len(spots) // 3), dtype=vals.dtype, device=vals.device)
    return vals


def _over_cap_raises(launch):
    """A staged launch over its cap raises (the C entry's
    cudaErrorInvalidValue) and gives way to no other route."""
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        launch()


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bspline_table_routes(cuda, k, offset, dtype):
    """K4 on every route that takes one table (staged groups, direct), at
    and one row over the staging cap and at 20^3, aligned and at an odd
    offset, with a NaN, +inf and -inf in the table: the wrapper's route one
    launch, every route bitwise against the plain version; a staged launch
    over the cap raises."""
    rng = np.random.default_rng(k + offset)
    item = torch.empty((), dtype=dtype).element_size()
    at = fused.GROUP_BYTES // (36 * item)
    shapes = [(20,) * 3, (at, 6, 6), (at + 1, 6, 6)]
    for dims in shapes:
        kt, ct, obs = _spline_case(dims, k, dtype, cuda, 5_000, seed=dims[0])
        ct = _spoil_flat(ct.clone()[None], rng)[0]
        ct = _at_offset(ct, offset) if offset else ct
        want = fused.plain_bspline(kt, ct, obs, k)
        fused.reset_launches()
        _equal(fused.eval_bspline(kt, ct, obs, k), want)
        assert fused.launches == {name: int(name == f"bspline_k{k}") for name in fused.launches}
        cols = (fused._VOIDP * 3)(*(t.data_ptr() for t in kt))

        def on(route):
            return fused._launch("fused_bspline", f"bspline_k{k}", (k, fused._is_f64(ct)), dims,
                                 ct, obs, obs[0].shape[0], False, cols, None, route=route)
        _equal(on("direct"), want)
        if math.prod(dims) * item > fused.GROUP_BYTES:
            _over_cap_raises(lambda: on("staged_groups"))
        else:
            _equal(on("staged_groups"), want)


@pytest.mark.parametrize("nch", [1, 3, 8, 17])
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_linear_stack_routes(cuda, nch, method, offset, dtype):
    """K6 linear and nearest on every route that takes the stack (direct,
    interleaved, staged for linear within its cap) on 20^3 tables and on an
    f32 stack at and one row over STAGE_BYTES, aligned and at an odd offset,
    with a NaN, +inf and -inf in every table: the wrapper's route one launch
    (and the interleave where it interleaves), every route bitwise against
    the plain version, each row against K2 / K3 on its table; a staged
    launch over the cap raises."""
    rng = np.random.default_rng(nch + offset)
    at = fused.STAGE_BYTES // (nch * 16 * 16 * 4)
    for dims in ((20,) * 3, (at, 16, 16), (at + 1, 16, 16)):
        grids, _, ob = _rect_case(dims, dtype, cuda, n=10_000, seed=nch + dims[0])
        vals = torch.as_tensor(rng.standard_normal((nch, math.prod(dims))), dtype=dtype,
                               device=cuda)
        vals = _spoil_flat(vals, rng)
        vals = _at_offset(vals, offset) if offset else vals
        want = fused.plain_rectilinear_stack(grids, vals, ob, method)
        rows = [fused.eval_rectilinear(grids, vals[c], ob, method) for c in range(nch)]
        route = fused.rectilinear_route(dims, dtype, method, nch)
        fused.reset_launches()
        _equal(fused.eval_rectilinear_stack(grids, vals, ob, method), want)
        layout = fused.RECT_LAYOUTS.get(route)
        assert fused.launches == {k: int(k in (f"rectilinear_{method}_stack", layout))
                                  for k in fused.launches}
        cols = (fused._VOIDP * 3)(*(g.data_ptr() for g in grids))

        def on(r):
            return fused._relaid_launch("rectilinear", r, fused.RECT_LAYOUTS, dims, vals, ob,
                                        method, True, ob[0].shape[0], True, cols)
        for r in ("direct", "interleaved", *(("staged",) if method == "linear" else ())):
            if r == "staged" and vals.numel() * vals.element_size() > fused.STAGE_BYTES:
                _over_cap_raises(lambda: on(r))
                continue
            got = on(r)
            _equal(got, want)
            for c in range(nch):
                _equal(got[c], rows[c])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rectilinear_interleave_equals_plain(cuda, dtype):
    """The rectilinear source's interleave alone: equal to plain_interleave,
    one launch of its own count."""
    rng = np.random.default_rng(5)
    for nch, entries in ((1, 50), (3, 8000), (8, 8000), (17, 4096)):
        vals = torch.as_tensor(rng.standard_normal((nch, entries)), dtype=dtype, device=cuda)
        fused.reset_launches()
        got = fused.interleave(vals, "rectilinear")
        assert fused.launches == {k: int(k == fused.RECT_INTERLEAVE) for k in fused.launches}
        _equal(got, fused.plain_interleave(vals))


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


# --- the f64 contraction engines (K8, K9) -------------------------------------------


def _engine_calls(engine, kind, dims, method, lin, device, n, seed):
    """(the engine's wrapper, its plain chain) on one random grid of `kind`
    with `_case`-like queries (NaN and +-inf mixed in), all on `device`:
    each a function of nothing returning the (n,) float64 result."""
    module = df64 if engine == "df64" else i8
    if kind == "regular":
        args = (dims, *_case(dims, torch.float64, device, n, seed)[1:], method, lin)
        return (lambda: module.eval_regular(*args)), (lambda: module.plain_regular(*args))
    if kind == "rectilinear":
        args = (*_rect_case(dims, torch.float64, device, n, seed), method, lin)
        return (lambda: module.eval_rectilinear(*args)), (lambda: module.plain_rectilinear(*args))
    args = (*_spline_case(dims, method, torch.float64, device, n, seed=seed), method)
    return (lambda: df64.eval_bspline(*args)), (lambda: df64.plain_bspline(*args))


def _one_launch_equal(monkeypatch, engine, kern, plain):
    """The wrapper launches its kernel once and builds no weights in torch;
    its result is the plain chain's, bit for bit."""
    built = []
    for module, name in ((df64, "weights_f64"), (df64, "spline_weights_f64"),
                         (i8, "weights_f64")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn: built.append(1) or _f(*a))
    got = _launched(engine, kern)
    assert not built
    monkeypatch.undo()
    _equal(got, plain())


F64_CASES = [(kind, dims, method, lin)
             for dims in DIMS[1:]
             for kind, method, lin in (("regular", "linear", True), ("regular", "cubic", True),
                                       ("regular", "cubic", False),
                                       ("rectilinear", "linear", True),
                                       ("rectilinear", "cubic", False))]


@pytest.mark.parametrize("kind,dims,method,lin", F64_CASES,
                         ids=[f"{k}-{m}-{lin}-{len(d)}d" for k, d, m, lin in F64_CASES])
def test_df64_kernel_equals_plain(cuda, monkeypatch, kind, dims, method, lin):
    """K8's one launch (weights, contraction, recombination) against the
    plain chain, with extrapolated, NaN and +-inf queries."""
    kern, plain = _engine_calls("df64", kind, dims, method, lin, cuda, _n(dims, 20_000), 3)
    _one_launch_equal(monkeypatch, "df64", kern, plain)


@pytest.mark.parametrize("dims", DIMS[1:], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("k", [3, 5])
def test_df64_spline_kernel_equals_plain(cuda, monkeypatch, dims, k):
    dims = tuple(max(d, k + 1) for d in dims)
    n = max(64, min(20_000, 2**24 // (k + 1) ** len(dims)))
    kern, plain = _engine_calls("df64", "bspline", dims, k, True, cuda, n, 4)
    _one_launch_equal(monkeypatch, "df64", kern, plain)


@pytest.mark.parametrize("scale", [2.0**115, 2.0**117, 2.0**-100, 2.0**-120])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_df64_at_the_float_range_edges(cuda, monkeypatch, scale, method):
    """K8 where TwoProd's error from one FMA would part from Dekker's
    product (a split of 4097 a overflowing from 2^116, partial products
    underflowing below 2^-103): tables scaled there, ordinary entries
    beside them, bitwise equal to the plain chain."""
    dims = (9, 8, 10)
    _, st, sp, vals, obs = _case(dims, torch.float64, cuda, 5000, seed=8)
    vals = vals * scale
    vals[::7] /= scale
    args = (dims, st, sp, vals, obs, method, True)
    _one_launch_equal(monkeypatch, "df64", lambda: df64.eval_regular(*args),
                      lambda: df64.plain_regular(*args))


I8_CASES = [(kind, dims, method, lin)
            for dims in DIMS[1:] + [(12, 12, 12, 12)]
            for kind, method, lin in (("regular", "linear", True), ("regular", "cubic", True),
                                      ("regular", "cubic", False),
                                      ("rectilinear", "cubic", False))]


@pytest.mark.parametrize("kind,dims,method,lin", I8_CASES,
                         ids=[f"{k}-{m}-{lin}-{'x'.join(map(str, d))}" for k, d, m, lin in I8_CASES])
def test_i8_kernel_equals_plain(cuda, monkeypatch, kind, dims, method, lin):
    """K9's one launch (weights, quantization, piece products by `__dp4a`
    up to 16 trailing entries and on the int8 tensor cores above,
    recombination) against the plain chain."""
    kern, plain = _engine_calls("i8", kind, dims, method, lin, cuda, _n(dims, 5_000), 5)
    _one_launch_equal(monkeypatch, "i8", kern, plain)


def test_engine_instantiations_keep_off_local_arrays(cuda):
    """K9's instantiations of the engine paths hold no per-entry array in
    local memory (the first K9 kept 656-8,464 bytes of weight pieces a
    thread there from 64 trailing entries): at most a spill slot or two at
    E = 4, 16 and 64."""
    frames = {(fp, nd): fused.engine_info("i8", fp, nd, i8._choose_group((n,) * nd))
              ["local_bytes"] for fp, n, nd in ((2, 20, 3), (4, 20, 3), (4, 12, 5))}
    assert max(frames.values()) <= 512, frames


def test_forced_engines_route_and_agree(cuda, monkeypatch):
    """INTERPN_TPU_F64=df64|i8 sends f64 CUDA linear/cubic (and splines, to
    K8) to the engines, within the JAX package's bars of the native kernel;
    nearest, f32 and non-finite tables keep their kernels."""
    dims, st, sp, vals, _ = _case((9, 8, 10), torch.float64, cuda, n=2000, seed=6)
    kt, ct, _ = _spline_case((9, 8, 10), 3, torch.float64, cuda, n=2000, seed=6)
    # queries up to one cell past each side, the JAX package's test range
    u = torch.rand(3, 2000, dtype=torch.float64, device=cuda, generator=torch.Generator(cuda))
    obs = tuple(st[k] + sp[k] * (u[k] * (dims[k] + 1) - 1) for k in range(3))
    sob = tuple(t[3] + u[k] * (t[-4] - t[3]) for k, t in enumerate(kt))
    native = {"linear": dispatch.linear_regular(dims, st, sp, vals, obs),
              "cubic": dispatch.cubic_regular(dims, st, sp, vals, obs, True),
              "spline": dispatch.bspline_eval(kt, ct, sob, 3)}
    for engine in ("df64", "i8"):
        monkeypatch.setenv("INTERPN_TPU_F64", engine)
        for name, call, kernel, tol in (
                ("linear", lambda: dispatch.linear_regular(dims, st, sp, vals, obs), engine, 1e-13),
                ("cubic", lambda: dispatch.cubic_regular(dims, st, sp, vals, obs, True), engine,
                 1e-12),
                ("spline", lambda: dispatch.bspline_eval(kt, ct, sob, 3), "df64", 1e-12)):
            fused.reset_launches()
            got = call()
            assert fused.launches == {k: int(k == kernel) for k in fused.launches}, (engine, name)
            torch.testing.assert_close(got, native[name], rtol=tol, atol=tol)
        for call, kernel in ((lambda: dispatch.nearest_regular(dims, st, sp, vals, obs),
                              "regular_nearest"),
                             (lambda: dispatch.linear_regular(dims, st.float(), sp.float(),
                                                              vals.float(), [o.float() for o in obs]),
                              "regular_linear")):
            fused.reset_launches()
            call()
            assert fused.launches == {k: int(k == kernel) for k in fused.launches}, engine
        bad = vals.clone()
        bad[5] = float("nan")
        fused.reset_launches()
        dispatch.cubic_regular(dims, st, sp, bad, obs, True)
        assert fused.launches == {k: int(k == "regular_cubic") for k in fused.launches}, engine


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_forced_engine_caches_numpy_tables_by_content(cuda, monkeypatch, engine):
    """raw called twice with one numpy table (a fresh CUDA tensor each
    call) prepares the table once: one host decomposition (i8), one split
    (df64), and no copy of the table kept in the cache."""
    monkeypatch.setenv("INTERPN_TPU_F64", engine)
    built = []
    decompose, split = i8.decompose, df64.split_f64
    monkeypatch.setattr(i8, "decompose", lambda *a: built.append("i8") or decompose(*a))
    monkeypatch.setattr(df64, "split_f64", lambda a: built.append(a.numel()) or split(a))
    rng = np.random.default_rng(11)
    dims = np.array([9, 8, 10])
    starts, steps = np.zeros(3), np.ones(3)
    vals = rng.standard_normal(720)
    obs = [rng.uniform(0, d - 1, 300) for d in dims]
    cache = df64._SPLITS if engine == "df64" else i8._PREPS
    before = set(cache.entries)
    outs = []
    for _ in range(2):
        out = np.zeros(300)
        fused.reset_launches()
        interpn_tpu_torch.raw.interpn_cubic_regular_f64(dims, starts, steps, vals, True, obs, out)
        assert fused.launches[engine] == 1
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert built.count("i8" if engine == "i8" else 720) == 1
    (key,) = set(cache.entries) - before
    assert key[0] == "h" and cache.entries[key][0] is None


def test_forced_engine_grads_equal_cpu_grads(cuda, monkeypatch):
    dims = (5, 4, 6)
    cpu_args = _case(dims, torch.float64, "cpu", n=500, seed=5)
    cpu_args = (*cpu_args[:4], tuple(torch.nan_to_num(o, posinf=9.0, neginf=-9.0)
                                     for o in cpu_args[4]))
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal(500))
    for engine in ("df64", "i8"):
        monkeypatch.setenv("INTERPN_TPU_F64", engine)
        grads = {}
        for dev in ("cpu", cuda):
            leaves = [t.detach().to(dev).requires_grad_() for t in (*cpu_args[1:4], *cpu_args[4])]
            fused.reset_launches()
            dispatch.cubic_regular(dims, *leaves[:3], leaves[3:], False).backward(cot.to(dev))
            assert fused.launches[engine] == int(dev != "cpu")
            grads[str(dev)] = _grads(leaves)
        for a, b in zip(grads["cpu"], grads[str(cuda)]):
            torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12, msg=engine)


# --- the unrepresentable-coordinate flag (csrc/unrep_flag.cu) ---------------------------

FLAG_NS = (1, 3, 4, 5, 1023, 1_000_003)


def _flag_equal(starts, steps, cols, expect=None):
    """The kernel's flag is the plain passes' on the same inputs, after one
    launch; and `expect` where given."""
    before = unrep.launches
    got = unrep.flag(starts, steps, cols)
    assert unrep.launches == before + 1
    want = unrep.plain(starts, steps, cols)
    assert got.dtype == torch.bool and got.shape == () and got.device == starts.device
    assert bool(got) == bool(want)
    if expect is not None:
        assert bool(got) == expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ndims", [1, 2, 3, 4, 8])
def test_unrep_flag_kernel_equals_plain(cuda, dtype, ndims):
    """At 1 to ~1e6 queries a column, columns aligned to 16 bytes and slices
    one element off (a scalar head), each edge case of `unrep_edge_cases`
    at the first queries (the head), the middle, and the last (the tail)
    of an axis that turns with the case."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    info = unrep.info(dtype)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, info
    rng = np.random.default_rng(ndims)
    s0 = rng.uniform(-1, 1, ndims)
    h0 = rng.uniform(0.3, 1, ndims)
    for n in FLAG_NS:
        full = [torch.tensor(s0[k] + h0[k] * rng.uniform(-5, 25, n + 1), dtype=dtype,
                             device=cuda) for k in range(ndims)]
        for sliced in (False, True):
            cols = [c[1:] if sliced else c[:n] for c in full]
            assert all(c.is_contiguous() for c in cols)
            positions = sorted({0, 1, 2, 3, n // 2, n - 4, n - 3, n - 2, n - 1} & set(range(n)))
            for i, (name, x, s, h, expect) in enumerate(unrep_edge_cases(np_dtype)):
                axis = i % ndims
                starts = torch.tensor(s0, dtype=dtype, device=cuda)
                steps = torch.tensor(h0, dtype=dtype, device=cuda)
                _flag_equal(starts, steps, cols, False)
                starts[axis], steps[axis] = float(s), float(h)
                col = cols[axis]
                keep = col.clone()
                col.uniform_(-5, 25)  # in range on the case's grid, but for its tiny step
                for pos in positions:
                    was = col[pos].item()
                    col[pos] = float(x)
                    _flag_equal(starts, steps, cols, expect)
                    col[pos] = was
                col.copy_(keep)


def test_unrep_flag_kernel_launches_nothing_for_no_queries(cuda):
    for dtype in (torch.float32, torch.float64):
        starts = torch.zeros(3, dtype=dtype, device=cuda)
        steps = torch.ones(3, dtype=dtype, device=cuda)
        cols = [torch.empty(0, dtype=dtype, device=cuda)] * 3
        before = unrep.launches
        got = unrep.flag(starts, steps, cols)
        assert unrep.launches == before and got.device == starts.device and not bool(got)


FLAG_MODELS = {"linear": MultilinearRegular, "cubic": MulticubicRegular,
               "nearest": NearestRegular}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_checked_entries_raise_before_writing_out(cuda, dtype, method):
    """`eval(obs, out=cuda_out)` of the class, the raw shim into a CUDA
    `out` and `interpn` from numpy on the card: with every query good, K1's
    values bitwise, through one launch of the flag's kernel; with one NaN,
    inf or far-out query, the reference's error and `out` untouched."""
    dims = (20, 20, 20)
    rng = np.random.default_rng(20)
    starts = np.array([-0.5, 0.25, -1.0], dtype=dtype)  # grids exact, so interpn's steps are
    steps = np.array([0.5, 0.25, 0.75], dtype=dtype)  # these
    vals = rng.uniform(0, 1, math.prod(dims)).astype(dtype)
    obs_np = [(starts[k] + steps[k] * rng.uniform(-0.5, 19.5, 10_000)).astype(dtype)
              for k in range(3)]
    grids = [starts[k] + steps[k] * np.arange(dims[k], dtype=dtype) for k in range(3)]
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    obs = [torch.from_numpy(o).to(cuda) for o in obs_np]
    st, sp, vt = (torch.from_numpy(a).to(cuda) for a in (starts, steps, vals))
    model = FLAG_MODELS[method].new(list(dims), starts, steps, vals)
    suffix = "f32" if dtype == np.float32 else "f64"
    shim = getattr(raw, f"interpn_{method}_regular_{suffix}")
    lin = (True,) if method == "cubic" else ()
    want = model.eval_torch(obs)
    calls = {
        "class": lambda o, out: model.eval(o, out=out),
        "raw": lambda o, out: shim(np.array(dims), st, sp, vt, *lin, o, out),
    }
    for name, call in calls.items():
        out = torch.full((10_000,), 7.0, dtype=tdtype, device=cuda)
        before = unrep.launches
        assert call(obs, out) is out
        assert unrep.launches == before + 1, name
        _equal(out, want)
        for bad in (np.nan, np.inf, 1e30):
            worse = [o.clone() for o in obs]
            worse[1][5_000] = bad
            out = torch.full((10_000,), 7.0, dtype=tdtype, device=cuda)
            with pytest.raises(AssertionError, match="Unrepresentable coordinate value"):
                call(worse, out)
            torch.cuda.synchronize()
            assert (out == 7.0).all(), (name, bad)
    out = np.full(10_000, 7.0, dtype=dtype)
    before = unrep.launches
    interpn_tpu_torch.interpn(obs_np, grids, vals.reshape(dims), method=method, out=out,
                              assume_regular=True)
    assert unrep.launches == before + 1
    np.testing.assert_array_equal(out, want.cpu().numpy())
    worse = [o.copy() for o in obs_np]
    worse[2][-1] = np.nan
    out = np.full(10_000, 7.0, dtype=dtype)
    with pytest.raises(AssertionError, match="Unrepresentable coordinate value"):
        interpn_tpu_torch.interpn(worse, grids, vals.reshape(dims), method=method, out=out,
                                  assume_regular=True)
    assert (out == 7.0).all()
