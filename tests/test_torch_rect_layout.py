"""The rectilinear cubic kernels' weights and the layouts they read, on the
CPU: each axis's weights (`cubic.rectilinear_cubic_weights`) against the
JAX package's `_rect_locs_weights`; an evaluation that contracts the
stencil as the kernels do (`WeightTree` in csrc/interp_common.cuh: depth
first, axis 0 innermost, unrolled levels summed from their first product,
looped levels from -0.0) through the table itself (direct, staged), the
cubic pack, and a stack's interleave, with the
gather tree where a result is not finite, bit for bit equal to the plain
version (`fused.plain_rectilinear[_stack]`) at 1-8D; the plain version
against the gather tree at the JAX package's bars (f32 rtol 1e-4, f64 rtol
1e-13), exact at nodes and bit for bit wherever a stencil holds a NaN or an
infinity; in the extrapolated corners of the jittered 100^3 grid, where
the f32 weights cancel, the plain version and the JAX package's K2 against
float64 and each other within 2u sum |W v| (a known difference: each
leaves the gather tree's f32 bar there); a linear or nearest stack read
through the interleave as K6 reads it, bit for bit equal to the plain
version; and `rectilinear_route` at and across each cap, for cubic and for
linear and nearest stacks.

The kernels themselves run only on a card (`tests/test_torch_gpu.py`,
`chip_smoke.py`); what is held here is what they assume of the weights and
the layouts.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import cubic as jcubic
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import cubic, fused
from interpn_tpu_torch.ops._gather import gather_corners_matrix
from interpn_tpu_torch.ops.locate import locate_rectilinear_linear

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)
from .test_torch_regular_layout import _bitwise, _c_strides, _read_interleaved

F32, F64 = torch.float32, torch.float64
DIMS = [(9,), (6, 7), (5, 4, 6), (4, 5, 4, 4), (4, 4, 5, 4, 4), (4,) * 6, (4,) * 7, (4,) * 8]
LAYOUTS = ["table", "taps", "interleaved"]
BAD = [np.nan, np.inf, -np.inf]


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _case(dims, dtype, n, seed, nch=None, spoil=False):
    """Jittered sorted axes, a random table (or an (nch, prod) stack) and
    queries reaching a unit past each side with NaN and +-inf mixed in;
    `spoil` puts a NaN, +inf and -inf into the table."""
    rng = np.random.default_rng(seed)
    grids = tuple(torch.as_tensor(np.cumsum(0.2 + rng.random(d)), dtype=dtype) for d in dims)
    shape = math.prod(dims) if nch is None else (nch, math.prod(dims))
    vals = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    if spoil:
        spots = torch.as_tensor(rng.choice(vals.numel(), 3, replace=False))
        vals.view(-1)[spots] = torch.tensor([math.nan, math.inf, -math.inf], dtype=dtype)
    obs = []
    for g in grids:
        o = rng.uniform(float(g[0]) - 1.0, float(g[-1]) + 1.0, n)
        o[rng.integers(0, n, 6)] = rng.choice(BAD, 6)
        obs.append(torch.as_tensor(o, dtype=dtype))
    return grids, vals, tuple(obs)


def _n(dims):
    return 200 if len(dims) <= 5 else 30


# --- the weights ----------------------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS[:5], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_weights_match_jax_rect_locs_weights(dims, lin):
    """Each axis's stencil start and four weights in f32 against the JAX
    package's `_rect_locs_weights` (the TPU K2's weights, in XLA f32): the
    start exact, the weights at rtol = atol 1e-6 (XLA:CPU may contract a
    multiply-add); NaN where it is NaN."""
    grids, _, obs = _case(dims, F32, 300, seed=len(dims))
    locs, ws = jv3._rect_locs_weights(tuple(jnp.asarray(g.numpy()) for g in grids),
                                      tuple(jnp.asarray(o.numpy()) for o in obs), "cubic", lin)
    for k, (g, o) in enumerate(zip(grids, obs)):
        loc, w = cubic.rectilinear_cubic_weights(o, g, lin)
        np.testing.assert_array_equal(loc.numpy(), np.asarray(locs[k]))
        for j in range(4):
            want = np.asarray(ws[4 * k + j])
            np.testing.assert_array_equal(np.isnan(w[j].numpy()), np.isnan(want))
            np.testing.assert_allclose(w[j].numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_weights_sum_to_one_inside(dtype):
    """Inside the grid the four weights of an axis reproduce a constant:
    they sum to 1 within rounding (the Hermite node is exact on constants)."""
    grids, _, obs = _case((30,), dtype, 2000, seed=3)
    g, x = grids[0], obs[0]
    inside = (x >= g[0]) & (x <= g[-1])
    _, w = cubic.rectilinear_cubic_weights(x, g, True)
    total = (w[0] + w[1] + w[2] + w[3])[inside]
    tol = 1e-5 if dtype == F32 else 1e-13
    torch.testing.assert_close(total, torch.ones_like(total), rtol=tol, atol=tol)


# --- evaluation through the layouts, as the kernels contract -------------------------


def _unrolled(layout, dtype):
    """WeightTree's UNROLLED of the route (csrc/rectilinear.cuh::unrolled_of)."""
    if layout == "interleaved":
        return 1
    if layout in ("staged", "staged_tables"):
        return 2 if dtype == F32 else 1
    return 3


def _contract(leaf, depth, leaf_depth, base, strides, weights, unrolled):
    """WeightTree::eval: the sub-stencil of `depth` axes at `base`, depth
    first; levels up to `unrolled` start from their first product, outer
    levels from -0.0."""
    if depth == leaf_depth:
        return leaf(base)
    w = weights[depth - 1]
    ys = (_contract(leaf, depth - 1, leaf_depth, base + j * strides[depth - 1], strides,
                    weights, unrolled) for j in range(4))
    if depth <= unrolled:
        acc = w[0] * next(ys)
    else:
        acc = torch.full_like(w[0], -0.0)
        acc = acc + w[0] * next(ys)
    for j, y in zip(range(1, 4), ys):
        acc = acc + w[j] * y
    return acc


def _through(layout, grids, vals, obs, lin, route="direct"):
    """Rectilinear cubic read as the kernel reads `layout`: each axis's
    weights, the located corner over the layout's strides, the contraction
    in the kernel's order, then the gather tree where a result is not
    finite. `vals` is a table, or an (nch, prod) stack for 'interleaved'
    and 'table'."""
    dims = tuple(int(g.shape[0]) for g in grids)
    nd = len(dims)
    per = [cubic.rectilinear_cubic_weights(o, g, lin) for g, o in zip(grids, obs)]
    weights = [w for _, w in per]
    strides = _c_strides(dims)
    base = sum(loc.long() * s for (loc, _), s in zip(per, strides))
    stack = vals if vals.dim() == 2 else vals[None]
    u = _unrolled(route, vals.dtype)
    if layout == "interleaved":
        inter = fused.plain_interleave(stack)  # (prod, nch)
        out = _contract(lambda b: inter[b], nd, 0, base, strides,
                        [[x[:, None] for x in w] for w in weights], u).t()
    elif layout == "table":
        out = torch.stack([_contract(lambda b, v=v: v[b], nd, 0, base, strides, weights, u)
                           for v in stack])
    else:
        pack = fused.plain_cubic_pack(dims, vals).reshape(-1, 4)

        def leaf(b):  # a cell of four taps dotted with axis 0's weights
            t = pack[b]
            w = weights[0]
            return w[0] * t[:, 0] + w[1] * t[:, 1] + w[2] * t[:, 2] + w[3] * t[:, 3]

        out = _contract(leaf, nd, 1, base, strides, weights, u)[None]
    tree = torch.stack([cubic.cubic_rectilinear(grids, v, obs, lin) for v in stack])
    out = torch.where(torch.isfinite(out), out, tree)
    return out if vals.dim() == 2 else out[0]


def _layout_cases():
    for dims, layout in itertools.product(DIMS, LAYOUTS):
        if layout != "taps" or len(dims) >= 2:
            yield dims, layout


@pytest.mark.parametrize("dims,layout", list(_layout_cases()),
                         ids=lambda v: f"{len(v)}d" if isinstance(v, tuple) else v)
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_layout_read_equals_plain(dims, layout, dtype, lin):
    """The kernels' contraction through each layout, bit for bit the plain
    version; a stack of 3 (8 f32 or 4 f64 channels interleaved, as the
    route reads them) on 'table' and 'interleaved', with a NaN and
    infinities inside some of its tables."""
    nch = None
    if layout == "interleaved":
        nch = 8 if dtype == F32 else 4
    elif layout == "table":
        nch = 3
    grids, vals, obs = _case(dims, dtype, _n(dims), seed=len(dims), nch=nch,
                             spoil=layout != "taps")
    plain = fused.plain_rectilinear_stack if nch else fused.plain_rectilinear
    want = plain(grids, vals, obs, "cubic", lin)
    # staged and direct differ in their unrolled levels (the order of the
    # sums does not); both where that is cheap to emulate
    routes = (layout,)
    if layout == "table":
        routes = ("staged", "staged_tables", "direct") if len(dims) <= 5 else ("direct",)
    for route in routes:
        _bitwise(_through(layout, grids, vals, obs, lin, route), want)


# --- the plain version against the gather tree ----------------------------------------


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_plain_matches_the_gather_tree(dims, dtype, lin):
    """The weights' contraction against the port's gather tree and the JAX
    package's (`interpn_tpu.ops.cubic.cubic_rectilinear`) at the JAX
    package's bars: f32 rtol = atol 1e-4, f64 1e-13; NaN where they are."""
    grids, vals, obs = _case(dims, dtype, _n(dims), seed=20 + len(dims))
    got = fused.plain_rectilinear(grids, vals, obs, "cubic", lin).numpy()
    tol = 1e-4 if dtype == F32 else 1e-13
    tree = cubic.cubic_rectilinear(grids, vals, obs, lin).numpy()
    want = np.asarray(jcubic.cubic_rectilinear(
        tuple(jnp.asarray(g.numpy()) for g in grids), jnp.asarray(vals.numpy()),
        tuple(jnp.asarray(o.numpy()) for o in obs), lin))
    for ref in (tree, want):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_plain_exact_at_nodes(dtype, lin):
    """Every node of a jittered 9 x 6 x 5 x 4 grid: the table itself, for
    one table and for each table of a stack."""
    dims = (9, 6, 5, 4)
    grids, vals, _ = _case(dims, dtype, 1, seed=4, nch=3)
    idx = np.stack(np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")).reshape(4, -1)
    obs = tuple(g[torch.from_numpy(i)] for g, i in zip(grids, idx))
    _bitwise(fused.plain_rectilinear(grids, vals[0], obs, "cubic", lin), vals[0])
    _bitwise(fused.plain_rectilinear_stack(grids, vals, obs, "cubic", lin), vals)


@pytest.mark.parametrize("dims", DIMS[:5], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_plain_is_the_gather_tree_where_a_stencil_is_not_finite(dims, dtype):
    """A table with a NaN, +inf and -inf: at every query whose stencil holds
    one, the plain version returns the gather tree's bits (the contraction
    would turn 0 * inf into NaN); elsewhere it is finite where the tree is."""
    grids, vals, obs = _case(dims, dtype, 2000, seed=30 + len(dims), spoil=True)
    got = fused.plain_rectilinear(grids, vals, obs, "cubic", True)
    tree = cubic.cubic_rectilinear(grids, vals, obs, True)
    strides = _c_strides(dims)
    base = sum(cubic.rectilinear_cubic_weights(o, g, True)[0].long() * s
               for g, o, s in zip(grids, obs, strides))
    offs = torch.tensor([sum(d * s for d, s in zip(reversed(digits), strides))
                         for digits in itertools.product(range(4), repeat=len(dims))])
    spoilt = ~torch.isfinite(vals[base[None, :] + offs[:, None]]).all(dim=0)
    assert spoilt.any()
    _bitwise(got[spoilt], tree[spoilt])
    fine = ~spoilt
    assert torch.equal(torch.isfinite(got[fine]), torch.isfinite(tree[fine]))


def _linear_through_interleaved(grids, stack, obs, method):
    """Linear or nearest evaluation of a stack read as K6 reads a wide one:
    K5's interleaved read (`_read_interleaved`) on cells and coordinates
    located by bisection."""
    dims = tuple(int(g.shape[0]) for g in grids)
    locs, ts = [], []
    for g, x in zip(grids, obs):
        loc, x0, x1 = locate_rectilinear_linear(x, g)
        locs.append(loc)
        ts.append((x - x0) / (x1 - x0))
    return _read_interleaved(dims, stack, locs, ts, method)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("nch", [8, 9])
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_linear_interleaved_read_equals_plain(dims, nch, method, dtype):
    """A linear or nearest stack read through the interleave as K6 reads it
    is the plain version bit for bit (the gather tree on each table), with
    NaN and +-inf in the tables and the queries."""
    grids, stack, obs = _case(dims, dtype, _n(dims), seed=nch + len(dims), nch=nch, spoil=True)
    _bitwise(_linear_through_interleaved(grids, stack, obs, method),
             fused.plain_rectilinear_stack(grids, stack, obs, method))


# --- f32 in the extrapolated corners of a 100^3 grid ----------------------------------

# Queries on `chip_smoke.bench_rect_axes(100, 3)` (the A/B script's jittered
# 100^3 grid) with table c of rng(1003).standard_normal((8, 10**6)) in f32,
# every axis extrapolated (the corners of [-0.5, 10.5]^3): where the weight
# contraction, the JAX K2 or both leave the gather tree's f32 bar (rtol =
# atol 1e-4). The first came from 1.04e8 results on uniform queries, the
# only one of them; the rest from the corners.
PINNED = [
    (5, (10.472643852233887, -0.3851606249809265, -0.4485081434249878)),
    (5, (10.340730667114258, -0.32613468170166016, -0.4479012191295624)),
    (5, (10.487374305725098, -0.383258581161499, -0.44084516167640686)),
    (1, (-0.47447288036346436, 10.494485855102539, 10.496223449707031)),
    (7, (-0.3632621467113495, -0.4880358576774597, -0.34629327058792114)),
]


def test_f32_corners_of_the_100_cubed_grid_match_the_jax_k2(_interpret_mode):  # noqa: F811
    """A known difference, held on PINNED: there the f32 weight contraction
    (the kernels' plain version) and the JAX package's K2 (interpret mode)
    both leave the gather tree's f32 bar, each somewhere, as the stencil's
    weights reach 1e3 and cancel (sum |W_j v_j| near 9e3 for a result of
    1.5). Each is within 2u sum |W_j v_j| (u = 2^-24, two roundings of the
    absolute stencil sum) of the float64 plain version on the same f32
    inputs, and of the other."""
    import chip_smoke as cs

    dims = (100,) * 3
    axes = tuple(torch.as_tensor(a, dtype=F32) for a in cs.bench_rect_axes(100, 3))
    tables = np.random.default_rng(1003).standard_normal((8, 10**6)).astype(np.float32)
    beyond = {"port": 0, "jax": 0}
    for c in sorted({c for c, _ in PINNED}):
        qs = [q for t, q in PINNED if t == c]
        obs = tuple(torch.tensor(col, dtype=F32) for col in zip(*qs))
        vals = torch.from_numpy(tables[c])
        port = fused.eval_rectilinear(axes, vals, obs, "cubic", True)
        jax_k2 = torch.from_numpy(np.array(jv3.eval_rectilinear_pre(
            tuple(jnp.asarray(a.numpy()) for a in axes), jnp.asarray(tables[c]),
            tuple(jnp.asarray(o.numpy()) for o in obs), "cubic", True, 6)))
        tree = cubic.cubic_rectilinear(axes, vals, obs, True)
        ax64, ob64, v64 = (tuple(a.double() for a in axes), tuple(o.double() for o in obs),
                           vals.double())
        ref = fused.plain_rectilinear(ax64, v64, ob64, "cubic", True)
        base, ws = 0, []
        for k in range(3):
            loc, w = cubic.rectilinear_cubic_weights(ob64[k], ax64[k], True)
            base = base + loc * _c_strides(dims)[k]
            ws.append(torch.stack(w))
        weights = torch.einsum("in,jn,kn->kjin", *ws).reshape(64, -1)
        stencil = gather_corners_matrix(v64, base.to(torch.int32), dims, 4)
        tol = 2.0**-23 * (weights.abs() * stencil.abs()).sum(0)
        assert (tol > 1e-4).all() and (tol < 2e-3).all()
        for got in (port, jax_k2):
            assert ((got.double() - ref).abs() <= tol).all(), (c, got - ref, tol)
        assert ((port.double() - jax_k2.double()).abs() <= tol).all(), (c, port - jax_k2, tol)
        bar = 1e-4 + 1e-4 * tree.abs()
        beyond["port"] += int(((port - tree).abs() > bar).sum())
        beyond["jax"] += int(((jax_k2 - tree).abs() > bar).sum())
    assert beyond["port"] >= 2 and beyond["jax"] >= 2, beyond


# --- the route ------------------------------------------------------------------------


@pytest.mark.parametrize("ndims", range(1, 9))
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_rectilinear_route_at_each_cap(ndims, dtype):
    """One cubic table takes the regular kernel's cubic route
    (`_cubic_route`), but one lane a query on the cubic pack; a cubic stack
    is staged while it fits STAGE_BYTES, staged a table at a time while a
    table does, else interleaved from RUN_BYTES of channels (f64 from 4D
    only above L1_BYTES), else direct; one linear or nearest table as
    `_lerp_table_route` says (staged, guided, direct), at and one row over
    each of its caps too, a stack of them as `_linear_stack_route` says."""
    item = torch.empty((), dtype=dtype).element_size()
    rest = 4 ** (ndims - 1)
    lerp_caps = [d for cap in _lerp_table_caps(ndims, dtype) for d in (cap - 1, cap)]
    for d0 in (4, fused.STAGE_BYTES // (rest * item), fused.STAGE_BYTES // (rest * item) + 1,
               fused.TAP_BYTES // (4 * rest * item) + 3,
               fused.TAP_BYTES // (4 * rest * item) + 4, *lerp_caps):
        dims = (max(d0, 4), *(4,) * (ndims - 1))
        one = fused._cubic_route(dims, dtype)
        assert fused.rectilinear_route(dims, dtype, "cubic") == (
            "taps" if one == "tap_lanes" else one)
        for method in ("linear", "nearest"):
            assert fused.rectilinear_route(dims, dtype, method) == _lerp_table_route(
                dims, dtype, method), (dims, method)
            assert fused.rectilinear_route(dims, dtype, method, 8) == _linear_stack_route(
                dims, dtype, method, 8)
    caps = _lerp_table_caps(ndims, dtype)
    for method in ("linear", "nearest"):  # a cap's route one row below it, the next at it
        for cap, kind in zip(caps, ("staged", "guided")[-len(caps):]):
            if cap <= 4:  # not even a 4-row table fits
                continue
            below, over = (fused.rectilinear_route((d0, *(4,) * (ndims - 1)), dtype, method)
                           for d0 in (cap - 1, cap))
            if kind == "staged" and method == "linear":
                assert below == "staged" and over != "staged", (cap, below, over)
            if kind == "guided" and below == "guided":
                assert over == "direct", (cap, below, over)
        size = math.prod(dims) * item
        run = fused.RUN_BYTES // item
        for nch in (1, run - 1, run, 2 * run):
            if size * nch <= fused.STAGE_BYTES:
                want = "staged"
            elif size <= fused.STAGE_BYTES:
                want = "staged_tables"
            else:
                wide = nch >= run and (dtype == F32 or ndims <= 3 or size > fused.L1_BYTES)
                want = "interleaved" if wide else "direct"
            assert fused.rectilinear_route(dims, dtype, "cubic", nch) == want, (dims, nch)


def _guide_bytes(dims, item):
    """The guided locate's shared memory (csrc/rectilinear.cuh): each
    column and its 2 dim + 1 int32 bucket starts."""
    return sum(d * item + (2 * d + 1) * 4 for d in dims)


def _lerp_table_route(dims, dtype, method):
    """One linear or nearest table: staged (f32 linear) where the table, on
    a 16-byte boundary after its offset, and the guide fit STAGE_BYTES; else
    guided where the guide fits COLUMN_BYTES, but direct for an f32 linear
    table above L1_BYTES from 3D; else direct."""
    item = torch.empty((), dtype=dtype).element_size()
    guide = _guide_bytes(dims, item)
    table = math.prod(dims) * item
    f32_linear = method == "linear" and dtype == F32
    if f32_linear and (table + 31) // 16 * 16 + guide <= fused.STAGE_BYTES + 16:
        return "staged"
    if f32_linear and len(dims) >= 3 and table > fused.L1_BYTES:
        return "direct"
    return "guided" if guide <= fused.COLUMN_BYTES else "direct"


def _lerp_table_caps(ndims, dtype):
    """The first d0 of (d0, 4, ..., 4) over each cap of `_lerp_table_route`:
    the f32 staged route's, then the guided route's."""
    item = torch.empty((), dtype=dtype).element_size()
    rest = (4,) * (ndims - 1)

    def over(fits):
        d0 = 4
        while fits((d0, *rest)):
            d0 += 1
        return d0

    table = [] if dtype == F64 else [over(
        lambda dims: _lerp_table_route(dims, dtype, "linear") == "staged")]
    return table + [over(lambda dims: _guide_bytes(dims, item) <= fused.COLUMN_BYTES)]


def _linear_stack_route(dims, dtype, method, nch):
    """K5's rule for a linear or nearest stack: interleaved from RUN_BYTES of
    channels (while the interleave has int32 indices), else staged for f32
    linear within STAGE_BYTES in all, else direct."""
    item = torch.empty((), dtype=dtype).element_size()
    size = math.prod(dims)
    if nch * item >= fused.RUN_BYTES and nch * size < 2**31:
        return "interleaved"
    if method == "linear" and dtype == F32 and nch * size * item <= fused.STAGE_BYTES:
        return "staged"
    return "direct"


@pytest.mark.parametrize("ndims", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_rectilinear_linear_stack_routes_at_each_cap(ndims, dtype, method):
    """A linear or nearest stack (K6) takes K5's route, `regular_route`'s:
    interleaved from RUN_BYTES of channels (one table fewer does not), an
    f32 linear stack of at most STAGE_BYTES staged (one row more not), else
    direct; one table as `_lerp_table_route` says."""
    item = torch.empty((), dtype=dtype).element_size()
    run = fused.RUN_BYTES // item
    rest = 2 ** (ndims - 1)
    for nch in (1, 3, run - 1, run, run + 1, 2 * run + 1):
        at = fused.STAGE_BYTES // (nch * rest * item)
        for d0 in (2, max(at, 2), at + 1, 4 * at):
            dims = (d0, *(2,) * (ndims - 1))
            want = _linear_stack_route(dims, dtype, method, nch)
            got = fused.rectilinear_route(dims, dtype, method, nch)
            assert got == want == fused.regular_route(dims, dtype, method, nch), (dims, nch)
            assert fused.rectilinear_route(dims, dtype, method) == _lerp_table_route(
                dims, dtype, method)
    assert fused.rectilinear_route((2,) * ndims, dtype, method, run) == "interleaved"
    assert fused.rectilinear_route((2,) * ndims, dtype, method, run - 1) == (
        "staged" if method == "linear" and dtype == F32 else "direct")


def test_rectilinear_route_of_the_bench_tables():
    """The rectilinear paths of `chip_smoke.py`: cubic, and linear and
    nearest stacks of 8 (interleaved) and their tables (linear staged,
    nearest guided; linear 100^3 direct, 1000^2 guided)."""
    want = {((20,) * 3, F32, None): "staged", ((20,) * 3, F64, None): "staged",
            ((100,) * 3, F32, None): "taps", ((20,) * 3, F32, 8): "staged_tables",
            ((20,) * 3, F32, 3): "staged", ((20,) * 3, F64, 4): "staged_tables",
            ((40,) * 3, F32, 8): "interleaved", ((40,) * 3, F32, 3): "direct",
            ((40,) * 3, F64, 4): "interleaved", ((12,) * 4, F64, 4): "direct",
            ((20,) * 4, F64, 4): "interleaved", ((8,) * 5, F64, 4): "direct",
            ((30,) * 3, F64, 4): "interleaved", ((9,) * 5, F64, 4): "interleaved",
            ((14,) * 4, F32, 8): "interleaved", ((12,) * 4, F32, None): "staged"}
    for (dims, dtype, nch), route in want.items():
        assert fused.rectilinear_route(dims, dtype, "cubic", nch) == route, (dims, dtype, nch)
    lin = {((20,) * 3, F32, None): "staged", ((20,) * 3, F32, 8): "interleaved",
           ((20,) * 3, F32, 3): "staged", ((20,) * 3, F64, 4): "interleaved",
           ((40,) * 3, F32, 3): "direct", ((20,) * 3, F64, None): "guided",
           ((100,) * 3, F32, None): "direct", ((1000,) * 2, F32, None): "guided"}
    for (dims, dtype, nch), route in lin.items():
        assert fused.rectilinear_route(dims, dtype, "linear", nch) == route, (dims, dtype, nch)
        nearest = "guided" if nch is None else ("direct" if route == "staged" else route)
        assert fused.rectilinear_route(dims, dtype, "nearest", nch) == nearest, (dims, nch)
