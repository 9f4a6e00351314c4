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
infinity; and `rectilinear_route` at and across each cap.

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

from .test_torch_regular_layout import _bitwise, _c_strides

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


# --- the route ------------------------------------------------------------------------


@pytest.mark.parametrize("ndims", range(1, 9))
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_rectilinear_route_at_each_cap(ndims, dtype):
    """One cubic table takes the regular kernel's cubic route
    (`_cubic_route`), but one lane a query on the cubic pack; a cubic stack
    is staged while it fits STAGE_BYTES, staged a table at a time while a
    table does, else interleaved from RUN_BYTES of channels (f64 from 4D
    only above L1_BYTES), else direct; linear and nearest read direct."""
    item = torch.empty((), dtype=dtype).element_size()
    rest = 4 ** (ndims - 1)
    for d0 in (4, fused.STAGE_BYTES // (rest * item), fused.STAGE_BYTES // (rest * item) + 1,
               fused.TAP_BYTES // (4 * rest * item) + 3,
               fused.TAP_BYTES // (4 * rest * item) + 4):
        dims = (max(d0, 4), *(4,) * (ndims - 1))
        one = fused._cubic_route(dims, dtype)
        assert fused.rectilinear_route(dims, dtype, "cubic") == (
            "taps" if one == "tap_lanes" else one)
        for method in ("linear", "nearest"):
            assert fused.rectilinear_route(dims, dtype, method) == "direct"
            assert fused.rectilinear_route(dims, dtype, method, 8) == "direct"
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


def test_rectilinear_route_of_the_bench_tables():
    """The rectilinear cubic paths of `chip_smoke.py`."""
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
