"""The regular cubic weights (`ops/cubic.py::regular_cubic_weights`, which
K8's plain chain builds) and their contraction, as the JAX package's K1
and K5 compute it, and the stack routes of K5 cubic and K7
(`ops/fused.py::regular_route`, `bspline_route`) with the group split of
csrc/regular.cuh emulated, on the CPU.

Tolerances:
* the weights contracted against the JAX package's K1/K5 in interpret
  mode (`pallas_v3.eval_regular_stack`, which contracts weights too, with
  split products): f32 rtol=atol=2e-5, the bar of tests/test_stack.py; the
  weights against `pallas_v3._cubic_axis_weights` the same in f32, 1e-13
  in f64 (XLA:CPU may contract a multiply-add);
* the weights contracted against the JAX package's gather tree
  (`interpn_tpu.ops.cubic.cubic_regular`): f64 rtol=atol=1e-13;
* exact: unit bases at grid nodes.

The kernels run only on a card (`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import cubic as jcubic
from interpn_tpu.ops import pallas_v3 as jv3
from interpn_tpu_torch import config
from interpn_tpu_torch import ops as tops
from interpn_tpu_torch.ops import cubic as tcubic
from interpn_tpu_torch.ops import fused
from interpn_tpu_torch.ops._gather import gather_corners_matrix

from .test_torch_ops import _interpret_mode  # noqa: F401  (fixture)

F32, F64 = torch.float32, torch.float64
NP = {F32: np.float32, F64: np.float64}
DIMS = [(9,), (8, 6), (7, 5, 6), (5, 4, 6, 4)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _case(dims, nch, dtype, seed, n=300, bad=True, ext=1 / 3):
    """(starts, steps, vals, obs) tensors: a random regular grid, a table
    (nch None) or an (nch, prod(dims)) stack from a seed, and queries `ext`
    of the grid past each side with NaN and +-inf mixed in where `bad`."""
    rng = np.random.default_rng(seed)
    starts, steps = rng.uniform(-1, 1, len(dims)), rng.uniform(0.3, 1.0, len(dims))
    vals = rng.standard_normal(math.prod(dims) if nch is None else (nch, math.prod(dims)))
    obs = []
    for s, h, d in zip(starts, steps, dims):
        span = h * (d - 1)
        o = rng.uniform(s - ext * span, s + (1 + ext) * span, n)
        if bad:
            o[rng.integers(0, n, 5)] = rng.choice([np.nan, np.inf, -np.inf], 5)
        obs.append(o)
    t = lambda a: torch.as_tensor(np.asarray(a, NP[dtype]))  # noqa: E731
    return t(starts), t(steps), t(vals), tuple(t(o) for o in obs)


def _j(t):
    return jnp.asarray(t.numpy())


# --- the weights -----------------------------------------------------------------------


@pytest.mark.parametrize("dim", [4, 5, 9])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_regular_cubic_weights_match_jax(dim, dtype, lin):
    """Every region of the axis (outside, inside and interior cells, exact
    nodes) and +-inf: the stencil's first index equal, the four weights at
    the bars; NaN queries give NaN weights in both."""
    start, step = torch.tensor(-0.7, dtype=dtype), torch.tensor(0.45, dtype=dtype)
    rng = np.random.default_rng(dim)
    x = np.concatenate([rng.uniform(-0.7 - 3, -0.7 + 0.45 * (dim + 2), 400),
                        -0.7 + 0.45 * np.arange(dim), [np.inf, -np.inf, np.nan]])
    xt = torch.as_tensor(x.astype(NP[dtype]))
    loc, w = tcubic.regular_cubic_weights(xt, start, step, dim, lin)
    jloc, jw = jv3._cubic_axis_weights(_j(xt), _j(start), _j(step), dim, lin)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(loc.numpy()[finite], np.asarray(jloc)[finite])
    tol = 2e-5 if dtype == F32 else 1e-13
    for got, want in zip(w, jw):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
        assert np.isnan(got.numpy()[-1]) and np.isnan(np.asarray(want)[-1])


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_regular_cubic_weights_are_unit_bases_at_nodes(dtype, lin):
    """At a grid node a weight vector is a unit basis exactly, so that the
    contraction reproduces the table there bit for bit."""
    dim = 7
    start, step = torch.tensor(0.25, dtype=dtype), torch.tensor(0.5, dtype=dtype)
    x = start + step * torch.arange(dim, dtype=dtype)
    _, w = tcubic.regular_cubic_weights(x, start, step, dim, lin)
    w = torch.stack(w)  # (4, dim)
    assert set(torch.unique(w).tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(w.sum(0), torch.ones(dim, dtype=dtype), rtol=0, atol=0)


# --- the weights contracted, against the JAX package ----------------------------------


def _contracted(dims, starts, steps, vals, obs, lin):
    """Each table of `vals` (one flat table or an (nch, prod(dims)) stack)
    contracted with the weights of `regular_cubic_weights`, built once for
    all of them, as the JAX package's K1/K5 and K8 contract them."""
    strides = [math.prod(dims[k + 1:]) for k in range(len(dims))]
    base, weights = 0, []
    for k in range(len(dims)):
        loc, w = tcubic.regular_cubic_weights(obs[k], starts[k], steps[k], dims[k], lin)
        base = base + loc * strides[k]
        weights.append(w)
    stack = vals if vals.dim() == 2 else vals[None]
    out = torch.stack([tcubic.contract_cubic(gather_corners_matrix(v, base, dims, 4), weights)
                       for v in stack])
    return out if vals.dim() == 2 else out[0]


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("nch", [None, 3], ids=["table", "stack"])
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_weights_contract_as_pallas_k5(_interpret_mode, dims, nch, lin):  # noqa: F811
    st, sp, vals, obs = _case(dims, nch, F32, seed=len(dims), bad=False, ext=0.1)
    got = _contracted(dims, st, sp, vals, obs, lin)
    stack = vals if nch else vals[None]
    want = np.asarray(jv3.eval_regular_stack(dims, _j(st), _j(sp), _j(stack),
                                             tuple(map(_j, obs)), "cubic", lin))
    np.testing.assert_allclose(got.numpy(), want if nch else want[0], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("nch", [None, 3], ids=["table", "stack"])
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_weights_contract_as_the_jax_gather_tree_f64(dims, nch, lin):
    """Within 1e-13 wherever every coordinate of the query is finite; a NaN
    or infinite coordinate gives NaN weights, so a NaN result."""
    st, sp, vals, obs = _case(dims, nch, F64, seed=10 + len(dims))
    got = _contracted(dims, st, sp, vals, obs, lin)
    finite = np.all([np.isfinite(o.numpy()) for o in obs], axis=0)
    assert 0 < (~finite).sum() < finite.sum()
    for c, table in enumerate(vals if nch else [vals]):
        want = np.asarray(jcubic.cubic_regular(dims, _j(st), _j(sp), _j(table),
                                               tuple(map(_j, obs)), lin))
        row = (got[c] if nch else got).numpy()
        assert np.isnan(row[~finite]).all()
        np.testing.assert_allclose(row[finite], want[finite], rtol=1e-13, atol=1e-13)


def test_cpu_stacks_stay_on_the_gather_tree():
    """`ops.cubic_regular[_stack]` on CPU tensors is the gather tree, bit for
    bit: the kernels' plain version, which the stack routes keep."""
    dims = (7, 5, 6)
    st, sp, vals, obs = _case(dims, 3, F64, seed=2)
    for lin in (True, False):
        got = tops.cubic_regular_stack(dims, st, sp, vals, obs, lin)
        torch.testing.assert_close(got, fused.plain_regular_stack(dims, st, sp, vals, obs,
                                                                  "cubic", lin),
                                   rtol=0, atol=0, equal_nan=True)
        one = tops.cubic_regular(dims, st, sp, vals[1], obs, lin)
        torch.testing.assert_close(one, tcubic.cubic_regular(dims, st, sp, vals[1], obs, lin),
                                   rtol=0, atol=0, equal_nan=True)


# --- the stack routes ------------------------------------------------------------------


def _stack_dims(table_bytes, dtype, ndims=3):
    """(d0, 4, ..., 4) dims of the largest table within `table_bytes`."""
    rest = 4 ** (ndims - 1)
    return (table_bytes // (rest * dtype.itemsize), *(4,) * (ndims - 1))


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("nch", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("ndims", [1, 3, 5])
def test_stack_routes_at_the_caps(dtype, nch, ndims):
    """K5 cubic and K7 stacks at and one row over each cap: tables within
    GROUP_BYTES in groups (the whole stack one group where it fits); larger
    ones through their cubic packs on four lanes a query for K5 (direct at
    1D and for one f64 table within L1_BYTES at 3D), interleaved for K7 from
    RUN_BYTES of channels, else direct; a single spline table within
    GROUP_BYTES staged as its one group, a larger one direct."""
    item = dtype.itemsize
    cases = [_stack_dims(fused.STAGE_BYTES // nch, dtype, ndims),
             _stack_dims(fused.GROUP_BYTES, dtype, ndims)]
    cases += [(d[0] + 1, *d[1:]) for d in cases]
    for dims in cases:
        if math.prod(dims) * item <= fused.GROUP_BYTES:
            want = spline = "staged_groups"
        else:
            in_l1 = dtype == F64 and ndims <= 3 and nch * math.prod(dims) * item <= fused.L1_BYTES
            want = "direct" if ndims == 1 or in_l1 else "tap_lanes"
            spline = "interleaved" if nch * item >= fused.RUN_BYTES else "direct"
        assert fused.regular_route(dims, dtype, "cubic", nch) == want, dims
        for k in fused.DEGREES:
            assert fused.bspline_route(dims, dtype, k, nch) == spline, (dims, k)
            one = "staged_groups" if math.prod(dims) * item <= fused.GROUP_BYTES else "direct"
            assert fused.bspline_route(dims, dtype, k) == one


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("nch", [1, 3, 8, 9])
@pytest.mark.parametrize("ndims", range(1, 9))
def test_cubic_stack_reads_its_packs_at_each_cap(ndims, dtype, nch):
    """K5 cubic stacks of tables (d0, 4, ..., 4) one row over GROUP_BYTES,
    at and one row over L1_BYTES, and at and one row over the pack's
    TAP_BYTES: each table through its cubic pack (taps at 2D, tap lanes from
    3D), as one table reads it (`_cubic_route`), but for f64 tables within
    L1_BYTES at 2-3D only where the stack fits L1_BYTES in all (one table:
    read direct one after another, more do not fit L1 together); direct at
    1D and for a pack above TAP_BYTES."""
    item, rest = dtype.itemsize, 4 ** (ndims - 1)
    at = [fused.GROUP_BYTES // (rest * item) + 1, fused.L1_BYTES // (rest * item),
          fused.TAP_BYTES // (4 * rest * item) + 3]
    for d0 in sorted({d for a in at for d in (a, a + 1)}):
        dims = (d0, *(4,) * (ndims - 1))
        if math.prod(dims) * item <= fused.GROUP_BYTES:
            continue
        packed = {1: "direct", 2: "taps"}.get(ndims, "tap_lanes")
        in_l1 = dtype == F64 and ndims <= 3 and nch * math.prod(dims) * item <= fused.L1_BYTES
        over = fused._taps_size(dims) * item > fused.TAP_BYTES
        want = "direct" if in_l1 or over else packed
        assert fused.regular_route(dims, dtype, "cubic", nch) == want, dims
        if nch == 1:  # a stack of one reads as its table does
            assert want == fused.regular_route(dims, dtype, "cubic"), dims


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("nch", [1, 8, 9])
@pytest.mark.parametrize("dims", [(40,) * 3, (20,) * 4, (12,) * 5, (300, 300)],
                         ids=lambda d: f"{d[0]}^{len(d)}")
def test_cubic_stack_pack_needs_its_copy_to_fit_free_memory(dims, dtype, nch):
    """Each call allocates the packs of the whole stack beside it, so a K5
    cubic stack reads them only while they fit the free bytes of its
    device: its packed route with exactly the packs' bytes free, direct
    with one byte fewer; with no bound (None, as on the CPU) packed."""
    packed = "taps" if len(dims) == 2 else "tap_lanes"
    copy = nch * fused._taps_size(dims) * dtype.itemsize
    assert fused.regular_route(dims, dtype, "cubic", nch) == packed
    assert fused.regular_route(dims, dtype, "cubic", nch, copy) == packed
    assert fused.regular_route(dims, dtype, "cubic", nch, copy - 1) == "direct"
    assert fused.regular_route(dims, dtype, "cubic", nch, 0) == "direct"


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("ndims", [2, 3, 5])
def test_cubic_stack_packs_past_int32_indices_read_direct(dtype, ndims):
    """A K5 cubic stack whose packs together would hold 2^31 entries or more
    reads direct, though each table's pack fits TAP_BYTES; one table fewer
    reads its packs."""
    rest = 4 ** (ndims - 1)
    per = fused.TAP_BYTES // dtype.itemsize  # one table's pack at TAP_BYTES
    dims = (per // (4 * rest) + 3, *(4,) * (ndims - 1))
    assert fused._taps_size(dims) == per
    nch = 2**31 // per
    packed = "taps" if ndims == 2 else "tap_lanes"
    assert fused.regular_route(dims, dtype, "cubic", nch) == "direct"
    assert fused.regular_route(dims, dtype, "cubic", nch - 1) == packed


def _k7_route_before(dims, dtype, nch, free):
    """K7's stack route as it stood before K5 read its packs: staged
    groups, else interleaved where `_interleaves`, else direct."""
    if math.prod(dims) * dtype.itemsize <= fused.GROUP_BYTES:
        return "staged_groups"
    return "interleaved" if fused._interleaves(dims, dtype, nch, free) else "direct"


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("k", fused.DEGREES)
def test_k7_stack_routes_do_not_move(dtype, k):
    """K7 keeps its own routes on every stack where K5 cubic now reads its
    packs, whatever the free bytes: no spline stack takes a taps route."""
    moved = 0
    for dims in ((40,) * 3, (20,) * 4, (12,) * 5, (300, 300), (31,) * 3, (100,) * 3):
        for nch in (1, 3, 4, 8, 9):
            for free in (None, 0, 10**6, 10**10):
                got = fused.bspline_route(dims, dtype, k, nch, free)
                assert got == _k7_route_before(dims, dtype, nch, free), (dims, nch, free)
                assert got not in fused.TAP_ROUTES
                moved += fused.regular_route(dims, dtype, "cubic", nch, free) in fused.TAP_ROUTES
    assert moved > 0


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_stacks_past_int32_indices_read_direct(dtype):
    """A K7 stack whose interleave would hold 2^31 entries or more (here 16
    tables of 2^27) reads direct, as the interleave needs int32 indices;
    one entry fewer interleaves. K5 cubic never interleaves."""
    dims = (2**9, 2**9, 2**9)
    assert fused.bspline_route(dims, dtype, 3, 16) == "direct"
    assert fused.bspline_route((2**9, 2**9, 2**9 - 1), dtype, 3, 16) == "interleaved"
    assert fused.regular_route(dims, dtype, "cubic", 16) == "direct"


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("family,method", [("regular", "linear"), ("regular", "nearest"),
                                           ("rectilinear", "cubic"), ("rectilinear", "linear"),
                                           ("rectilinear", "nearest")])
def test_wide_stacks_past_int32_indices_read_direct(family, method, dtype):
    """A K5 linear or nearest stack, and a K6 cubic, linear or nearest one,
    of RUN_BYTES of channels or more interleaves only while the interleave
    holds fewer than 2^31 entries: 16 tables of 512^3 read direct, 16 of
    512 x 512 x 511 interleaved (each table alone has int32 indices)."""
    choose = fused.regular_route if family == "regular" else fused.rectilinear_route
    assert 16 * 2**27 == 2**31 and 16 * 2**18 * 511 < 2**31
    assert choose((2**9, 2**9, 2**9), dtype, method, 16) == "direct"
    assert choose((2**9, 2**9, 2**9 - 1), dtype, method, 16) == "interleaved"


INTERLEAVING = [("K5", "regular", "linear"), ("K5", "regular", "nearest"),
                ("K6", "rectilinear", "cubic"), ("K6", "rectilinear", "linear"),
                ("K6", "rectilinear", "nearest"), ("K7", "bspline", 3), ("K7", "bspline", 5)]


@pytest.mark.parametrize("dtype,nch", [(F32, 8), (F64, 4)], ids=["f32x8", "f64x4"])
@pytest.mark.parametrize("kernel,family,method", INTERLEAVING,
                         ids=[f"{k}-{f}-{m}" for k, f, m in INTERLEAVING])
def test_interleave_needs_its_copy_to_fit_free_memory(kernel, family, method, dtype, nch):
    """Each call allocates the interleaved copy of the whole stack beside
    it, so a stack interleaves only while that copy fits the free bytes of
    its device: interleaved with exactly the copy's bytes free, direct with
    one byte fewer; with no bound (None, as on the CPU) interleaved."""
    dims = (40, 40, 40)  # each table above STAGE_BYTES and GROUP_BYTES
    choose = {"regular": fused.regular_route, "rectilinear": fused.rectilinear_route,
              "bspline": fused.bspline_route}[family]
    copy = nch * math.prod(dims) * dtype.itemsize
    assert choose(dims, dtype, method, nch) == "interleaved"
    assert choose(dims, dtype, method, nch, copy) == "interleaved"
    assert choose(dims, dtype, method, nch, copy - 1) == "direct"
    assert choose(dims, dtype, method, nch, 0) == "direct"
    assert choose(dims, dtype, method, None, 0) == choose(dims, dtype, method)  # one table


def test_free_bytes_only_on_the_card(monkeypatch):
    """The free bytes are asked of CUDA tensors' devices alone, once."""
    asked = []
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: asked.append(device) or (123, 456))

    class OnCard:
        device = torch.device("cuda", 0)

    assert fused.free_bytes(torch.zeros(1)) is None and asked == []
    assert fused.free_bytes(OnCard()) == 123 and asked == [torch.device("cuda", 0)]


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("ndims", [1, 2, 3, 5])
def test_bspline_route_of_one_table_at_the_cap(k, dtype, ndims):
    """One coefficient table (K4) is staged in shared memory while it fits
    GROUP_BYTES, as one group of `staged_groups`, and read direct one row
    over; every bench table fits."""
    at = _stack_dims(fused.GROUP_BYTES, dtype, ndims)
    assert math.prod(at) * dtype.itemsize <= fused.GROUP_BYTES
    assert fused.bspline_route(at, dtype, k) == "staged_groups"
    assert fused.bspline_route((at[0] + 1, *at[1:]), dtype, k) == "direct"
    for dims in ((20,) * 3, (100,) * 2):
        assert fused.bspline_route(dims, dtype, k) == "staged_groups"


def test_stack_routes_of_the_bench_stacks():
    """The stack paths of `chip_smoke.py` and the A/B script's stacks, with
    the groups the C entry splits them into (`_groups`)."""
    want = {((20,) * 3, F32, 8): ("staged_groups", 2), ((20,) * 3, F32, 3): ("staged_groups", 1),
            ((20,) * 3, F32, 9): ("staged_groups", 2), ((20,) * 3, F64, 4): ("staged_groups", 2),
            ((21,) * 3, F64, 3): ("staged_groups", 1), ((21,) * 3, F64, 8): ("staged_groups", 3),
            ((40,) * 3, F32, 8): ("tap_lanes", None), ((12,) * 4, F32, 8): ("staged_groups", 4),
            ((40,) * 3, F64, 3): ("tap_lanes", None), ((20,) * 4, F64, 8): ("tap_lanes", None)}
    for (dims, dtype, nch), (route, groups) in want.items():
        assert fused.regular_route(dims, dtype, "cubic", nch) == route, (dims, dtype, nch)
        spline = {"tap_lanes": "direct"}.get(route, route)
        spline = "interleaved" if (dims, nch) in (((40,) * 3, 8), ((20,) * 4, 8)) else spline
        assert fused.bspline_route(dims, dtype, 3, nch) == spline, (dims, dtype, nch)
        if groups:
            assert _groups(math.prod(dims) * dtype.itemsize, nch) == groups, (dims, dtype, nch)


# The group split of csrc/regular.cuh, emulated: `table_groups` (how many),
# `table_group` (which tables) and `block_group` (which blocks).


def _groups(table_bytes, nch):
    """table_groups: the fewest groups of at most GROUP_BYTES // table tables."""
    per = fused.GROUP_BYTES // table_bytes
    return -(-nch // per) if per else 0


def _group_tables(nch, groups):
    """table_group: consecutive tables, the first nch % groups one larger."""
    q, r = divmod(nch, groups)
    starts = [g * q + min(g, r) for g in range(groups + 1)]
    return [range(a, b) for a, b in zip(starts, starts[1:])]


def _block_group(nch, groups, blocks, b):
    """block_group: (group, its first block, its blocks) of block b."""
    for g, tables in enumerate(_group_tables(nch, groups)):
        lo, hi = blocks * tables.start // nch, blocks * tables.stop // nch
        if b < hi or g == groups - 1:
            return g, lo, hi - lo
    raise AssertionError("no group")


@pytest.mark.parametrize("per", [1, 2, 3, 4, 7])
def test_table_groups_split_evenly(per):
    """For every stack of up to 20 tables of which `per` fit GROUP_BYTES: the
    fewest groups whose largest holds at most `per` tables, consecutive,
    each table in exactly one, sizes differing by at most one (the first
    groups the larger)."""
    table = fused.GROUP_BYTES // per
    assert fused.GROUP_BYTES // table == per
    for nch in range(1, 21):
        groups = _groups(table, nch)
        split = _group_tables(nch, groups)
        assert [c for g in split for c in g] == list(range(nch))
        sizes = [len(g) for g in split]
        assert max(sizes) <= per and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)
        assert groups == 1 or math.ceil(nch / (groups - 1)) > per
    assert _groups(fused.GROUP_BYTES + 1, 1) == 0


@pytest.mark.parametrize("nch,groups", [(1, 1), (3, 1), (8, 2), (8, 3), (9, 2), (9, 3),
                                        (17, 6)])
@pytest.mark.parametrize("blocks", [17, 132, 133, 264])
def test_blocks_share_out_in_proportion_to_tables(nch, groups, blocks):
    """Every block runs one group, each group's blocks are consecutive and
    its share of the grid is its share of the tables, within one block; no
    group is left without a block where blocks >= nch (the grid's least)."""
    got = [_block_group(nch, groups, blocks, b) for b in range(blocks)]
    split = _group_tables(nch, groups)
    for g, tables in enumerate(split):
        mine = [b for b, (h, _, _) in enumerate(got) if h == g]
        lo, nb = got[mine[0]][1:]
        assert mine == list(range(lo, lo + nb))
        assert abs(nb - blocks * len(tables) / nch) < 1
    assert sum(got[b][2] for b in range(blocks) if got[b][1] == b) == blocks
