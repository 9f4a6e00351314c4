"""The cubic pack that K1's taps routes read, and the packs of a stack that
K5's read, on the CPU: their index contract, an evaluation read through
them as the kernels read them (one thread a query, and four lanes a query;
a stack's tables one after another, each through its pack at its offset)
bit for bit equal to the plain version (`plain_regular` cubic,
`plain_regular_stack`) at 1-8D with extrapolated, NaN and +-inf queries,
the same read against the JAX package's cubic gather tree at its bars (f32
rtol 1e-4, f64 rtol 1e-13, exact at nodes), and `regular_route` for cubic
at and across each cap.

The kernels themselves run only on a card (`tests/test_torch_gpu.py`,
`chip_smoke.py`); what is held here is what they assume of the layout.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64 before any jax use)
import jax.numpy as jnp

from interpn_tpu.ops import cubic as jcubic
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import fused
from interpn_tpu_torch.ops.cubic import _axis_reduce_regular
from interpn_tpu_torch.ops.locate import locate_regular_cubic

from .test_torch_regular_layout import _bitwise, _c_strides, _case

F32, F64 = torch.float32, torch.float64
DIMS = [(9,), (6, 7), (5, 4, 6), (4, 5, 4, 4), (4, 4, 5, 4, 4), (4,) * 6, (4,) * 7, (4,) * 8]
READS = ["one_lane", "four_lanes"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _n(dims):
    """Queries a case: fewer for the 4^7 and 4^8 stencils."""
    return 300 if len(dims) <= 6 else 40


# --- the pack -------------------------------------------------------------------------


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
def test_cubic_pack_index_contract(dims):
    """Cell (i, r...) of the cubic pack holds entry (i + a, r...) in slot a,
    over (d0-3, d1, ..., dN-1) cells; its CPU route is its plain version."""
    rng = np.random.default_rng(len(dims))
    vals = torch.from_numpy(rng.standard_normal(math.prod(dims)))
    packed = fused.cubic_pack(dims, vals)
    assert torch.equal(packed, fused.plain_cubic_pack(dims, vals))
    assert packed.shape == (dims[0] - 3, *dims[1:], 4)
    assert packed.numel() == fused._taps_size(dims)
    v = vals.reshape(dims)
    cells = itertools.product(range(dims[0] - 3), *(range(d) for d in dims[1:]))
    for cell in itertools.islice(cells, 0, None, max(1, math.prod(dims) // 512)):
        for a in range(4):
            assert packed[cell][a] == v[(cell[0] + a, *cell[1:])]


@pytest.mark.parametrize("nch", [1, 3, 8, 9])
@pytest.mark.parametrize("dims", DIMS[:5], ids=lambda d: f"{len(d)}d")
def test_cubic_stack_pack_is_each_table_pack(dims, nch):
    """The packs of a stack lie table after table: row c of
    `plain_cubic_stack_pack` is `plain_cubic_pack` of table c, the whole
    is `_layout_size` entries on the taps routes, and the pack's CPU route
    is its plain version."""
    rng = np.random.default_rng(nch)
    stack = torch.from_numpy(rng.standard_normal((nch, math.prod(dims))))
    packed = fused.cubic_stack_pack(dims, stack)
    assert torch.equal(packed, fused.plain_cubic_stack_pack(dims, stack))
    assert packed.shape == (nch, dims[0] - 3, *dims[1:], 4)
    for c in range(nch):
        assert torch.equal(packed[c], fused.plain_cubic_pack(dims, stack[c]))
    for route in fused.TAP_ROUTES:
        assert fused._layout_size(dims, route, stack) == packed.numel()
        assert fused._layout_size(dims, route, stack) == nch * fused._taps_size(dims)
        assert fused._layout_size(dims, route, stack[0]) == fused._taps_size(dims)


# --- the route ------------------------------------------------------------------------


@pytest.mark.parametrize("ndims", range(1, 9))
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_cubic_route_at_each_cap(ndims, dtype):
    """One cubic table (d0, 4, ..., 4): staged while the table fits
    STAGE_BYTES; then its cubic pack, read by one lane a query at 2D and
    four from 3D, while the pack fits TAP_BYTES, but direct for an f64
    table of at most L1_BYTES at 2-3D; then direct. A 1-D table reads
    direct beyond the staging cap. A stack of cubic tables is staged in
    groups within GROUP_BYTES a table, else read through the tables' packs
    where one table would be (`_stack_route`,
    tests/test_torch_stack_cubic.py)."""
    item = torch.empty((), dtype=dtype).element_size()
    rest = 4 ** (ndims - 1)
    packed = {1: "direct", 2: "taps"}.get(ndims, "tap_lanes")

    def route(d0, nch=None):
        return fused.regular_route((d0, *(4,) * (ndims - 1)), dtype, "cubic", nch)

    at_stage = fused.STAGE_BYTES // (rest * item)
    if at_stage >= 4:
        assert route(at_stage) == "staged"
        assert route(at_stage, 1) == route(at_stage, 3) == "staged_groups"
    in_l1 = dtype == F64 and ndims <= 3
    assert route(max(at_stage + 1, 4)) == ("direct" if in_l1 else packed)
    if in_l1:
        at_l1 = fused.L1_BYTES // (rest * item)
        assert route(at_l1) == "direct" and route(at_l1 + 1) == packed
    at_tap = fused.TAP_BYTES // (4 * rest * item) + 3
    assert fused._taps_size((at_tap, *(4,) * (ndims - 1))) * item <= fused.TAP_BYTES
    assert route(at_tap) == packed and route(at_tap + 1) == "direct"
    assert route(at_tap, 8) == packed


def test_cubic_route_of_the_bench_tables():
    """The four cubic paths of `chip_smoke.py`, and the tables whose timing
    on an H100 set the caps (PERF.md, "the choices")."""
    want = {((20,) * 3, F32): "staged", ((20,) * 3, F64): "staged",
            ((20,) * 4, F32): "tap_lanes", ((12,) * 5, F64): "tap_lanes",
            ((30,) * 3, F32): "staged", ((30,) * 3, F64): "direct",
            ((35,) * 3, F64): "tap_lanes", ((100,) * 3, F64): "tap_lanes",
            ((200, 200), F32): "taps", ((40_000,), F32): "direct"}
    for (dims, dtype), route in want.items():
        assert fused.regular_route(dims, dtype, "cubic") == route, (dims, dtype)


# --- evaluation through the pack, as the kernel reads it ----------------------------


def _through_taps(dims, starts, steps, vals, obs, lin, read, packed=None):
    """Cubic evaluation read as the taps routes read: each query's cell in
    the cubic pack (the located corner over the pack's strides), one cell a
    vertex of the other axes' 4^(N-1) stencil, each cell's four taps reduced
    by axis 0's node, then the tree over axes 1, 2, ... in groups of four
    (axis 1 in the lowest digit). On "four_lanes" the four children of the
    outermost axis are reduced apart, each over axes 1..N-2 as a lane runs
    its subtree, and joined by the outermost axis's node. `packed` is the
    flat pack read (the table's own by default)."""
    nd = len(dims)
    per = [locate_regular_cubic(obs[k], starts[k], steps[k], dims[k]) for k in range(nd)]
    if packed is None:
        packed = fused.cubic_pack(dims, vals).reshape(-1)
    strides = _c_strides((dims[0] - 3, *dims[1:]))
    base = sum(cl.loc * s for cl, s in zip(per, strides))

    def node(k, v):
        cl = per[k]
        return _axis_reduce_regular(v, cl.t, cl.low, cl.high, cl.outside, lin)

    def reduce(rows, first):  # groups of four adjacent rows, axis `first` first
        k = first
        while rows.shape[0] > 1:
            g = rows.reshape(rows.shape[0] // 4, 4, -1)
            rows = node(k, (g[:, 0], g[:, 1], g[:, 2], g[:, 3]))
            k += 1
        return rows[0]

    offsets = torch.tensor([sum(d * strides[1 + k] for k, d in enumerate(reversed(digits)))
                            for digits in itertools.product(range(4), repeat=nd - 1)])
    taps = packed.reshape(-1, 4)[base[None, :] + offsets[:, None]]  # (4^(N-1), n, 4)
    leaves = node(0, (taps[..., 0], taps[..., 1], taps[..., 2], taps[..., 3]))
    if read == "one_lane" or nd == 1:
        return reduce(leaves, 1)
    lanes = leaves.reshape(4, -1, leaves.shape[-1])  # by the outermost axis's digit
    return node(nd - 1, tuple(reduce(lane, 1) for lane in lanes))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
@pytest.mark.parametrize("read", READS)
def test_taps_read_equals_plain(dims, dtype, lin, read):
    st, sp, vals, obs = _case(dims, dtype, _n(dims), seed=len(dims))
    _bitwise(_through_taps(dims, st, sp, vals, obs, lin, read),
             fused.plain_regular(dims, st, sp, vals, obs, "cubic", lin))


@pytest.mark.parametrize("dims", DIMS[1:], ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
@pytest.mark.parametrize("read", READS)
def test_stack_taps_read_equals_plain(dims, dtype, lin, read):
    """A stack of 3 tables read as K5's taps routes read it: the flat packs
    of the whole stack, table c's `_layout_size` / nch entries in at its
    offset, each table's tree over its own pack: bitwise the plain stack."""
    nch = 3
    st, sp, vals, obs = _case(dims, dtype, _n(dims) // 3, seed=20 + len(dims))
    rng = np.random.default_rng(len(dims))
    stack = torch.as_tensor(rng.standard_normal((nch, math.prod(dims))), dtype=dtype)
    stack[1, rng.integers(0, stack.shape[1], 3)] = torch.tensor([np.nan, np.inf, -np.inf],
                                                               dtype=dtype)
    flat = fused.cubic_stack_pack(dims, stack).reshape(-1)
    table = fused._layout_size(dims, "tap_lanes", stack) // nch
    got = torch.stack([_through_taps(dims, st, sp, None, obs, lin, read,
                                     flat[c * table:(c + 1) * table]) for c in range(nch)])
    _bitwise(got, fused.plain_regular_stack(dims, st, sp, stack, obs, "cubic", lin))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("lin", [True, False], ids=["linearize", "quadratic"])
def test_taps_read_matches_jax(dims, dtype, lin):
    """The read through the pack against `interpn_tpu.ops.cubic.cubic_regular`
    on the same numpy inputs, at the JAX package's bars."""
    st, sp, vals, obs = _case(dims, dtype, _n(dims), seed=10 + len(dims))
    got = _through_taps(dims, st, sp, vals, obs, lin, "four_lanes").numpy()
    want = np.asarray(jcubic.cubic_regular(
        dims, jnp.asarray(st.numpy()), jnp.asarray(sp.numpy()), jnp.asarray(vals.numpy()),
        tuple(jnp.asarray(o.numpy()) for o in obs), lin))
    tol = 1e-4 if dtype == F32 else 1e-13
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("read", READS)
def test_taps_read_exact_at_nodes(dtype, read):
    """Every node of a 9 x 6 x 5 x 4 grid, both extrapolation modes: the
    read through the pack returns the table, as the JAX gather tree does."""
    dims = (9, 6, 5, 4)
    rng = np.random.default_rng(4)
    vals = torch.as_tensor(rng.standard_normal(math.prod(dims)), dtype=dtype)
    idx = np.stack(np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")).reshape(4, -1)
    st, sp = torch.zeros(4, dtype=dtype), torch.full((4,), 0.5, dtype=dtype)
    obs = tuple(torch.as_tensor(i * 0.5, dtype=dtype) for i in idx)
    for lin in (True, False):
        got = _through_taps(dims, st, sp, vals, obs, lin, read)
        _bitwise(got, vals)
        want = jcubic.cubic_regular(dims, jnp.asarray(st.numpy()), jnp.asarray(sp.numpy()),
                                    jnp.asarray(vals.numpy()),
                                    tuple(jnp.asarray(o.numpy()) for o in obs), lin)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
