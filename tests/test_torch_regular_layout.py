"""The layouts the regular kernels (K1, K5) read, on the CPU: the route
(`ops/fused.py::regular_route`) at and around its two caps, the packed quads
and the channel-interleaved stack against the index contract the kernels
rely on, and an evaluation through each layout in torch, read as the
kernels read it, bit for bit equal to the plain versions (`plain_regular`,
`plain_regular_stack`) at 1-8D with NaN and +-inf queries.

The kernels themselves run only on a card (`tests/test_torch_gpu.py`,
`chip_smoke.py`); what is held here is what they assume of the layouts.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from interpn_tpu_torch import config
from interpn_tpu_torch.ops import fused
from interpn_tpu_torch.ops.linear import _lerp_reduce
from interpn_tpu_torch.ops.locate import locate_regular_linear

F32, F64 = torch.float32, torch.float64
DIMS = [(7,), (5, 6), (4, 5, 3), (3, 4, 2, 3), (2, 3, 3, 2, 2), (3, 2, 2, 2, 3, 2),
        (2,) * 7, (2, 3, 2, 2, 2, 2, 2, 2)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


# --- the route --------------------------------------------------------------------


def _entries(dtype, nbytes):
    return nbytes // torch.empty((), dtype=dtype).element_size()


def test_route_at_the_stage_cap():
    """f32 linear tables of at most STAGE_BYTES are staged; one entry more
    and they read packed quads. Cubic tables are staged up to the same cap
    (`tests/test_torch_cubic_layout.py` holds their other caps); nearest
    reads the table at any size. The whole table counts, whatever its
    shape."""
    at = _entries(F32, fused.STAGE_BYTES)
    for dims in ((at,), (at // 64, 64), (at // 256, 16, 16)):
        assert math.prod(dims) == at
        assert fused.regular_route(dims, F32, "linear") == "staged"
        assert fused.regular_route(dims, F32, "nearest") == "direct"
        assert fused.regular_route(dims, F32, "cubic") == "staged"
    for dims in ((at + 1,), (at // 64 + 1, 64)):
        assert fused.regular_route(dims, F32, "linear") == "quads"
        assert fused.regular_route(dims, F32, "nearest") == "direct"


def test_f64_reads_its_table_direct():
    """Linear and nearest f64 are never staged nor packed, whatever the
    table's size or the stack's: a table and a narrow stack read direct, a
    wide stack interleaved. One cubic f64 table is staged within STAGE_BYTES
    and read through its cubic pack beyond L1_BYTES (`_cubic_route`); a
    cubic stack is staged in groups of tables where each fits GROUP_BYTES,
    else read through the tables' packs as one table is (`_stack_route`)."""
    cubic = {(50,): "staged", (20,) * 3: "staged", (12,) * 4: "tap_lanes",
             (100,) * 3: "tap_lanes"}
    # a stack's tables within GROUP_BYTES, but 100^3
    stack = {(100,) * 3: "tap_lanes"}
    for dims in ((50,), (20,) * 3, (12,) * 4, (100,) * 3):
        for method in ("linear", "cubic", "nearest"):
            for nch in (None, 1, 3, 8):
                wide = nch == 8 and method != "cubic"
                want = "interleaved" if wide else "direct"
                if method == "cubic":
                    want = cubic[dims] if nch is None else stack.get(dims, "staged_groups")
                assert fused.regular_route(dims, F64, method, nch) == want


def test_route_of_stacks():
    """An f32 linear stack read table by table (fewer than 8 tables) is
    staged while all its tables together fit STAGE_BYTES, else direct; a
    wide one (8 or more) is interleaved at any size; a stack is never
    packed, and a stack of one is staged as its table is."""
    at = _entries(F32, fused.STAGE_BYTES)
    for nch in (1, 3, 7):
        assert fused.regular_route((at // nch,), F32, "linear", nch) == "staged"
        assert fused.regular_route((at // nch + 1,), F32, "linear", nch) == "direct"
    for nch in (1, 3, 8):
        wide = "interleaved" if nch == 8 else "direct"
        assert fused.regular_route((at // nch,), F32, "nearest", nch) == wide
        assert fused.regular_route((at // nch,), F32, "cubic", nch) == "staged_groups"
    assert fused.regular_route((at // 8,), F32, "linear", 8) == "interleaved"
    # the bench's stack of 8 20^3 f32 tables (256 KB) reads from device memory
    assert fused.regular_route((20,) * 3, F32, "linear", 8) == "interleaved"
    assert fused.regular_route((20,) * 3, F32, "linear", 3) == "staged"


def test_route_at_the_quad_cap():
    """An f32 linear table above STAGE_BYTES reads packed quads while the
    packed copy fits QUAD_BYTES, else the table; the bench's tables fall
    so."""
    # (d0-1)(d1-1)prod(rest) = 2^20 cells of 4 f32 entries: the cap exactly
    assert fused._packed_size((129, 129, 64)) * 4 == fused.QUAD_BYTES
    assert fused.regular_route((129, 129, 64), F32, "linear") == "quads"
    assert fused.regular_route((129, 129, 65), F32, "linear") == "direct"
    assert fused._packed_size((2**21 + 1,)) * 4 == fused.QUAD_BYTES
    assert fused.regular_route((2**21 + 1,), F32, "linear") == "quads"
    assert fused.regular_route((2**21 + 2,), F32, "linear") == "direct"
    bench = {((20,) * 3, F32): "staged", ((20,) * 3, F64): "direct",
             ((100,) * 3, F32): "quads", ((100,) * 3, F64): "direct",
             ((200,) * 3, F32): "direct"}
    for (dims, dtype), route in bench.items():
        assert fused.regular_route(dims, dtype, "linear") == route, (dims, dtype)


# --- the packed quads -----------------------------------------------------------------


def test_pack_index_contract():
    """Cell (i, j, r...) of the packed copy holds corner (i + a, j + b, r...)
    in slot a + 2b; a 1-D table packs (i, i + 1) pairs; the pack's CPU
    route is its plain version."""
    rng = np.random.default_rng(0)
    for dims in DIMS:
        vals = torch.from_numpy(rng.standard_normal(math.prod(dims)))
        packed = fused.pack(dims, vals)
        assert torch.equal(packed, fused.plain_pack(dims, vals))
        assert packed.numel() == fused._packed_size(dims)
        v = vals.reshape(dims)
        if len(dims) == 1:
            assert packed.shape == (dims[0] - 1, 2)
            for i in range(dims[0] - 1):
                assert packed[i].tolist() == [v[i].item(), v[i + 1].item()]
            continue
        assert packed.shape == (dims[0] - 1, dims[1] - 1, *dims[2:], 4)
        for cell in itertools.product(*(range(d - (k < 2)) for k, d in enumerate(dims))):
            for a, b in itertools.product((0, 1), (0, 1)):
                corner = (cell[0] + a, cell[1] + b, *cell[2:])
                assert packed[cell][a + 2 * b] == v[corner]


# --- evaluation through each layout, as the kernels read it -----------------------


def _case(dims, dtype, n, seed, nch=None):
    """A random grid, table (or stack) and queries over the grid and past
    each side, with NaN and +-inf mixed in."""
    rng = np.random.default_rng(seed)
    nd = len(dims)
    starts = rng.uniform(-1, 1, nd)
    steps = rng.uniform(0.3, 1.0, nd)
    shape = math.prod(dims) if nch is None else (nch, math.prod(dims))
    vals = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    obs = []
    for k in range(nd):
        lo, hi = starts[k], starts[k] + steps[k] * (dims[k] - 1)
        o = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), n)
        o[rng.integers(0, n, 12)] = rng.choice([np.nan, np.inf, -np.inf], 12)
        obs.append(torch.as_tensor(o, dtype=dtype))
    return (torch.as_tensor(starts, dtype=dtype), torch.as_tensor(steps, dtype=dtype), vals,
            tuple(obs))


def _locate(dims, starts, steps, obs):
    out = [locate_regular_linear(obs[k], starts[k], steps[k], dims[k]) for k in range(len(dims))]
    return [loc for loc, _ in out], [t for _, t in out]


def _c_strides(shape):
    return [math.prod(shape[k + 1:]) for k in range(len(shape))]


def _through_quads(dims, starts, steps, vals, obs):
    """Linear evaluation read as the quads route reads: the cell's index in
    the packed copy, one pair or quad per corner of the axes past the first
    two, each reduced by the tree's first levels, then the rest of the tree
    depth first (axis 2 first)."""
    locs, ts = _locate(dims, starts, steps, obs)
    packed = fused.pack(dims, vals)
    leaf = 1 if len(dims) == 1 else 2
    cells = packed.reshape(-1, 2**leaf)
    strides = _c_strides(tuple(packed.shape[:-1]))
    base = sum(loc * s for loc, s in zip(locs, strides))
    leaves = []
    for corner in itertools.product((0, 1), repeat=len(dims) - leaf):  # last axis slowest
        off = sum(c * strides[leaf + k] for k, c in enumerate(reversed(corner)))
        q = cells[base + off]
        y = q[:, 0] + ts[0] * (q[:, 1] - q[:, 0])
        if leaf == 2:
            y1 = q[:, 2] + ts[0] * (q[:, 3] - q[:, 2])
            y = y + ts[1] * (y1 - y)
        leaves.append(y)
    # `leaves` is in vertex order of the remaining axes (axis `leaf` in the lowest digit)
    return _lerp_reduce(leaves, ts[leaf:]) if len(leaves) > 1 else leaves[0]


def _through_interleaved(dims, starts, steps, stack, obs, method):
    """Linear or nearest evaluation of a stack read as the kernel reads a
    wide one: the (prod(dims), nch) interleaved copy, each corner's channels
    as one row, the per-channel trees on the rows."""
    return _read_interleaved(dims, stack, *_locate(dims, starts, steps, obs), method)


def _read_interleaved(dims, stack, locs, ts, method):
    """`_through_interleaved` on each axis's cells and coordinates (`locs`,
    `ts`), however located (K5's and K6's reads differ only there)."""
    inter = fused.interleave(stack)
    strides = _c_strides(dims)
    if method == "nearest":
        flat = sum((loc + torch.where(t <= 0.5, 0, 1)) * s for loc, t, s in zip(locs, ts, strides))
        return inter[flat].t()
    base = sum(loc * s for loc, s in zip(locs, strides))
    corners = []
    for corner in itertools.product((0, 1), repeat=len(dims)):
        off = sum(c * strides[k] for k, c in enumerate(reversed(corner)))
        corners.append(inter[base + off].t())  # (nch, n)
    return _lerp_reduce(corners, [t[None] for t in ts])


def _bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_quads_read_equals_plain(dims, dtype):
    st, sp, vals, obs = _case(dims, dtype, 500, seed=len(dims))
    _bitwise(_through_quads(dims, st, sp, vals, obs),
             fused.plain_regular(dims, st, sp, vals, obs, "linear"))


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_which_stacks_interleave(dtype):
    """Linear and nearest stacks of 32 bytes of channels or more (8 f32, 4
    f64 tables) are read interleaved; smaller ones as given, cubic ones
    never (`_stack_route`), and never a single table."""
    wide = 32 // torch.empty((), dtype=dtype).element_size()
    for dims in ((20,) * 3, (100,) * 3):
        for method in ("linear", "nearest"):
            assert fused.regular_route(dims, dtype, method, wide - 1) != "interleaved"
            assert fused.regular_route(dims, dtype, method, wide) == "interleaved"
            assert fused.regular_route(dims, dtype, method, 3 * wide + 1) == "interleaved"
            assert fused.regular_route(dims, dtype, method) != "interleaved"
        assert fused.regular_route(dims, dtype, "cubic", 4 * wide) != "interleaved"


def test_interleave_index_contract():
    """Row e of the interleaved copy holds entry e of every table, table c
    in column c; the interleave's CPU route is its plain version, for the
    regular and the rectilinear source alike."""
    rng = np.random.default_rng(1)
    for nch, entries in ((1, 7), (3, 5), (8, 60), (9, 24)):
        stack = torch.from_numpy(rng.standard_normal((nch, entries)))
        inter = fused.interleave(stack)
        assert torch.equal(inter, fused.plain_interleave(stack))
        assert torch.equal(fused.interleave(stack, "rectilinear"), inter)
        assert inter.shape == (entries, nch) and inter.is_contiguous()
        for e, c in itertools.product(range(entries), range(nch)):
            assert inter[e, c].item() == stack[c, e].item()
    with pytest.raises(ValueError, match="family"):
        fused.interleave(stack, "bspline")


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("nch", [4, 8, 9, 16])
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
def test_interleaved_read_equals_plain(dims, nch, method, dtype):
    st, sp, stack, obs = _case(dims, dtype, 300, seed=nch, nch=nch)
    _bitwise(_through_interleaved(dims, st, sp, stack, obs, method),
             fused.plain_regular_stack(dims, st, sp, stack, obs, method))
