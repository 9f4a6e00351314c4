"""The layouts the f64 engines' kernels read, on the CPU: K8's packed hi/lo
taps (`ops/df64.py::plain_taps`) and K9's weight operand and MMA fragments
(`_level_weights`, `_plain_levels` and an emulation of
`csrc/fused_i8.cu`'s lane mapping, here), held against the flat split, the
cell-major pieces and the plain contractions. All comparisons are bitwise:
the taps and pieces are copies, the int32 level sums exact in any order.
(The engines' entries on CPU tensors are held against the JAX engines in
`tests/test_torch_df64.py` and `tests/test_torch_i8.py`.)"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64)
from jax.experimental import pallas as pl

from interpn_tpu_torch import config
from interpn_tpu_torch.ops import bspline, df64, fused, i8
from interpn_tpu_torch.utils import c_strides


@pytest.fixture(autouse=True)
def _on_cpu_interpret(monkeypatch):
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    with config.device("cpu"):
        yield


SHAPES = [(9, 7), (6, 7, 8), (5, 6, 4, 7), (4, 5, 4, 4, 6), (4,) * 6, (4, 4, 3, 4, 4, 4, 3),
          (3,) * 8]


def _t(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _regular(dims, seed, n):
    """Random starts, steps and table; queries up to two cells past each
    side, with NaN and +-inf mixed in."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(dims))
    steps = rng.uniform(0.3, 1.0, len(dims))
    vals = rng.standard_normal(math.prod(dims))
    obs = [rng.uniform(starts[k] - 2 * steps[k], starts[k] + steps[k] * (dims[k] + 1), n)
           for k in range(len(dims))]
    for o in obs:
        o[rng.integers(0, n, 3)] = rng.choice([np.nan, np.inf, -np.inf], 3)
    return _t((starts, steps)), torch.from_numpy(vals), _t(obs)


# --- K8: the packed hi/lo taps ---------------------------------------------------------


@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("fp", [2, 4, 6])
def test_taps_hold_the_split(dims, fp):
    """Cell (row, j) of the taps holds the split's hi then lo parts of
    entries j .. j + fp - 1 along the last axis of table row `row`."""
    dims = tuple(max(d, fp) for d in dims)
    vals = torch.from_numpy(np.random.default_rng(len(dims)).standard_normal(math.prod(dims)))
    vh, vl, _ = df64.table_split(vals)
    taps = df64.plain_taps(dims, fp, vh, vl)
    last = dims[-1] - fp + 1
    assert taps.shape == (math.prod(dims[:-1]) * last, 2 * fp) and taps.dtype == torch.float32
    h = vh.numpy().reshape(-1, dims[-1])
    lo = vl.numpy().reshape(-1, dims[-1])
    want = np.stack([np.concatenate([h[:, j:j + fp], lo[:, j:j + fp]], axis=1)
                     for j in range(last)], axis=1).reshape(-1, 2 * fp)
    np.testing.assert_array_equal(taps.numpy(), want)
    assert df64.table_taps(vals, dims, fp) is df64.table_taps(vals, dims, fp)
    torch.testing.assert_close(df64.table_taps(vals, dims, fp), taps, rtol=0, atol=0)


def _contract_through_taps(dims, fp, locs, wh, wl, taps):
    """K8's contraction as `csrc/fused_df64.cu` reads it: each stencil row of
    the leading axes one packed cell at packed offset sum(loc * pstride),
    then `plain_df64`'s steps."""
    nd = len(dims)
    n = locs.shape[1]
    pstride = [0] * nd
    pstride[-1] = 1
    acc = 1
    for k in range(nd - 2, -1, -1):
        acc *= dims[-1] - fp + 1 if k == nd - 2 else dims[k + 1]
        pstride[k] = acc
    base = sum(locs[k].to(torch.int64) * pstride[k] for k in range(nd))
    rows = torch.zeros(1, dtype=torch.int64)
    for k in range(nd - 1):
        rows = (rows[:, None] + torch.arange(fp) * pstride[k]).reshape(-1)
    cells = taps[base[None, :] + rows[:, None]]  # (R, n, 2 fp)
    th = torch.zeros((rows.shape[0], n), dtype=torch.float32)
    tl = torch.zeros_like(th)
    w0 = (nd - 1) * fp
    for j in range(fp):
        th, tl = df64._df_madd(th, tl, cells[..., j], cells[..., fp + j], wh[w0 + j], wl[w0 + j])
    th, tl = df64._two_sum(th, tl)
    for k in range(nd - 2, -1, -1):
        g_h, g_l = th.reshape(-1, fp, n), tl.reshape(-1, fp, n)
        sh = torch.zeros_like(g_h[:, 0])
        sl = torch.zeros_like(sh)
        for b in range(fp):
            sh, sl = df64._df_madd(sh, sl, g_h[:, b], g_l[:, b], wh[k * fp + b], wl[k * fp + b])
        th, tl = df64._two_sum(sh, sl)
    return th[0], tl[0]


@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: f"{len(d)}d")
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_contraction_through_taps_is_plain_df64(dims, method):
    fp = df64.FOOTPRINT[method]
    dims = tuple(max(d, fp) for d in dims)
    (st, sp), vals, obs = _regular(dims, sum(dims), 200 if len(dims) <= 5 else 40)
    locs, wh, wl, _ = df64.weights_f64(dims, st, sp, None, obs, method, False)
    vh, vl, _ = df64.table_split(vals)
    got = _contract_through_taps(dims, fp, locs, wh, wl, df64.plain_taps(dims, fp, vh, vl))
    for g, w in zip(got, df64.plain_df64(dims, fp, locs, wh, wl, vh, vl)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("k", [3, 5])
def test_spline_contraction_through_taps_is_plain_df64(k):
    rng = np.random.default_rng(k)
    dims = (9, 8, 10)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    knots, coeffs = bspline.prep_bspline(grids, rng.standard_normal(math.prod(dims)), k)
    obs = _t([rng.uniform(g[0] - 1, g[-1] + 1, 150) for g in grids])
    locs, wh, wl, _ = df64.spline_weights_f64(_t(knots), obs, k)
    vh, vl, _ = df64.table_split(coeffs)
    got = _contract_through_taps(dims, k + 1, locs, wh, wl, df64.plain_taps(dims, k + 1, vh, vl))
    for g, w in zip(got, df64.plain_df64(dims, k + 1, locs, wh, wl, vh, vl)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


# --- K9: the weight operand and the MMA fragments ----------------------------------------


def _i8_operands(dims, method, seed, n):
    """The plain chain's K9 operands: cell-major pieces a (R, E, n, 8) int32
    of each query's stencil, its weight pieces bq (7, E, n), the per-axis
    weights, and `prepare`'s cell-major table."""
    fp = df64.FOOTPRINT[method]
    (st, sp), vals, obs = _regular(dims, seed, n)
    locs, wh, wl, _ = df64.weights_f64(dims, st, sp, None, obs, method, True)
    g, _, _ = i8._shape(dims)
    nd = len(dims)
    cwh, cwl = i8._combined_weights_df(wh, wl, nd, g, fp)
    bq, _ = i8._quantize_weights(cwh, cwl)
    pieces = i8.prepare(dims, vals)[0]
    strides = c_strides(dims)
    base = sum(locs[k].to(torch.int64) * strides[k] for k in range(nd))
    rows = i8._stencil_offsets(dims, fp, range(nd - g), torch.device("cpu"))
    cols = i8._stencil_offsets(dims, fp, range(nd - g, nd), torch.device("cpu"))
    cells = base[None, :] + rows[:, None]
    a = pieces[cells[:, None, :] + cols[None, :, None]].to(torch.int32)  # (R, E, n, 8)
    return a, bq, pieces, locs, cells


def _grouped(a, bq):
    """acc[r, s, n] as `_plain_i8_impl` sums the piece pairs."""
    groups = [0] * (i8.SMAX + 1)
    for i in range(i8.NPIECE_V):
        for j in range(i8.NPIECE_W):
            if i + j <= i8.SMAX:
                groups[i + j] = groups[i + j] + (a[..., i] * bq[j][None]).sum(dim=1)
    return torch.stack(groups, dim=1).to(torch.int32)


def _level_weights(bq):
    """K9's weight operand (`csrc/fused_i8.cu`, up to the order of K within
    a k-step of 32): B'[(e, i), s] = B_{s - i}[e] (0 where s - i is
    not a piece), (E * 8, 8, n) int32 from the (NPIECE_W, E, n) pieces of
    `_quantize_weights`: the level-s column of entry e's table piece i, so
    that one product of the (rows, E * 8) cell-major pieces by it gives each
    row's grouped sums."""
    npw, e, n = bq.shape
    out = torch.zeros((e, i8.NPIECE_V, i8.SMAX + 1, n), dtype=torch.int32, device=bq.device)
    for i in range(i8.NPIECE_V):
        for s in range(i, min(i + npw, i8.SMAX + 1)):
            out[:, i, s] = bq[s - i]
    return out.reshape(e * i8.NPIECE_V, i8.SMAX + 1, n)


def _plain_levels(a, bq):
    """The grouped sums acc[r, s, n] = sum over i + j = s <= SMAX of
    A_i[r, e, n] * B_j[e, n] as K9's MMAs form them: the cell-major pieces
    a (R, E, n, 8) as (R, E * 8) rows times `_level_weights(bq)`."""
    r, e, n, _ = a.shape
    rows = a.permute(0, 2, 1, 3).reshape(r, n, e * i8.NPIECE_V).to(torch.int64)
    cols = _level_weights(bq).permute(2, 0, 1).to(torch.int64)  # (n, E * 8, levels)
    return torch.einsum("rnk,nks->rsn", rows, cols).to(torch.int32)


I8_SHAPES = [((12, 12), "linear"), ((12, 12), "cubic"), ((9, 8, 10), "linear"),
             ((9, 8, 10), "cubic"), ((6, 7, 5, 6), "cubic"), ((6,) * 5, "cubic"),
             ((5,) * 6, "linear"), ((4,) * 6, "cubic"), ((4,) * 7, "cubic"), ((3,) * 8, "linear")]


@pytest.mark.parametrize("dims,method", I8_SHAPES, ids=lambda x: str(x))
def test_level_weights_give_the_grouped_sums(dims, method):
    """The products through `_level_weights` (rows of cell-major pieces, K =
    (entry, piece), N = the 8 levels) are the plain version's grouped
    piece-pair sums, integer for integer."""
    a, bq, *_ = _i8_operands(dims, method, seed=len(dims), n=60)
    torch.testing.assert_close(_plain_levels(a, bq), _grouped(a, bq), rtol=0, atol=0)


def _chunk_axes(fp, m):
    lc = 0
    while lc < m and fp ** (lc + 1) <= 16:
        lc += 1
    return lc


def _mma_levels(dims, fp, cells, cell, uwords, q):
    """One query's accumulators as `csrc/fused_i8.cu` forms them: per lane
    (g, t) of the warp, in each k-step k of a pass, its A registers (cell
    4 k + t of chunk rows g and g + 8: pieces 0-3 in the first and second,
    4-7 in the third and fourth) and B' registers (bytes 7 - g .. 10 - g and
    11 - g .. 14 - g of entry 4 k + t's staged word), placed as the
    m16n8k32 s8 fragments place them, multiplied and summed over the
    k-steps and passes: (RC, 8) int64 for the chunk whose first cell is
    `cell`; `cells` the cell-major pieces as (cells, 8) int64."""
    nd = len(dims)
    g_axes, _, _ = i8._shape(dims)
    m = nd - g_axes
    e_count = fp**g_axes
    lc = _chunk_axes(fp, m)
    rc = fp**lc
    ec = 32  # entries a pass, kPass
    ksteps = ec // 4
    strides = c_strides(dims)

    def entry_offset(e):
        off = 0
        for ax in range(nd - 1, nd - g_axes - 1, -1):
            off += (e % fp) * strides[ax]
            e //= fp
        return off

    def row_offset(r):
        off = 0
        for ax in range(m - 1, m - lc - 1, -1):
            off += (r % fp) * strides[ax]
            r //= fp
        return off

    def window(word, start):
        """Bytes start .. start + 3 of a 64-bit word as signed int8."""
        return [(((word >> (8 * (start + u))) & 0xFF) ^ 0x80) - 0x80 if start + u < 8 else 0
                for u in range(4)]

    acc = np.zeros((16, 8), dtype=np.int64)
    for p in range(e_count // ec):
        a_tile = np.zeros((ksteps, 16, 32), dtype=np.int64)
        b_tile = np.zeros((ksteps, 32, 8), dtype=np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for k in range(ksteps):
                word = int(uwords[q][p * ec + 4 * k + t])
                b_tile[k, 4 * t:4 * t + 4, g] = window(word, 7 - g)
                b_tile[k, 16 + 4 * t:16 + 4 * t + 4, g] = window(word, 11 - g)
                for h in range(2):
                    if g + 8 * h >= rc:
                        continue
                    c = (cell + row_offset(g + 8 * h) + entry_offset(t)
                         + entry_offset(p * ec) + entry_offset(4 * k))
                    a_tile[k, g + 8 * h, 4 * t:4 * t + 4] = cells[c, :4]
                    a_tile[k, g + 8 * h, 16 + 4 * t:16 + 4 * t + 4] = cells[c, 4:]
        acc += np.einsum("kmc,kcn->mn", a_tile, b_tile)
    return acc[:rc]


def _staged_words(bq):
    """Each entry's staged word: piece j at byte 7 - j (`quantize`)."""
    b = bq.numpy().astype(np.int64) & 0xFF  # (7, E, n)
    words = np.zeros(b.shape[1:], dtype=np.uint64)
    for j in range(b.shape[0]):
        words |= b[j].astype(np.uint64) << np.uint64(8 * (7 - j))
    return words.T  # (n, E)


def _entries(dims, method):
    return df64.FOOTPRINT[method] ** i8._shape(dims)[0]


MMA_SHAPES = [(dims, method) for dims, method in I8_SHAPES + [
    ((6, 5, 4, 5), "cubic"), ((8,) * 5, "cubic"), ((4,) * 8, "cubic")]
    if _entries(dims, method) > fused.DP4A_ENTRIES]


@pytest.mark.parametrize("dims,method", MMA_SHAPES, ids=lambda x: str(x))
def test_mma_fragments_give_the_grouped_sums(dims, method):
    """The lane mapping of K9's MMAs, emulated for a few queries on the
    cell-major pieces: every chunk's accumulators equal the plain version's
    grouped sums of its rows."""
    fp = df64.FOOTPRINT[method]
    a, bq, pieces, locs, cells = _i8_operands(dims, method, seed=sum(dims), n=6)
    want = _grouped(a, bq).numpy()  # (R, 8, n)
    cells_np = pieces.numpy().astype(np.int64)
    uwords = _staged_words(bq)
    g_axes, _, _ = i8._shape(dims)
    nd = len(dims)
    m = nd - g_axes
    rc = fp ** _chunk_axes(fp, m)
    for q in range(locs.shape[1]):
        for chunk in range(want.shape[0] // rc):
            first = int(cells[chunk * rc, q])  # the chunk's first row, trailing entry 0
            got = _mma_levels(dims, fp, cells_np, first, uwords, q)
            np.testing.assert_array_equal(got, want[chunk * rc:(chunk + 1) * rc, :, q])


def _funnel(lo, hi, shift):
    """`__funnelshift_rc(lo, hi, shift)`: the low 32 bits of hi:lo shifted
    right by min(shift, 32)."""
    return ((hi << 32 | lo) >> min(shift, 32)) & 0xFFFFFFFF


def _dp4a(a4, word):
    """`__dp4a(a, word, 0)` with `a` as four signed bytes."""
    b = [((word >> (8 * u) & 0xFF) ^ 0x80) - 0x80 for u in range(4)]
    return sum(int(x) * y for x, y in zip(a4, b))


def _dp4a_levels(a_row, words):
    """One stencil row's 8 levels as `row_levels` in `csrc/fused_i8.cu`
    forms them on the dp4a route: per entry e the windows of its staged
    word (pieces 0-3 at byte 7 - lev, 4-7 at byte 11 - lev) by funnel
    shifts, and per level one or two dp4a of the row's pieces."""
    lv = [0] * (i8.SMAX + 1)
    for e, word in enumerate(words):
        lo, hi = int(word) & 0xFFFFFFFF, int(word) >> 32
        for lev in range(i8.SMAX + 1):
            w0 = _funnel(hi, 0, 8 * (3 - lev)) if lev <= 3 else _funnel(lo, hi, 8 * (7 - lev))
            lv[lev] += _dp4a(a_row[e, :4], w0)
            if lev >= 4:
                lv[lev] += _dp4a(a_row[e, 4:], _funnel(hi, 0, 8 * (7 - lev)))
    return lv


DP4A_SHAPES = [(dims, method) for dims, method in I8_SHAPES
               if _entries(dims, method) <= fused.DP4A_ENTRIES]


@pytest.mark.parametrize("dims,method", DP4A_SHAPES, ids=lambda x: str(x))
def test_dp4a_levels_give_the_grouped_sums(dims, method):
    """K9's dp4a route, emulated for a few queries: every stencil row's
    levels equal the plain version's grouped sums."""
    a, bq, *_ = _i8_operands(dims, method, seed=sum(dims) + 1, n=4)
    want = _grouped(a, bq).numpy()  # (R, 8, n)
    a_np = a.numpy().astype(np.int64)  # (R, E, n, 8)
    uwords = _staged_words(bq)
    for q in range(a_np.shape[2]):
        for r in range(a_np.shape[0]):
            assert _dp4a_levels(a_np[r, :, q], uwords[q]) == want[r, :, q].tolist(), (q, r)


@pytest.mark.parametrize("footprint,group,route", [
    (2, 1, "dp4a"), (2, 2, "dp4a"), (2, 4, "dp4a"), (2, 5, "mma"), (4, 1, "dp4a"),
    (4, 2, "dp4a"), (4, 3, "mma"), (4, 5, "mma")])
def test_i8_route_picks_by_trailing_entries(footprint, group, route):
    """K9's route: dp4a within DP4A_ENTRIES trailing entries (linear 3D
    at 20^3: 4; cubic 20^3: 16), mma above (cubic 12^5: 64)."""
    assert fused.i8_route(footprint, group) == route
