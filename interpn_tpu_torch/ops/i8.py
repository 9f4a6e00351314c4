"""int8 multipass f64 contraction with exact int32 sums: K9's wrapper and
plain version.

Counterpart of `interpn_tpu/ops/pallas_i8.py` (which imports jax, so the
port keeps its own copy of the host decomposition). The f64 contraction
becomes fixed-point arithmetic:

    V[r, c] = c_r + 2^e_r * sum_i A_i[r, c] 2^-(6+7i)      (A_i int8, 8 pieces)
    W[c, q] =       2^f_q * sum_j B_j[c, q] 2^-(6+7j)      (B_j int8, 7 pieces)

over the table's rows r (the leading m = ndims - g axes) and columns c (the
trailing g axes, `_choose_group`). The 35 piece pairs with i + j <= 7 are
summed exactly in int32, grouped by level s = i + j; the groups recombine in
double-float, the power-of-two scales restore exactly, the row centres come
back through S_w (the double-float product of the trailing axes' weight
sums), the leading axes reduce in double-float, and the global centre c0
returns in float64 (`base + c0 * wsum`).

* `prepare` decomposes the table once, in host numpy float64 exactly as the
  JAX package does (bitwise equal pieces, centres and scales), at its true
  extents (the kernel reads only the stencil, so nothing is padded), and
  keeps the pieces cell-major: (prod(dims), 8) int8, one 8-byte load per
  stencil cell. It is cached per table (`df64.cache_key`: content for numpy
  and for the tensors the entry points make of it, storage and version for
  other tensors), with the table's finiteness.
* The weight side is quantized per query over the trailing stencil only;
  every off-stencil weight of the TPU's dense contraction is 0, whose
  pieces are 0, so the int32 sums are the dense ones.
* `f = ceil(log2(peak))` is taken exactly from the float32 bits (exponent,
  minus one at an exact power of two), in the plain version and the kernel
  alike, where the JAX package calls `jnp.log2`.

`eval_regular` and `eval_rectilinear` are K9's wrappers: on CPU tensors
they run the plain chain (`plain_regular`, `plain_rectilinear`:
`df64.weights_f64`, `contract`, which is `plain_i8`, and `(oh + ol) + c0 *
wsum`); on CUDA tensors they launch `csrc/fused_i8.cu`
(`ops/fused.py::launch_i8`), which builds the weights itself, quantizes
them and forms the piece products from the same cell-major pieces, by
`__dp4a` for a small trailing stencil and on the int8 tensor cores for a
larger one (`ops/fused.py::i8_route`), or raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import c_strides, tracing
from . import fused as _fused
from ._chunk import chunk_len
from .df64 import (
    FOOTPRINT,
    TableCache,
    _df_add,
    _flat,
    host_array,
    _df_mul,
    _stencil_offsets,
    _two_sum,
    weights_f64,
)

_F32 = torch.float32
_F64 = torch.float64
_I32 = torch.int32

NPIECE_V = 8
NPIECE_W = 7
SMAX = 7  # keep piece pairs with i + j <= SMAX (35 passes)
NPASSES = sum(1 for i in range(NPIECE_V) for j in range(NPIECE_W) if i + j <= SMAX)

# `_choose_group`'s cost model, verbatim from the JAX package: it decides
# which axes are quantized, so it is part of the function computed
_MAX_GROUP_K = 2048
_MAX_LEAD = 6144


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def _choose_group(dims) -> int:
    """Trailing-axis count g of the fixed-point contraction (the JAX
    package's padded-block cost model, biased toward deep K)."""
    ndims = len(dims)
    best_g, best_cost = 1, None
    k = 1
    for g in range(1, ndims):
        k *= dims[ndims - g]
        if k > _MAX_GROUP_K and g > 1:
            break
        lead = math.prod(dims[: ndims - g])
        if lead > _MAX_LEAD:
            continue
        cost = _pad128(lead) * _pad128(k)
        if best_cost is None or cost <= best_cost:
            best_g, best_cost = g, cost
    return best_g


def _shape(dims, _method=None):
    """(group, lead, k): the true extents of the (lead, k) table view."""
    g = _choose_group(dims)
    return (
        g,
        max(math.prod(dims[: len(dims) - g]), 1),
        math.prod(dims[len(dims) - g:]),
    )


# --- host table decomposition ----------------------------------------------------------


def _decompose_table(vals, lead: int, k: int):
    """(pieces (NPIECE_V, lead, k) int8, centres hi/lo (lead, 1) float32,
    scales (lead, 1) float32, exact powers of two), in host float64 numpy
    as `pallas_i8._decompose_table`."""
    v = np.asarray(vals, dtype=np.float64).reshape(lead, k)
    mid = (v.max(axis=1, keepdims=True) + v.min(axis=1, keepdims=True)) * 0.5
    vc = v - mid
    peak = np.abs(vc).max(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        e = np.ceil(np.log2(np.maximum(peak, 1e-300)))
    scale = np.where(peak > 0, np.exp2(e), 1.0)
    r = vc / scale  # exact (power-of-two divide), |r| <= 1
    pieces = np.empty((NPIECE_V, lead, k), dtype=np.int8)
    for i in range(NPIECE_V):
        q = np.rint(r * 2.0 ** (6 + 7 * i))
        pieces[i] = q.astype(np.int8)
        r = r - q * 2.0 ** (-(6 + 7 * i))
    ch = mid.astype(np.float32)
    cl = (mid - ch.astype(np.float64)).astype(np.float32)
    return pieces, ch, cl, scale.astype(np.float32)


def decompose(dims, vals):
    """Host decomposition of a finite table: (pieces (NPIECE_V, lead, k),
    ch, cl, sv (lead, 1), c0), the JAX package's `prepare` before its
    128-padding."""
    _, lead, ksize = _shape(tuple(dims))
    v_np = np.asarray(vals, dtype=np.float64)
    c0 = float((v_np.max() + v_np.min()) * 0.5)
    return (*_decompose_table((v_np - c0).reshape(lead, ksize), lead, ksize), c0)


_PREPS = TableCache(8)


def prepare(dims, vals):
    """(pieces (prod(dims), 8) int8 cell-major, ch, cl, sv (lead,) float32,
    c0), on the table's device, or None for a table with a non-finite entry
    (which the fixed-point decomposition cannot carry). Cached per table."""
    dims = tuple(int(d) for d in dims)

    def build():
        host = host_array(vals)
        if host is None:
            host = tracing.host_numpy(vals)
        host = np.asarray(host, dtype=np.float64).reshape(-1)
        if not np.isfinite(host).all():
            return None
        pieces, ch, cl, sv, c0 = decompose(dims, host)
        device = vals.device if isinstance(vals, torch.Tensor) else torch.device("cpu")
        cells = np.ascontiguousarray(pieces.reshape(NPIECE_V, -1).T)
        return (torch.from_numpy(cells).to(device),
                *(torch.from_numpy(a.reshape(-1)).to(device) for a in (ch, cl, sv)), c0)

    return _PREPS.get(vals, dims, build)


# --- the weight side ---------------------------------------------------------------------


def _combined_weights_df(w_h, w_l, ndims, g, fp):
    """Grouped trailing-axes stencil weights as a double-float (fp^g, n)
    pair, right to left as `pallas_i8._combined_weights_df`: the axis's
    weight times the partial product, C order over the stencil."""
    wh = w_h[(ndims - 1) * fp: ndims * fp]
    wl = w_l[(ndims - 1) * fp: ndims * fp]
    for a in range(ndims - 2, ndims - g - 1, -1):
        ah = w_h[a * fp:(a + 1) * fp, None]
        al = w_l[a * fp:(a + 1) * fp, None]
        ph, plo = _df_mul(ah, al, wh[None], wl[None])
        wh = ph.reshape(-1, ph.shape[-1])
        wl = plo.reshape(-1, plo.shape[-1])
    return wh, wl


def _pow2(f):
    """2^f for int32 f in [-126, 127], from the float32 bits (exact)."""
    return ((f + 127) << 23).view(_F32)


def _scales(peak):
    """(2^f, 2^-f) with f = ceil(log2(max(peak, 1e-30))) taken exactly from
    the float32 bits (peaks up to 2^126, where 2^-f is still normal); (inf,
    0) for an infinite peak, NaN for NaN."""
    p = torch.maximum(peak, torch.full_like(peak, 1e-30))
    bits = p.view(_I32)
    f = ((bits >> 23) & 0xFF) - 126 - ((bits & 0x7FFFFF) == 0).to(_I32)
    finite = torch.isfinite(p)
    f = torch.where(finite, f, torch.zeros_like(f))
    scale = torch.where(finite, _pow2(f), p)
    inv = torch.where(finite, _pow2(-f), torch.where(torch.isnan(p), p, torch.zeros_like(p)))
    return scale, inv


def _quantize_weights(wh, wl):
    """(B pieces (NPIECE_W, E, n) int32, f_q scale (n,) float32): the
    double-float residual renormalized by the exact two_sum after every
    extraction (`pallas_i8._quantize_weights`); a non-finite piece is 0."""
    scale, inv = _scales(torch.amax(torch.abs(wh), dim=0))
    rh = wh * inv
    rl = wl * inv
    pieces = []
    for j in range(NPIECE_W):
        q = torch.round(rh * 2.0 ** (6 + 7 * j))  # half to even, as jnp.rint
        pieces.append(torch.where(torch.isfinite(q), q, torch.zeros_like(q)).to(_I32))
        rh = rh - q * 2.0 ** (-(6 + 7 * j))  # exact (Sterbenz)
        rh, rl = _two_sum(rh, rl)
    return torch.stack(pieces), scale


def _exact_i32_to_df(acc):
    """int32 -> exact float32 hi/lo pair (values may exceed 2^24); the
    remainder truncates toward zero, as `jax.lax.rem`."""
    lo_i = torch.fmod(acc, 4096)
    hi_i = torch.div(acc - lo_i, 4096, rounding_mode="trunc")
    return hi_i.to(_F32) * 4096.0, lo_i.to(_F32)


# --- K9: the plain version and the wrapper ---------------------------------------------


def _plain_i8_impl(dims, footprint, locs, wh, wl, pieces, ch, cl, sv):
    ndims = len(dims)
    fp = footprint
    g, lead, ksize = _shape(dims)
    m = ndims - g
    n = locs.shape[1]
    dev = locs.device
    strides = c_strides(dims)
    cwh, cwl = _combined_weights_df(wh, wl, ndims, g, fp)
    bq, fq = _quantize_weights(cwh, cwl)

    base = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(ndims):
        base = base + locs[k].to(torch.int64) * strides[k]
    rows = _stencil_offsets(dims, fp, range(m), dev)  # (R,)
    cols = _stencil_offsets(dims, fp, range(m, ndims), dev)  # (E,)
    row_cell = base[None, :] + rows[:, None]  # (R, n), the row's first cell
    a = pieces[row_cell[:, None, :] + cols[None, :, None]].to(_I32)  # (R, E, n, 8)
    groups = [None] * (SMAX + 1)
    for i in range(NPIECE_V):
        for j in range(NPIECE_W):
            if i + j <= SMAX:
                t = (a[..., i] * bq[j][None]).sum(dim=1)
                s = i + j
                groups[s] = t if groups[s] is None else groups[s] + t
    th = torch.zeros((rows.shape[0], n), dtype=_F32, device=dev)
    tl = torch.zeros_like(th)
    for s, acc in enumerate(groups):
        acc = acc.to(_I32)
        lvl = 2.0 ** (-(12 + 7 * s))
        if s <= 5:
            gh, gl = _exact_i32_to_df(acc)
            th, tl = _df_add(th, tl, gh * lvl, gl * lvl)
        else:
            th, tl = _df_add(th, tl, acc.to(_F32) * lvl, torch.zeros_like(th))

    r_idx = torch.div(row_cell, ksize, rounding_mode="floor")  # row of the (lead, k) view
    th = th * sv[r_idx] * fq
    tl = tl * sv[r_idx] * fq
    swh = swl = None
    for ax in range(m, ndims):
        axh, axl = wh[ax * fp], wl[ax * fp]
        for b in range(1, fp):
            axh, axl = _df_add(axh, axl, wh[ax * fp + b], wl[ax * fp + b])
        if swh is None:
            swh, swl = axh, axl
        else:
            swh, swl = _df_mul(swh, swl, axh, axl)
    ph, plo = _df_mul(ch[r_idx], cl[r_idx], swh, swl)
    th, tl = _df_add(th, tl, ph, plo)
    th, tl = _two_sum(th, tl)

    for ax in range(m - 1, -1, -1):
        g_h = th.reshape(-1, fp, n)
        g_l = tl.reshape(-1, fp, n)
        sh = torch.zeros_like(g_h[:, 0])
        sl = torch.zeros_like(sh)
        for b in range(fp):
            ph, plo = _df_mul(g_h[:, b], g_l[:, b], wh[ax * fp + b], wl[ax * fp + b])
            sh, sl = _df_add(sh, sl, ph, plo)
        th, tl = sh, sl
    return th[0], tl[0]


def plain_i8(dims, footprint, locs, wh, wl, pieces, ch, cl, sv):
    """The plain version of K9: (oh, ol) float32 (n,) from `locs`, `wh`/`wl`
    as `df64.plain_df64`'s and `prepare`'s pieces and row arrays. Chunked
    over the queries so that the (rows, cells, n, 8) piece gathers stay
    bounded."""
    dims = tuple(int(d) for d in dims)
    step = chunk_len(footprint ** len(dims) * NPIECE_V, 8)
    parts = [_plain_i8_impl(dims, footprint, locs[:, i:i + step], wh[:, i:i + step],
                            wl[:, i:i + step], pieces, ch, cl, sv)
             for i in range(0, max(locs.shape[1], 1), step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def contract(dims, footprint, locs, wh, wl, pieces, ch, cl, sv):
    """The contraction step of the plain chain: `plain_i8`, (oh, ol) float32
    (n,) on the tensors' device."""
    return plain_i8(tuple(int(d) for d in dims), footprint, locs, wh, wl, pieces, ch, cl, sv)


def _prep(dims, vals, prep):
    prep = prepare(dims, vals) if prep is None else prep
    if prep is None:
        raise ValueError("the int8 engine needs a table with finite entries")
    return prep


def _plain(dims, starts, steps, grids, vals, obs, method, linearize, prep):
    pieces, ch, cl, sv, c0 = _prep(dims, vals, prep)
    locs, wh, wl, wsum = weights_f64(dims, starts, steps, grids, obs, method, linearize)
    oh, ol = contract(dims, FOOTPRINT[method], locs, wh, wl, pieces, ch, cl, sv)
    return (oh.to(_F64) + ol.to(_F64)) + c0 * wsum


def plain_regular(dims, starts, steps, vals, obs, method, linearize=True, prep=None):
    """K9's plain version on a regular grid: the float64 weights, the
    contraction and `(oh + ol) + c0 * wsum`, in torch on the tensors'
    device."""
    dims = tuple(int(d) for d in dims)
    return _plain(dims, starts, steps, None, vals, obs, method, linearize, prep)


def plain_rectilinear(grids, vals, obs, method, linearize=True, prep=None):
    """K9's plain version on a rectilinear grid."""
    dims = tuple(int(g.shape[0]) for g in grids)
    return _plain(dims, None, None, grids, vals, obs, method, linearize, prep)


@tracing.traced(tracing.WRAPPER)
def eval_regular(dims, starts, steps, vals, obs, method, linearize=True, prep=None):
    """int8-multipass f64 evaluation on a regular grid (linear or cubic,
    2-8D): the counterpart of `pallas_i8.eval_regular`. `prep` is
    `prepare(dims, vals)`, where the caller has it. Returns (n,) float64:
    the plain chain on CPU tensors, one launch of K9 on CUDA tensors."""
    dims = tuple(int(d) for d in dims)
    obs = _flat(obs)
    if _fused._device((vals, starts, steps, *obs)).type == "cpu":
        return plain_regular(dims, starts, steps, vals, obs, method, linearize, prep)
    return _fused.launch_i8("regular", dims, (starts, steps), _prep(dims, vals, prep), obs,
                            FOOTPRINT[method], linearize, _choose_group(dims))


@tracing.traced(tracing.WRAPPER)
def eval_rectilinear(grids, vals, obs, method, linearize=True, prep=None):
    """int8-multipass f64 evaluation on a rectilinear grid."""
    grids = tuple(grids)
    obs = _flat(obs)
    dims = tuple(int(g.shape[0]) for g in grids)
    if _fused._device((vals, *grids, *obs)).type == "cpu":
        return plain_rectilinear(grids, vals, obs, method, linearize, prep)
    return _fused.launch_i8("rectilinear", dims, grids, _prep(dims, vals, prep), obs,
                            FOOTPRINT[method], linearize, _choose_group(dims))


def supported(dims, method) -> bool:
    """The JAX engine's method and rank domain (`pallas_i8.supported`
    without its TPU caps and auto-mode gates): linear or cubic, 2-8D,
    dims[-1] >= 2."""
    return method in ("linear", "cubic") and 2 <= len(dims) <= 8 and dims[-1] >= 2
