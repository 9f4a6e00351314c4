"""Double-float (compensated float32) f64 evaluation: K8's wrapper and plain
version.

Counterpart of `interpn_tpu/ops/pallas_df64.py`. The cell locate and the
per-axis stencil weights are computed in float64 (`weights_f64`), split
into float32 hi/lo pairs (hi + lo keeps about 48 of a double's 53 bits);
the value table is split once into hi/lo pairs (`table_split`, cached per
table: `cache_key`); the contraction runs in double-float arithmetic
(Dekker/Veltkamp TwoProd with no FMA, Knuth TwoSum) and returns an (hi, lo)
pair that is recombined in float64 (`_finish`).

The TPU kernel contracts dense per-axis weight matrices against the whole
table. Here the contraction reads only each query's stencil, in the flat
kernel's order (`_contract_slab`): per stencil row of the leading axes in C
order, `_df_madd` over the last axis's stencil entries, then the exact
`_two_sum`; then each middle axis, innermost first, `_df_madd` over its
stencil entries and `_two_sum`. On a finite table every off-stencil term of
the dense contraction is an exact identity, so this order gives the dense
kernel's numbers (the TPU's looped kernel for leading blocks above 2048 rows
uses another order; the two agree at the JAX package's 5e-12 bar).

`eval_regular`, `eval_rectilinear` and `eval_bspline` are K8's wrappers:
on CPU tensors they run the plain chain (`plain_regular`,
`plain_rectilinear`, `plain_bspline`: `weights_f64`, `contract`, which is
`plain_df64`, and `_finish`); on CUDA tensors they launch
`csrc/fused_df64.cu` (`ops/fused.py::launch_df64`), which builds the
weights itself and reads the table's packed taps (`table_taps`), or raise.
The primitives below are op for op `pallas_df64.py`'s; torch runs each op
as its own kernel, so nothing is contracted into an FMA across ops, and no
fused op (`addcmul`, ...) is used.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..utils import c_strides, tracing
from . import fused as _fused
from ._chunk import chunk_len
from .bspline import spline_locs_weights
from .cubic import rectilinear_cubic_weights, regular_cubic_weights
from .locate import locate_rectilinear_linear, locate_regular_linear

_F32 = torch.float32
_F64 = torch.float64
_I32 = torch.int32

FOOTPRINT = {"linear": 2, "cubic": 4, 3: 4, 5: 6}  # method, or spline degree


# --- double-float primitives (float32 tensors, exact IEEE ops, no FMA) -------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _veltkamp(a):
    c = a * 4097.0  # 2^12 + 1 for float32's 24-bit significand
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ahi, alo = _veltkamp(a)
    bhi, blo = _veltkamp(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _df_norm(h, e):
    s = h + e
    return s, e - (s - h)


def _df_add(xh, xl, yh, yl):
    sh, se = _two_sum(xh, yh)
    return _df_norm(sh, se + (xl + yl))


def _df_mul(xh, xl, yh, yl):
    ph, pe = _two_prod(xh, yh)
    return _df_norm(ph, pe + (xh * yl + xl * yh))


def _df_madd(th, tl, ah, al, bh, bl):
    """(th, tl) += (ah, al) * (bh, bl): the product pair normalized, then a
    deferred two_sum accumulation (`pallas_df64._df_madd`)."""
    ahh, ahl = _veltkamp(ah)
    bhh, bhl = _veltkamp(bh)
    p = ah * bh
    err = (((ahh * bhh - p) + ahh * bhl) + ahl * bhh) + ahl * bhl
    low = err + (ah * bl + al * bh)
    p, low = _df_norm(p, low)
    s, e = _two_sum(th, p)
    return s, tl + (e + low)


def split_f64(a64):
    """The float32 (hi, lo) pair of a float64 tensor: hi = f32(a), lo =
    f32(a - hi), so hi + lo is a within about 2^-48 relative."""
    hi = a64.to(_F32)
    lo = (a64 - hi.to(a64.dtype)).to(_F32)
    return hi, lo


# --- cached per-table hi/lo split ----------------------------------------------------


_HOST = "_interpn_host"


def host_tensor(a, *, device, dtype=None):
    """`torch.as_tensor(a)` on `device` for a numpy table `a`, carrying `a`
    so that the per-table caches key the tensor by the array's content: an
    entry point makes a fresh tensor of a numpy table on every call, and a
    caller that passes one table on every call then hits the cache."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    setattr(t, _HOST, a)
    return t


def host_array(vals):
    """The numpy table `vals` is, or was made from by `host_tensor`, else
    None."""
    return vals if isinstance(vals, np.ndarray) else getattr(vals, _HOST, None)


def cache_key(vals, extra=()):
    """Key of the per-table caches: a numpy table, or a tensor that
    `host_tensor` made of one, by content (as `ops/bspline.py::_content_key`)
    and, for the tensor, its dtype and device; any other tensor by storage
    address, layout and version counter (shared by all views of the
    storage, bumped by every in-place update), so that the fresh flat views
    the entry points make of one table share an entry. A write that does not
    bump the version counter (through `.data`, DLPack or a raw pointer) is
    not seen: pass such a table as a new tensor."""
    host = host_array(vals)
    if host is not None:
        buf = np.ascontiguousarray(host)
        h = hashlib.blake2b(buf, digest_size=16).digest()
        where = (str(vals.dtype), str(vals.device)) if isinstance(vals, torch.Tensor) else ()
        return ("h", h, buf.dtype.str, buf.shape, *where, *extra)
    return ("t", vals.data_ptr(), tuple(vals.shape), vals.stride(), str(vals.dtype),
            str(vals.device), vals._version, *extra)


class TableCache:
    """A small keyed cache of per-table preparations, oldest out first. An
    entry keyed by storage address keeps its table alive, so that no other
    tensor can take that address while the entry exists; one keyed by
    content keeps only the preparation."""

    def __init__(self, size: int):
        self.size = size
        self.entries: dict = {}

    def get(self, vals, extra, build):
        key = cache_key(vals, extra)
        hit = self.entries.get(key)
        if hit is None:
            hit = self.entries[key] = (vals if key[0] == "t" else None, build())
            while len(self.entries) > self.size:
                self.entries.pop(next(iter(self.entries)))
        return hit[1]


_SPLITS = TableCache(16)
_TAPS = TableCache(16)


def table_split(vals):
    """(vh, vl, finite): the table's float32 hi/lo split on its device and
    whether every entry is finite, cached per table."""

    def build():
        v = torch.as_tensor(vals).detach().reshape(-1).to(_F64)
        vh, vl = split_f64(v)
        return vh.contiguous(), vl.contiguous(), tracing.host_bool(torch.isfinite(v).all())

    return _SPLITS.get(vals, (), build)


def plain_taps(dims, footprint, vh, vl):
    """K8's packed layout of a flat hi/lo split: (prod(dims[:-1]) *
    (dims[-1] - footprint + 1), 2 * footprint) float32, cell (row, j)
    holding the hi parts of entries j .. j + footprint - 1 along the last
    axis, then their lo parts: a stencil row of the last axis in one
    16-byte (footprint 2), 32-byte (4) or 48-byte (6) cell."""
    shape = (math.prod(dims[:-1]), dims[-1])
    h = vh.reshape(shape).unfold(1, footprint, 1)
    l = vl.reshape(shape).unfold(1, footprint, 1)
    return torch.cat([h, l], dim=-1).reshape(-1, 2 * footprint).contiguous()


def table_taps(vals, dims, footprint):
    """`plain_taps` of the table's `table_split`, on its device, cached per
    table, dims and footprint (K8 reads nothing else of the table)."""
    dims = tuple(int(d) for d in dims)

    def build():
        vh, vl, _ = table_split(vals)
        return plain_taps(dims, footprint, vh, vl)

    return _TAPS.get(vals, (dims, footprint), build)


# --- per-axis weights in float64 -------------------------------------------------------


def _axis_weights(dims, starts, steps, grids, obs, method, linearize):
    """Per axis (loc, [w...]) in float64 (`pallas_df64._axis_weights_f64`):
    linear (1 - t, t); cubic the node function on the four unit bases, as
    `ops/factorized.py::_basis_weights_cubic_*` in the JAX package."""
    out = []
    for k in range(len(dims)):
        x = obs[k]
        if grids is None:
            if method == "linear":
                loc, t = locate_regular_linear(x, starts[k], steps[k], dims[k])
                out.append((loc, [1.0 - t, t]))
            else:
                out.append(regular_cubic_weights(x, starts[k], steps[k], dims[k], linearize))
        elif method == "linear":
            loc, x0, x1 = locate_rectilinear_linear(x, grids[k])
            t = (x - x0) / (x1 - x0)
            out.append((loc, [1.0 - t, t]))
        else:
            out.append(rectilinear_cubic_weights(x, grids[k], linearize))
    return out


def _pack(per_axis, n):
    """(locs (ndims, n) int32, wh, wl (ndims * footprint, n) float32, wsum
    (n,) float64: the product over axes of each axis's stencil-weight sum)."""
    locs = torch.stack([loc.reshape(n).to(_I32) for loc, _ in per_axis]).contiguous()
    w64 = torch.stack([w.reshape(n) for _, ws in per_axis for w in ws])
    wh, wl = split_f64(w64)
    wsum = None
    for _, ws in per_axis:
        s = ws[0]
        for w in ws[1:]:
            s = s + w
        wsum = s if wsum is None else wsum * s
    return locs, wh.contiguous(), wl.contiguous(), wsum.reshape(n)


def weights_f64(dims, starts, steps, grids, obs, method, linearize=True):
    """Counterpart of `pallas_df64._axis_weights_f64` + `_weights_jit`
    without the padding: per-axis int32 `locs`, hi/lo `wh`/`wl`
    (ndims * footprint rows, axis-major) and the float64 `wsum`, on the
    queries' device. `grids` is None for a regular grid."""
    obs = tuple(o.reshape(-1).to(_F64) for o in obs)
    per_axis = _axis_weights(tuple(dims), starts, steps, grids, obs, method, bool(linearize))
    return _pack(per_axis, obs[0].shape[0])


def spline_weights_f64(knots, obs, k: int):
    """`weights_f64` for a degree-k B-spline: the de Boor spans rebased to
    the first coefficient and the k+1 Cox-de Boor weights per axis."""
    obs = tuple(o.reshape(-1).to(_F64) for o in obs)
    per_axis = spline_locs_weights([t.to(_F64) for t in knots], obs, k)
    return _pack(per_axis, obs[0].shape[0])


# --- K8: the plain version and the wrapper -------------------------------------------


def _stencil_offsets(dims, footprint, axes, device):
    """Flat table offsets of the stencil over `axes`, C order (the first of
    `axes` in the most significant digit)."""
    strides = c_strides(dims)
    off = torch.zeros(1, dtype=torch.int64, device=device)
    for a in axes:
        step = torch.arange(footprint, dtype=torch.int64, device=device) * strides[a]
        off = (off[:, None] + step[None, :]).reshape(-1)
    return off


def _plain_df64_impl(dims, footprint, locs, wh, wl, vh, vl):
    ndims = len(dims)
    fp = footprint
    n = locs.shape[1]
    strides = c_strides(dims)
    base = torch.zeros(n, dtype=torch.int64, device=locs.device)
    for k in range(ndims):
        base = base + locs[k].to(torch.int64) * strides[k]
    rows = _stencil_offsets(dims, fp, range(ndims - 1), locs.device)
    last = torch.arange(fp, dtype=torch.int64, device=locs.device) * strides[-1]
    cells = base[None, None, :] + (rows[:, None] + last[None, :])[:, :, None]  # (R, fp, n)
    gh, gl = vh[cells], vl[cells]
    th = torch.zeros((rows.shape[0], n), dtype=_F32, device=locs.device)
    tl = torch.zeros_like(th)
    w0 = (ndims - 1) * fp
    for j in range(fp):
        th, tl = _df_madd(th, tl, gh[:, j], gl[:, j], wh[w0 + j], wl[w0 + j])
    th, tl = _two_sum(th, tl)
    for k in range(ndims - 2, -1, -1):
        g_h = th.reshape(-1, fp, n)
        g_l = tl.reshape(-1, fp, n)
        sh = torch.zeros_like(g_h[:, 0])
        sl = torch.zeros_like(sh)
        for b in range(fp):
            sh, sl = _df_madd(sh, sl, g_h[:, b], g_l[:, b], wh[k * fp + b], wl[k * fp + b])
        th, tl = _two_sum(sh, sl)
    return th[0], tl[0]


def plain_df64(dims, footprint, locs, wh, wl, vh, vl):
    """The plain version of K8: (oh, ol) float32 (n,) from `locs`
    (ndims, n) int32, `wh`/`wl` (ndims * footprint, n) and the flat hi/lo
    table. Chunked over the queries so that the (footprint^ndims, n)
    temporaries stay bounded."""
    step = chunk_len(footprint ** len(dims) * 16, 4)  # ~16 live float32 temporaries
    parts = [_plain_df64_impl(dims, footprint, locs[:, i:i + step], wh[:, i:i + step],
                              wl[:, i:i + step], vh, vl)
             for i in range(0, max(locs.shape[1], 1), step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def contract(dims, footprint, locs, wh, wl, vh, vl):
    """The contraction step of the plain chain: `plain_df64`, (oh, ol)
    float32 (n,) on the tensors' device."""
    return plain_df64(tuple(int(d) for d in dims), footprint, locs, wh, wl, vh, vl)


def _finish(oh, ol):
    return oh.to(_F64) + ol.to(_F64)


def plain_regular(dims, starts, steps, vals, obs, method, linearize=True):
    """K8's plain version on a regular grid: the float64 weights, the
    contraction and the recombination, in torch on the tensors' device."""
    dims = tuple(int(d) for d in dims)
    locs, wh, wl, _ = weights_f64(dims, starts, steps, None, obs, method, linearize)
    vh, vl, _ = table_split(vals)
    return _finish(*contract(dims, FOOTPRINT[method], locs, wh, wl, vh, vl))


def plain_rectilinear(grids, vals, obs, method, linearize=True):
    """K8's plain version on a rectilinear grid."""
    dims = tuple(int(g.shape[0]) for g in grids)
    locs, wh, wl, _ = weights_f64(dims, None, None, grids, obs, method, linearize)
    vh, vl, _ = table_split(vals)
    return _finish(*contract(dims, FOOTPRINT[method], locs, wh, wl, vh, vl))


def plain_bspline(knots, coeffs, obs, k: int):
    """K8's plain version of a degree-k tensor-product B-spline."""
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    locs, wh, wl, _ = spline_weights_f64(knots, obs, k)
    vh, vl, _ = table_split(coeffs)
    return _finish(*contract(dims, FOOTPRINT[k], locs, wh, wl, vh, vl))


def _on_cpu(tensors) -> bool:
    return _fused._device(tensors).type == "cpu"


def _flat(obs):
    return tuple(o.reshape(-1).contiguous() for o in obs)


@tracing.traced(tracing.WRAPPER)
def eval_regular(dims, starts, steps, vals, obs, method, linearize=True):
    """Double-float f64 evaluation on a regular grid (linear or cubic, 2-8D):
    the counterpart of `pallas_df64.eval_regular`. Returns (n,) float64:
    the plain chain on CPU tensors, one launch of K8 on CUDA tensors."""
    dims = tuple(int(d) for d in dims)
    obs = _flat(obs)
    if _on_cpu((vals, starts, steps, *obs)):
        return plain_regular(dims, starts, steps, vals, obs, method, linearize)
    fp = FOOTPRINT[method]
    return _fused.launch_df64("regular", dims, (starts, steps), table_taps(vals, dims, fp), obs,
                              fp, linearize)


@tracing.traced(tracing.WRAPPER)
def eval_rectilinear(grids, vals, obs, method, linearize=True):
    """Double-float f64 evaluation on a rectilinear grid."""
    grids, obs = tuple(grids), _flat(obs)
    if _on_cpu((vals, *grids, *obs)):
        return plain_rectilinear(grids, vals, obs, method, linearize)
    dims = tuple(int(g.shape[0]) for g in grids)
    fp = FOOTPRINT[method]
    return _fused.launch_df64("rectilinear", dims, grids, table_taps(vals, dims, fp), obs, fp,
                              linearize)


@tracing.traced(tracing.WRAPPER)
def eval_bspline(knots, coeffs, obs, k: int):
    """Double-float f64 evaluation of a degree-k (3 or 5) tensor-product
    B-spline: the counterpart of `pallas_df64.eval_bspline`."""
    knots, obs = tuple(knots), _flat(obs)
    if _on_cpu((coeffs, *knots, *obs)):
        return plain_bspline(knots, coeffs, obs, k)
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    return _fused.launch_df64("bspline", dims, knots, table_taps(coeffs, dims, k + 1), obs,
                              k + 1)


def supported(dims, method) -> bool:
    """The JAX engine's method and rank domain (`pallas_df64.supported`
    without its TPU caps): linear, cubic or a spline degree, 2-8D."""
    return method in FOOTPRINT and 2 <= len(dims) <= 8
