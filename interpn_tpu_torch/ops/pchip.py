"""Tensor-product PCHIP (monotone cubic Hermite), batched over queries.

Counterpart of `interpn_tpu/ops/pchip.py`, term for term in the same order of
operations. Semantics are scipy's `RegularGridInterpolator(method="pchip")`:

* Per-axis slopes are PCHIP derivatives: zero at local extrema and sign
  changes, else the weighted harmonic mean of the adjacent differences; the
  grid's boundary nodes take the one-sided three-point estimate with Moler's
  clamps.
* The 1D interpolant is applied axis by axis, LAST axis first (scipy's
  recursion order). PCHIP is nonlinear in the values, so the order is part
  of the function, not only of the rounding.
* Out-of-bounds queries extrapolate the edge interval's cubic.

A slope needs the two adjacent differences, so an interval needs the values
at i-1..i+2: the cubic's 4^N stencil (`ops/locate.py`'s cubic locate, the
gathers of `ops/_gather.py`), reduced in reversed axis order by grouping the
stencil on its top base-4 digit. No weights can be drawn out of a function
that is nonlinear in the table, so there is no contraction form and no
kernel: the gather tree serves every device, CUDA tensors included. Up to
LIST_MAX_VERTS vertices the stencil is a list of flat gathers; above it
(5-8D) one matrix, over query chunks.

The `_stack` functions take (nch, prod(dims)) tables sharing the grid, for
`interpn_stack`: the stencil is gathered once for every table and each
table's arithmetic is elementwise, so each row is bitwise the single-table
result. Grids need at least 4 points per axis.
"""

from __future__ import annotations

import torch

from ..utils import c_strides
from ._chunk import chunk_queries
from ._gather import LIST_MAX_VERTS, gather_corners, gather_corners_matrix
from .cubic import _hermite
from .locate import locate_rectilinear_cubic, locate_regular_cubic


def _sign(x):
    """jnp.sign: -1, 0 or 1, and NaN for NaN (torch.sign gives 0 there,
    which would compare equal to the sign of a zero difference)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _interior_slope(hl, hr, ml, mr):
    """PCHIP derivative at the node between differences ml (left) and mr
    (right): zero where they vanish or disagree in sign, else the weighted
    harmonic mean."""
    cond = (_sign(ml) != _sign(mr)) | (mr == 0) | (ml == 0)
    one = torch.ones((), dtype=ml.dtype, device=ml.device)
    w1 = 2.0 * hr + hl
    w2 = hr + 2.0 * hl
    # guard the divisions that `where` still evaluates on the discarded lanes
    sl = torch.where(cond, one, ml)
    sr = torch.where(cond, one, mr)
    return torch.where(cond, 0.0, (w1 + w2) / (w1 / sl + w2 / sr))


def _edge_slope(h0, h1, m0, m1):
    """One-sided three-point boundary derivative with Moler's clamps: h0/m0
    belong to the boundary interval, h1/m1 to its neighbor."""
    d = ((2.0 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
    zero_it = _sign(d) != _sign(m0)
    clamp_it = (_sign(m0) != _sign(m1)) & (torch.abs(d) > 3.0 * torch.abs(m0))
    return torch.where(zero_it, 0.0, torch.where(clamp_it, 3.0 * m0, d))


def _select3(low, high, a, b, c):
    """a / b / c on the low-edge / interior / high-edge interval."""
    return torch.where(low, a, torch.where(high, c, b))


def _axis_reduce_pchip_regular(v, t, low, high):
    """One PCHIP node on a regular grid in normalized units (h == 1). v is
    the 4-point stencil, t the coordinate from stencil index 1; `low` /
    `high` flag the grid's first / last interval, where the edge formulas
    apply."""
    v0, v1, v2, v3 = v
    m0 = v1 - v0
    m1 = v2 - v1
    m2 = v3 - v2
    one = torch.ones((), dtype=m0.dtype, device=m0.device)
    zero = torch.zeros((), dtype=m0.dtype, device=m0.device)
    s1 = _interior_slope(one, one, m0, m1)  # node 1
    s2 = _interior_slope(one, one, m1, m2)  # node 2
    e0 = _edge_slope(one, one, m0, m1)  # node 0 == grid node 0
    e3 = _edge_slope(one, one, m2, m1)  # node 3 == grid node n-1

    tt = t + _select3(low, high, one, zero, -one)
    yl = _select3(low, high, v0, v1, v2)
    yr = _select3(low, high, v1, v2, v3)
    k0 = _select3(low, high, e0, s1, s2)
    k1 = _select3(low, high, s1, s2, e3)
    res = _hermite(tt, yl, yr - yl, k0, k1)
    # nodes exact
    return torch.where(tt == 0.0, yl, torch.where(tt == 1.0, yr, res))


def _axis_reduce_pchip_rect(v, x, gc, low, high):
    """One PCHIP node on a rectilinear grid; gc holds the stencil's four
    grid coordinates."""
    v0, v1, v2, v3 = v
    g0, g1, g2, g3 = gc
    h0 = g1 - g0
    h1 = g2 - g1
    h2 = g3 - g2
    m0 = (v1 - v0) / h0
    m1 = (v2 - v1) / h1
    m2 = (v3 - v2) / h2
    s1 = _interior_slope(h0, h1, m0, m1)
    s2 = _interior_slope(h1, h2, m1, m2)
    e0 = _edge_slope(h0, h1, m0, m1)
    e3 = _edge_slope(h2, h1, m2, m1)

    yl = _select3(low, high, v0, v1, v2)
    yr = _select3(low, high, v1, v2, v3)
    xl = _select3(low, high, g0, g1, g2)
    h = _select3(low, high, h0, h1, h2)
    dl = _select3(low, high, e0, s1, s2)
    dr = _select3(low, high, s1, s2, e3)
    tt = (x - xl) / h
    res = _hermite(tt, yl, yr - yl, dl * h, dr * h)
    return torch.where(tt == 0.0, yl, torch.where(tt == 1.0, yr, res))


def _reduce_last_axis_first(vals, base, dims, node):
    """Gather the 4^N stencil and reduce it LAST axis first: the vertex
    order carries dim 0 in the lowest base-4 digit, so each level groups by
    the top digit. node(k, (v0, v1, v2, v3)) reduces axis k."""
    if 4 ** len(dims) <= LIST_MAX_VERTS:
        c = gather_corners(vals, base, dims, 4)
        for k in reversed(range(len(dims))):
            q = len(c) // 4
            c = [node(k, (c[j], c[j + q], c[j + 2 * q], c[j + 3 * q])) for j in range(q)]
        return c[0]
    c = gather_corners_matrix(vals, base, dims, 4)  # (..., 4^N, n)
    for k in reversed(range(len(dims))):
        g = c.unflatten(-2, (4, c.shape[-2] // 4))
        c = node(k, tuple(g[..., i, :, :] for i in range(4)))
    return c[..., 0, :]


def _regular(dims, starts, steps, vals, obs):
    dims = tuple(int(d) for d in dims)
    strides = c_strides(dims)

    def impl(ob):
        base = torch.zeros(ob[0].shape, dtype=torch.int32, device=ob[0].device)
        per_dim = []
        for k in range(len(dims)):
            cl = locate_regular_cubic(ob[k], starts[k], steps[k], dims[k])
            base = base + cl.loc * strides[k]
            per_dim.append(cl)
        return _reduce_last_axis_first(
            vals, base, dims,
            lambda k, v: _axis_reduce_pchip_regular(v, per_dim[k].t, per_dim[k].low,
                                                    per_dim[k].high),
        )

    nch = vals.shape[0] if vals.dim() == 2 else 1
    return chunk_queries(impl, obs, nch * 4 ** len(dims), vals.element_size())


def _rectilinear(grids, vals, obs):
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)

    def impl(ob):
        base = torch.zeros(ob[0].shape, dtype=torch.int32, device=ob[0].device)
        per_dim = []
        for k in range(len(dims)):
            cl, gc = locate_rectilinear_cubic(ob[k], grids[k])
            base = base + cl.loc * strides[k]
            per_dim.append((cl, gc))
        return _reduce_last_axis_first(
            vals, base, dims,
            lambda k, v: _axis_reduce_pchip_rect(v, ob[k], per_dim[k][1], per_dim[k][0].low,
                                                 per_dim[k][0].high),
        )

    nch = vals.shape[0] if vals.dim() == 2 else 1
    return chunk_queries(impl, obs, nch * 4 ** len(dims), vals.element_size())


def pchip_regular(dims: tuple[int, ...], starts, steps, vals, obs):
    """Tensor-product PCHIP on a regular grid (1-8 dims, >= 4 points per
    axis): `vals` the flat C-order table, obs a tuple of ndims tensors of
    one shape; the result has that shape."""
    return _regular(dims, starts, steps, vals.reshape(-1), obs)


def pchip_rectilinear(grids, vals, obs):
    """Tensor-product PCHIP on a rectilinear grid (1-8 dims, >= 4 points
    per axis); grids a tuple of sorted 1-D tensors."""
    return _rectilinear(grids, vals.reshape(-1), obs)


def pchip_regular_stack(dims: tuple[int, ...], starts, steps, vals_stack, obs):
    """`pchip_regular` of each row of the (nch, prod(dims)) stack, as one
    (nch, *obs[0].shape) block."""
    return _regular(dims, starts, steps, vals_stack.reshape(vals_stack.shape[0], -1), obs)


def pchip_rectilinear_stack(grids, vals_stack, obs):
    """`pchip_rectilinear` of each row of the (nch, prod(dims)) stack."""
    return _rectilinear(grids, vals_stack.reshape(vals_stack.shape[0], -1), obs)
