"""Multicubic (Hermite) interpolation/extrapolation: the gather tree.

Counterpart of `interpn_tpu/ops/cubic.py`, term for term in the same order of
operations, so that both packages round alike. This is the port's CPU path,
its gradient path, and the plain version of the cubic kernels
(`csrc/fused_regular.cu`, `csrc/fused_rectilinear.cu`).

* The 4^N stencil is one (4^N, n) gather, vertex-major in the reference's
  base-4 digit order (dim 0 in the lowest digit). The JAX package gathers a
  list of flat vectors up to 4D because of TPU compile times; the per-element
  arithmetic is the same either way. Flat batches are chunked so that the
  matrix stays bounded (`ops/_chunk.py`).
* Each axis's 5-region saturation is a set of `where` selects over one
  normalized Hermite spline; only (t, y0, dy, k0, k1) differ by region:
    None:        t'=t,   y0=v1, dy=v2-v1, k0=(v2-v0)/2,  k1=(v3-v1)/2
    Inside/OutsideLow (mirrored): t'=-t, y0=v1, dy=v0-v1,
                 k0=-(v2-v0)/2, k1=2*dy-k0
    Inside/OutsideHigh: t'=t-1, y0=v2, dy=v3-v2, k0=(v3-v1)/2, k1=2*dy-k0
  With `linearize_extrapolation` the two Outside regions become
  y_edge + k1*(t'-1). At t' == 0 or 1 the node returns the stencil value
  itself, so grid nodes reproduce exactly.
* The tree reduces groups of 4 adjacent vertices per level, dim 0 first.

The rectilinear variant carries the 4 bracketing grid coordinates per axis
and uses the distance-weighted nonuniform centered difference with the
reference's h-ratio normalizations.

`cubic_rectilinear_weighted` computes the same function the way the
rectilinear kernels K2 and K6 do (`csrc/rectilinear.cuh`) and the JAX
package's K2 does (`interpn_tpu/ops/pallas_v3.py::_rect_locs_weights`):
each axis's four weights, its node on the four unit bases
(`rectilinear_cubic_weights`), built once for every table of a stack, and
the stencil contracted with them axis 0 first (`contract_cubic`); where a
result is not finite, the gather tree's in its place, so that a NaN or inf
in a stencil gives the gather tree's answer (a contraction turns 0 * inf
into NaN).
"""

from __future__ import annotations

import torch

from ..utils import c_strides
from ._chunk import chunk_queries
from ._gather import gather_corners_matrix
from .locate import locate_rectilinear_cubic, locate_regular_cubic


def _hermite(t, y0, dy, k0, k1):
    """Normalized cubic Hermite spline via Horner."""
    a = k0 - dy
    b = -k1 + dy
    c1 = dy + a
    c2 = b - (a + a)
    c3 = a - b
    return y0 + t * (c1 + t * (c2 + t * c3))


def _centered_diff_nonuniform(y0, y1, y2, h01, h12):
    """Distance-weighted central difference on a nonuniform grid."""
    a = h01 / (h01 + h12)
    b = (y2 - y1) / h12
    c = h12 / (h12 + h01)
    d = (y1 - y0) / h01
    return a * b + c * d


def _finish_node(res, tt, y0, k1, v, low, high, outside, linearize: bool):
    """Linearized extrapolation in the Outside regions, then the exact
    endpoint values at tt == 0/1."""
    v0, _, v2, v3 = v
    if linearize:
        y_edge = torch.where(low, v0, v3)
        lin = y_edge + k1 * (tt - 1.0)
        res = torch.where(outside, lin, res)
    endpoint = torch.where(low, v0, torch.where(high, v3, v2))
    return torch.where(tt == 0.0, y0, torch.where(tt == 1.0, endpoint, res))


def _axis_reduce_regular(v, t, low, high, outside, linearize: bool):
    """One node of the cubic tree on a regular grid; v is 4 tensors."""
    v0, v1, v2, v3 = v
    tt = torch.where(low, -t, torch.where(high, t - 1.0, t))
    y0 = torch.where(high, v2, v1)
    dy = torch.where(low, v0 - v1, torch.where(high, v3 - v2, v2 - v1))
    half02 = (v2 - v0) * 0.5
    half13 = (v3 - v1) * 0.5
    k0 = torch.where(low, -half02, torch.where(high, half13, half02))
    k1 = torch.where(low | high, 2.0 * dy - k0, half13)
    res = _hermite(tt, y0, dy, k0, k1)
    return _finish_node(res, tt, y0, k1, v, low, high, outside, linearize)


def _axis_reduce_rectilinear(v, x, gc, low, high, outside, linearize: bool):
    """One node of the cubic tree on a rectilinear grid; v is 4 tensors, gc
    the 4 bracketing grid coordinates."""
    v0, v1, v2, v3 = v
    g0, g1, g2, g3 = gc
    h01 = g1 - g0
    h12 = g2 - g1
    h23 = g3 - g2
    one = torch.ones((), dtype=x.dtype, device=x.device)

    k0_none = _centered_diff_nonuniform(v0, v1, v2, h01 / h12, one)
    k1_none = _centered_diff_nonuniform(v1, v2, v3, one, h23 / h12)
    k0_low = -_centered_diff_nonuniform(v0, v1, v2, one, h12 / h01)
    k0_high = _centered_diff_nonuniform(v1, v2, v3, h12 / h23, one)

    dy = torch.where(low, v0 - v1, torch.where(high, v3 - v2, v2 - v1))
    y0 = torch.where(high, v2, v1)
    k0 = torch.where(low, k0_low, torch.where(high, k0_high, k0_none))
    k1 = torch.where(low | high, 2.0 * dy - k0, k1_none)
    # None: (x-g1)/h12; low: -(x-g1)/h01 (mirrored); high: (x-g2)/h23
    tt = torch.where(
        low, -(x - g1) / h01, torch.where(high, (x - g2) / h23, (x - g1) / h12)
    )
    res = _hermite(tt, y0, dy, k0, k1)
    return _finish_node(res, tt, y0, k1, v, low, high, outside, linearize)


def unit_bases(like):
    """The four unit bases (e_0 .. e_3) of a stencil row, as scalar tensors
    of `like`'s dtype and device: the node on basis j is tap j's weight."""
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    one = torch.ones((), dtype=like.dtype, device=like.device)
    return [tuple(one if j == i else zero for j in range(4)) for i in range(4)]


def rectilinear_cubic_weights(x, grid, linearize: bool):
    """(loc, [w0, w1, w2, w3]) of one rectilinear axis at `x`, in x's dtype:
    the stencil's first index and `_axis_reduce_rectilinear` on the four
    unit bases (the kernels' `cubic_weights`, csrc/interp_common.cuh)."""
    cl, gc = locate_rectilinear_cubic(x, grid)
    return cl.loc, [_axis_reduce_rectilinear(e, x, gc, cl.low, cl.high, cl.outside, linearize)
                    for e in unit_bases(x)]


def regular_cubic_weights(x, start, step, dim: int, linearize: bool):
    """(loc, [w0, w1, w2, w3]) of one regular axis at `x`, in x's dtype:
    the stencil's first index and `_axis_reduce_regular` on the four unit
    bases (K8's regular weights; the kernels' `regular_cubic_weights`,
    csrc/interp_common.cuh)."""
    cl = locate_regular_cubic(x, start, step, dim)
    return cl.loc, [_axis_reduce_regular(e, cl.t, cl.low, cl.high, cl.outside, linearize)
                    for e in unit_bases(x)]


def contract_cubic(c, weights):
    """The vertex-major stencil matrix c (..., 4^N, n) contracted with each
    axis's four weights, axis 0 first: each group of four adjacent rows
    becomes ((w0 v0 + w1 v1) + w2 v2) + w3 v3, the kernels' order
    (`WeightTree`, csrc/interp_common.cuh)."""
    for w in weights:
        g = c.reshape(*c.shape[:-2], c.shape[-2] // 4, 4, c.shape[-1])
        c = w[0] * g[..., 0, :] + w[1] * g[..., 1, :] + w[2] * g[..., 2, :] + w[3] * g[..., 3, :]
    return c[..., 0, :]


def _reduce_tree(c, node):
    """Collapse the vertex-major corner matrix one axis at a time, dim 0
    first: node(k, (v0, v1, v2, v3)) reduces groups of 4 adjacent rows."""
    k = 0
    while c.shape[0] > 1:
        g = c.reshape(c.shape[0] // 4, 4, *c.shape[1:])
        c = node(k, (g[:, 0], g[:, 1], g[:, 2], g[:, 3]))
        k += 1
    return c[0]


def cubic_regular(
    dims: tuple[int, ...], starts, steps, vals, obs, linearize_extrapolation: bool
):
    """Multicubic eval on a regular grid (1-8 dims, every dim >= 4), the
    result shaped like obs[0]."""
    dims = tuple(int(d) for d in dims)
    lin = bool(linearize_extrapolation)

    def impl(ob):
        strides = c_strides(dims)
        base = torch.zeros(ob[0].shape, dtype=torch.int32, device=ob[0].device)
        per_dim = []
        for k in range(len(dims)):
            cl = locate_regular_cubic(ob[k], starts[k], steps[k], dims[k])
            base = base + cl.loc * strides[k]
            per_dim.append(cl)
        c = gather_corners_matrix(vals, base, dims, 4)
        return _reduce_tree(
            c,
            lambda k, v: _axis_reduce_regular(
                v, per_dim[k].t, per_dim[k].low, per_dim[k].high, per_dim[k].outside, lin
            ),
        )

    return chunk_queries(impl, obs, 4 ** len(dims), vals.element_size())


def cubic_rectilinear(grids, vals, obs, linearize_extrapolation: bool):
    """Multicubic eval on a rectilinear grid (1-8 dims, every axis >= 4
    entries), the result shaped like obs[0]."""
    dims = tuple(int(g.shape[0]) for g in grids)
    lin = bool(linearize_extrapolation)

    def impl(ob):
        strides = c_strides(dims)
        base = torch.zeros(ob[0].shape, dtype=torch.int32, device=ob[0].device)
        per_dim = []
        for k in range(len(dims)):
            cl, gc = locate_rectilinear_cubic(ob[k], grids[k])
            base = base + cl.loc * strides[k]
            per_dim.append((cl, gc))
        c = gather_corners_matrix(vals, base, dims, 4)
        return _reduce_tree(
            c,
            lambda k, v: _axis_reduce_rectilinear(
                v, ob[k], per_dim[k][1], per_dim[k][0].low, per_dim[k][0].high,
                per_dim[k][0].outside, lin,
            ),
        )

    return chunk_queries(impl, obs, 4 ** len(dims), vals.element_size())


def cubic_rectilinear_weighted(grids, vals, obs, linearize_extrapolation: bool):
    """Multicubic eval on a rectilinear grid by weights, for one table
    (flat) or a stack (nch, prod(dims)) sharing them: the result shaped like
    obs[0], with a leading nch for a stack. `cubic_rectilinear` within
    rounding, and its value wherever the contraction is not finite."""
    dims = tuple(int(g.shape[0]) for g in grids)
    lin = bool(linearize_extrapolation)
    stack = vals if vals.dim() == 2 else vals[None]

    def impl(ob):
        strides = c_strides(dims)
        base = torch.zeros(ob[0].shape, dtype=torch.int32, device=ob[0].device)
        weights = []
        for k in range(len(dims)):
            loc, w = rectilinear_cubic_weights(ob[k], grids[k], lin)
            base = base + loc * strides[k]
            weights.append(w)
        out = torch.stack([contract_cubic(gather_corners_matrix(v, base, dims, 4), weights)
                           for v in stack])
        tree = torch.stack([cubic_rectilinear(grids, v, ob, lin) for v in stack])
        return torch.where(torch.isfinite(out), out, tree)

    out = chunk_queries(impl, obs, 4 ** len(dims), vals.element_size())
    return out if vals.dim() == 2 else out[0]
