"""Tensor-product B-spline interpolation (scipy's ``cubic`` / ``quintic``).

Counterpart of `interpn_tpu/ops/bspline.py`, which imports jax, so the port
keeps its own copy of the host part.

* Host preparation (numpy and scipy, float64): per axis the not-a-knot knot
  vector and the banded collocation solve, axis by axis, giving the
  tensor-product coefficients. The arithmetic is the JAX package's, so the
  knots and coefficients are bitwise equal to its `prep_bspline`'s.
  `prep_bspline_cached` keys the solve by content, as there.
* Device evaluation (torch), the plain version of `csrc/fused_bspline.cu`
  (K4, K7) and the port's CPU and gradient path: per axis the de Boor span
  (`searchsorted(side="right") - 1` clamped to [k, n-1], NaN counting 0 as
  `ops/locate.py` pins it), the Cox-de Boor basis values term for term as
  `_basis_weights`, then the (k+1)^N stencil gathered as one matrix and
  reduced last axis first, each axis summed left to right. Out-of-bounds
  queries extrapolate the end span's polynomial.

The entry points that route CUDA tensors to the kernel are
`ops.dispatch.bspline_eval` and `ops.stack.bspline_eval_stack`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils import c_strides
from ._chunk import chunk_queries
from ._gather import gather_corners_matrix
from .locate import partition_point

_I32 = torch.int32


# --- host preparation: not-a-knot knots and collocation solves --------------------


def not_a_knot_knots(x: np.ndarray, k: int) -> np.ndarray:
    """Not-a-knot knot vector for data sites `x` and odd degree `k`:
    full-multiplicity end knots, interior knots the data sites without the
    (k-1)/2 sites next to each boundary (de Boor XIII(12))."""
    if k % 2 != 1:
        raise ValueError("not-a-knot requires odd spline degree")
    x = np.asarray(x, dtype=np.float64)
    m = (k - 1) // 2
    interior = x[m + 1 : x.size - (m + 1)]
    return np.concatenate([np.full(k + 1, x[0]), interior, np.full(k + 1, x[-1])])


def _basis_row_np(t: np.ndarray, span: int, x: float, k: int) -> np.ndarray:
    """The k+1 nonzero B-spline basis values at `x` in `span` (Cox-de Boor,
    host scalar form for the collocation rows)."""
    N = np.zeros(k + 1)
    N[0] = 1.0
    for j in range(1, k + 1):
        saved = 0.0
        for r in range(j):
            den = t[span + r + 1] - t[span + r + 1 - j]
            temp = N[r] / den
            N[r] = saved + (t[span + r + 1] - x) * temp
            saved = (x - t[span + r + 1 - j]) * temp
        N[j] = saved
    return N


def _solve_axis(x: np.ndarray, t: np.ndarray, k: int, rhs: np.ndarray) -> np.ndarray:
    """Solve the square collocation system B(x_i) c = rhs along axis 0, in
    banded form (scipy `solve_banded`): site x_i touches the k+1
    coefficients [span_i - k, span_i]."""
    from scipy.linalg import solve_banded

    n = x.size
    spans = np.clip(np.searchsorted(t, x, side="right") - 1, k, n - 1)
    # band extents from the span pattern (not-a-knot end rows sit off the
    # diagonal by up to k)
    idx = np.arange(n)
    lower = int(np.max(idx - (spans - k)))
    upper = int(np.max(spans - idx))
    ab = np.zeros((lower + upper + 1, n))
    for i in range(n):
        s = int(spans[i])
        row = _basis_row_np(t, s, float(x[i]), k)
        for r in range(k + 1):
            j = s - k + r
            ab[upper + i - j, j] = row[r]
    return solve_banded((lower, upper), ab, rhs)


def prep_bspline(grids, vals, k: int):
    """Per-axis not-a-knot knots and the tensor-product coefficients.

    grids: strictly ascending 1-D arrays; vals: flat C-order table
    (prod(dims),) or (prod(dims), nch) with a trailing channel axis.
    Returns (knots, coeffs), coeffs shaped like vals, all float64 numpy."""
    grids = [np.asarray(g, dtype=np.float64) for g in grids]
    dims = tuple(int(g.size) for g in grids)
    vals = np.asarray(vals, dtype=np.float64)
    trailing = vals.shape[1:]
    c = vals.reshape(dims + trailing)
    knots = []
    for ax, x in enumerate(grids):
        if x.size < k + 1:
            raise ValueError(f"degree-{k} spline needs at least {k + 1} points per axis")
        t = not_a_knot_knots(x, k)
        knots.append(t)
        cm = np.moveaxis(c, ax, 0)
        sol = _solve_axis(x, t, k, cm.reshape(x.size, -1))
        c = np.moveaxis(sol.reshape(cm.shape), 0, ax)
    return knots, np.ascontiguousarray(c.reshape(vals.shape))


# Content-keyed cache of prepared coefficients: one-shot callers
# (`interpn(method=...)`, `interpn_stack`) present the same table on every
# call, and the solve is the costly part.
_PREP_CACHE: dict = {}
_PREP_ORDER: list = []
_PREP_MAX = 8


def _content_key(arrays, k: int):
    h = hashlib.blake2b(digest_size=16)
    parts = []
    for a in arrays:
        buf = np.ascontiguousarray(a)
        h.update(buf)
        parts.append((buf.dtype.str, buf.shape))
    return (h.digest(), tuple(parts), k)


def prep_bspline_cached(grids, vals, k: int):
    """`prep_bspline` behind a content-keyed cache of the last 8 tables."""
    grids = [np.asarray(g, dtype=np.float64) for g in grids]
    vals = np.asarray(vals, dtype=np.float64)
    key = _content_key(grids + [vals], k)
    hit = _PREP_CACHE.get(key)
    if hit is not None:
        return hit
    prep = prep_bspline(grids, vals, k)
    _PREP_CACHE[key] = prep
    _PREP_ORDER.append(key)
    while len(_PREP_ORDER) > _PREP_MAX:
        _PREP_CACHE.pop(_PREP_ORDER.pop(0), None)
    return prep


# --- device evaluation: the gather tree ---------------------------------------------


def _basis_weights(t, span, x, k: int):
    """The k+1 nonzero basis values per query (Cox-de Boor), from the knots
    t[span - k + 1 .. span + k]."""
    tk = {off: t[span + off] for off in range(-k + 1, k + 1)}
    N = [torch.ones_like(x)] + [torch.zeros_like(x) for _ in range(k)]
    for j in range(1, k + 1):
        saved = torch.zeros_like(x)
        for r in range(j):
            den = tk[r + 1] - tk[r + 1 - j]
            temp = N[r] / den
            N[r] = saved + (tk[r + 1] - x) * temp
            saved = (x - tk[r + 1 - j]) * temp
        N[j] = saved
    return N


def spline_locs_weights(knots, obs, k: int):
    """Per axis (loc, [w_0..w_k]): the de Boor span clamped to [k, n-1]
    (out-of-bounds queries extrapolate the end span's polynomial), rebased
    to the first coefficient index `span - k`, and the basis values."""
    out = []
    for t, x in zip(knots, obs):
        n = int(t.shape[0]) - k - 1
        span = torch.clamp(partition_point(t, x, side="right") - 1, k, n - 1)
        out.append((span - k, _basis_weights(t, span, x, k)))
    return out


def _bspline_impl(knots, coeffs, obs, k: int):
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    strides = c_strides(dims)
    base = torch.zeros(obs[0].shape, dtype=_I32, device=obs[0].device)
    wts = []
    for ax, (loc, ws) in enumerate(spline_locs_weights(knots, obs, k)):
        base = base + loc * strides[ax]
        wts.append(ws)
    width = k + 1
    # vertex-major, dim 0 in the lowest base-(k+1) digit: the leading axis
    # of each reshape is the last axis still unreduced
    c = gather_corners_matrix(coeffs, base, dims, width)
    for w in reversed(wts):
        g = c.reshape(width, c.shape[0] // width, *c.shape[1:])
        acc = w[0] * g[0]
        for r in range(1, width):
            acc = acc + w[r] * g[r]
        c = acc
    return c[0]


def bspline_gather(knots, coeffs, obs, k: int):
    """Tensor-product B-spline of degree k at `obs` (ndims tensors of one
    shape), the result shaped like obs[0]: the gather tree, chunked so that
    the (k+1)^N stencil matrix stays bounded."""
    return chunk_queries(
        lambda ob: _bspline_impl(knots, coeffs, ob, k),
        obs, (k + 1) ** len(knots), coeffs.element_size(),
    )
