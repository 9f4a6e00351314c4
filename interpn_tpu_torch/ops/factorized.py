"""Factorized evaluation: interpolation as per-axis weight-matrix products.

Counterpart of `interpn_tpu/ops/factorized.py`, selected by
INTERPN_TPU_IMPL=factorized (`ops/dispatch.py`) for one table of linear,
cubic or nearest on either grid kind. Every method is linear in the grid
values: the result is the sum over the stencil of vals[corner] times the
product of each axis's weight at that corner. Each axis gets a dense
(n, dims[k]) weight matrix W_k, zero off the stencil, and

    y = W_lead @ vals.reshape(prod(dims[:p]), -1)     # one matrix product
    y = einsum('qbr,qb->qr', y, W_k)   for k = p .. N-1

where W_lead joins the first p axes' matrices (`_split_point`). The work is
2 * n * prod(dims) multiply-adds whatever the stencil, so cubic costs what
linear does, and it grows with the grid. The products are plain PyTorch
(cuBLAS on the card): the JAX package computes them outside any Pallas
kernel too.

Caveat: a product multiplies every grid value by its weight, zero off the
stencil, so one non-finite table entry poisons every result (0 * inf =
nan), where the gather tree and the kernels read only the stencil. Use it
on finite tables only.

The cubic weights are the gather tree's own node on the four unit bases
(`ops/cubic.py::regular_cubic_weights`, `rectilinear_cubic_weights`), so
both compute the same function and differ in rounding order only.

float32 products stay IEEE float32: every call checks
`config.require_ieee_fp32()` (no TF32), where the JAX package pins
`precision=HIGHEST`.
"""

from __future__ import annotations

import math

import torch

from ..config import require_ieee_fp32
from ._chunk import chunk_queries
from .cubic import rectilinear_cubic_weights, regular_cubic_weights
from .locate import locate_rectilinear_linear, locate_regular_linear

_I32 = torch.int32

# The first product makes an (n_chunk, prod(dims[p:])) temporary; the query
# axis is chunked to bound it to about this many bytes (see ops/_chunk.py).
_CHUNK_BYTES = 2 * 1024 * 1024 * 1024

# The widest contraction when leading axes are joined into one product.
_MAX_GROUPED_K = 2048


def _chunk_queries(f, obs, rest: int, itemsize: int):
    """f over query chunks sized to bound the contraction's temporary."""
    return chunk_queries(f, obs, rest, itemsize, _CHUNK_BYTES)


def _scatter_weights(loc, ws, dim: int):
    """Dense (n, dim) weight matrix with ws[i] at column loc + i."""
    iota = torch.arange(dim, dtype=_I32, device=loc.device)
    cols = loc[:, None]
    w = None
    for i, wi in enumerate(ws):
        term = torch.where(iota == cols + i, wi[:, None], 0)
        w = term if w is None else w + term
    return w


def _split_point(dims) -> int:
    """How many leading axes join the matrix product: the split with the
    least per-query width (joined weights + first intermediate); ties
    prefer fewer axes. 20^4 joins two (K = 400, rest = 400)."""
    best_p, best_cost = 1, None
    k = 1
    rest = math.prod(dims)
    for p in range(1, len(dims) + 1):
        k *= dims[p - 1]
        rest //= dims[p - 1]
        if k > _MAX_GROUPED_K and p > 1:
            break
        cost = (k if p > 1 else 0) + rest  # the joined weights exist only if p > 1
        if best_cost is None or cost < best_cost:
            best_p, best_cost = p, cost
    return best_p


def _max_row_width(dims) -> int:
    """The widest per-query row the contraction makes (sizes the chunks)."""
    p = _split_point(dims)
    k = math.prod(dims[:p])
    rest = math.prod(dims[p:])
    return max(k if p > 1 else 0, rest, 1)


def _contract(weight_mats, vals, dims):
    """Apply the per-axis contractions; weight_mats[k] is (n, dims[k])."""
    n = weight_mats[0].shape[0]
    p = _split_point(dims)
    wlead = weight_mats[0]
    for k in range(1, p):
        wlead = (wlead[:, :, None] * weight_mats[k][:, None, :]).reshape(n, -1)
    ksize = math.prod(dims[:p])
    y = wlead @ vals.reshape(ksize, -1)
    for k in range(p, len(dims)):
        rest = y.shape[1] // dims[k]
        y = torch.einsum("qbr,qb->qr", y.reshape(n, dims[k], rest), weight_mats[k])
    return y.reshape(n)


def _run(dims, vals, obs, axis_weights):
    """The contraction of `axis_weights(k, x)` -> (loc, [weights]) over the
    axes, chunked over the queries."""
    require_ieee_fp32()
    dims = tuple(int(d) for d in dims)

    def run(ob):
        mats = []
        for k in range(len(dims)):
            loc, ws = axis_weights(k, ob[k])
            mats.append(_scatter_weights(loc, ws, dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, tuple(obs), _max_row_width(dims), vals.element_size())


def _nearest_pick(loc, dt):
    """The nearest node's column and its one weight."""
    sel = loc + torch.where(dt <= 0.5, 0, 1).to(loc.dtype)
    return sel, [torch.ones_like(dt)]


def linear_regular_factorized(dims, starts, steps, vals, obs):
    """Multilinear on a regular grid (the locate of
    `ops.linear.linear_regular`)."""

    def weights(k, x):
        loc, t = locate_regular_linear(x, starts[k], steps[k], int(dims[k]))
        return loc, [1.0 - t, t]

    return _run(dims, vals, obs, weights)


def linear_rectilinear_factorized(grids, vals, obs):
    def weights(k, x):
        loc, x0, x1 = locate_rectilinear_linear(x, grids[k])
        t = (x - x0) / (x1 - x0)
        return loc, [1.0 - t, t]

    return _run([g.shape[0] for g in grids], vals, obs, weights)


def nearest_regular_factorized(dims, starts, steps, vals, obs):
    """Nearest neighbor as a one-hot contraction: one weight of 1 an axis,
    at the chosen node."""

    def weights(k, x):
        loc, dt = locate_regular_linear(x, starts[k], steps[k], int(dims[k]))
        return _nearest_pick(loc, dt)

    return _run(dims, vals, obs, weights)


def nearest_rectilinear_factorized(grids, vals, obs):
    def weights(k, x):
        loc, x0, x1 = locate_rectilinear_linear(x, grids[k])
        return _nearest_pick(loc, (x - x0) / (x1 - x0))

    return _run([g.shape[0] for g in grids], vals, obs, weights)


def cubic_regular_factorized(dims, starts, steps, vals, obs, linearize: bool):
    def weights(k, x):
        return regular_cubic_weights(x, starts[k], steps[k], int(dims[k]), bool(linearize))

    return _run(dims, vals, obs, weights)


def cubic_rectilinear_factorized(grids, vals, obs, linearize: bool):
    def weights(k, x):
        return rectilinear_cubic_weights(x, grids[k], bool(linearize))

    return _run([g.shape[0] for g in grids], vals, obs, weights)
