"""Multilinear and multicubic interpolation on a regular grid, in plain torch.

Written from the method's definition (upstream interpn's multilinear and
multicubic regular-grid interpolators), not from the program's code: each
axis gives the first index of its stencil and the stencil's weights in
closed form, and a query's value is the tensor product of the axes' weights
contracted with the table's stencil.

Axis k of a regular grid has `dim` nodes x_j = start + j * step. With
u = (x - start) / step and f = floor(u):

* linear: the cell i = clamp(f, 0, dim - 2), t = u - i, weights (1 - t, t):
  outside the grid the edge cell's line continues.
* cubic: the stencil i .. i + 3 with i = clamp(f - 1, 0, dim - 4) and
  t = u - (i + 1) (dim >= 4). Three regions:
  - interior (1 <= f <= dim - 3): the cubic Hermite spline on [x_{i+1},
    x_{i+2}] with centred-difference slopes (v2 - v0) / 2 and (v3 - v1) / 2,
    whose weights are Catmull-Rom's:
      w0 = (-t + 2t^2 - t^3) / 2      w1 = (2 - 5t^2 + 3t^3) / 2
      w2 = (t + 4t^2 - 3t^3) / 2      w3 = (t^3 - t^2) / 2
  - high (f >= dim - 2): s = t - 1 from node dim - 2. The last cell is the
    quadratic that starts at v2 with the centred slope (v3 - v1) / 2 and
    ends at v3 (the natural end: no cubic term):
      w = (0, (s^2 - s) / 2, 1 - s^2, (s^2 + s) / 2)
    Beyond the last node (s > 1) that quadratic continues, or, with
    `linearize` (upstream's `linearize_extrapolation`), the line through v3
    with the quadratic's end slope 2 (v3 - v2) - (v3 - v1) / 2; with
    e = s - 1:
      w = (0, e / 2, -2e, 1 + 3e / 2)
  - low (f <= 0): the mirror image, s = -t from node 1 towards node 0:
      w = ((s^2 + s) / 2, 1 - s^2, (s^2 - s) / 2, 0), and for s > 1 with
      `linearize`: w = (1 + 3e / 2, -2e, e / 2, 0).

Every formula is evaluated in the dtype of the tensors given, so the same
code computes the float64 reference and, on inputs cast down, the control
in a lower precision. `operand`, where given, rounds both factors of the
contraction (the stencil's weights and the table's values) before they are
multiplied, as a TF32 tensor-core product rounds its inputs and accumulates
in float32 (`tf32`).
"""

from __future__ import annotations

import math

import torch

# queries a block: a 4D cubic block holds 256 indices and values a query
BLOCK_ENTRIES = 1 << 26


def tf32(x):
    """float32 `x` rounded to TF32's 10-bit mantissa, to nearest, ties to
    even, as a float32 tensor (finite values)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


def axis_linear(x, start, step, dim):
    """(first stencil index as int64, [w0, w1]) of one axis at `x`."""
    u = (x - start) / step
    i = torch.clamp(torch.floor(u), 0, dim - 2)
    t = u - i
    return i.to(torch.int64), [1 - t, t]


def axis_cubic(x, start, step, dim, linearize):
    """(first stencil index as int64, [w0, w1, w2, w3]) of one axis at `x`."""
    u = (x - start) / step
    f = torch.floor(u)
    i = torch.clamp(f - 1, 0, dim - 4)
    t = u - (i + 1)
    low = f <= 0
    high = (~low) & (f >= dim - 2)
    t2 = t * t
    t3 = t2 * t
    inner = [(-t + 2 * t2 - t3) / 2, (2 - 5 * t2 + 3 * t3) / 2,
             (t + 4 * t2 - 3 * t3) / 2, (t3 - t2) / 2]
    # the edge cells' quadratic, written from the edge node outwards
    s = torch.where(low, -t, t - 1)
    s2 = s * s
    zero = torch.zeros_like(s)
    edge = [zero, (s2 - s) / 2, 1 - s2, (s2 + s) / 2]
    if linearize:
        e = s - 1
        line = [zero, e / 2, -2 * e, 1 + 1.5 * e]
        edge = [torch.where(s > 1, b, a) for a, b in zip(edge, line)]
    lows = edge[::-1]  # the mirror: node 0 plays node 3's part
    w = [torch.where(low, lo, torch.where(high, hi, mid))
         for lo, hi, mid in zip(lows, edge, inner)]
    return i.to(torch.int64), w


def _stencil(dims, locs, weights):
    """Flat table indices (B, w^N) and weights (B, w^N) of each query's
    stencil, axis 0 the slowest digit."""
    strides = [math.prod(dims[k + 1:]) for k in range(len(dims))]
    idx = None
    wts = None
    for k, (loc, w) in enumerate(zip(locs, weights)):
        width = len(w)
        offs = (loc[:, None] + torch.arange(width, device=loc.device)[None, :]) * strides[k]
        wk = torch.stack(w, dim=1)
        if idx is None:
            idx, wts = offs, wk
        else:
            idx = (idx[:, :, None] + offs[:, None, :]).reshape(idx.shape[0], -1)
            wts = (wts[:, :, None] * wk[:, None, :]).reshape(wts.shape[0], -1)
    return idx, wts


def contract(dims, width, tables, n, axes, operand=None):
    """(T, n) values of the (T, prod(dims)) `tables` at n queries, a block
    of queries at a time: `axes(a, b)` gives, for the queries a .. b - 1,
    each axis's first stencil index and its `width` weights, and the
    tables' stencils are contracted with the tensor product of the weights.
    `operand`, where given, rounds the weights and the table's values
    before they are multiplied."""
    block = max(1, BLOCK_ENTRIES // width ** len(dims))
    out = torch.empty((tables.shape[0], n), dtype=tables.dtype, device=tables.device)
    for a in range(0, n, block):
        b = min(n, a + block)
        locs, weights = axes(a, b)
        idx, wts = _stencil(dims, locs, weights)
        if operand is not None:
            wts = operand(wts)
        for c in range(tables.shape[0]):
            vals = tables[c][idx]
            out[c, a:b] = ((vals if operand is None else operand(vals)) * wts).sum(dim=1)
    return out


def evaluate(method, dims, starts, steps, tables, obs, linearize=True, operand=None):
    """(T, n) values of the (T, prod(dims)) `tables` at the (N, n) queries
    `obs`, by `method` ("linear" or "cubic"), computed in the dtype of the
    arguments (one dtype for all). `starts` and `steps` are sequences of N
    numbers or 0-d tensors of that dtype. `operand`, where given, rounds
    the weights and the table's values before they are multiplied."""
    dims = [int(d) for d in dims]

    def axes(a, b):
        locs, weights = [], []
        for k, dim in enumerate(dims):
            x = obs[k, a:b]
            if method == "cubic":
                loc, w = axis_cubic(x, starts[k], steps[k], dim, linearize)
            else:
                loc, w = axis_linear(x, starts[k], steps[k], dim)
            locs.append(loc)
            weights.append(w)
        return locs, weights

    return contract(dims, 4 if method == "cubic" else 2, tables, obs.shape[1], axes, operand)
