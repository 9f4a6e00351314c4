"""Multilinear and multicubic interpolation on a rectilinear grid, in plain torch.

Written from the method's definition (upstream interpn's multilinear and
multicubic rectilinear interpolators: `partition_point` locate, Hermite
cubic with non-uniform centred slopes, `src/multicubic/rectilinear.rs`),
not from the program's code: each axis gives the first index of its stencil
and the stencil's weights in closed form, and a query's value is the tensor
product of the axes' weights contracted with the table's stencil.

Axis k has `dim` strictly increasing nodes c_0 .. c_{dim-1}. A query x is
located by p = #{j : c_j < x} (upstream's `partition_point(< x)`,
`torch.searchsorted(c, x)`, left side).

* linear: the cell i = clamp(p - 1, 0, dim - 2), t = (x - c_i) / (c_{i+1} -
  c_i), weights (1 - t, t): outside the grid the edge cell's line continues.
* cubic: the stencil g0 .. g3 = c_i .. c_{i+3} with i = clamp(p - 2, 0,
  dim - 4) (dim >= 4), spacings h01, h12, h23. The slope at a node m
  between nodes l and r, a = x_m - x_l, b = x_r - x_m, is the non-uniform
  centred difference (exact on quadratics; upstream's
  `centered_difference_nonuniform`, Veldman and Rinzema's method B)
      D = a / (a + b) * (y_r - y_m) / b + b / (a + b) * (y_m - y_l) / a.
  A slope used on a piece of length H enters as H D, linear in the three
  values: H D = s_l y_l + s_m y_m + s_r y_r with
      s_r = H a / ((a + b) b),   s_l = -H b / ((a + b) a),   s_m = -(s_l + s_r).
  Three regions, as `reference/regular.py`'s on uneven spacing:
  - interior (2 <= p <= dim - 2, so g1 < x <= g2): the cubic Hermite on
    [g1, g2], t = (x - g1) / h12, with H = h12 and the slopes at g1 (over
    g0, g1, g2) and g2 (over g1, g2, g3), K1 and K2:
      value = h00 v1 + h01 v2 + h10 K1 + h11 K2,
      h00 = 2t^3 - 3t^2 + 1, h01 = 3t^2 - 2t^3, h10 = t^3 - 2t^2 + t,
      h11 = t^3 - t^2.
  - high (p >= dim - 1, so x > g2): s = (x - g2) / h23 from node dim - 2.
    The last cell is the quadratic that starts at v2 with the slope K at g2
    (over g1, g2, g3, H = h23) and ends at v3 (upstream's natural end
    k1 = 2 dy - k0: no cubic term):
      value = (1 - s^2) v2 + s^2 v3 + (s - s^2) K.
    Beyond the last node (p = dim) that quadratic continues, or, with
    `linearize` (upstream's `linearize_extrapolation`), the line through v3
    with the quadratic's end slope 2 (v3 - v2) - K; with e = s - 1:
      value = v3 + e (2 v3 - 2 v2 - K).
  - low (p <= 1, so x <= g1): the mirror image, s = (g1 - x) / h01 from
    node 1 towards node 0, with K the slope at g1 (over g0, g1, g2, H = h01)
    taken towards node 0, i.e. negated; beyond the first node (p = 0) the
    line through v0 with `linearize`.

Every formula is evaluated in the dtype of the tensors given, so the same
code computes the float64 reference and, on inputs cast down, the control
in a lower precision. `operand`, where given, rounds both factors of the
contraction (the stencil's weights and the table's values) before they are
multiplied, as a TF32 tensor-core product rounds its inputs and accumulates
in float32 (`tf32`). The contraction and `tf32` are `reference/regular.py`'s:
only the axes' stencils differ.

Departures from upstream, each a change of rounding only: the slopes are
formed as H D above, where upstream normalises the spacings by h12 (or the
edge cell's length) first; the value is the contraction of the tensor
product of the axes' weights with the stencil, where upstream evaluates a
tree of 1-D Hermite polynomials by Horner's rule axis by axis; and no
branch returns a node's value exactly, since at a node the weights are
exactly 0 and 1 already. NaN queries and non-finite tables, which the
benchmark's traffic never holds, are not given upstream's handling.
"""

from __future__ import annotations

import torch

from .regular import contract, tf32  # noqa: F401  (tf32: the control's rounding)


def _slope(a, b, h):
    """(s_l, s_m, s_r): h times the centred slope at the middle of three
    nodes spaced a and b, as weights of their three values."""
    right = h * a / ((a + b) * b)
    left = -h * b / ((a + b) * a)
    return left, -(left + right), right


def axis_linear(x, c):
    """(first stencil index as int64, [w0, w1]) of one axis at `x`."""
    p = torch.searchsorted(c, x)
    i = torch.clamp(p - 1, 0, c.shape[0] - 2)
    x0, x1 = c[i], c[i + 1]
    t = (x - x0) / (x1 - x0)
    return i, [1 - t, t]


def axis_cubic(x, c, linearize):
    """(first stencil index as int64, [w0, w1, w2, w3]) of one axis at `x`."""
    dim = c.shape[0]
    p = torch.searchsorted(c, x)
    i = torch.clamp(p - 2, 0, dim - 4)
    g0, g1, g2, g3 = (c[i + j] for j in range(4))
    h01, h12, h23 = g1 - g0, g2 - g1, g3 - g2
    low = p <= 1
    high = (~low) & (p >= dim - 1)
    zero = torch.zeros_like(x)
    # interior: the Hermite cubic on [g1, g2]
    t = (x - g1) / h12
    t2 = t * t
    t3 = t2 * t
    e00, e01, e10, e11 = 2 * t3 - 3 * t2 + 1, 3 * t2 - 2 * t3, t3 - 2 * t2 + t, t3 - t2
    k1 = _slope(h01, h12, h12)  # at g1, over v0 v1 v2
    k2 = _slope(h12, h23, h12)  # at g2, over v1 v2 v3
    inner = [e10 * k1[0], e00 + e10 * k1[1] + e11 * k2[0], e01 + e10 * k1[2] + e11 * k2[1],
             e11 * k2[2]]
    # high: the quadratic on [g2, g3] from v2 with the slope at g2, to v3
    s = (x - g2) / h23
    q = s - s * s
    k = _slope(h12, h23, h23)
    hi = [zero, q * k[0], 1 - s * s + q * k[1], s * s + q * k[2]]
    # low: its mirror on [g0, g1] from v1 towards v0, the slope taken towards g0
    r = (g1 - x) / h01
    qr = r - r * r
    m = [-w for w in _slope(h01, h12, h01)]
    lo = [r * r + qr * m[0], 1 - r * r + qr * m[1], qr * m[2], zero]
    if linearize:
        e = s - 1
        hi = [torch.where(p == dim, ln, w) for w, ln in
              zip(hi, [zero, -e * k[0], -2 * e - e * k[1], 1 + 2 * e - e * k[2]])]
        er = r - 1
        lo = [torch.where(p == 0, ln, w) for w, ln in
              zip(lo, [1 + 2 * er - er * m[0], -2 * er - er * m[1], -er * m[2], zero])]
    w = [torch.where(low, l_, torch.where(high, h_, i_)) for l_, h_, i_ in zip(lo, hi, inner)]
    return i, w


def evaluate(method, dims, coords, tables, obs, linearize=True, operand=None):
    """(T, n) values of the (T, prod(dims)) `tables` at the (N, n) queries
    `obs`, by `method` ("linear" or "cubic"), computed in the dtype of the
    arguments (one dtype for all). `coords` is a sequence of N strictly
    increasing 1-D tensors, axis k of `dims[k]` nodes. `operand`, where
    given, rounds the weights and the table's values before they are
    multiplied."""
    dims = [int(d) for d in dims]
    if [int(c.shape[0]) for c in coords] != dims:
        raise ValueError(f"coords of {[c.shape[0] for c in coords]} nodes for dims {dims}")

    def axes(a, b):
        locs, weights = [], []
        for c, x in zip(coords, obs[:, a:b]):
            loc, w = (axis_cubic(x.contiguous(), c, linearize) if method == "cubic"
                      else axis_linear(x.contiguous(), c))
            locs.append(loc)
            weights.append(w)
        return locs, weights

    return contract(dims, 4 if method == "cubic" else 2, tables, obs.shape[1], axes, operand)
