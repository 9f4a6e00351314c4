"""Multilinear interpolation/extrapolation: the gather tree.

Counterpart of `interpn_tpu/ops/linear.py`: one flat gather per stencil
vertex, then the reference's repeated-lerp tree, dim 0 first. This is the
port's CPU path, its gradient path, and the plain version of the linear
kernels (`ops/fused.py`).
"""

from __future__ import annotations

import torch

from ..utils import c_strides
from ._gather import gather_corners
from .locate import locate_rectilinear_linear, locate_regular_linear


def _lerp_reduce(corners, ts):
    """Collapse the corner list with repeated 1D lerps, pairing adjacent
    entries (which differ in dimension 0's bit) first."""
    c = corners
    for t in ts:
        c = [y0 + t * (y1 - y0) for y0, y1 in zip(c[0::2], c[1::2])]
    return c[0]


def linear_regular(dims: tuple[int, ...], starts, steps, vals, obs):
    """Multilinear eval on a regular grid.

    Args:
        dims: grid shape, one entry per dimension.
        starts: (ndims,) first grid coordinate per dimension.
        steps: (ndims,) grid spacing per dimension (positive).
        vals: flat (prod(dims),) C-order grid values.
        obs: tuple of ndims query-coordinate tensors, all the same shape.

    Returns interpolated/extrapolated values shaped like obs[0].
    """
    strides = c_strides(dims)
    base = torch.zeros(obs[0].shape, dtype=torch.int32, device=obs[0].device)
    ts = []
    for k in range(len(dims)):
        loc, t = locate_regular_linear(obs[k], starts[k], steps[k], dims[k])
        base = base + loc * strides[k]
        ts.append(t)
    corners = gather_corners(vals, base, dims, 2)
    return _lerp_reduce(corners, ts)


def linear_rectilinear(grids, vals, obs):
    """Multilinear eval on a rectilinear (monotonic, non-uniform) grid.

    The cell comes from a bisection; t = (x - x0)/(x1 - x0) from the
    bracketing grid coordinates.
    """
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)
    base = torch.zeros(obs[0].shape, dtype=torch.int32, device=obs[0].device)
    ts = []
    for k in range(len(dims)):
        loc, x0, x1 = locate_rectilinear_linear(obs[k], grids[k])
        base = base + loc * strides[k]
        ts.append((obs[k] - x0) / (x1 - x0))
    corners = gather_corners(vals, base, dims, 2)
    return _lerp_reduce(corners, ts)
