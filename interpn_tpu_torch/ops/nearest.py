"""Nearest-neighbor interpolation: the gather tree.

Counterpart of `interpn_tpu/ops/nearest.py`, and the plain version of the
nearest kernels. Each axis selects independently; the midpoint (dt == 0.5)
selects the LOWER index. A NaN query has dt = NaN, which fails `dt <= 0.5`,
so it selects index 1 of its cell on that axis, as the JAX package does.
One gather per query.
"""

from __future__ import annotations

import torch

from ..utils import c_strides
from ._gather import take1
from .locate import locate_rectilinear_linear, locate_regular_linear


def _offset(dt):
    """0 where dt <= 0.5 (the lower index wins the tie), else 1."""
    return torch.where(dt <= 0.5, 0, 1).to(torch.int32)


def nearest_regular(dims: tuple[int, ...], starts, steps, vals, obs):
    """Nearest-neighbor eval on a regular grid, shaped like obs[0]."""
    strides = c_strides(dims)
    flat = torch.zeros(obs[0].shape, dtype=torch.int32, device=obs[0].device)
    for k in range(len(dims)):
        loc, dt = locate_regular_linear(obs[k], starts[k], steps[k], dims[k])
        flat = flat + (loc + _offset(dt)) * strides[k]
    return take1(vals, flat)


def nearest_rectilinear(grids, vals, obs):
    """Nearest-neighbor eval on a rectilinear grid, shaped like obs[0]."""
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)
    flat = torch.zeros(obs[0].shape, dtype=torch.int32, device=obs[0].device)
    for k in range(len(dims)):
        loc, x0, x1 = locate_rectilinear_linear(obs[k], grids[k])
        dt = (obs[k] - x0) / (x1 - x0)
        flat = flat + (loc + _offset(dt)) * strides[k]
    return take1(vals, flat)
