"""Bounds checking for observation points on regular and rectilinear grids.

Counterpart of `interpn_tpu/ops/bounds.py`.
"""

from __future__ import annotations

import torch


def check_bounds_regular(dims: tuple[int, ...], starts, steps, obs, atol):
    """Per-dimension out-of-bounds flags on a regular grid.

    A point x violates dimension i when (x - lo) <= -atol or (x - hi) >= atol,
    with lo/hi the min/max of the first and last grid coordinates. `atol` is
    taken in the dtype of `starts`. Returns a (ndims,) bool tensor.
    """
    atol = torch.as_tensor(atol, dtype=starts.dtype, device=starts.device)
    flags = []
    for i in range(len(dims)):
        first = starts[i]
        last = starts[i] + steps[i] * (dims[i] - 1)
        lo = torch.minimum(first, last)
        hi = torch.maximum(first, last)
        x = obs[i]
        flags.append((((x - lo) <= -atol) | ((x - hi) >= atol)).any())
    return torch.stack(flags)


def check_bounds_rectilinear(grids, obs, atol):
    """Per-dimension out-of-bounds flags on a rectilinear grid: as
    `check_bounds_regular` with lo/hi the first and last grid entries."""
    atol = torch.as_tensor(atol, dtype=grids[0].dtype, device=grids[0].device)
    flags = []
    for i in range(len(grids)):
        lo = grids[i][0]
        hi = grids[i][-1]
        x = obs[i]
        flags.append((((x - lo) <= -atol) | ((x - hi) >= atol)).any())
    return torch.stack(flags)
