"""Carry grid parameters held as numpy arrays (the JAX package's form) into
the port's tensors, so that both packages compute on the same numbers."""

from __future__ import annotations

import numpy as np
import torch


def regular_grid_from_numpy(dims, starts, steps, vals, *, device, dtype):
    """(dims, starts, steps, vals) as the port's regular-grid functions take
    them: a tuple of ints, two (ndims,) tensors and the flat C-order table,
    on `device` in `dtype`."""
    return (
        tuple(int(d) for d in np.asarray(dims).ravel()),
        torch.as_tensor(np.asarray(starts).ravel(), dtype=dtype, device=device),
        torch.as_tensor(np.asarray(steps).ravel(), dtype=dtype, device=device),
        torch.as_tensor(np.asarray(vals).ravel(), dtype=dtype, device=device),
    )


def rectilinear_grid_from_numpy(grids, vals, *, device, dtype):
    """(grids, vals) as the port's rectilinear-grid functions take them: a
    tuple of 1-D grid tensors and the flat C-order table, on `device` in
    `dtype`."""
    return (
        obs_from_numpy(grids, device=device, dtype=dtype),
        torch.as_tensor(np.asarray(vals).ravel(), dtype=dtype, device=device),
    )


def obs_from_numpy(obs, *, device, dtype) -> tuple[torch.Tensor, ...]:
    """A tuple of 1-D query tensors, one per dimension."""
    return tuple(
        torch.as_tensor(np.asarray(o).ravel(), dtype=dtype, device=device) for o in obs
    )


def bspline_from_numpy(knots, coeffs, *, device, dtype):
    """(knots, coeffs) as `ops.bspline_eval` takes them: a tuple of 1-D knot
    tensors and the coefficient table (flat, or (nch, prod(dims)) for a
    stack), on `device` in `dtype`. Takes `prep_bspline`'s output of either
    package."""
    return (
        obs_from_numpy(knots, device=device, dtype=dtype),
        torch.as_tensor(np.asarray(coeffs), dtype=dtype, device=device),
    )
