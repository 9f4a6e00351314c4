"""interpn_tpu_torch: the PyTorch / CUDA port of interpn-tpu.

A second package beside `interpn_tpu` (the JAX reference). It imports torch
and numpy, never jax. Ported so far: multilinear evaluation on regular
grids, f32 and f64, 1-8D, through a hand-written CUDA kernel for Hopper
on CUDA tensors and the gather tree on CPU tensors.

* `interpn(...)`: the one-shot convenience function (linear, regular grids)
* `interpn_tpu_torch.raw`: the ported flat functions
* `interpn_tpu_torch.ops`: the batched functions on tensors
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from numpy.typing import NDArray

from . import raw

__version__ = "0.4.0"

__all__ = ["__version__", "raw", "interpn"]

# What is not ported yet, by ROADMAP.md item.
_NOT_PORTED = {
    "cubic": "ROADMAP item 5",
    "nearest": "ROADMAP item 5",
    "pchip": "ROADMAP item 13",
    "cubic_spline": "ROADMAP item 12",
    "quintic": "ROADMAP item 12",
}


def interpn(
    obs: Sequence[NDArray],
    grids: Sequence[NDArray],
    vals: NDArray,
    *,
    method: str = "linear",
    out: NDArray | None = None,
    linearize_extrapolation: bool = True,
    assume_regular: bool = False,
    check_bounds: bool = False,
    bounds_atol: float = 1e-8,
) -> NDArray:
    """Evaluate an N-dimensional grid at the supplied observation points.

    `interpn_tpu.interpn` with numpy inputs and outputs, computed on
    `torch.get_default_device()`. Grid regularity is detected by exact
    spacing equality; `check_bounds` raises ValueError for points outside
    the grid. Only method="linear" on regular grids is ported; other methods
    and rectilinear grids raise NotImplementedError naming their ROADMAP
    item. `linearize_extrapolation` is accepted for signature parity (it
    concerns the cubic method).
    """
    user_out = out if out is not None else np.zeros_like(obs[0])
    outshape = user_out.shape
    out = user_out.ravel()
    # ravel() of a non-contiguous array is a copy: compute into it, then
    # fold the result back into the caller's array.
    out_is_view = out.base is not None or out is user_out

    obs = [np.ascontiguousarray(np.asarray(x).ravel()) for x in obs]
    grids = [np.ascontiguousarray(np.asarray(x).ravel()) for x in grids]
    vals = np.ascontiguousarray(np.asarray(vals).ravel())

    dtype = vals.dtype
    if dtype not in [np.float64, np.float32]:
        raise AssertionError("`interpn` defined only for float32 and float64 data")
    is_regular = assume_regular or _check_regular(grids)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet ({_NOT_PORTED[method]})"
        )
    if method != "linear":
        raise ValueError(
            "Unsupported interpolation configuration:"
            f" {dtype}, {is_regular}, {method}"
        )
    if not is_regular:
        raise NotImplementedError(
            "rectilinear grids are not ported yet (ROADMAP item 7)"
        )
    dims = np.array([len(grid) for grid in grids], dtype=int)
    starts = np.array([grid[0] for grid in grids], dtype=dtype)
    steps = np.array([grid[1] - grid[0] for grid in grids], dtype=dtype)

    if check_bounds:
        outb = np.zeros((len(grids),), dtype=bool)
        if dtype == np.float32:
            raw.check_bounds_regular_f32(dims, starts, steps, obs, bounds_atol, outb)
        else:
            raw.check_bounds_regular_f64(dims, starts, steps, obs, bounds_atol, outb)
        if any(outb):
            raise ValueError("Observation points violate interpolator bounds")

    if dtype == np.float32:
        raw.interpn_linear_regular_f32(dims, starts, steps, vals, obs, out)
    else:
        raw.interpn_linear_regular_f64(dims, starts, steps, vals, obs, out)

    if not out_is_view:
        np.copyto(user_out, out.reshape(outshape))
        return user_out
    return out.reshape(outshape)


def _check_regular(grids: Sequence[NDArray]) -> bool:
    """True when every grid is regularly spaced (exact equality of
    spacings, as the reference's `_check_regular`)."""
    is_regular = True
    for grid in grids:
        dgrid = np.diff(grid)
        is_regular = is_regular and bool(np.all(dgrid == dgrid[0]))
    return bool(is_regular)
