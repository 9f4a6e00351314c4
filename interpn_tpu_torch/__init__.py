"""interpn_tpu_torch: the PyTorch / CUDA port of interpn-tpu.

A second package beside `interpn_tpu` (the JAX reference). It imports torch
and numpy, never jax. Ported so far: linear, cubic and nearest evaluation on
regular and rectilinear grids, f32 and f64, 1-8D (nearest 1-6D at the flat
API), through hand-written CUDA kernels for Hopper on CUDA tensors and the
gather tree on CPU tensors.

* `interpn(...)`: the one-shot convenience function
* `interpn_tpu_torch.raw`: the reference's 16 flat functions
* `interpn_tpu_torch.ops`: the batched functions on tensors
* `interpn_tpu_torch.config`: where numpy inputs compute (CUDA by default;
  `config.set_device("cpu")` asks for the CPU)
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
    `config.default_device()` (the CUDA device unless the caller asked for
    another). Grid regularity is detected by exact spacing equality;
    `check_bounds` raises ValueError for points outside the grid. Methods
    "linear", "cubic" (with `linearize_extrapolation`) and "nearest" are
    ported on regular and rectilinear grids; "pchip", "cubic_spline" and
    "quintic" raise NotImplementedError naming their ROADMAP item.
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
    if is_regular:
        dims = np.array([len(grid) for grid in grids], dtype=int)
        starts = np.array([grid[0] for grid in grids], dtype=dtype)
        steps = np.array([grid[1] - grid[0] for grid in grids], dtype=dtype)

    if check_bounds:
        outb = np.zeros((len(grids),), dtype=bool)
        f32 = dtype == np.float32
        if is_regular:
            bounds = raw.check_bounds_regular_f32 if f32 else raw.check_bounds_regular_f64
            bounds(dims, starts, steps, obs, bounds_atol, outb)
        else:
            bounds = raw.check_bounds_rectilinear_f32 if f32 else raw.check_bounds_rectilinear_f64
            bounds(grids, obs, bounds_atol, outb)
        if any(outb):
            raise ValueError("Observation points violate interpolator bounds")

    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet ({_NOT_PORTED[method]})"
        )
    if method not in ("linear", "cubic", "nearest"):
        raise ValueError(
            "Unsupported interpolation configuration:"
            f" {dtype}, {is_regular}, {method}"
        )
    suffix = "f32" if dtype == np.float32 else "f64"
    kind = "regular" if is_regular else "rectilinear"
    fn = getattr(raw, f"interpn_{method}_{kind}_{suffix}")
    grid = (dims, starts, steps, vals) if is_regular else (grids, vals)
    lin = (linearize_extrapolation,) if method == "cubic" else ()
    fn(*grid, *lin, obs, out)

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
