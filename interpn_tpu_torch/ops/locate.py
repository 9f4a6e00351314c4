"""Grid-cell location, vectorized over query batches.

Counterpart of `interpn_tpu/ops/locate.py`, with the same operation order,
so that both packages compute the same cell, the same normalized coordinate
and the same saturation masks bit for bit.

Regular grids use the closed-form locate, clamped to the interior so that
out-of-bounds points land in the edge cell and extrapolate. Rectilinear
grids bisect with `torch.searchsorted(side="left")`, which is
`grid.partition_point(|g| g < x)` for a sorted grid; the TPU's
scan/compare_all switch and one-hot takes have no counterpart here.

NaN queries: a NaN cast to int32 is INT_MIN on the CPU, and
`torch.searchsorted` sorts NaN after the grid, so both are pinned to index 0
before any index is formed, as JAX's saturating cast and the reference's
partition_point (which counts no element < NaN) give.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_I32 = torch.int32


class CubicLoc(NamedTuple):
    """Per-dimension cubic cell location and saturation masks."""

    loc: torch.Tensor  # int32 lower corner of the 4-point stencil
    t: torch.Tensor  # normalized coordinate w.r.t. stencil index 1 (regular)
    low: torch.Tensor  # bool: InsideLow | OutsideLow
    high: torch.Tensor  # bool: InsideHigh | OutsideHigh
    outside: torch.Tensor  # bool: OutsideLow | OutsideHigh


def _nan_to_zero(f: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(f), torch.zeros_like(f), f)


def locate_regular_linear(x, start, step, dim: int):
    """Lower corner + normalized coordinate for a 2-point stencil.

    loc = floor((x - start) / step) clamped to [0, dim-2]; t is measured from
    the clamped cell origin, so extrapolation shows as t outside [0, 1].
    A NaN query reads cell 0 and gives t = NaN.
    """
    floc = _nan_to_zero(torch.floor((x - start) / step))
    loc = torch.clamp(floc, 0.0, float(max(dim - 2, 0))).to(_I32)
    t = (x - (start + step * loc.to(x.dtype))) / step
    return loc, t


def locate_regular_cubic(x, start, step, dim: int) -> CubicLoc:
    """Lower corner of the 4-point stencil plus saturation masks.

    iloc = floor((x-start)/step) - 1, clamped to [0, dim-4]; t is measured
    from stencil index 1. Saturation, with the reference's precedence:
      OutsideLow:  iloc < -1     InsideLow:  iloc == -1
      OutsideHigh: iloc > dim-3  InsideHigh: iloc == dim-3
    The masks come from the raw iloc (all False for NaN); only the index
    cast sees NaN mapped to 0.
    """
    floc = torch.floor((x - start) / step)
    iloc = floc - 1.0
    loc = torch.clamp(_nan_to_zero(iloc), 0.0, float(max(dim - 4, 0))).to(_I32)
    low = iloc <= -1.0
    high = (~low) & (iloc >= float(dim - 3))
    outside = (iloc < -1.0) | ((~low) & (iloc > float(dim - 3)))
    t = (x - (start + step * (loc + 1).to(x.dtype))) / step
    return CubicLoc(loc, t, low, high, outside)


def partition_point(grid, x, side: str = "left"):
    """Count of grid entries < x (side "left") or <= x (side "right") for a
    sorted 1-D `grid` (int32, shaped like x), with NaN counting 0."""
    sp = torch.searchsorted(grid, x.contiguous(), side=side).to(_I32)
    return torch.where(torch.isnan(x), torch.zeros_like(sp), sp)


def locate_rectilinear_linear(x, grid):
    """Lower corner for a 2-point stencil on a monotonic grid:
    partition_point(< x) - 1 clamped to [0, len-2]. Returns (loc, x0, x1)
    where x0/x1 bracket the (possibly clamped) cell."""
    dim = grid.shape[0]
    loc = torch.clamp(partition_point(grid, x) - 1, 0, max(dim - 2, 0))
    return loc, grid[loc], grid[loc + 1]


def locate_rectilinear_cubic(x, grid) -> tuple[CubicLoc, tuple[torch.Tensor, ...]]:
    """Lower corner of the 4-point stencil on a monotonic grid + cell coords.

    iloc = partition_point(< x) - 2, clamped to [0, len-4]. Saturation:
      OutsideLow:  iloc == -2    InsideLow:  iloc == -1
      OutsideHigh: iloc == n-2   InsideHigh: iloc == n-3

    Returns (CubicLoc, grid_cell), grid_cell holding grid[loc+0..3] shaped
    like x. CubicLoc.t carries x: the rectilinear normalized coordinate is
    case-dependent and computed in the tree node.
    """
    dim = grid.shape[0]
    iloc = partition_point(grid, x) - 2
    loc = torch.clamp(iloc, 0, max(dim - 4, 0))
    low = iloc <= -1
    high = (~low) & (iloc >= dim - 3)
    outside = (iloc < -1) | ((~low) & (iloc > dim - 3))
    grid_cell = tuple(grid[loc + i] for i in range(4))
    return CubicLoc(loc, x, low, high, outside), grid_cell
