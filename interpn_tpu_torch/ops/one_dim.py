"""1D interpolants on one grid.

Counterpart of `interpn_tpu/ops/one_dim.py`: regular and rectilinear 1D
grids and the interpolants Linear1D, LinearHoldLast1D, Left1D, Right1D and
Nearest1D, batched and branch-free, with the reference's extrapolation flag
as two masks: `Linear1D(RegularGrid1D(start, step, vals)).eval(locs)`.

Placement follows the port's rule: a numpy table goes to
`config.default_device()` when the grid is built (the CUDA device unless the
caller asked for another), a tensor stays where it lives, and locations go
to the table's device. These are torch elementwise operations and one gather
on every device; the TPU's one-hot take has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..config import default_device
from .locate import partition_point

_I32 = torch.int32
_TWO63 = 9223372036854775808.0  # 2^63, exactly representable in f32 and f64


def _length(x) -> int:
    """Leading-axis length of an array-like (1 for a scalar)."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        return int(shape[0]) if len(shape) else 1
    return len(x)


def _table(a) -> torch.Tensor:
    """A grid or value column as a tensor: where it lives, or on the
    default device for numpy and lists."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=default_device())


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """Locations as a tensor on `like`'s device, in their own dtype."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=like.device)


@dataclass(frozen=True)
class GridSample1D:
    """The bracketing sample of each location, with extrapolation masks."""

    x0: Any
    y0: Any
    x1: Any
    y1: Any
    outside_low: Any
    outside_high: Any


@dataclass(frozen=True)
class RegularGrid1D:
    """Uniformly spaced grid. `start` and `step` take the table's dtype and
    device."""

    start: Any
    step: Any
    vals: Any

    def __post_init__(self):
        # a 1-point grid would underflow the reference's `vals.len() - 2`
        if _length(self.vals) < 2:
            raise ValueError("Length mismatch")
        vals = _table(self.vals)
        object.__setattr__(self, "vals", vals)
        for name in ("start", "step"):
            object.__setattr__(self, name, torch.as_tensor(getattr(self, name),
                                                           dtype=vals.dtype, device=vals.device))

    def at(self, loc) -> GridSample1D:
        vals, start, step = self.vals, self.start, self.step
        loc = _on(loc, vals)
        n = vals.shape[0]
        stop = start + step * (n - 1)
        outside_low = loc < start
        outside_high = loc > stop
        # The reference errors where a cell index does not fit an isize: non-
        # finite or huge locations. A batch cannot raise per point, so those
        # give NaN, with the index sanitized before the cast (a NaN cast to
        # an integer is INT_MIN on the CPU).
        fi_raw = torch.floor((loc - start) / step)
        bad = ~torch.isfinite(loc) | (torch.abs(fi_raw) >= _TWO63)
        fi = torch.floor((torch.where(bad, start, loc) - start) / step)
        i = torch.clamp(fi, 0.0, float(n - 2)).to(_I32)
        x0 = start + step * i.to(vals.dtype)
        x1 = x0 + step
        y0 = torch.where(bad, torch.nan, vals[i])
        y1 = torch.where(bad, torch.nan, vals[i + 1])
        return GridSample1D(x0, y0, x1, y1, outside_low, outside_high)


@dataclass(frozen=True)
class RectilinearGrid1D:
    """Monotonic non-uniform grid."""

    grid: Any
    vals: Any

    def __post_init__(self):
        ng = _length(self.grid)
        if ng != _length(self.vals) or ng < 2:
            raise ValueError("Length mismatch")
        object.__setattr__(self, "vals", _table(self.vals))
        object.__setattr__(self, "grid", torch.as_tensor(self.grid, device=self.vals.device))

    def at(self, loc) -> GridSample1D:
        grid, vals = self.grid, self.vals
        loc = _on(loc, vals)
        n = grid.shape[0]
        # partition_point(< NaN) = 0: NaN locates in the first cell with no
        # extrapolation flag, inf at the edges; each interpolant's own
        # arithmetic then decides the value, as the reference's bisection.
        dt = torch.promote_types(grid.dtype, loc.dtype)
        i = torch.clamp(partition_point(grid.to(dt), loc.to(dt)) - 1, 0, n - 2)
        outside_low = loc < grid[0]
        outside_high = loc > grid[-1]
        return GridSample1D(grid[i], vals[i], grid[i + 1], vals[i + 1], outside_low,
                            outside_high)


class _Interp1D:
    """Batched evaluation over locations. `eval(locs)` returns a tensor on
    the table's device (the reference's `eval_alloc`); `eval(locs, out)`
    writes into a numpy array or tensor and returns it, raising "Length
    mismatch" when the lengths disagree."""

    def __init__(self, grid):
        self.grid = grid

    def _eval(self, locs: torch.Tensor):
        raise NotImplementedError  # subclass evaluation hook, on a tensor

    def eval(self, locs, out=None):
        result = self._eval(_on(locs, self.grid.vals))
        if out is None:
            return result
        if _length(out) != _length(locs):
            raise ValueError("Length mismatch")
        if isinstance(out, torch.Tensor):
            out.copy_(result)
        else:
            np.copyto(out, result.detach().cpu().numpy())
        return out

    def eval_alloc(self, locs):
        return self.eval(locs)


class Linear1D(_Interp1D):
    """Linear interpolation and extrapolation."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        slope = (s.y1 - s.y0) / (s.x1 - s.x0)
        return s.y0 + slope * (locs - s.x0)


class LinearHoldLast1D(_Interp1D):
    """Linear inside; holds the edge values outside."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        slope = (s.y1 - s.y0) / (s.x1 - s.x0)
        inside = s.y0 + slope * (locs - s.x0)
        return torch.where(s.outside_low, s.y0, torch.where(s.outside_high, s.y1, inside))


class Left1D(_Interp1D):
    """Hold-last piecewise constant."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        return torch.where(s.outside_high, s.y1, s.y0)


class Right1D(_Interp1D):
    """Hold-next piecewise constant."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        return torch.where(s.outside_low, s.y0, s.y1)


class Nearest1D(_Interp1D):
    """Nearest value; ties take the left value."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        dx0 = torch.abs(locs - s.x0)
        dx1 = torch.abs(locs - s.x1)
        return torch.where(dx1 >= dx0, s.y0, s.y1)
