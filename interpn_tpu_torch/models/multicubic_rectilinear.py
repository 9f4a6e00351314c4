"""MulticubicRectilinear: cubic Hermite interpolator on a rectilinear grid.

Counterpart of `interpn_tpu/models/multicubic_rectilinear.py`: the same
fields, `new()`, validation messages and JSON bytes; evaluation runs the
port's `ops.cubic_rectilinear` through `models/_device.py`.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray
from pydantic import model_validator

from ._base import InterpolatorBase, RectilinearGridMixin, arrtype_for, prod_dims
from .serialization import Array


class MulticubicRectilinear(RectilinearGridMixin, InterpolatorBase):
    """Multicubic interpolation on a rectilinear grid in up to 8 dimensions.

    Same Hermite construction as MulticubicRegular, with derivative estimates
    from distance-weighted nonuniform centered differences.

    Construction expects flat (1D, contiguous) arrays sharing one float
    dtype, np.float64 or np.float32; each grid needs at least 4 strictly
    increasing entries (the 4-point stencil's floor).
    """

    _MIN_GRID = 4
    _MIN_GRID_MSG = "All grids must have at least 4 entries"

    grids: list[Array]
    vals: Array
    linearize_extrapolation: bool

    @classmethod
    def new(
        cls,
        grids: list[NDArray],
        vals: NDArray,
        linearize_extrapolation: bool = True,
    ) -> "MulticubicRectilinear":
        """Build a model from per-axis coordinate arrays and a value table.

        Args:
            grids: per-axis coordinate arrays, each strictly increasing.
            vals: grid-point value table, flattened in C (row-major) order.
            linearize_extrapolation: Whether to fall back to linear
                extrapolation with the boundary slope outside the grid
        """
        arrtype = arrtype_for(np.asarray(vals))
        return cls(
            grids=[arrtype(data=np.asarray(x)) for x in grids],
            vals=arrtype(data=np.asarray(vals).flatten()),
            linearize_extrapolation=linearize_extrapolation,
        )

    @model_validator(mode="after")
    def _validate_model(self):
        dims = self.dims()
        ndims = self.ndims()
        assert ndims <= 8 and ndims >= 1, (
            "Number of dimensions must be at least 1 and no more than 8"
        )
        assert self.vals.data.size == prod_dims(dims), (
            "Size of value array does not match grid dims"
        )
        assert all([np.all(np.diff(x.data) > 0.0) for x in self.grids]), (
            "All grids must be monotonically increasing"
        )
        assert all([x.data.dtype == self.vals.data.dtype for x in self.grids]), (
            "All grid inputs must be of the same data type (np.float32 or np.float64)"
        )
        assert (
            all([x.data.data.contiguous for x in self.grids])
            and self.vals.data.data.contiguous
        ), "Grid data must be contiguous"
        return self

    def ndims(self) -> int:
        return len(self.grids)

    def _device_spec(self) -> dict:
        return dict(method="cubic", linearize_extrapolation=self.linearize_extrapolation,
                    **self._grid_spec())
