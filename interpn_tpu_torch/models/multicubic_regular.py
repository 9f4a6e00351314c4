"""MulticubicRegular: cubic Hermite interpolator on a regular grid.

Counterpart of `interpn_tpu/models/multicubic_regular.py`: the same
fields, `new()`, validation messages and JSON bytes; evaluation runs the
port's `ops.cubic_regular` through `models/_device.py`.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray
from pydantic import model_validator

from ._base import InterpolatorBase, RegularGridMixin, arrtype_for, prod_dims
from .serialization import Array


class MulticubicRegular(RegularGridMixin, InterpolatorBase):
    """Multicubic interpolation on a regular grid in up to 8 dimensions.

    Uses a symmetrized Hermite spline with derivatives from second-order
    centered differences: continuous value and first derivative, quadratic in
    the last cell before each boundary (natural spline BC). When
    `linearize_extrapolation` is set, dimensions under extrapolation continue
    linearly with the boundary slope.

    Construction expects flat (1D, contiguous) arrays sharing one float
    dtype, np.float64 or np.float32, with at least 4 points per axis (the
    4-point stencil's floor).
    """

    _MIN_GRID = 4
    _MIN_GRID_MSG = "All grids must have at least four entries"

    dims: list[int]
    starts: Array
    steps: Array
    vals: Array
    linearize_extrapolation: bool

    @classmethod
    def new(
        cls,
        dims: list[int],
        starts: NDArray,
        steps: NDArray,
        vals: NDArray,
        linearize_extrapolation: bool = True,
    ) -> "MulticubicRegular":
        """Build a model from plain numpy inputs: arrays are flattened to
        contiguous storage and converted to the dtype of `vals` before
        validation.

        Args:
            dims: grid point count along each axis
            starts: first grid coordinate along each axis
            steps: spacing between grid points along each axis
            vals: grid-point value table, flattened in C (row-major) order
            linearize_extrapolation: Whether to fall back to linear
                extrapolation with the boundary slope outside the grid
        """
        arrtype = arrtype_for(np.asarray(vals))
        return cls(
            dims=dims,
            starts=arrtype(data=np.asarray(starts).flatten()),
            steps=arrtype(data=np.asarray(steps).flatten()),
            vals=arrtype(data=np.asarray(vals).flatten()),
            linearize_extrapolation=linearize_extrapolation,
        )

    @model_validator(mode="after")
    def _validate_model(self):
        ndims = self.ndims()
        assert ndims <= 8 and ndims >= 1, (
            "Number of dimensions must be at least 1 and no more than 8"
        )
        assert self.starts.data.size == ndims, "Grid dimension mismatch"
        assert self.steps.data.size == ndims, "Grid dimension mismatch"
        assert self.vals.data.size == prod_dims(self.dims), (
            "Size of value array does not match grid dims"
        )
        assert all([x > 0.0 for x in self.steps.data]), (
            "All grid steps must be positive and nonzero"
        )
        assert all(
            [x.data.dtype == self.vals.data.dtype for x in [self.steps, self.vals]]
        ), "All grid inputs must be of the same data type (np.float32 or np.float64)"
        assert all(
            [x.data.data.contiguous for x in [self.starts, self.steps, self.vals]]
        ), "Grid data must be contiguous"
        return self

    def ndims(self) -> int:
        return len(self.dims)

    def _device_spec(self) -> dict:
        return dict(method="cubic", linearize_extrapolation=self.linearize_extrapolation,
                    **self._grid_spec())
