"""NearestRegular: nearest-neighbor interpolator on a regular grid.

Counterpart of `interpn_tpu/models/nearest_regular.py`: the same
fields, `new()`, validation messages and JSON bytes; evaluation runs the
port's `ops.nearest_regular` through `models/_device.py`.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray
from pydantic import model_validator

from ._base import InterpolatorBase, RegularGridMixin, arrtype_for, prod_dims
from .serialization import Array


class NearestRegular(RegularGridMixin, InterpolatorBase):
    """Nearest-neighbor interpolation on a regular grid in up to 6 dimensions.

    Construction expects flat (1D, contiguous) arrays sharing one float
    dtype, np.float64 or np.float32; the validator rejects anything else.
    """

    dims: list[int]
    starts: Array
    steps: Array
    vals: Array

    @classmethod
    def new(
        cls, dims: list[int], starts: NDArray, steps: NDArray, vals: NDArray
    ) -> "NearestRegular":
        """Build a model from plain numpy inputs: arrays are flattened to
        contiguous storage and converted to the dtype of `vals` before
        validation."""
        arrtype = arrtype_for(np.asarray(vals))
        return cls(
            dims=dims,
            starts=arrtype(data=np.asarray(starts).flatten()),
            steps=arrtype(data=np.asarray(steps).flatten()),
            vals=arrtype(data=np.asarray(vals).flatten()),
        )

    @model_validator(mode="after")
    def _validate_model(self):
        ndims = self.ndims()
        assert ndims <= 6 and ndims >= 1, (
            "Number of dimensions must be at least 1 and no more than 6"
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
            [
                x.data.dtype == self.vals.data.dtype
                for x in [self.starts, self.steps, self.vals]
            ]
        ), "All grid inputs must be of the same data type (np.float32 or np.float64)"
        assert all(
            [x.data.data.contiguous for x in [self.starts, self.steps, self.vals]]
        ), "Grid data must be contiguous"
        return self

    def ndims(self) -> int:
        return len(self.dims)

    def _device_spec(self) -> dict:
        return dict(method="nearest", **self._grid_spec())
