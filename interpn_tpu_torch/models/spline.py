"""Persistent model classes of the spline methods.

Counterpart of `interpn_tpu/models/spline.py`: `TensorSplineRegular` and
`TensorSplineRectilinear`, one model per grid kind with a ``method`` field
(``pchip``, ``cubic_spline`` or ``quintic``), in the Array wire format.

* ``cubic_spline`` / ``quintic``: the per-axis collocation solves run once,
  at the first evaluation, on the host in float64 through the content-keyed
  prep cache (a model rebuilt from JSON reuses an earlier solve of the same
  table); evaluation runs in the model's dtype through `ops.bspline_eval`
  (the kernel K4 on the card).
* ``pchip`` is nonlinear in the table; it evaluates through `ops.pchip_*`,
  a gather tree on every device.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
from numpy.typing import NDArray
from pydantic import model_validator

from ._base import (
    InterpolatorBase,
    RectilinearGridMixin,
    RegularGridMixin,
    arrtype_for,
    prod_dims,
)
from .serialization import Array

_DEGREE = {"cubic_spline": 3, "quintic": 5}
_WORDS = {4: "four", 6: "six"}


def _min_points(method: str) -> int:
    return 4 if method == "pchip" else _DEGREE[method] + 1


class _SplineBase(InterpolatorBase):
    """What the two spline model classes share.

    Subclasses declare the ``method`` field (after their grid fields, so
    it serializes last — matching the reference convention of trailing
    config fields, cf. ``linearize_extrapolation``)."""

    def _grid_floor(self) -> tuple[int, str]:
        # the floor depends on the `method` field
        n = _min_points(self.method)
        return n, f"All grids must have at least {_WORDS.get(n, n)} entries"

    def _device_spec(self) -> dict:
        return dict(method=self.method, **self._grid_spec())


class TensorSplineRegular(RegularGridMixin, _SplineBase):
    """Spline-family interpolation on a regular grid in up to 8 dimensions.

    ``method`` selects the interpolant:

    * ``"pchip"`` — monotone cubic Hermite (Fritsch-Carlson/Moler slopes),
      scipy ``RegularGridInterpolator(method="pchip")`` semantics incl.
      edge-interval extrapolation; needs >= 4 points per axis.
    * ``"cubic_spline"`` / ``"quintic"`` — global not-a-knot tensor-product
      interpolating splines of degree 3/5 (scipy RGI ``cubic``/``quintic``
      semantics, exact per-axis collocation solves); need >= 4/6 points
      per axis. Out-of-bounds queries evaluate the end span's polynomial.

    Construction expects flat (1D, contiguous) arrays sharing one float
    dtype, np.float64 or np.float32. There is no reference analogue; the
    class follows the reference's persistent-model pattern
    (`src/interpn/multicubic_regular.py:24-234`).
    """

    dims: list[int]
    starts: Array
    steps: Array
    vals: Array
    method: Literal["pchip", "cubic_spline", "quintic"]

    @classmethod
    def new(
        cls,
        dims: list[int],
        starts: NDArray,
        steps: NDArray,
        vals: NDArray,
        method: Literal["pchip", "cubic_spline", "quintic"] = "cubic_spline",
    ) -> "TensorSplineRegular":
        """Build a model from plain numpy inputs: arrays are flattened to
        contiguous storage and converted to the dtype of `vals` before
        validation.

        Args:
            dims: grid point count along each axis
            starts: first grid coordinate along each axis
            steps: spacing between grid points along each axis
            vals: grid-point value table, flattened in C (row-major) order
            method: "pchip", "cubic_spline", or "quintic"
        """
        arrtype = arrtype_for(np.asarray(vals))
        return cls(
            dims=dims,
            starts=arrtype(data=np.asarray(starts).flatten()),
            steps=arrtype(data=np.asarray(steps).flatten()),
            vals=arrtype(data=np.asarray(vals).flatten()),
            method=method,
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



class TensorSplineRectilinear(RectilinearGridMixin, _SplineBase):
    """Spline-family interpolation on a rectilinear grid in up to 8
    dimensions. See :class:`TensorSplineRegular` for the method semantics;
    grids must be strictly monotonically increasing."""

    grids: list[Array]
    vals: Array
    method: Literal["pchip", "cubic_spline", "quintic"]

    @classmethod
    def new(
        cls,
        grids: list[NDArray],
        vals: NDArray,
        method: Literal["pchip", "cubic_spline", "quintic"] = "cubic_spline",
    ) -> "TensorSplineRectilinear":
        """Build a model from per-axis coordinate arrays and a value table.

        Args:
            grids: per-axis coordinate arrays, each strictly increasing.
            vals: grid-point value table, flattened in C (row-major) order
            method: "pchip", "cubic_spline", or "quintic"
        """
        arrtype = arrtype_for(np.asarray(vals))
        return cls(
            grids=[arrtype(data=np.asarray(x)) for x in grids],
            vals=arrtype(data=np.asarray(vals).flatten()),
            method=method,
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
