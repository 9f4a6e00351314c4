"""Batched interpolation on tensors.

The evaluation functions dispatch between the Hopper kernels (`ops.fused`)
and the gather trees (`ops.linear`, `ops.cubic`, `ops.nearest`,
`ops.bspline`); both stay importable from their submodules. `raw` wraps the
single-table ones with the reference-compatible flat API; `interpn_stack`
wraps the stacked ones (`ops.stack`). B-spline tables come from
`ops.bspline.prep_bspline`.
"""

from .bounds import check_bounds_rectilinear, check_bounds_regular
from .dispatch import (
    bspline_eval,
    cubic_rectilinear,
    cubic_regular,
    linear_rectilinear,
    linear_regular,
    nearest_rectilinear,
    nearest_regular,
)
from .stack import (
    bspline_eval_stack,
    cubic_rectilinear_stack,
    cubic_regular_stack,
    linear_rectilinear_stack,
    linear_regular_stack,
    nearest_rectilinear_stack,
    nearest_regular_stack,
)

__all__ = [
    "bspline_eval",
    "bspline_eval_stack",
    "check_bounds_rectilinear",
    "check_bounds_regular",
    "cubic_rectilinear",
    "cubic_rectilinear_stack",
    "cubic_regular",
    "cubic_regular_stack",
    "linear_rectilinear",
    "linear_rectilinear_stack",
    "linear_regular",
    "linear_regular_stack",
    "nearest_rectilinear",
    "nearest_rectilinear_stack",
    "nearest_regular",
    "nearest_regular_stack",
]
