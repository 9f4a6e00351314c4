"""Batched interpolation on tensors.

The evaluation functions dispatch between the Hopper kernels (`ops.fused`)
and the gather tree (`ops.linear`, `ops.cubic`, `ops.nearest`); both stay
importable from their submodules. `raw` wraps these with the
reference-compatible flat API.
"""

from .bounds import check_bounds_rectilinear, check_bounds_regular
from .dispatch import (
    cubic_rectilinear,
    cubic_regular,
    linear_rectilinear,
    linear_regular,
    nearest_rectilinear,
    nearest_regular,
)

__all__ = [
    "check_bounds_rectilinear",
    "check_bounds_regular",
    "cubic_rectilinear",
    "cubic_regular",
    "linear_rectilinear",
    "linear_regular",
    "nearest_rectilinear",
    "nearest_regular",
]
