"""Batched interpolation on tensors.

`linear_regular` dispatches between the Hopper kernel (`ops.fused`) and the
gather tree (`ops.linear`); both stay importable from their submodules.
`raw` wraps these with the reference-compatible flat API.
"""

from .bounds import check_bounds_regular
from .dispatch import linear_regular

__all__ = ["check_bounds_regular", "linear_regular"]
