"""Persistent, serializable interpolator models (pydantic).

Counterpart of `interpn_tpu.models`: one class per reference wrapper plus
the two spline classes, with the JAX package's JSON bytes. Their evaluation
is `models/_device.py::DeviceInterpolator`, which needs no pydantic: where
pydantic is not installed, this package exports nothing and `_device` still
imports.
"""

from importlib.util import find_spec as _find_spec

__all__: list[str] = []

if _find_spec("pydantic") is not None:
    from .multicubic_rectilinear import MulticubicRectilinear
    from .multicubic_regular import MulticubicRegular
    from .multilinear_rectilinear import MultilinearRectilinear
    from .multilinear_regular import MultilinearRegular
    from .nearest_rectilinear import NearestRectilinear
    from .nearest_regular import NearestRegular
    from .serialization import Array, ArrayF32, ArrayF64
    from .spline import TensorSplineRectilinear, TensorSplineRegular

    __all__ = [
        "Array",
        "ArrayF32",
        "ArrayF64",
        "MulticubicRectilinear",
        "MulticubicRegular",
        "MultilinearRectilinear",
        "MultilinearRegular",
        "NearestRectilinear",
        "NearestRegular",
        "TensorSplineRectilinear",
        "TensorSplineRegular",
    ]
