"""Serializable numpy-array wrappers for the interpolator models.

The port's own copy of `interpn_tpu/models/serialization.py`, with the same
wire format, so that a model's JSON is byte for byte the JAX package's and
the reference's:

* ``data`` is serialized as a JSON *string* holding the list of values
  (float64 text for both dtypes: f32 is stored as float64 text).
* The ``dtype`` literal field discriminates the union.

Arrays are held as host numpy (contiguous); the model classes place them on
a device at their first evaluation.
"""

from __future__ import annotations

import json
from typing import Annotated, Any, Literal

import numpy as np
import torch
from numpy.typing import NDArray
from pydantic import BaseModel, ConfigDict, Field, field_serializer, field_validator


def _coerce(data: Any, np_dtype) -> np.ndarray:
    """Accept a JSON string, ndarray, tensor (on any device), list, or any
    array-like and return a contiguous numpy array of the requested dtype."""
    if isinstance(data, str):
        return np.ascontiguousarray(np.array(json.loads(data), dtype=np_dtype))
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.astype(np_dtype))
    if isinstance(data, list):
        return np.array(data, dtype=np_dtype)
    if hasattr(data, "__array__"):
        return np.ascontiguousarray(np.asarray(data).astype(np_dtype))
    raise TypeError


class ArrayF64(BaseModel):
    """Serializable wrapper for NDArray[float64]."""

    data: NDArray[np.float64]
    dtype: Literal["float64"] = "float64"

    model_config = ConfigDict(frozen=True, extra="forbid", arbitrary_types_allowed=True)

    @field_validator("data", mode="before")
    def _validate_data(data: Any) -> NDArray[np.float64]:
        return _coerce(data, np.float64)

    @field_serializer("data", return_type=str)
    def _serialize_data(data: Any) -> str:
        return json.dumps(data.tolist())


class ArrayF32(BaseModel):
    """Serializable wrapper for NDArray[float32]; stored as float64 text."""

    data: NDArray[np.float32]
    dtype: Literal["float32"] = "float32"

    model_config = ConfigDict(frozen=True, extra="forbid", arbitrary_types_allowed=True)

    @field_validator("data", mode="before")
    def _validate_data(data: Any) -> NDArray[np.float32]:
        return _coerce(data, np.float32)

    @field_serializer("data", return_type=str)
    def _serialize_data(data: Any) -> str:
        return json.dumps(data.tolist())


Array = Annotated[ArrayF32 | ArrayF64, Field(discriminator="dtype")]
