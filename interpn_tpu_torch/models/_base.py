"""Shared machinery of the persistent interpolator model classes.

Counterpart of `interpn_tpu/models/_base.py`. Each concrete class is a
frozen pydantic model holding the grid definition, with `.new()`, `.eval()`,
`.eval_unchecked()`, `.check_bounds()` and the JAX package's JSON bytes. The
evaluation lives in a pydantic-free `models/_device.py::DeviceInterpolator`,
made at the first call and kept in the private `_dev` (it holds the grid and
table on the device, and the native engine's prepared call); pickling and
copying drop it. Beyond the reference API, as in the JAX package:

* `.eval_torch(obs)`: tensors or arrays in, a tensor on their device out,
  with no host sync (the JAX package's `eval_jax`);
* `.gradient_torch(obs)`: each query's partial derivatives (its
  `gradient_jax`, by reverse mode here);
* `.warmup(n)`: build the kernels and launch once at batch n.
"""

from __future__ import annotations

from functools import reduce
from typing import Any, ClassVar

import numpy as np
from pydantic import BaseModel, ConfigDict, PrivateAttr

from ._device import DeviceInterpolator
from .serialization import ArrayF32, ArrayF64


def arrtype_for(vals: np.ndarray):
    return ArrayF64 if vals.dtype == np.float64 else ArrayF32


def prod_dims(dims) -> int:
    return reduce(lambda acc, x: acc * x, dims)


class InterpolatorBase(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid", arbitrary_types_allowed=True)

    # Minimum grid points per axis of the method's stencil, with the
    # reference core's message, checked at evaluation (the reference builds
    # such models and errors in its kernel); concrete classes override.
    _MIN_GRID: ClassVar[int] = 2
    _MIN_GRID_MSG: ClassVar[str] = "All grids must have at least two entries"

    # The DeviceInterpolator, made at the first evaluation.
    _dev: Any = PrivateAttr(default=None)

    def __getstate__(self):
        """Models pickle at any time; the device side (tensors on the card)
        is dropped and made again at the first evaluation."""
        state = super().__getstate__()
        priv = dict(state.get("__pydantic_private__") or {})
        priv["_dev"] = None
        state["__pydantic_private__"] = priv
        return state

    def __copy__(self):
        """A copy (`model_copy`, `copy.copy`) makes its own device side and
        native prepared call from its own fields at its first evaluation,
        so that one made with `update=` never evaluates the old grid."""
        copied = super().__copy__()
        copied._dev = None
        return copied

    def __deepcopy__(self, memo=None):
        copied = super().__deepcopy__(memo)
        copied._dev = None
        return copied

    # ---- subclass hooks -------------------------------------------------
    def _device_spec(self) -> dict:  # pragma: no cover - abstract
        """DeviceInterpolator's keywords: method, vals and the grid."""
        raise NotImplementedError

    def _grid_floor(self) -> tuple[int, str]:
        return self._MIN_GRID, self._MIN_GRID_MSG

    def ndims(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    # ---- shared API ------------------------------------------------------
    def _device(self) -> DeviceInterpolator:
        if self._dev is None:
            floor, msg = self._grid_floor()
            self._dev = DeviceInterpolator(**self._device_spec(), min_grid=floor,
                                           min_grid_msg=msg)
        return self._dev

    @property
    def _dtype(self):
        return self.vals.data.dtype  # type: ignore[attr-defined]

    def eval_torch(self, obs):
        """Evaluate on the device and return a flat tensor there, with no
        host sync (not part of the reference API). Never raises on NaN or
        inf coordinates."""
        return self._device().eval_torch(obs)

    def eval(self, obs, out=None):
        """Evaluate at observation points, optionally writing into a
        preallocated numpy array or tensor (reference semantics)."""
        return self._device().eval(obs, out)

    def eval_unchecked(self, obs, out=None):
        """Evaluate with the reference's input checks (the layout was
        validated at construction)."""
        return self._device().eval_unchecked(obs, out)

    def gradient_torch(self, obs):
        """Partial derivatives of the interpolant at each observation point
        (not part of the reference API): a tuple of ndims flat tensors,
        d(interpolant)/d(x_k)."""
        return self._device().gradient_torch(obs)

    def warmup(self, n: int) -> None:
        """Build the kernels and launch once at batch size n before taking
        traffic (not part of the reference API)."""
        self._device().warmup(n)

    def check_bounds(self, obs, atol):
        """Per-dimension bounds-violation flags."""
        return self._device().check_bounds(obs, atol)


class RegularGridMixin:
    """The device spec shared by the regular-grid models (fields: dims,
    starts, steps, vals)."""

    def _grid_spec(self) -> dict:
        return dict(dims=self.dims, starts=self.starts.data, steps=self.steps.data,
                    vals=self.vals.data)


class RectilinearGridMixin:
    """The device spec shared by the rectilinear-grid models (fields:
    grids, vals)."""

    def _grid_spec(self) -> dict:
        return dict(grids=[g.data for g in self.grids], vals=self.vals.data)

    def dims(self) -> list[int]:
        return [x.data.size for x in self.grids]
