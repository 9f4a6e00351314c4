"""interpn_tpu_torch: the PyTorch / CUDA port of interpn-tpu.

A second package beside `interpn_tpu` (the JAX reference). It imports torch,
numpy and scipy (for the spline solve), never jax. Ported: linear, cubic and
nearest evaluation on regular and rectilinear grids, the global cubic and
quintic B-splines, pchip, and stacks of tables sharing one grid, f32 and
f64, 1-8D (nearest 1-6D at the flat API), through hand-written CUDA kernels
for Hopper on CUDA tensors and the gather trees on CPU tensors (pchip is a
gather tree on every device).

* `interpn(...)`: the one-shot convenience function
* `interpn_stack(...)`: the same for a stack of tables on one grid
* `interpn_tpu_torch.raw`: the reference's 16 flat functions
* the eight persistent pydantic interpolator classes (where pydantic is
  installed), with the JAX package's JSON bytes
* `interpn_tpu_torch.ops`: the batched functions on tensors
* `interpn_tpu_torch.ops.one_dim`: the 1D interpolants
* `interpn_tpu_torch.functional.TorchInterpolator`: an interpolator that
  `torch.func` transforms take as an argument (grad and jvp into the table
  and the queries, vmap over tables onto the stack kernels)
* `interpn_tpu_torch.compat`: scipy's `RegularGridInterpolator` and
  `interpn`, with scipy's semantics and error strings
* `interpn_tpu_torch.aot`: serving artifacts (`torch.export` programs of a
  model's evaluation, one per batch-size bucket, over the kernels as
  `torch.library` custom ops, `ops/library.py`)
* `interpn_tpu_torch.parallel`: the queries split over a mesh of devices
* `interpn_tpu_torch.config`: where numpy inputs compute (CUDA by default;
  `config.set_device("cpu")` asks for the CPU)
"""

from __future__ import annotations

from importlib.util import find_spec as _find_spec
from typing import Sequence

import numpy as np
import torch
from numpy.typing import NDArray

from . import convert, ops, raw
from ._entry import copy_into as _copy_into
from .config import default_device
from .ops import bspline as _bspline
from .ops import pchip as _pchip
from .ops.df64 import host_tensor
from .utils.tracing import host_numpy as _host_numpy

# The persistent model classes need pydantic; the functional API works
# without it, as in the JAX package.
_PYDANTIC_FOUND = _find_spec("pydantic") is not None

if _PYDANTIC_FOUND:
    from .models import (
        MulticubicRectilinear,
        MulticubicRegular,
        MultilinearRectilinear,
        MultilinearRegular,
        NearestRectilinear,
        NearestRegular,
        TensorSplineRectilinear,
        TensorSplineRegular,
    )

__version__ = "0.4.0"

__all__ = ["__version__", "raw", "interpn", "interpn_stack"]

if _PYDANTIC_FOUND:
    __all__ += [
        "MultilinearRegular",
        "MultilinearRectilinear",
        "MulticubicRegular",
        "MulticubicRectilinear",
        "NearestRegular",
        "NearestRectilinear",
        "TensorSplineRegular",
        "TensorSplineRectilinear",
    ]

_SPLINE_DEGREE = {"cubic_spline": 3, "quintic": 5}
_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def interpn(
    obs: Sequence[NDArray],
    grids: Sequence[NDArray],
    vals: NDArray,
    *,
    method: str = "linear",
    out: NDArray | None = None,
    linearize_extrapolation: bool = True,
    assume_regular: bool = False,
    check_bounds: bool = False,
    bounds_atol: float = 1e-8,
) -> NDArray:
    """Evaluate an N-dimensional grid at the supplied observation points.

    `interpn_tpu.interpn` with numpy inputs and outputs, computed on
    `config.default_device()` (the CUDA device unless the caller asked for
    another). Grid regularity is detected by exact spacing equality;
    `check_bounds` raises ValueError for points outside the grid. Methods
    "linear", "cubic" (with `linearize_extrapolation`) and "nearest" are
    ported on regular and rectilinear grids, and "cubic_spline" / "quintic"
    (global not-a-knot tensor-product splines of degree 3 / 5, >= 4 / 6
    points per axis, coefficients solved on the host in float64 and cached
    by content) and "pchip" (monotone cubic, scipy's semantics, >= 4 points
    per axis).
    """
    user_out = out if out is not None else np.zeros_like(obs[0])
    outshape = user_out.shape
    out = user_out.ravel()
    # ravel() of a non-contiguous array is a copy: compute into it, then
    # fold the result back into the caller's array.
    out_is_view = out.base is not None or out is user_out

    obs = [np.ascontiguousarray(np.asarray(x).ravel()) for x in obs]
    grids = [np.ascontiguousarray(np.asarray(x).ravel()) for x in grids]
    vals = np.ascontiguousarray(np.asarray(vals).ravel())

    dtype = vals.dtype
    if dtype not in [np.float64, np.float32]:
        raise AssertionError("`interpn` defined only for float32 and float64 data")
    is_regular = assume_regular or _check_regular(grids)
    if is_regular:
        dims = np.array([len(grid) for grid in grids], dtype=int)
        starts = np.array([grid[0] for grid in grids], dtype=dtype)
        steps = np.array([grid[1] - grid[0] for grid in grids], dtype=dtype)

    if check_bounds:
        outb = np.zeros((len(grids),), dtype=bool)
        f32 = dtype == np.float32
        if is_regular:
            bounds = raw.check_bounds_regular_f32 if f32 else raw.check_bounds_regular_f64
            bounds(dims, starts, steps, obs, bounds_atol, outb)
        else:
            bounds = raw.check_bounds_rectilinear_f32 if f32 else raw.check_bounds_rectilinear_f64
            bounds(grids, obs, bounds_atol, outb)
        if any(outb):
            raise ValueError("Observation points violate interpolator bounds")

    if method == "pchip":
        if is_regular:
            arrays = [("starts", starts), ("steps", steps), ("vals", vals)]
        else:
            arrays = [(f"grids[{k}]", g) for k, g in enumerate(grids)] + [("vals", vals)]
        raw._check_eval_dtypes(dtype, out, obs, arrays)
        if is_regular:
            dims_t = tuple(int(d) for d in dims)
            raw._validate_regular(
                dims_t, starts, steps, vals, obs, out,
                min_size=4, size_msg="All grids must have at least four entries",
            )
        else:
            raw._validate_rectilinear(
                grids, vals, obs, out,
                min_size=4, size_msg="All grids must have at least 4 entries",
            )
        device, tdtype = default_device(), _TORCH_DTYPE[dtype]
        if is_regular:
            grid = convert.regular_grid_from_numpy(dims_t, starts, steps, vals,
                                                   device=device, dtype=tdtype)
            fn = ops.pchip_regular
        else:
            grid = convert.rectilinear_grid_from_numpy(grids, vals, device=device, dtype=tdtype)
            fn = ops.pchip_rectilinear
        res = fn(*grid, convert.obs_from_numpy(obs, device=device, dtype=tdtype))
        _copy_into(res, out)
    elif method in _SPLINE_DEGREE:
        k = _SPLINE_DEGREE[method]
        arrays = [(f"grids[{i}]", g) for i, g in enumerate(grids)] + [("vals", vals)]
        raw._check_eval_dtypes(dtype, out, obs, arrays)
        raw._validate_rectilinear(
            grids, vals, obs, out,
            min_size=k + 1, size_msg=f"All grids must have at least {k + 1} entries",
        )
        knots, coeffs = _bspline.prep_bspline_cached(grids, vals.astype(np.float64, copy=False), k)
        device, tdtype = default_device(), _TORCH_DTYPE[dtype]
        kt = convert.obs_from_numpy(knots, device=device, dtype=tdtype)
        cf = host_tensor(np.asarray(coeffs), device=device, dtype=tdtype)
        res = ops.bspline_eval(kt, cf, convert.obs_from_numpy(obs, device=device, dtype=tdtype), k)
        _copy_into(res, out)
    elif method not in ("linear", "cubic", "nearest"):
        raise ValueError(
            "Unsupported interpolation configuration:"
            f" {dtype}, {is_regular}, {method}"
        )
    else:
        suffix = "f32" if dtype == np.float32 else "f64"
        kind = "regular" if is_regular else "rectilinear"
        fn = getattr(raw, f"interpn_{method}_{kind}_{suffix}")
        grid = (dims, starts, steps, vals) if is_regular else (grids, vals)
        lin = (linearize_extrapolation,) if method == "cubic" else ()
        fn(*grid, *lin, obs, out)

    if not out_is_view:
        np.copyto(user_out, out.reshape(outshape))
        return user_out
    return out.reshape(outshape)


def interpn_stack(
    obs: Sequence[NDArray],
    grids: Sequence[NDArray],
    vals: NDArray,
    *,
    method: str = "linear",
    linearize_extrapolation: bool = True,
    assume_regular: bool = False,
    check_bounds: bool = False,
    bounds_atol: float = 1e-8,
) -> NDArray:
    """Evaluate a stack of value tables sharing one grid at the same points.

    `interpn_tpu.interpn_stack` with numpy inputs and outputs, computed on
    `config.default_device()`. `vals` carries the channel axis first, shape
    (nch, *grid_shape) or (nch, prod(dims)); the result is a new
    (nch, *obs_shape) array. On the card one kernel launch locates and
    weighs each query once for all channels. Every method of `interpn`; the
    splines solve one coefficient stack on the host, and pchip gathers each
    query's stencil once for all channels. Args other than `vals` match
    `interpn` (no `out=`).
    """
    obs_np = [np.ascontiguousarray(np.asarray(x)) for x in obs]
    outshape = obs_np[0].shape
    obs_np = [x.ravel() for x in obs_np]
    grids = [np.ascontiguousarray(np.asarray(g).ravel()) for g in grids]
    vals = np.ascontiguousarray(np.asarray(vals))
    if vals.ndim < 2:
        raise AssertionError("Dimension mismatch")
    nch = vals.shape[0]
    vals2 = vals.reshape(nch, -1)

    dtype = vals2.dtype
    if dtype not in [np.float64, np.float32]:
        raise AssertionError("`interpn` defined only for float32 and float64 data")
    for x in obs_np + grids:
        if x.dtype != dtype:
            raise TypeError(
                "All arrays must share one float dtype (np.float32 or np.float64)"
            )
    ndims = len(grids)
    if len(obs_np) != ndims:
        raise AssertionError("Dimension mismatch")
    if vals2.shape[1] != int(np.prod([len(g) for g in grids])):
        raise AssertionError("Size of value array does not match grid dims")

    is_regular = assume_regular or _check_regular(grids)
    dims = tuple(len(g) for g in grids)
    if is_regular:
        starts = np.array([g[0] for g in grids], dtype=dtype)
        steps = np.array([g[1] - g[0] for g in grids], dtype=dtype)
    if check_bounds:
        outb = np.zeros((ndims,), dtype=bool)
        f32 = dtype == np.float32
        if is_regular:
            bounds = raw.check_bounds_regular_f32 if f32 else raw.check_bounds_regular_f64
            bounds(np.array(dims), starts, steps, obs_np, bounds_atol, outb)
        else:
            bounds = raw.check_bounds_rectilinear_f32 if f32 else raw.check_bounds_rectilinear_f64
            bounds(grids, obs_np, bounds_atol, outb)
        if any(outb):
            raise ValueError("Observation points violate interpolator bounds")

    device, tdtype = default_device(), _TORCH_DTYPE[dtype]
    obs_t = convert.obs_from_numpy(obs_np, device=device, dtype=tdtype)
    if method == "pchip":
        if any(len(g) < 4 for g in grids):
            raise AssertionError("All grids must have at least 4 entries")
        vals_t = torch.as_tensor(vals2, device=device)
        if is_regular:
            st, sp = convert.obs_from_numpy((starts, steps), device=device, dtype=tdtype)
            out = _pchip.pchip_regular_stack(dims, st, sp, vals_t, obs_t)
        else:
            grids_t = convert.obs_from_numpy(grids, device=device, dtype=tdtype)
            out = _pchip.pchip_rectilinear_stack(grids_t, vals_t, obs_t)
    elif method in _SPLINE_DEGREE:
        k = _SPLINE_DEGREE[method]
        if any(len(g) < k + 1 for g in grids):
            raise AssertionError(f"All grids must have at least {k + 1} entries")
        knots, coeffs = _bspline.prep_bspline_cached(
            grids, np.ascontiguousarray(vals2.T, dtype=np.float64), k
        )
        kt, ct = convert.bspline_from_numpy(
            knots, np.ascontiguousarray(coeffs.T), device=device, dtype=tdtype
        )
        out = ops.bspline_eval_stack(kt, ct, obs_t, k)
    elif method not in ("linear", "cubic", "nearest"):
        raise ValueError(f"Unsupported method: {method}")
    else:
        vals_t = torch.as_tensor(vals2, device=device)
        lin = (bool(linearize_extrapolation),) if method == "cubic" else ()
        if is_regular:
            fn = getattr(ops, f"{method}_regular_stack")
            out = fn(dims, *convert.obs_from_numpy((starts, steps), device=device,
                                                   dtype=tdtype), vals_t, obs_t, *lin)
        else:
            fn = getattr(ops, f"{method}_rectilinear_stack")
            grids_t = convert.obs_from_numpy(grids, device=device, dtype=tdtype)
            out = fn(grids_t, vals_t, obs_t, *lin)
    return _host_numpy(out).reshape((nch,) + outshape)


def _check_regular(grids: Sequence[NDArray]) -> bool:
    """True when every grid is regularly spaced (exact equality of
    spacings, as the reference's `_check_regular`)."""
    is_regular = True
    for grid in grids:
        dgrid = np.diff(grid)
        is_regular = is_regular and bool(np.all(dgrid == dgrid[0]))
    return bool(is_regular)
