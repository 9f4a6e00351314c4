"""Flat entry points of `interpn_tpu.raw`: the reference's 16 functions,
linear, cubic and nearest evaluation and bounds checks on regular and
rectilinear grids, f32 and f64.

Names, signatures, argument order, error types (AssertionError for the
reference's validation, TypeError for a dtype mismatch) and error strings are
those of `interpn_tpu.raw`. The regular-grid evaluators raise the
reference's "Unrepresentable coordinate value" for NaN, inf and far-out
queries; the rectilinear ones bisect instead and never raise it.

Inputs are numpy arrays or tensors. Numpy inputs go to
`config.default_device()`: the CUDA device unless the caller asked for
another (`config.set_device`); tensors are computed where they live, and all
tensors of one call must share a device. `out` is mandatory, as in the
reference, and is written in place whether it is a numpy array or a tensor;
the function also returns it.

Numpy inputs with a C-contiguous numpy `out` take the native CPU engine
(`native`, as `interpn_tpu/raw.py::_host_small` does) where
`native.use_native` admits the batch: the CPU is the device in force, or
INTERPN_TPU_NATIVE_THRESHOLD asks for it. What the engine does not serve
(more axes than it takes, ragged bounds queries) goes to the plain path on
the device in force.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import native, ops
from ._entry import call_device, copy_into, dtype_name, write_checked
from .ops import unrep
from .ops.df64 import host_tensor
from .utils import tracing

__all__ = [
    "interpn_linear_regular_f64",
    "interpn_linear_regular_f32",
    "interpn_linear_rectilinear_f64",
    "interpn_linear_rectilinear_f32",
    "interpn_nearest_regular_f64",
    "interpn_nearest_regular_f32",
    "interpn_nearest_rectilinear_f64",
    "interpn_nearest_rectilinear_f32",
    "interpn_cubic_regular_f64",
    "interpn_cubic_regular_f32",
    "interpn_cubic_rectilinear_f64",
    "interpn_cubic_rectilinear_f32",
    "check_bounds_regular_f64",
    "check_bounds_regular_f32",
    "check_bounds_rectilinear_f64",
    "check_bounds_rectilinear_f32",
]

_MAX_DIMS_MSG = (
    "Dimension exceeds maximum (8)."
    " Use interpolator struct directly for higher dimensions."
)

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

# ---------------------------------------------------------------------------
# host-side validation (reference error strings)
# ---------------------------------------------------------------------------


def _require(cond, msg):
    """An AssertionError that survives python -O, as the reference's."""
    if not cond:
        raise AssertionError(msg)


def _host(a) -> np.ndarray:
    return tracing.host_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _as_dims(dims) -> tuple[int, ...]:
    return tuple(int(d) for d in _host(dims).ravel())


def _require_dtype(want: str, pairs):
    """Refuse non-arrays and mismatched dtypes outright, as the reference's
    monomorphized signatures do, rather than cast."""
    for name, a in pairs:
        dt = getattr(a, "dtype", None)
        if dt is None:
            raise TypeError(
                f"argument '{name}': expected a {want} array,"
                f" got {type(a).__name__}"
            )
        if dtype_name(dt) != want:
            raise TypeError(
                f"argument '{name}': expected a {want} array,"
                f" got {dtype_name(dt)}"
            )


def _check_eval_dtypes(dtype, out, obs, arrays):
    pairs = list(arrays)
    pairs += [("obs", o) for o in obs]
    pairs.append(("out", out))
    _require_dtype(dtype_name(dtype), pairs)


def _check_bounds_dtypes(dtype, out, obs, arrays):
    pairs = list(arrays)
    pairs += [("obs", o) for o in obs]
    _require_dtype(dtype_name(dtype), pairs)
    _require_dtype("bool", [("out", out)])


def _size(x) -> int:
    """Element count without a device-to-host copy."""
    if isinstance(x, torch.Tensor):
        return x.numel()
    return int(x.size) if hasattr(x, "size") else len(x)


def _validate_regular(dims, starts, steps, vals, obs, out, *, min_size, size_msg):
    ndims = len(dims)
    _require(
        len(starts) == ndims and len(steps) == ndims and len(obs) == ndims,
        "Dimension mismatch",
    )
    _require(_size(vals) == math.prod(dims), "Dimension mismatch")
    _require(all(d >= min_size for d in dims), size_msg)
    _require(
        bool(np.all(_host(steps) > 0)), "All grids must be monotonically increasing"
    )
    n = _size(out)
    _require(all(_size(x) == n for x in obs), "Dimension mismatch")


def _validate_rectilinear(grids, vals, obs, out, *, min_size, size_msg):
    ndims = len(grids)
    _require(len(obs) == ndims, "Dimension mismatch")
    dims = tuple(_size(g) for g in grids)
    _require(_size(vals) == math.prod(dims), "Dimension mismatch")
    _require(all(d >= min_size for d in dims), size_msg)
    for g in grids:
        g0, g1 = _host(g[:2])  # first two entries only, as in the reference
        _require(g1 > g0, "All grids must be monotonically increasing")
    n = _size(out)
    _require(all(_size(x) == n for x in obs), "Dimension mismatch")


def _host_native(out, n, *data) -> bool:
    """Whether this call of n queries takes the native engine: numpy data,
    a writable C-contiguous numpy `out`, and `native.use_native` admits the
    batch."""
    return (
        isinstance(out, np.ndarray)
        and out.flags.c_contiguous
        and out.flags.writeable
        and not any(isinstance(a, torch.Tensor) for a in data)
        and native.use_native(n)
    )


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _prep(device, *arrays) -> tuple[torch.Tensor, ...]:
    """Flat contiguous tensors on `device` (dtypes were checked already)."""
    return tuple(
        a.reshape(-1).contiguous()
        if isinstance(a, torch.Tensor)
        else torch.as_tensor(np.ascontiguousarray(np.asarray(a).ravel()), device=device)
        for a in arrays
    )


def _prep_table(device, vals) -> torch.Tensor:
    """`vals` as `_prep` makes it; one from numpy carries the array, so that
    the f64 engines' per-table caches key it by content
    (`ops/df64.py::host_tensor`)."""
    if isinstance(vals, torch.Tensor):
        return vals.reshape(-1).contiguous()
    return host_tensor(np.ascontiguousarray(np.asarray(vals).ravel()), device=device)


# ---------------------------------------------------------------------------
# public shims
# ---------------------------------------------------------------------------

_SIZE_MSG = {
    # (regular, rectilinear) message for grids shorter than the stencil
    2: ("All grids must have at least two entries", "All grids must have at least 2 entries"),
    4: ("All grids must have at least four entries", "All grids must have at least 4 entries"),
}


def _require_ndims(ndims: int, method: str):
    _require(1 <= ndims, "Dimension mismatch")
    if method == "nearest":
        _require(ndims <= 6, "Dimension exceeds maximum (6).")
    else:
        _require(ndims <= 8, _MAX_DIMS_MSG)


@tracing.traced(tracing.ENTRY)
def _interpn_regular(method, dtype, dims, starts, steps, vals, obs, out, lin=True):
    _check_eval_dtypes(
        dtype, out, obs, [("starts", starts), ("steps", steps), ("vals", vals)]
    )
    dims = _as_dims(dims)
    _require_ndims(len(dims), method)
    min_size = 4 if method == "cubic" else 2
    _validate_regular(
        dims, starts, steps, vals, obs, out,
        min_size=min_size, size_msg=_SIZE_MSG[min_size][0],
    )
    if _host_native(out, _size(out), starts, steps, vals, *obs) and (
        native.cubic_regular(dims, starts, steps, vals, bool(lin), obs, out)
        if method == "cubic"
        else getattr(native, f"{method}_regular")(dims, starts, steps, vals, obs, out)
    ):
        return out
    device = call_device(starts, steps, vals, *obs, out)
    starts_t, steps_t = _prep(device, starts, steps)
    vals_t = _prep_table(device, vals)
    obs_t = _prep(device, *obs)
    if method == "cubic":
        result = ops.cubic_regular(dims, starts_t, steps_t, vals_t, obs_t, bool(lin))
    else:
        fn = ops.linear_regular if method == "linear" else ops.nearest_regular
        result = fn(dims, starts_t, steps_t, vals_t, obs_t)
    return write_checked(result, unrep.flag(starts_t, steps_t, obs_t), out)


@tracing.traced(tracing.ENTRY)
def _interpn_rectilinear(method, dtype, grids, vals, obs, out, lin=True):
    _check_eval_dtypes(dtype, out, obs, [("grids", g) for g in grids] + [("vals", vals)])
    _require_ndims(len(grids), method)
    min_size = 4 if method == "cubic" else 2
    _validate_rectilinear(
        grids, vals, obs, out, min_size=min_size, size_msg=_SIZE_MSG[min_size][1]
    )
    if _host_native(out, _size(out), *grids, vals, *obs) and (
        native.cubic_rectilinear(grids, vals, bool(lin), obs, out)
        if method == "cubic"
        else getattr(native, f"{method}_rectilinear")(grids, vals, obs, out)
    ):
        return out
    device = call_device(*grids, vals, *obs, out)
    grids_t = _prep(device, *grids)
    vals_t = _prep_table(device, vals)
    obs_t = _prep(device, *obs)
    if method == "cubic":
        result = ops.cubic_rectilinear(grids_t, vals_t, obs_t, bool(lin))
    else:
        fn = ops.linear_rectilinear if method == "linear" else ops.nearest_rectilinear
        result = fn(grids_t, vals_t, obs_t)
    return copy_into(result, out)


def interpn_linear_regular_f64(dims, starts, steps, vals, obs, out):
    return _interpn_regular("linear", torch.float64, dims, starts, steps, vals, obs, out)


def interpn_linear_regular_f32(dims, starts, steps, vals, obs, out):
    return _interpn_regular("linear", torch.float32, dims, starts, steps, vals, obs, out)


def interpn_linear_rectilinear_f64(grids, vals, obs, out):
    return _interpn_rectilinear("linear", torch.float64, grids, vals, obs, out)


def interpn_linear_rectilinear_f32(grids, vals, obs, out):
    return _interpn_rectilinear("linear", torch.float32, grids, vals, obs, out)


def interpn_nearest_regular_f64(dims, starts, steps, vals, obs, out):
    return _interpn_regular("nearest", torch.float64, dims, starts, steps, vals, obs, out)


def interpn_nearest_regular_f32(dims, starts, steps, vals, obs, out):
    return _interpn_regular("nearest", torch.float32, dims, starts, steps, vals, obs, out)


def interpn_nearest_rectilinear_f64(grids, vals, obs, out):
    return _interpn_rectilinear("nearest", torch.float64, grids, vals, obs, out)


def interpn_nearest_rectilinear_f32(grids, vals, obs, out):
    return _interpn_rectilinear("nearest", torch.float32, grids, vals, obs, out)


def interpn_cubic_regular_f64(dims, starts, steps, vals, linearize_extrapolation, obs, out):
    return _interpn_regular(
        "cubic", torch.float64, dims, starts, steps, vals, obs, out, linearize_extrapolation
    )


def interpn_cubic_regular_f32(dims, starts, steps, vals, linearize_extrapolation, obs, out):
    return _interpn_regular(
        "cubic", torch.float32, dims, starts, steps, vals, obs, out, linearize_extrapolation
    )


def interpn_cubic_rectilinear_f64(grids, vals, linearize_extrapolation, obs, out):
    return _interpn_rectilinear(
        "cubic", torch.float64, grids, vals, obs, out, linearize_extrapolation
    )


def interpn_cubic_rectilinear_f32(grids, vals, linearize_extrapolation, obs, out):
    return _interpn_rectilinear(
        "cubic", torch.float32, grids, vals, obs, out, linearize_extrapolation
    )


def _check_bounds_regular(dtype, dims, starts, steps, obs, atol, out):
    _check_bounds_dtypes(dtype, out, obs, [("starts", starts), ("steps", steps)])
    dims = _as_dims(dims)
    ndims = len(dims)
    _require(len(obs) == ndims and _size(out) == ndims, "Dimension mismatch")
    if obs and _host_native(out, _size(obs[0]), starts, steps, *obs) and (
        native.check_bounds_regular(dims, starts, steps, obs, atol, out, _NP_DTYPE[dtype])
    ):
        return out
    device = call_device(starts, steps, *obs, out)
    starts_t, steps_t = _prep(device, starts, steps)
    obs_t = _prep(device, *obs)
    return copy_into(ops.check_bounds_regular(dims, starts_t, steps_t, obs_t, atol), out)


def check_bounds_regular_f64(dims, starts, steps, obs, atol, out):
    return _check_bounds_regular(torch.float64, dims, starts, steps, obs, atol, out)


def check_bounds_regular_f32(dims, starts, steps, obs, atol, out):
    return _check_bounds_regular(torch.float32, dims, starts, steps, obs, atol, out)


def _check_bounds_rectilinear(dtype, grids, obs, atol, out):
    _check_bounds_dtypes(dtype, out, obs, [("grids", g) for g in grids])
    ndims = len(grids)
    _require(len(obs) == ndims and _size(out) == ndims, "Dimension mismatch")
    _require(all(_size(g) > 0 for g in grids), "Dimension mismatch")
    if obs and _host_native(out, _size(obs[0]), *grids, *obs) and (
        native.check_bounds_rectilinear(grids, obs, atol, out, _NP_DTYPE[dtype])
    ):
        return out
    device = call_device(*grids, *obs, out)
    grids_t = _prep(device, *grids)
    obs_t = _prep(device, *obs)
    return copy_into(ops.check_bounds_rectilinear(grids_t, obs_t, atol), out)


def check_bounds_rectilinear_f64(grids, obs, atol, out):
    return _check_bounds_rectilinear(torch.float64, grids, obs, atol, out)


def check_bounds_rectilinear_f32(grids, obs, atol, out):
    return _check_bounds_rectilinear(torch.float32, grids, obs, atol, out)
