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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import ops
from .config import default_device

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

_TWO63 = 9223372036854775808.0  # 2^63, exactly representable in f32 and f64


def _unrep_flag(starts, steps, obs) -> torch.Tensor:
    """True when a query's cell index does not fit an isize: the reference's
    "Unrepresentable coordinate value" error for NaN, inf and far-out
    coordinates."""
    bad = torch.zeros((), dtype=torch.bool, device=starts.device)
    for k, x in enumerate(obs):
        floc = torch.floor((x - starts[k]) / steps[k])
        ok = (floc >= -_TWO63) & (floc < _TWO63)  # False for NaN too
        bad = bad | (~ok).any()
    return bad


# ---------------------------------------------------------------------------
# host-side validation (reference error strings)
# ---------------------------------------------------------------------------


def _require(cond, msg):
    """An AssertionError that survives python -O, as the reference's."""
    if not cond:
        raise AssertionError(msg)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _as_dims(dims) -> tuple[int, ...]:
    return tuple(int(d) for d in _host(dims).ravel())


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


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
        if _dtype_name(dt) != want:
            raise TypeError(
                f"argument '{name}': expected a {want} array,"
                f" got {_dtype_name(dt)}"
            )


def _check_eval_dtypes(dtype, out, obs, arrays):
    pairs = list(arrays)
    pairs += [("obs", o) for o in obs]
    pairs.append(("out", out))
    _require_dtype(_dtype_name(dtype), pairs)


def _check_bounds_dtypes(dtype, out, obs, arrays):
    pairs = list(arrays)
    pairs += [("obs", o) for o in obs]
    _require_dtype(_dtype_name(dtype), pairs)
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


def _raise_unrep(bad):
    if bool(bad):
        raise AssertionError("Unrepresentable coordinate value")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _device(*arrays) -> torch.device:
    """The one device of the tensors among `arrays`, or
    `config.default_device()` when all are numpy."""
    devices = {a.device for a in arrays if isinstance(a, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(
            f"tensors of one call must share a device, got {sorted(map(str, devices))}"
        )
    return devices.pop() if devices else default_device()


def _prep(device, *arrays) -> tuple[torch.Tensor, ...]:
    """Flat contiguous tensors on `device` (dtypes were checked already)."""
    return tuple(
        a.reshape(-1).contiguous()
        if isinstance(a, torch.Tensor)
        else torch.as_tensor(np.ascontiguousarray(np.asarray(a).ravel()), device=device)
        for a in arrays
    )


def _finish(result, out):
    """Write `result` into `out` in place and return `out`."""
    if isinstance(out, torch.Tensor):
        out.copy_(result.reshape(out.shape))
    else:
        np.copyto(out, result.detach().cpu().numpy().reshape(out.shape))
    return out


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
    device = _device(starts, steps, vals, *obs, out)
    starts_t, steps_t, vals_t = _prep(device, starts, steps, vals)
    obs_t = _prep(device, *obs)
    if method == "cubic":
        result = ops.cubic_regular(dims, starts_t, steps_t, vals_t, obs_t, bool(lin))
    else:
        fn = ops.linear_regular if method == "linear" else ops.nearest_regular
        result = fn(dims, starts_t, steps_t, vals_t, obs_t)
    _raise_unrep(_unrep_flag(starts_t, steps_t, obs_t))
    return _finish(result, out)


def _interpn_rectilinear(method, dtype, grids, vals, obs, out, lin=True):
    _check_eval_dtypes(dtype, out, obs, [("grids", g) for g in grids] + [("vals", vals)])
    _require_ndims(len(grids), method)
    min_size = 4 if method == "cubic" else 2
    _validate_rectilinear(
        grids, vals, obs, out, min_size=min_size, size_msg=_SIZE_MSG[min_size][1]
    )
    device = _device(*grids, vals, *obs, out)
    grids_t = _prep(device, *grids)
    (vals_t,) = _prep(device, vals)
    obs_t = _prep(device, *obs)
    if method == "cubic":
        result = ops.cubic_rectilinear(grids_t, vals_t, obs_t, bool(lin))
    else:
        fn = ops.linear_rectilinear if method == "linear" else ops.nearest_rectilinear
        result = fn(grids_t, vals_t, obs_t)
    return _finish(result, out)


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
    device = _device(starts, steps, *obs, out)
    starts_t, steps_t = _prep(device, starts, steps)
    obs_t = _prep(device, *obs)
    return _finish(ops.check_bounds_regular(dims, starts_t, steps_t, obs_t, atol), out)


def check_bounds_regular_f64(dims, starts, steps, obs, atol, out):
    return _check_bounds_regular(torch.float64, dims, starts, steps, obs, atol, out)


def check_bounds_regular_f32(dims, starts, steps, obs, atol, out):
    return _check_bounds_regular(torch.float32, dims, starts, steps, obs, atol, out)


def _check_bounds_rectilinear(dtype, grids, obs, atol, out):
    _check_bounds_dtypes(dtype, out, obs, [("grids", g) for g in grids])
    ndims = len(grids)
    _require(len(obs) == ndims and _size(out) == ndims, "Dimension mismatch")
    _require(all(_size(g) > 0 for g in grids), "Dimension mismatch")
    device = _device(*grids, *obs, out)
    grids_t = _prep(device, *grids)
    obs_t = _prep(device, *obs)
    return _finish(ops.check_bounds_rectilinear(grids_t, obs_t, atol), out)


def check_bounds_rectilinear_f64(grids, obs, atol, out):
    return _check_bounds_rectilinear(torch.float64, grids, obs, atol, out)


def check_bounds_rectilinear_f32(grids, obs, atol, out):
    return _check_bounds_rectilinear(torch.float32, grids, obs, atol, out)
