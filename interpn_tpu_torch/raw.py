"""Flat entry points of `interpn_tpu.raw`, ported so far: multilinear
evaluation and bounds checks on regular grids.

Names, signatures, argument order, error types (AssertionError for the
reference's validation, TypeError for a dtype mismatch) and error strings are
those of `interpn_tpu.raw`. The other twelve reference functions
(rectilinear, nearest, cubic) are not ported yet; ROADMAP.md lists them.

Inputs are numpy arrays or tensors. Numpy inputs go to
`torch.get_default_device()`; tensors are computed where they live, and all
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
    "check_bounds_regular_f64",
    "check_bounds_regular_f32",
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


def _raise_unrep(bad):
    if bool(bad):
        raise AssertionError("Unrepresentable coordinate value")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _device(*arrays) -> torch.device:
    """The one device of the tensors among `arrays`, or the default device
    when all are numpy."""
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


def _interpn_linear_regular(dtype, dims, starts, steps, vals, obs, out):
    _check_eval_dtypes(
        dtype, out, obs, [("starts", starts), ("steps", steps), ("vals", vals)]
    )
    dims = _as_dims(dims)
    _require(1 <= len(dims), "Dimension mismatch")
    _require(len(dims) <= 8, _MAX_DIMS_MSG)
    _validate_regular(
        dims, starts, steps, vals, obs, out,
        min_size=2, size_msg="All grids must have at least two entries",
    )
    device = _device(starts, steps, vals, *obs, out)
    starts_t, steps_t, vals_t = _prep(device, starts, steps, vals)
    obs_t = _prep(device, *obs)
    result = ops.linear_regular(dims, starts_t, steps_t, vals_t, obs_t)
    _raise_unrep(_unrep_flag(starts_t, steps_t, obs_t))
    return _finish(result, out)


def interpn_linear_regular_f64(dims, starts, steps, vals, obs, out):
    return _interpn_linear_regular(torch.float64, dims, starts, steps, vals, obs, out)


def interpn_linear_regular_f32(dims, starts, steps, vals, obs, out):
    return _interpn_linear_regular(torch.float32, dims, starts, steps, vals, obs, out)


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
