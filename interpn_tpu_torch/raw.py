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

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build, native, ops
from .config import default_device
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

_TWO63 = 9223372036854775808.0  # 2^63, exactly representable in f32 and f64
_VOIDP = ctypes.c_void_p


# Launches of the flag's kernel (`csrc/unrep_flag.cu`), one a flag on a CUDA
# tensor with queries; a run reads it to show that the flag went through the
# kernel. Kept apart from `ops.fused.launches`, which counts the evaluation
# wrappers' kernels.
flag_launches = 0


def _unrep_flag(starts, steps, obs) -> torch.Tensor:
    """True when a query's cell index does not fit an isize: the reference's
    "Unrepresentable coordinate value" error for NaN, inf and far-out
    coordinates. A 0-d bool tensor on the queries' device, not read to the
    host here. On a CUDA tensor one launch of `csrc/unrep_flag.cu`, which
    reads each query column once (`_unrep_kernel`); on a CPU tensor its
    plain version, `_unrep_passes`. `starts`, `steps` and every obs column
    are 1-D, contiguous, of one float dtype and on one device; the obs
    columns of one length."""
    if tracing.profiler._is_profiler_enabled:
        with tracing.span(tracing.UNREP_FLAG, starts.device):
            return _unrep_on_device(starts, steps, obs)
    return _unrep_on_device(starts, steps, obs)


def _unrep_on_device(starts, steps, obs) -> torch.Tensor:
    n = _check_flag_inputs(starts, steps, obs)
    if starts.device.type == "cuda":
        return _unrep_kernel(starts, steps, obs, n)
    return _unrep_passes(starts, steps, obs)


def _unrep_passes(starts, steps, obs) -> torch.Tensor:
    bad = torch.zeros((), dtype=torch.bool, device=starts.device)
    for k, x in enumerate(obs):
        floc = torch.floor((x - starts[k]) / steps[k])
        ok = (floc >= -_TWO63) & (floc < _TWO63)  # False for NaN too
        bad = bad | (~ok).any()
    return bad


def _check_flag_inputs(starts, steps, obs) -> int:
    """Refuse what the flag's kernel does not take; return the query count."""
    ndims = len(obs)
    if not 1 <= ndims <= 8 or starts.shape != (ndims,) or steps.shape != (ndims,):
        raise ValueError("starts, steps and obs must have one entry per dim, 1-8 dims")
    dtype, device = starts.dtype, starts.device
    if dtype not in _NP_DTYPE:
        raise TypeError(f"the flag takes float32 or float64, got {dtype}")
    n = obs[0].numel()
    for t in (starts, steps, *obs):
        if t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs starts {dtype}")
        if t.device != device:
            raise ValueError(f"device mismatch: {t.device} vs starts {device}")
        if not t.is_contiguous():
            raise ValueError("the flag's inputs must be contiguous")
    if any(x.dim() != 1 or x.numel() != n for x in obs):
        raise ValueError("obs must be 1-D tensors of one length")
    return n


@functools.cache
def _flag_entry():
    """`interpn_unrep_flag` of `csrc/unrep_flag.cu`, built first if needed:
    is_f64, ndims, starts, steps, obs, n, flag, stream."""
    fn = _build.load("unrep_flag").interpn_unrep_flag
    fn.argtypes = [ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP, ctypes.POINTER(_VOIDP),
                   ctypes.c_longlong, _VOIDP, _VOIDP]
    fn.restype = ctypes.c_int
    return fn


def _flag_info(dtype) -> dict:
    """Registers a thread, static shared bytes, local (spill) bytes a thread
    and resident blocks an SM of the flag's kernel for `dtype`, on the
    current CUDA device (`interpn_unrep_flag_info`)."""
    fn = _build.load("unrep_flag").interpn_unrep_flag_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    got = (ctypes.c_int * 4)()
    rc = fn(int(dtype == torch.float64), got)
    if rc != 0:
        raise RuntimeError(f"unrep_flag info failed: CUDA error {rc}")
    return dict(zip(("registers", "static_smem", "local_bytes", "blocks_per_sm"), got))


def _unrep_kernel(starts, steps, obs, n) -> torch.Tensor:
    """The flag of `n` queries on CUDA tensors: zeroed, then one launch of
    the kernel on the current stream, which sets it where a query is
    unrepresentable; none for n == 0. Counts the launch."""
    global flag_launches
    device = starts.device
    flag = torch.zeros((), dtype=torch.bool, device=device)
    if n == 0:
        return flag
    with torch.cuda.device(device):
        rc = _flag_entry()(
            int(starts.dtype == torch.float64), len(obs), starts.data_ptr(), steps.data_ptr(),
            (_VOIDP * len(obs))(*(x.data_ptr() for x in obs)), n, flag.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"unrep_flag launch failed: CUDA error {rc}")
    flag_launches += 1
    return flag


# ---------------------------------------------------------------------------
# host-side validation (reference error strings)
# ---------------------------------------------------------------------------


def _require(cond, msg):
    """An AssertionError that survives python -O, as the reference's."""
    if not cond:
        raise AssertionError(msg)


def _host(a) -> np.ndarray:
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if tracing.profiler._is_profiler_enabled:
        return tracing.call(tracing.SYNC, _to_numpy, a)
    return _to_numpy(a)


def _to_numpy(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def _as_dims(dims) -> tuple[int, ...]:
    return tuple(int(d) for d in _host(dims).ravel())


@functools.cache
def _dtype_name(dt) -> str:
    """The dtype's name ("float32"); cached, as numpy's `.name` costs
    microseconds on the native engine's small-batch path."""
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


def _raise_unrep(bad):
    if tracing.profiler._is_profiler_enabled:
        bad = tracing.call(tracing.SYNC, bool, bad)
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


def _prep_table(device, vals) -> torch.Tensor:
    """`vals` as `_prep` makes it; one from numpy carries the array, so that
    the f64 engines' per-table caches key it by content
    (`ops/df64.py::host_tensor`)."""
    if isinstance(vals, torch.Tensor):
        return vals.reshape(-1).contiguous()
    return host_tensor(np.ascontiguousarray(np.asarray(vals).ravel()), device=device)


def _finish(result, out):
    """Write `result` into `out` in place and return `out`."""
    if tracing.profiler._is_profiler_enabled:
        return tracing.call(tracing.FINISH, _copy_into, result, out)
    return _copy_into(result, out)


def _copy_into(result, out):
    if isinstance(out, torch.Tensor):
        out.copy_(result.reshape(out.shape))
    else:
        np.copyto(out, _host(result).reshape(out.shape))
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
    if tracing.profiler._is_profiler_enabled:
        return tracing.call(tracing.ENTRY, _regular_call, method, dtype, dims, starts, steps,
                            vals, obs, out, lin)
    return _regular_call(method, dtype, dims, starts, steps, vals, obs, out, lin)


def _regular_call(method, dtype, dims, starts, steps, vals, obs, out, lin):
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
    device = _device(starts, steps, vals, *obs, out)
    starts_t, steps_t = _prep(device, starts, steps)
    vals_t = _prep_table(device, vals)
    obs_t = _prep(device, *obs)
    if method == "cubic":
        result = ops.cubic_regular(dims, starts_t, steps_t, vals_t, obs_t, bool(lin))
    else:
        fn = ops.linear_regular if method == "linear" else ops.nearest_regular
        result = fn(dims, starts_t, steps_t, vals_t, obs_t)
    _raise_unrep(_unrep_flag(starts_t, steps_t, obs_t))
    return _finish(result, out)


def _interpn_rectilinear(method, dtype, grids, vals, obs, out, lin=True):
    if tracing.profiler._is_profiler_enabled:
        return tracing.call(tracing.ENTRY, _rectilinear_call, method, dtype, grids, vals, obs,
                            out, lin)
    return _rectilinear_call(method, dtype, grids, vals, obs, out, lin)


def _rectilinear_call(method, dtype, grids, vals, obs, out, lin):
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
    device = _device(*grids, vals, *obs, out)
    grids_t = _prep(device, *grids)
    vals_t = _prep_table(device, vals)
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
    if obs and _host_native(out, _size(obs[0]), starts, steps, *obs) and (
        native.check_bounds_regular(dims, starts, steps, obs, atol, out, _NP_DTYPE[dtype])
    ):
        return out
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
    if obs and _host_native(out, _size(obs[0]), *grids, *obs) and (
        native.check_bounds_rectilinear(grids, obs, atol, out, _NP_DTYPE[dtype])
    ):
        return out
    device = _device(*grids, *obs, out)
    grids_t = _prep(device, *grids)
    obs_t = _prep(device, *obs)
    return _finish(ops.check_bounds_rectilinear(grids_t, obs_t, atol), out)


def check_bounds_rectilinear_f64(grids, obs, atol, out):
    return _check_bounds_rectilinear(torch.float64, grids, obs, atol, out)


def check_bounds_rectilinear_f32(grids, obs, atol, out):
    return _check_bounds_rectilinear(torch.float32, grids, obs, atol, out)
