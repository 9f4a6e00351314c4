"""The device side of the persistent interpolator classes, without pydantic.

`DeviceInterpolator` is built from plain numpy arrays (a regular grid's
dims, starts and steps, or a rectilinear grid's axes, and the flat C-order
table) and one method: "linear", "cubic" or "nearest" (the six reference
classes), "pchip", "cubic_spline" or "quintic" (the two spline classes). It
holds what `interpn_tpu/models/_base.py::InterpolatorBase` does at
evaluation:

* the grid and table on each device, put there once at the first
  evaluation on that device (`tensors`); the B-spline coefficients are
  solved on the host in float64 through the content-keyed prep cache and
  cast to the model's dtype, as `interpn()` does;
* `eval` / `eval_unchecked` with the reference's contract: a numpy array or
  tensor `out` written in place, "Dimension mismatch" for mismatched sizes,
  TypeError for arrays of another dtype (lists and scalars are accepted),
  the grid-size floor checked at evaluation, and on regular grids the
  reference's "Unrepresentable coordinate value" exactly where `raw` raises
  it;
* `eval_torch`, which takes tensors or arrays and returns a tensor on their
  device with no host sync and never raises on NaN or inf coordinates;
* `gradient_torch`, each query's partial derivatives by reverse mode: every
  output depends on its own query alone, so the gradient of the sum is the
  per-query derivative, one backward pass for every axis;
* `warmup(n)` and `check_bounds`;
* `core(device)`: the evaluation on one device as an `nn.Module`
  (`DeviceCore`, the grid and table its buffers), which `aot.export_eval`
  exports.

Each evaluation calls the port's `ops` function of the method with the
cached tensors, so a class's result is bitwise that call's, and `raw`'s.
Numpy inputs compute on `config.default_device()`, tensors where they live;
`eval` from numpy into a numpy `out` takes the native CPU engine where
`native.use_native` admits the batch (the CPU device in force, or
INTERPN_TPU_NATIVE_THRESHOLD), through a `native.prepare_*` closure that
freezes the grid and is made once (`_prepare_native`, as
`interpn_tpu/models/_base.py` caches `_native`; the spline methods have
none), so that its result is bitwise `raw`'s on the engine. The pydantic
classes of `models/` hold one of these and add the fields, validation and
JSON; a copy of a class drops it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _entry, convert, native, ops, raw
from ..config import default_device
from ..ops import bspline as _bspline
from ..ops import unrep
from ..utils import tracing

SPLINE_DEGREE = {"cubic_spline": 3, "quintic": 5}
REFERENCE_METHODS = ("linear", "cubic", "nearest")
METHODS = (*REFERENCE_METHODS, "pchip", *SPLINE_DEGREE)
_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _size(x) -> int:
    """Element count of a tensor, array, list or scalar (a scalar counts 1)."""
    if isinstance(x, torch.Tensor):
        return x.numel()
    return int(x.size) if hasattr(x, "size") else int(np.size(x))


def evaluate(method: str, dims, linearize: bool, grid, obs_t):
    """`method` at the flat query tensors `obs_t` on the cached tensors
    `grid` (`DeviceInterpolator.tensors`): the `ops` call of the method;
    `dims` is a regular grid's dims, None for a rectilinear grid. No check
    and no host sync."""
    if method in SPLINE_DEGREE:
        return ops.bspline_eval(*grid, obs_t, SPLINE_DEGREE[method])
    kind = "rectilinear" if dims is None else "regular"
    lead = () if dims is None else (dims,)
    lin = (linearize,) if method == "cubic" else ()
    return getattr(ops, f"{method}_{kind}")(*lead, *grid, obs_t, *lin)


class DeviceCore(torch.nn.Module):
    """obs -> result of one interpolator on its tensors on one device, as
    `torch.export` takes it: the counterpart of the JAX classes'
    `_eval_device_full` in `interpn_tpu/aot.py`. The grid and table are
    the module's buffers (the interpolator's cached tensors, not copies);
    `forward(*obs)` takes ndims flat tensors of the model's dtype on that
    device and runs `evaluate`: no unrepresentable-coordinate flag, no
    host sync, so NaN and inf coordinates give NaN or extrapolate, as
    `eval_torch` does."""

    def __init__(self, interp: "DeviceInterpolator", device: torch.device):
        super().__init__()
        self.method = interp.method
        self.dims = interp.grid_dims
        self.linearize = interp.linearize
        grid = interp.tensors(device)
        # regular: (starts, steps, vals); rectilinear: (grids, vals); spline: (knots, coeffs)
        self.nested = isinstance(grid[0], tuple)
        flat = [*grid[0], grid[1]] if self.nested else list(grid)
        for i, t in enumerate(flat):
            self.register_buffer(f"t{i}", t)
        self.count = len(flat)

    def forward(self, *obs):
        flat = [getattr(self, f"t{i}") for i in range(self.count)]
        grid = (tuple(flat[:-1]), flat[-1]) if self.nested else tuple(flat)
        return evaluate(self.method, self.dims, self.linearize, grid, obs)


class DeviceInterpolator:
    """One interpolator's evaluation on the device; see the module
    docstring. Give `dims`, `starts` and `steps` for a regular grid, or
    `grids` for a rectilinear one."""

    def __init__(self, method: str, vals, *, dims=None, starts=None, steps=None, grids=None,
                 linearize_extrapolation: bool = True, min_grid: int = 2,
                 min_grid_msg: str = "All grids must have at least two entries"):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        self.method = method
        self.regular = dims is not None
        self.vals = np.ascontiguousarray(np.asarray(vals).ravel())
        self.dtype = self.vals.dtype
        if self.regular:
            self.dims = tuple(int(d) for d in dims)
            self.starts = np.ascontiguousarray(np.asarray(starts).ravel())
            self.steps = np.ascontiguousarray(np.asarray(steps).ravel())
        else:
            self.grids = [np.ascontiguousarray(np.asarray(g).ravel()) for g in grids]
            self.dims = tuple(g.size for g in self.grids)
        self.grid_dims = self.dims if self.regular else None  # what `evaluate` takes
        self.linearize = bool(linearize_extrapolation)
        self.grid_ok = all(d >= min_grid for d in self.dims)
        self.min_grid_msg = min_grid_msg
        self._tensors: dict[torch.device, tuple] = {}
        # the native engine's prepared call: None until made, False where
        # the engine does not serve this interpolator
        self._native = None

    def ndims(self) -> int:
        return len(self.dims)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPE[self.dtype]

    # --- the cached tensors ----------------------------------------------------

    def _spline_axes(self) -> list[np.ndarray]:
        """The axes the collocation solves run on, in float64; a regular
        grid's rebuilt from its starts and steps."""
        if not self.regular:
            return [g.astype(np.float64) for g in self.grids]
        s = self.starts.astype(np.float64)
        h = self.steps.astype(np.float64)
        return [s[i] + h[i] * np.arange(d) for i, d in enumerate(self.dims)]

    def tensors(self, device: torch.device) -> tuple:
        """The grid and table on `device`, made at the first call for it:
        (starts, steps, vals) on a regular grid, (grids, vals) on a
        rectilinear one, (knots, coeffs) for a B-spline."""
        device = torch.device(device)
        cached = self._tensors.get(device)
        if cached is not None:
            return cached
        dtype = self.torch_dtype
        if self.method in SPLINE_DEGREE:
            knots, coeffs = _bspline.prep_bspline_cached(
                self._spline_axes(), self.vals.astype(np.float64), SPLINE_DEGREE[self.method])
            cached = convert.bspline_from_numpy(knots, coeffs, device=device, dtype=dtype)
        elif self.regular:
            cached = convert.regular_grid_from_numpy(self.dims, self.starts, self.steps,
                                                     self.vals, device=device, dtype=dtype)[1:]
        else:
            cached = convert.rectilinear_grid_from_numpy(self.grids, self.vals, device=device,
                                                         dtype=dtype)
        self._tensors[device] = cached
        return cached

    # --- evaluation ------------------------------------------------------------

    def _prepare_native(self):
        """The engine's prepared call for this grid and method (JAX: each
        class's `_prepare_native`), or None: the spline methods, or more
        axes than the engine takes."""
        if self.method not in REFERENCE_METHODS:
            return None
        dt = self.dtype.type
        lin = (self.linearize,) if self.method == "cubic" else ()
        if self.regular:
            return getattr(native, f"prepare_{self.method}_regular")(
                self.dims, self.starts, self.steps, self.vals, *lin, dt)
        return getattr(native, f"prepare_{self.method}_rectilinear")(
            self.grids, self.vals, *lin, dt)

    def _native_call(self):
        """The prepared call, made at the first need and kept; not kept
        while the engine is off and unbuilt, so that turning it on again
        builds it."""
        if self._native is None:
            prep = self._prepare_native()
            if prep is not None or not native.load_deferred():
                self._native = prep or False
            return prep or False
        return self._native

    def _host_native(self, obs, out) -> bool:
        """Evaluate into `out` on the native engine where it serves this
        call: numpy queries, a C-contiguous numpy `out`, a batch
        `native.use_native` admits. False where the caller's path serves."""
        if type(out) is not np.ndarray or not out.flags.c_contiguous:
            return False
        if any(type(x) is not np.ndarray for x in obs) or not native.use_native(out.size):
            return False
        call = self._native_call()
        return bool(call) and call(obs, out)

    def core(self, device) -> "DeviceCore":
        """The evaluation on `device` as a module (for `aot.export_eval`)."""
        return DeviceCore(self, torch.device(device))

    def _obs_to_device(self, obs, device) -> tuple[torch.Tensor, ...]:
        """Flat contiguous query tensors of the model's dtype on `device`."""
        dtype = self.torch_dtype
        return tuple(
            x.reshape(-1).to(dtype).contiguous() if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x).ravel(), dtype=dtype, device=device)
            for x in obs
        )

    def check_obs_sizes(self, obs, out=None) -> None:
        """ndims observation arrays of one size, and `out` of that size
        ("Dimension mismatch")."""
        if len(obs) != self.ndims():
            raise AssertionError("Dimension mismatch")
        sizes = {_size(x) for x in obs}
        if len(sizes) > 1 or (out is not None and _size(out) not in sizes):
            raise AssertionError("Dimension mismatch")

    def check_grid_sizes(self) -> None:
        """The stencil's floor of points per axis, raised at evaluation."""
        if not self.grid_ok:
            raise AssertionError(self.min_grid_msg)

    def check_eval_dtypes(self, obs, out=None) -> None:
        """TypeError for an array or tensor of another dtype; lists and
        scalars pass and are converted."""
        want = self.dtype.name
        pairs = [("obs", o) for o in obs] + ([("out", out)] if out is not None else [])
        for name, a in pairs:
            dt = getattr(a, "dtype", None)
            if dt is not None and _entry.dtype_name(dt) != want:
                raise TypeError(
                    f"argument '{name}': expected a {want} array, got {_entry.dtype_name(dt)}"
                )

    def _check_float(self) -> None:
        if self.dtype not in (np.float64, np.float32):
            raise TypeError(f"Unexpected data type: {self.dtype}")

    @tracing.traced(tracing.ENTRY)
    def eval_torch(self, obs) -> torch.Tensor:
        """The flat result on the queries' device (numpy queries: the
        default device), with no host sync. NaN and inf coordinates give
        NaN or extrapolate; nothing raises for them."""
        return evaluate(self.method, self.grid_dims, self.linearize, *self._torch_inputs(obs))

    @tracing.traced(tracing.CHECKS)
    def _torch_inputs(self, obs):
        """`eval_torch`'s checks; (the cached tensors, the flat query
        tensors) on the queries' device."""
        self._check_float()
        self.check_grid_sizes()
        self.check_obs_sizes(obs)
        obs_t = self._obs_to_device(obs, _entry.call_device(*obs))
        return self.tensors(obs_t[0].device), obs_t

    def eval(self, obs, out=None):
        """Evaluate at the observation points, into `out` when given (numpy
        or tensor), else into a new numpy array of the model's dtype."""
        if out is not None:
            return self.eval_unchecked(obs, out)
        out = np.zeros(np.shape(obs[0]), dtype=self.dtype)
        self.eval_unchecked(obs, out)
        return out

    @tracing.traced(tracing.ENTRY)
    def eval_unchecked(self, obs, out=None):
        """`eval` with the reference's checks of sizes and dtypes; on a
        regular grid, AssertionError "Unrepresentable coordinate value" for
        a NaN, inf or far-out coordinate of a reference method, raised
        before `out` is written."""
        if self._native and type(out) is np.ndarray and self._host_native(obs, out):
            return out  # a prepared call exists, so the checks below passed once
        out, grid, obs_t = self._out_inputs(obs, out)
        if grid is None:  # the native engine wrote `out`
            return out
        result = evaluate(self.method, self.grid_dims, self.linearize, grid, obs_t)
        if self.regular and self.method in REFERENCE_METHODS:
            return _entry.write_checked(result, unrep.flag(grid[0], grid[1], obs_t), out)
        return _entry.copy_into(result, out)

    @tracing.traced(tracing.CHECKS)
    def _out_inputs(self, obs, out):
        """`eval_unchecked`'s checks; (out, the cached tensors, the flat
        query tensors) on the call's device, or (out, None, None) where the
        native engine has written `out`."""
        self.check_grid_sizes()
        out = out if out is not None else np.zeros(np.shape(obs[0]), dtype=self.dtype)
        self.check_obs_sizes(obs, out)
        self.check_eval_dtypes(obs, out)
        self._check_float()
        if self._host_native(obs, out):
            return out, None, None
        obs_t = self._obs_to_device(obs, _entry.call_device(*obs, out))
        return out, self.tensors(obs_t[0].device), obs_t

    @tracing.traced(tracing.ENTRY)
    def gradient_torch(self, obs) -> tuple[torch.Tensor, ...]:
        """ndims flat tensors, d(interpolant)/d(x_k) at each query, by
        reverse mode through the evaluation (the kernels' backward is their
        gather tree's). Piecewise polynomials: not defined exactly at cell
        boundaries; zero for nearest."""
        self.check_grid_sizes()
        self.check_obs_sizes(obs)
        obs_t = tuple(x.detach().requires_grad_() for x in
                      self._obs_to_device(obs, _entry.call_device(*obs)))
        with torch.enable_grad():
            y = evaluate(self.method, self.grid_dims, self.linearize,
                         self.tensors(obs_t[0].device), obs_t)
        if not y.requires_grad:  # nearest's gather tree: no path from the queries
            return tuple(torch.zeros_like(x) for x in obs_t)
        return torch.autograd.grad(y.sum(), obs_t)

    def warmup(self, n: int) -> None:
        """Put the grid on the default device, build the kernels the model
        launches and launch them once at batch n."""
        device = default_device()
        obs = tuple(torch.zeros(n, dtype=self.torch_dtype, device=device)
                    for _ in range(self.ndims()))
        self.eval_torch(obs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def check_bounds(self, obs, atol):
        """Per-dimension flags: does any query fall outside the grid by more
        than `atol` (the port's `raw.check_bounds_*`)."""
        self._check_float()
        suffix = "f64" if self.dtype == np.float64 else "f32"
        out = np.array([False] * self.ndims())
        obs = [x.reshape(-1) if isinstance(x, torch.Tensor) else np.asarray(x).flatten()
               for x in obs]
        if self.regular:
            fn = getattr(raw, f"check_bounds_regular_{suffix}")
            fn(list(self.dims), self.starts, self.steps, obs, atol, out)
        else:
            fn = getattr(raw, f"check_bounds_rectilinear_{suffix}")
            fn(self.grids, obs, atol, out)
        return out
