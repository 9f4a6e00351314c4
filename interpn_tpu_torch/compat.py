"""scipy.interpolate-compatible adapter.

Counterpart of `interpn_tpu/compat.py`: drop-in equivalents of
`scipy.interpolate.RegularGridInterpolator` and `scipy.interpolate.interpn`
on the port's evaluators, so that scipy users move without rewriting call
sites. Inputs are numpy, computed on `config.default_device()` (the CUDA
device unless the caller asked for another; without one, and without a
request for the CPU, RuntimeError), and results come back as numpy.

scipy's semantics, as the JAX package carries them:

* `points` axes may be strictly ascending or descending; descending axes
  are flipped and `.grid` holds the ascending copy.
* `values` may carry trailing (non-grid) axes; they evaluate as a channel
  stack and come back as trailing axes of the result.
* `xi` is an `(..., ndim)` array, a broadcastable tuple of coordinate
  arrays, or a 1-D array (a column of points on a 1-D grid, one point
  otherwise).
* `bounds_error` / `fill_value` / NaN: the exact `lo <= x <= hi` test; a NaN
  coordinate raises under `bounds_error`, else gives NaN (never
  `fill_value`); `fill_value=None` extrapolates.
* Error messages are scipy's strings.

How each method is served:

* `linear` and `slinear` (a degree-1 tensor spline is the multilinear
  function; scipy's two agree to 1 ulp): the class `MultilinearRectilinear`
  (K2 on the card); `nearest`: `NearestRectilinear` (K3); `hermite` (the
  reference library's local cubic, an extension; `linearize_extrapolation`
  applies to it alone): `MulticubicRectilinear` (K2 cubic).
* `cubic` / `quintic`: the global not-a-knot tensor-product splines; the
  coefficients come from exact per-axis solves on the host in float64
  (`ops.prep_bspline`), evaluated by `ops.bspline_eval` (K4). scipy's RGI
  solves the N-d system iteratively and can miss its own definition by
  ~1e-4 in 3D, so agreement with scipy is bounded by its solver.
* `pchip`: `ops.pchip_rectilinear`, the gather tree (scipy's slopes and
  recursion order).
* Trailing axes: one stack call serves every channel, each row of which
  is the single-channel call's bits: the rectilinear stack ops (K6) for
  linear, nearest and hermite (the JAX package's `interpn_stack` would take
  a regularly spaced grid to the regular stack, whose rows are not the
  classes' bits), `ops.bspline_eval_stack` (K7) for the splines and
  `ops.pchip.pchip_rectilinear_stack` for pchip, where the JAX package
  loops the channels of the last two.

Deliberate deviations: nearest's midpoint ties follow the reference (the
lower node); a NaN coordinate always gives NaN (scipy's own N-d pchip raises
there); complex values are refused.

Computation is float64 by default (scipy's promotion: float32 `values`
still give float64). `dtype=np.float32`, an extension, casts grids, values
and queries to float32 and evaluates on the float32 kernels; the spline
fit still runs in float64 and only its coefficients are cast.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import convert
from .config import default_device

__all__ = ["RegularGridInterpolator", "interpn"]

_METHODS = ("linear", "nearest", "cubic", "slinear", "pchip", "quintic", "hermite")
_SPLINE_DEGREE = {"cubic": 3, "quintic": 5}
_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _resolve_dtype(dtype):
    """None -> float64 (scipy's promotion), else float32 or float64 only."""
    if dtype is None:
        return np.dtype(np.float64)
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(
            "dtype must be None (float64, scipy-compatible), float32, or "
            f"float64; got {dt}"
        )
    return dt


def _as_points(points, values, dtype=np.float64):
    """Validate the grid axes, flip descending ones: (grids, values)."""
    if hasattr(values, "ndim") and np.iscomplexobj(values):
        raise ValueError("complex values are not supported by interpn_tpu_torch.compat")
    values = np.asarray(values, dtype=dtype)
    if isinstance(points, np.ndarray) and points.ndim == 1:
        points = (points,)
    grids = []
    for i, p in enumerate(points):
        p = np.ascontiguousarray(np.asarray(p, dtype=dtype))
        if p.ndim != 1:
            raise ValueError(f"The points in dimension {i} must be 1-dimensional")
        d = np.diff(p)
        if np.all(d > 0):
            pass
        elif np.all(d < 0):
            p = p[::-1].copy()
            values = np.flip(values, axis=i)
        else:
            raise ValueError(
                f"The points in dimension {i} must be strictly ascending or descending"
            )
        grids.append(p)
    if values.ndim < len(grids):
        raise ValueError(
            f"There are {len(grids)} point arrays, but values has {values.ndim} dimensions"
        )
    for i, g in enumerate(grids):
        if values.shape[i] != g.size:
            raise ValueError(
                f"There are {g.size} points and {values.shape[i]} values in dimension {i}"
            )
    return grids, np.ascontiguousarray(values)


def _check_method(method, grids):
    if method not in _METHODS:
        raise ValueError(f"Method '{method}' is not defined")
    min_pts = {"cubic": 4, "slinear": 2, "pchip": 4, "quintic": 6, "hermite": 4}.get(method)
    if min_pts is not None:
        for i, g in enumerate(grids):
            if g.size < min_pts:
                # scipy's message (double space included)
                raise ValueError(
                    f"There are {g.size} points in dimension {i}, but "
                    f"method {method} requires at least  {min_pts} points "
                    "per dimension."
                )


class RegularGridInterpolator:
    """scipy-compatible interpolator over a rectilinear grid.

    Parameters, attributes (`grid`, `values`, `method`, `bounds_error`,
    `fill_value`), call convention and error strings follow
    `scipy.interpolate.RegularGridInterpolator`; evaluation runs on the
    port (the kernels on the card). Extension method `hermite` is the
    reference library's local cubic, and `linearize_extrapolation`
    (default False) switches it to the reference's linearized
    out-of-bounds mode. Extension `dtype` (default None: float64): pass
    `np.float32` to run grids, values, queries and output in float32.
    """

    def __init__(self, points, values, method: str = "linear", bounds_error: bool = True,
                 fill_value=np.nan, *, linearize_extrapolation: bool = False, dtype=None):
        self._dtype = _resolve_dtype(dtype)
        grids, values = _as_points(points, values, self._dtype)
        _check_method(method, grids)
        if linearize_extrapolation and method != "hermite":
            warnings.warn(
                "linearize_extrapolation applies only to method='hermite' "
                "(the reference library's local cubic); it is ignored by "
                f"method='{method}'",
                UserWarning,
                stacklevel=2,
            )
        if fill_value is not None:
            try:
                fill_value = float(fill_value)
            except (TypeError, ValueError):
                raise ValueError(
                    "fill_value must be either 'None' or of a type compatible with values"
                ) from None
        self.grid = tuple(grids)
        self.values = values
        self.method = method
        self.bounds_error = bounds_error
        self.fill_value = fill_value
        self.linearize_extrapolation = linearize_extrapolation
        self._ndim = len(grids)
        self._models: dict[str, object] = {}
        # per degree: (knots, coefficients with a trailing channel axis),
        # solved once per table
        self._splines: dict[int, tuple] = {}
        self._descending_dimensions = ()

    # -- xi ------------------------------------------------------------------------------
    def _prepare_xi(self, xi):
        ndim = self._ndim
        if isinstance(xi, tuple):
            arrs = np.broadcast_arrays(*(np.asarray(a, dtype=self._dtype) for a in xi))
            if len(arrs) != ndim:
                raise ValueError(
                    f"The requested sample points xi have dimension {len(arrs)} but this "
                    f"RegularGridInterpolator has dimension {ndim}"
                )
            xi = np.stack(arrs, axis=-1)
        else:
            xi = np.asarray(xi, dtype=self._dtype)
            if xi.ndim == 1:
                xi = xi.reshape(-1, 1) if ndim == 1 else xi.reshape(1, -1)
        if xi.ndim == 0 or xi.shape[-1] != ndim:
            have = xi.shape[-1] if xi.ndim else 0
            raise ValueError(
                f"The requested sample points xi have dimension {have} but this "
                f"RegularGridInterpolator has dimension {ndim}"
            )
        return np.ascontiguousarray(xi.reshape(-1, ndim)), xi.shape[:-1]

    # -- the evaluators ------------------------------------------------------------------
    def _model(self, method):
        m = self._models.get(method)
        if m is None:
            from .models import MulticubicRectilinear, MultilinearRectilinear, NearestRectilinear

            vals, grids = self.values.reshape(-1), list(self.grid)
            if method == "linear":
                m = MultilinearRectilinear.new(grids, vals)
            elif method == "hermite":
                m = MulticubicRectilinear.new(
                    grids, vals, linearize_extrapolation=self.linearize_extrapolation)
            else:
                m = NearestRectilinear.new(grids, vals)
            self._models[method] = m
        return m

    def _channels(self):
        """The values as (prod(grid shape), nch)."""
        return self.values.reshape(int(np.prod(self.values.shape[:self._ndim])), -1)

    def _spline(self, k):
        """(knots, coefficients (prod(dims), nch)) of degree k, in the
        evaluation dtype; the fit runs in float64."""
        sp = self._splines.get(k)
        if sp is None:
            from .ops import bspline

            knots, coeffs = bspline.prep_bspline(list(self.grid), self._channels(), k)
            if self._dtype == np.float32:
                knots = [np.asarray(t, dtype=np.float32) for t in knots]
                coeffs = np.asarray(coeffs, dtype=np.float32)
            sp = self._splines[k] = (knots, coeffs)
        return sp

    def _tables(self, method, obs):
        """(nch, npts) at `obs`, one call for all the channels: pchip and
        the splines (the single-table op for one channel), and linear,
        nearest and hermite of values with trailing axes (the rectilinear
        stack ops)."""
        from . import ops
        from .ops import pchip

        device, dtype = default_device(), _TORCH_DTYPE[self._dtype]
        obs_t = convert.obs_from_numpy(obs, device=device, dtype=dtype)
        if method in _SPLINE_DEGREE:
            k = _SPLINE_DEGREE[method]
            knots, coeffs = self._spline(k)
            kt, ct = convert.bspline_from_numpy(knots, np.ascontiguousarray(coeffs.T),
                                                device=device, dtype=dtype)
            if ct.shape[0] == 1:
                return ops.bspline_eval(kt, ct[0], obs_t, k)[None]
            return ops.bspline_eval_stack(kt, ct, obs_t, k)
        grids = convert.obs_from_numpy(self.grid, device=device, dtype=dtype)
        vt = torch.as_tensor(np.ascontiguousarray(self._channels().T), device=device)
        if method == "pchip":
            if vt.shape[0] == 1:
                return pchip.pchip_rectilinear(grids, vt[0], obs_t)[None]
            return pchip.pchip_rectilinear_stack(grids, vt, obs_t)
        if method == "hermite":
            return ops.cubic_rectilinear_stack(grids, vt, obs_t, self.linearize_extrapolation)
        return getattr(ops, f"{method}_rectilinear_stack")(grids, vt, obs_t)

    # -- evaluation ----------------------------------------------------------------------
    def __call__(self, xi, method: str | None = None):
        method = self.method if method is None else method
        _check_method(method, self.grid)
        if method == "slinear":  # the same piecewise-linear function
            method = "linear"
        flat, out_shape = self._prepare_xi(xi)
        ndim = self._ndim

        nan_mask = np.zeros(flat.shape[0], dtype=bool)
        oob_mask = np.zeros(flat.shape[0], dtype=bool)
        for i in range(ndim):
            p = flat[:, i]
            lo, hi = self.grid[i][0], self.grid[i][-1]
            nan_mask |= np.isnan(p)
            if self.bounds_error:
                if not np.all(np.logical_and(p >= lo, p <= hi)):
                    raise ValueError(
                        f"One of the requested xi is out of bounds in dimension {i}"
                    )
            else:
                # scipy's rule: NaN is not out of bounds (NaN out, never fill_value)
                oob_mask |= (p < lo) | (p > hi)

        sanitize = nan_mask if self.fill_value is None else (nan_mask | oob_mask)
        if sanitize.any():
            flat = flat.copy()
            for i in range(ndim):
                flat[sanitize, i] = self.grid[i][0]

        obs = [np.ascontiguousarray(flat[:, i]) for i in range(ndim)]
        trailing = self.values.shape[ndim:]
        if method in ("pchip", "cubic", "quintic") or trailing:
            res = self._tables(method, obs).cpu().numpy()
            if self.fill_value is not None and oob_mask.any():
                res[:, oob_mask] = self.fill_value
            if nan_mask.any():
                res[:, nan_mask] = np.nan
            if trailing:
                return res.T.reshape(out_shape + trailing)
            return res[0].reshape(out_shape)

        res = self._model(method).eval(obs)
        if self.fill_value is not None and oob_mask.any():
            res[oob_mask] = self.fill_value
        if nan_mask.any():
            res[nan_mask] = np.nan
        return res.reshape(out_shape)


def interpn(points, values, xi, method: str = "linear", bounds_error: bool = True,
            fill_value=np.nan, *, dtype=None):
    """scipy.interpolate.interpn-compatible one-shot helper. `dtype` is the
    extension of `RegularGridInterpolator`: `np.float32` evaluates in
    float32; None keeps scipy's float64 promotion."""
    rgi = RegularGridInterpolator(points, values, method=method, bounds_error=bounds_error,
                                  fill_value=fill_value, dtype=dtype)
    return rgi(xi)
