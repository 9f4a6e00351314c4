"""Implementation selection between the Hopper kernels and the gather tree.

Counterpart of `interpn_tpu/ops/dispatch.py` and of the engine choice in
`interpn_tpu/ops/bspline.py::bspline_eval`. The JAX package picks among
five engines from static trace information; here the device decides: a CUDA
tensor goes to a kernel (`ops/fused.py`, f32 and f64, any batch size), a
CPU tensor to the gather tree (`ops/linear.py`, `ops/cubic.py`,
`ops/nearest.py`, `ops/bspline.py`). The stacked-table routes are in
`ops/stack.py`. The kernels read only the stencil, so the TPU's
finite-table guard, batch floor and grid-size caps have no counterpart.

f64 runs on the native `double` kernels (K1, K2, K4) unless the
environment variable INTERPN_TPU_F64, read at each call as the JAX package
reads it, forces one of its two f64 contraction engines:

* `df64`: linear and cubic on both grid kinds and the f64 B-splines go to
  K8, the double-float engine (`ops/df64.py`, `csrc/fused_df64.cu`);
* `i8`: linear and cubic on both grid kinds go to K9, the int8 multipass
  engine (`ops/i8.py`, `csrc/fused_i8.cu`); f64 B-splines go to K8, as the
  JAX package's spline route knows only df64.

A forced engine takes f64 CUDA tables of 2-8D with finite entries; nearest,
stacks, f32, 1-D, CPU tensors and tables with a NaN or inf keep their
routes (the JAX package sends a non-finite table to its gather tree; here
the native kernel reads only the stencil). Unset, `auto` or any other value
changes nothing: the port makes no automatic choice of these engines, and
the JAX package's auto-mode gates (`_prefer_i8`, the cost model, the spike
and depth gates) have no counterpart yet.

Every evaluator takes the JAX package's keyword-only `vals_finite` and
ignores it: there it tells the engine choice whether the table is finite
(the TPU kernels contract the whole table, so one inf would spoil every
result); the kernels here read only each query's stencil, and the forced
f64 engines check the table themselves.

The kernels have no backward kernel (nor had the TPU kernels), so each
kernel route is a `KernelRoute`: the kernel forward, the vector-Jacobian
product of the gather tree backward, as the JAX package's `_with_gather_jvp`
takes tangents from the gather tree. For nearest that gives zero gradients
to the queries and one-hot gradients to `vals`.
"""

from __future__ import annotations

import os

import torch

from . import df64 as _df64
from . import fused as _fused
from . import i8 as _i8
from .bspline import bspline_gather as _bspline_gather
from .cubic import cubic_rectilinear as _cubic_rect_gather
from .cubic import cubic_regular as _cubic_reg_gather
from .linear import linear_rectilinear as _linear_rect_gather
from .linear import linear_regular as _linear_reg_gather
from .nearest import nearest_rectilinear as _nearest_rect_gather
from .nearest import nearest_regular as _nearest_reg_gather

F64_ENV = "INTERPN_TPU_F64"


class KernelRoute(torch.autograd.Function):
    """Forward: kernel(*tensors). Backward: the vector-Jacobian product of
    gather(*tensors), the kernel's plain version, at the same inputs."""

    @staticmethod
    def forward(ctx, kernel, gather, *tensors):
        ctx.gather = gather
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        _, vjp_fn = torch.func.vjp(ctx.gather, *ctx.saved_tensors)
        return (None, None, *vjp_fn(grad_out))


def _impl(vals: torch.Tensor) -> str:
    """'kernel' for a CUDA tensor, 'gather' otherwise."""
    return "kernel" if vals.device.type == "cuda" else "gather"


def f64_engine() -> str:
    """The engine INTERPN_TPU_F64 forces, read now: 'df64', 'i8', or 'auto'
    (unset, 'auto' or any other value: the native kernels)."""
    mode = os.environ.get(F64_ENV, "auto")
    return mode if mode in ("df64", "i8") else "auto"


def f64_route(vals, dims, method):
    """(engine, keywords of its wrapper): ('df64', {}) or ('i8', {'prep':
    the table's `i8.prepare`}) where INTERPN_TPU_F64 forces that engine on
    this call, else (None, {}). `method` is 'linear', 'cubic' or a spline
    degree (3, 5). The table's finiteness is cached with its split
    (`df64.table_split`, which K8's cached taps are made from) or its
    decomposition."""
    engine = f64_engine()
    if engine == "auto" or _impl(vals) != "kernel" or vals.dtype != torch.float64:
        return None, {}
    if engine == "i8" and _i8.supported(dims, method):
        prep = _i8.prepare(dims, vals)
        return ("i8", {"prep": prep}) if prep is not None else (None, {})
    if _df64.supported(dims, method) and _df64.table_split(vals)[2]:
        return "df64", {}
    return None, {}


def _route(kernel, gather, params, vals, obs, lead=()):
    """gather(*params, vals, *obs) on the CPU; on a CUDA tensor the kernel
    on flat contiguous queries, reshaped to (*lead, *obs[0].shape): `lead`
    is (nch,) for a stack of tables."""
    if _impl(vals) == "gather":
        return gather(*params, vals, *obs)
    shape = obs[0].shape
    tensors = [t.contiguous() for t in params] + [vals.contiguous()]
    tensors += [o.reshape(-1).contiguous() for o in obs]
    return KernelRoute.apply(kernel, gather, *tensors).reshape(*lead, *shape)


def _regular(method, dims, starts, steps, vals, obs, gather, *lin):
    dims = tuple(int(d) for d in dims)
    engine, kw = f64_route(vals, dims, method)
    if engine is None:
        def kernel(st, sp, v, *ob):
            return _fused.eval_regular(dims, st, sp, v, ob, method, *lin)
    else:
        module = _df64 if engine == "df64" else _i8

        def kernel(st, sp, v, *ob):
            return module.eval_regular(dims, st, sp, v, ob, method, *lin, **kw)
    return _route(kernel, lambda st, sp, v, *ob: gather(dims, st, sp, v, ob, *lin),
                  (starts, steps), vals, obs)


def linear_regular(dims, starts, steps, vals, obs, *, vals_finite=None):
    """Multilinear eval on a regular grid; obs is a tuple of ndims tensors of
    one shape, and the result has that shape."""
    return _regular("linear", dims, starts, steps, vals, obs, _linear_reg_gather)


def cubic_regular(dims, starts, steps, vals, obs, linearize_extrapolation: bool, *,
                  vals_finite=None):
    """Multicubic eval on a regular grid (every dim >= 4)."""
    return _regular("cubic", dims, starts, steps, vals, obs, _cubic_reg_gather,
                    bool(linearize_extrapolation))


def nearest_regular(dims, starts, steps, vals, obs, *, vals_finite=None):
    """Nearest-neighbor eval on a regular grid."""
    return _regular("nearest", dims, starts, steps, vals, obs, _nearest_reg_gather)


def _rect_route(method, gather, grids, vals, obs, *extra):
    ng = len(grids)
    dims = tuple(int(g.shape[0]) for g in grids)
    engine, kw = f64_route(vals, dims, method)
    if engine is None:
        def kernel(*a):
            return _fused.eval_rectilinear(a[:ng], a[ng], a[ng + 1 :], method, *extra)
    else:
        module = _df64 if engine == "df64" else _i8

        def kernel(*a):
            return module.eval_rectilinear(a[:ng], a[ng], a[ng + 1 :], method, *extra, **kw)
    return _route(kernel, lambda *a: gather(a[:ng], a[ng], a[ng + 1 :], *extra),
                  tuple(grids), vals, obs)


def linear_rectilinear(grids, vals, obs, *, vals_finite=None):
    """Multilinear eval on a rectilinear grid; grids is a tuple of sorted
    1-D tensors, one per dim."""
    return _rect_route("linear", _linear_rect_gather, grids, vals, obs)


def cubic_rectilinear(grids, vals, obs, linearize_extrapolation: bool, *, vals_finite=None):
    """Multicubic eval on a rectilinear grid (every axis >= 4 entries)."""
    return _rect_route(
        "cubic", _cubic_rect_gather, grids, vals, obs, bool(linearize_extrapolation)
    )


def nearest_rectilinear(grids, vals, obs, *, vals_finite=None):
    """Nearest-neighbor eval on a rectilinear grid."""
    return _rect_route("nearest", _nearest_rect_gather, grids, vals, obs)


def bspline_eval(knots, coeffs, obs, k: int, *, vals_finite=None):
    """Tensor-product B-spline of degree k (3: cubic_spline, 5: quintic) at
    `obs`, shaped like obs[0]. `knots` and `coeffs` come from
    `ops.bspline.prep_bspline` (carried into tensors by
    `convert.bspline_from_numpy`); out-of-bounds queries extrapolate the end
    span's polynomial."""
    ng = len(knots)
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    engine, _ = f64_route(coeffs, dims, k)
    if engine is None:
        def kernel(*a):
            return _fused.eval_bspline(a[:ng], a[ng], a[ng + 1 :], k)
    else:
        def kernel(*a):
            return _df64.eval_bspline(a[:ng], a[ng], a[ng + 1 :], k)
    return _route(
        kernel,
        lambda *a: _bspline_gather(a[:ng], a[ng], a[ng + 1 :], k),
        tuple(knots), coeffs, obs,
    )
