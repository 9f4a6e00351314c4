"""Implementation selection between the Hopper kernels and the gather tree.

Counterpart of `interpn_tpu/ops/dispatch.py` and of the engine choice in
`interpn_tpu/ops/bspline.py::bspline_eval`. The JAX package picks among
five engines from static trace information; here the device decides: a CUDA
tensor goes to the kernel (`ops/fused.py`, f32 and f64, any batch size), a
CPU tensor to the gather tree (`ops/linear.py`, `ops/cubic.py`,
`ops/nearest.py`, `ops/bspline.py`). The stacked-table routes are in
`ops/stack.py`. The kernels read only the stencil, so the TPU's
finite-table guard, batch floor and grid-size caps have no counterpart.

The kernels have no backward kernel (nor had the TPU kernels), so each
kernel route is a `KernelRoute`: the kernel forward, the vector-Jacobian
product of the gather tree backward, as the JAX package's `_with_gather_jvp`
takes tangents from the gather tree. For nearest that gives zero gradients
to the queries and one-hot gradients to `vals`.
"""

from __future__ import annotations

import torch

from . import fused as _fused
from .bspline import bspline_gather as _bspline_gather
from .cubic import cubic_rectilinear as _cubic_rect_gather
from .cubic import cubic_regular as _cubic_reg_gather
from .linear import linear_rectilinear as _linear_rect_gather
from .linear import linear_regular as _linear_reg_gather
from .nearest import nearest_rectilinear as _nearest_rect_gather
from .nearest import nearest_regular as _nearest_reg_gather


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


def linear_regular(dims, starts, steps, vals, obs):
    """Multilinear eval on a regular grid; obs is a tuple of ndims tensors of
    one shape, and the result has that shape."""
    dims = tuple(int(d) for d in dims)
    return _route(
        lambda st, sp, v, *ob: _fused.eval_regular(dims, st, sp, v, ob, "linear"),
        lambda st, sp, v, *ob: _linear_reg_gather(dims, st, sp, v, ob),
        (starts, steps), vals, obs,
    )


def cubic_regular(dims, starts, steps, vals, obs, linearize_extrapolation: bool):
    """Multicubic eval on a regular grid (every dim >= 4)."""
    dims = tuple(int(d) for d in dims)
    lin = bool(linearize_extrapolation)
    return _route(
        lambda st, sp, v, *ob: _fused.eval_regular(dims, st, sp, v, ob, "cubic", lin),
        lambda st, sp, v, *ob: _cubic_reg_gather(dims, st, sp, v, ob, lin),
        (starts, steps), vals, obs,
    )


def nearest_regular(dims, starts, steps, vals, obs):
    """Nearest-neighbor eval on a regular grid."""
    dims = tuple(int(d) for d in dims)
    return _route(
        lambda st, sp, v, *ob: _fused.eval_regular(dims, st, sp, v, ob, "nearest"),
        lambda st, sp, v, *ob: _nearest_reg_gather(dims, st, sp, v, ob),
        (starts, steps), vals, obs,
    )


def _rect_route(method, gather, grids, vals, obs, *extra):
    ng = len(grids)
    return _route(
        lambda *a: _fused.eval_rectilinear(a[:ng], a[ng], a[ng + 1 :], method, *extra),
        lambda *a: gather(a[:ng], a[ng], a[ng + 1 :], *extra),
        tuple(grids), vals, obs,
    )


def linear_rectilinear(grids, vals, obs):
    """Multilinear eval on a rectilinear grid; grids is a tuple of sorted
    1-D tensors, one per dim."""
    return _rect_route("linear", _linear_rect_gather, grids, vals, obs)


def cubic_rectilinear(grids, vals, obs, linearize_extrapolation: bool):
    """Multicubic eval on a rectilinear grid (every axis >= 4 entries)."""
    return _rect_route(
        "cubic", _cubic_rect_gather, grids, vals, obs, bool(linearize_extrapolation)
    )


def nearest_rectilinear(grids, vals, obs):
    """Nearest-neighbor eval on a rectilinear grid."""
    return _rect_route("nearest", _nearest_rect_gather, grids, vals, obs)


def bspline_eval(knots, coeffs, obs, k: int):
    """Tensor-product B-spline of degree k (3: cubic_spline, 5: quintic) at
    `obs`, shaped like obs[0]. `knots` and `coeffs` come from
    `ops.bspline.prep_bspline` (carried into tensors by
    `convert.bspline_from_numpy`); out-of-bounds queries extrapolate the end
    span's polynomial."""
    ng = len(knots)
    return _route(
        lambda *a: _fused.eval_bspline(a[:ng], a[ng], a[ng + 1 :], k),
        lambda *a: _bspline_gather(a[:ng], a[ng], a[ng + 1 :], k),
        tuple(knots), coeffs, obs,
    )
