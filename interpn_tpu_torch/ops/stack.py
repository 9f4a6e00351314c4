"""Stacked-table (multi-channel) evaluation.

Counterpart of `interpn_tpu/ops/stack.py` and of
`interpn_tpu/ops/bspline.py::bspline_eval_stack`: `nch` value tables (or
B-spline coefficient tables) that share one grid, evaluated at the same
queries into an (nch, *obs[0].shape) block. A CUDA tensor goes to the
source's kernel with the channel count (`ops/fused.py`, K5-K7: one locate
and weight build per query for every table, f32 and f64 alike); a CPU tensor
to the single-table gather tree over each channel. The JAX package's f64
channel loop and `vals_finite` guard answer TPU limits and have no
counterpart. Gradients come from the per-channel gather tree, as in
`ops/dispatch.py`.
"""

from __future__ import annotations

from . import fused as _fused
from .dispatch import _route


def _stack(kernel, plain, params, vals_stack, obs):
    return _route(kernel, plain, params, vals_stack, tuple(obs),
                  lead=(int(vals_stack.shape[0]),))


def _regular_stack(method, dims, starts, steps, vals_stack, obs, lin=True):
    dims = tuple(int(d) for d in dims)
    return _stack(
        lambda st, sp, v, *ob: _fused.eval_regular_stack(dims, st, sp, v, ob, method, lin),
        lambda st, sp, v, *ob: _fused.plain_regular_stack(dims, st, sp, v, ob, method, lin),
        (starts, steps), vals_stack, obs,
    )


def _rectilinear_stack(method, grids, vals_stack, obs, lin=True):
    ng = len(grids)
    return _stack(
        lambda *a: _fused.eval_rectilinear_stack(a[:ng], a[ng], a[ng + 1 :], method, lin),
        lambda *a: _fused.plain_rectilinear_stack(a[:ng], a[ng], a[ng + 1 :], method, lin),
        tuple(grids), vals_stack, obs,
    )


def linear_regular_stack(dims, starts, steps, vals_stack, obs):
    """Multilinear eval of an (nch, prod(dims)) stack on a regular grid."""
    return _regular_stack("linear", dims, starts, steps, vals_stack, obs)


def nearest_regular_stack(dims, starts, steps, vals_stack, obs):
    """Nearest-neighbor eval of a stack on a regular grid."""
    return _regular_stack("nearest", dims, starts, steps, vals_stack, obs)


def cubic_regular_stack(dims, starts, steps, vals_stack, obs,
                        linearize_extrapolation: bool = True):
    """Multicubic eval of a stack on a regular grid (every dim >= 4)."""
    return _regular_stack("cubic", dims, starts, steps, vals_stack, obs,
                          bool(linearize_extrapolation))


def linear_rectilinear_stack(grids, vals_stack, obs):
    """Multilinear eval of a stack on a rectilinear grid."""
    return _rectilinear_stack("linear", grids, vals_stack, obs)


def nearest_rectilinear_stack(grids, vals_stack, obs):
    """Nearest-neighbor eval of a stack on a rectilinear grid."""
    return _rectilinear_stack("nearest", grids, vals_stack, obs)


def cubic_rectilinear_stack(grids, vals_stack, obs, linearize_extrapolation: bool = True):
    """Multicubic eval of a stack on a rectilinear grid (every axis >= 4
    entries)."""
    return _rectilinear_stack("cubic", grids, vals_stack, obs, bool(linearize_extrapolation))


def bspline_eval_stack(knots, coeffs_stack, obs, k: int):
    """An (nch, prod(dims)) stack of B-spline coefficient tables sharing one
    knot set, at `obs`: (nch, *obs[0].shape)."""
    ng = len(knots)
    return _stack(
        lambda *a: _fused.eval_bspline_stack(a[:ng], a[ng], a[ng + 1 :], k),
        lambda *a: _fused.plain_bspline_stack(a[:ng], a[ng], a[ng + 1 :], k),
        tuple(knots), coeffs_stack, obs,
    )
