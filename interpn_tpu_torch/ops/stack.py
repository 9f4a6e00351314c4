"""Stacked-table (multi-channel) evaluation.

Counterpart of `interpn_tpu/ops/stack.py` and of
`interpn_tpu/ops/bspline.py::bspline_eval_stack`: `nch` value tables (or
B-spline coefficient tables) that share one grid, evaluated at the same
queries into an (nch, *obs[0].shape) block. A CUDA tensor goes to the
source's kernel with the channel count (`ops/fused.py`, K5-K7: one locate
and weight build per query for every table, f32 and f64 alike); a CPU tensor
to the single-table gather tree over each channel (`fused.plain_*_stack`;
for rectilinear grids `fused.gather_rectilinear_stack`, since the plain
version of rectilinear cubic contracts weights). The JAX package's f64
channel loop and `vals_finite` guard answer TPU limits and have no
counterpart: `vals_finite` is accepted and ignored. Each stack op runs the
stack route of `ops/dispatch.py::kernel_route`, so gradients come from the
per-channel gather tree and `torch.func` composes as it does there; under
INTERPN_TPU_IMPL=gather or =factorized a stack takes that gather tree on
the card too (`dispatch._impl`), as the JAX package's stacks do.
"""

from __future__ import annotations

from ..utils import tracing
from .dispatch import _route, kernel_route


@tracing.traced(tracing.ENTRY)
def _regular_stack(method, dims, starts, steps, vals_stack, obs, *lin):
    dims = tuple(int(d) for d in dims)
    route = kernel_route("regular", method, dims, *lin).stack
    return _route(route, (starts, steps), vals_stack, tuple(obs))


@tracing.traced(tracing.ENTRY)
def _rectilinear_stack(method, grids, vals_stack, obs, *lin):
    grids = tuple(grids)
    route = kernel_route("rectilinear", method, len(grids), *lin).stack
    return _route(route, grids, vals_stack, tuple(obs))


def linear_regular_stack(dims, starts, steps, vals_stack, obs, *, vals_finite=None):
    """Multilinear eval of an (nch, prod(dims)) stack on a regular grid."""
    return _regular_stack("linear", dims, starts, steps, vals_stack, obs)


def nearest_regular_stack(dims, starts, steps, vals_stack, obs, *, vals_finite=None):
    """Nearest-neighbor eval of a stack on a regular grid."""
    return _regular_stack("nearest", dims, starts, steps, vals_stack, obs)


def cubic_regular_stack(dims, starts, steps, vals_stack, obs,
                        linearize_extrapolation: bool = True, *, vals_finite=None):
    """Multicubic eval of a stack on a regular grid (every dim >= 4)."""
    return _regular_stack("cubic", dims, starts, steps, vals_stack, obs,
                          bool(linearize_extrapolation))


def linear_rectilinear_stack(grids, vals_stack, obs, *, vals_finite=None):
    """Multilinear eval of a stack on a rectilinear grid."""
    return _rectilinear_stack("linear", grids, vals_stack, obs)


def nearest_rectilinear_stack(grids, vals_stack, obs, *, vals_finite=None):
    """Nearest-neighbor eval of a stack on a rectilinear grid."""
    return _rectilinear_stack("nearest", grids, vals_stack, obs)


def cubic_rectilinear_stack(grids, vals_stack, obs, linearize_extrapolation: bool = True, *,
                            vals_finite=None):
    """Multicubic eval of a stack on a rectilinear grid (every axis >= 4
    entries)."""
    return _rectilinear_stack("cubic", grids, vals_stack, obs, bool(linearize_extrapolation))


@tracing.traced(tracing.ENTRY)
def bspline_eval_stack(knots, coeffs_stack, obs, k: int, *, vals_finite=None):
    """An (nch, prod(dims)) stack of B-spline coefficient tables sharing one
    knot set, at `obs`: (nch, *obs[0].shape)."""
    knots = tuple(knots)
    route = kernel_route("bspline", int(k), len(knots)).stack
    return _route(route, knots, coeffs_stack, tuple(obs))
