"""Implementation selection between the Hopper kernels, the gather tree and
the factorized products.

Counterpart of `interpn_tpu/ops/dispatch.py` and of the engine choice in
`interpn_tpu/ops/bspline.py::bspline_eval`. The JAX package picks among
five engines from static trace information; here the device decides: a CUDA
tensor goes to a kernel (`ops/fused.py`, f32 and f64, any batch size), a
CPU tensor to the gather tree (`ops/linear.py`, `ops/cubic.py`,
`ops/nearest.py`, `ops/bspline.py`). The stacked-table routes are in
`ops/stack.py`. The kernels read only the stencil, so the TPU's
finite-table guard, batch floor and grid-size caps have no counterpart.

INTERPN_TPU_IMPL, read at each call as the JAX package reads it, overrides
the device's choice (`impl_mode`):

* `gather`: every family takes its gather tree, on CUDA tensors too: one
  table, stacks, B-splines;
* `factorized`: one table of linear, cubic or nearest on either grid kind
  takes `ops/factorized.py`'s weight-matrix products (a non-finite table
  entry then poisons every result; see there); stacks and B-splines take
  the gather tree, as in the JAX package (`ops/stack.py`, `ops/bspline.py`);
* `pallas`, `auto`, unset or any other value: the device decides, as above.

A call on the gather tree or the factorized products records plain torch
operations under `torch.export` and no custom op.

f64 runs on the native `double` kernels (K1, K2, K4) unless the
environment variable INTERPN_TPU_F64, read at each call as the JAX package
reads it, forces one of its two f64 contraction engines:

* `df64`: linear and cubic on both grid kinds and the f64 B-splines go to
  K8, the double-float engine (`ops/df64.py`, `csrc/fused_df64.cu`);
* `i8`: linear and cubic on both grid kinds go to K9, the int8 multipass
  engine (`ops/i8.py`, `csrc/fused_i8.cu`); f64 B-splines go to K8, as the
  JAX package's spline route knows only df64.

A forced engine takes f64 CUDA tables of 2-8D with finite entries on
the kernel route (not under INTERPN_TPU_IMPL=gather|factorized); nearest,
stacks, f32, 1-D, CPU tensors and tables with a NaN or inf keep their
routes (the JAX package sends a non-finite table to its gather tree; here
the native kernel reads only the stencil). Unset, `auto` or any other value
changes nothing: `auto` sends f64 to K8 or K9 never, so the JAX package's
auto-mode gates (`_prefer_i8`, the cost model, the spike and depth gates)
have no counterpart. On the H100 the native `double` kernels win every f64
path by whole call, the shapes the JAX package's `auto` sends to its int8
engine included: regular cubic f64 at 1e6 queries, 20^4 native 0.4134 ms,
K8 0.5431, K9 0.9488; 12^5 native 1.3898, K8 1.9731, K9 2.3887
(`scripts/torch_regular_ab.py --engines`, H100 80GB HBM3 at 700 W).

Every evaluator takes the JAX package's keyword-only `vals_finite` and
ignores it: there it tells the engine choice whether the table is finite
(the TPU kernels contract the whole table, so one inf would spoil every
result); the kernels here read only each query's stencil, and the forced
f64 engines check the table themselves.

The kernels have no backward kernel (nor had the TPU kernels), so each
kernel route is a `KernelRoute`: the kernel forward, and the derivatives of
the gather tree (its plain version) at the same inputs, as the JAX
package's `_with_gather_jvp` takes tangents from the gather tree. For
nearest that gives zero gradients to the queries and one-hot gradients to
`vals`. `KernelRoute` composes with `torch.func` (`grad`, `vjp`, `jvp`,
`jacrev`, `jacfwd`, `vmap`); its `vmap` rule keeps every row of a batched
call bit for bit the call on that row's inputs. What a call runs is a
`Route`, built in one place (`kernel_route`). `_impl` reads only the
device, which a `torch.func` wrapper reports as its inner tensor's; the
rest of the route decision (`f64_route`, the layouts, the engines' caches)
is taken inside the kernel callables, which run on plain tensors.

The kernel callables are the `torch.library` custom ops of
`ops/library.py`, one per family and form, so `torch.export` records a
kernel call as one node (`aot.py`). A call asks its op for the engine
INTERPN_TPU_F64 forces when the call is made or traced (`_engine`, which
reads no table data); the op admits it for the table (`f64_route`).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple

import torch

from ..utils import tracing
from . import df64 as _df64
from . import factorized as _fz
from . import fused as _fused
from . import i8 as _i8
from . import library as _library
from .bspline import bspline_gather as _bspline_gather
from .cubic import cubic_rectilinear as _cubic_rect_gather
from .cubic import cubic_regular as _cubic_reg_gather
from .linear import linear_rectilinear as _linear_rect_gather
from .linear import linear_regular as _linear_reg_gather
from .nearest import nearest_rectilinear as _nearest_rect_gather
from .nearest import nearest_regular as _nearest_reg_gather

F64_ENV = "INTERPN_TPU_F64"
IMPL_ENV = "INTERPN_TPU_IMPL"


class Route(NamedTuple):
    """What `KernelRoute` runs: `kernel(*params, vals, *obs)` on flat
    contiguous queries (the kernel wrapper: its plain version on CPU
    tensors), `gather` on the same arguments (the differentiable gather
    tree, which gives the derivatives), `nparams` grid tensors ahead of
    `vals`, and `stacked`: `vals` an (nch, P) stack and the result
    (nch, n). `stack` is the family's stack route that a batch of tables
    goes to (None on a stack route, which takes a batch itself); `f64`
    whether a forced f64 engine may take the route (`f64_route`)."""

    kernel: Callable
    gather: Callable
    nparams: int
    stacked: bool
    stack: "Route | None"
    f64: bool


class KernelRoute(torch.autograd.Function):
    """Forward: route.kernel(*tensors). Backward: the vector-Jacobian
    product of route.gather, the kernel's plain version, at the same
    inputs; forward mode its Jacobian-vector product.

    `torch.func.vmap` calls the `vmap` rule, under which each row of the
    batched result is bit for bit the unbatched call on that row's inputs
    and the gather tree never runs forward:

    * only the table batched (B tables, or B stacks of nch as B * nch
      tables): one launch of the family's stack kernel (K1 -> K5, K2/K3 ->
      K6, K4 -> K7) over the batch as a stack, whose rows are the
      single-table kernel's bits;
    * only the queries batched: one launch over the B * n queries;
    * anything else (a batched grid, the table and the queries batched
      together) and every call under a forced f64 engine
      (INTERPN_TPU_F64=df64|i8, which stacks do not take): one launch per
      batch item, the results stacked. The launches are the price.

    Each of these calls KernelRoute again, so the transforms nest."""

    @staticmethod
    def forward(route, *tensors):
        return route.kernel(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        route, *tensors = inputs
        ctx.route = route
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        _, vjp_fn = torch.func.vjp(ctx.route.gather, *ctx.saved_tensors)
        return (None, *vjp_fn(grad_out))

    @staticmethod
    def jvp(ctx, _route, *tangents):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents))
        return torch.func.jvp(ctx.route.gather, primals, tangents)[1]

    @staticmethod
    def vmap(info, in_dims, route, *tensors):
        dims = in_dims[1:]
        k = route.nparams
        size = info.batch_size
        per_item = (any(d is not None for d in dims[:k])
                    or (route.f64 and f64_engine() != "auto"
                        and tensors[k].dtype == torch.float64))
        if not per_item and all(d is None for d in dims[k + 1:]):
            if dims[k] is None:  # nothing batched at this level
                return KernelRoute.apply(route, *tensors), None
            return _batched_tables(route, tensors, dims[k], size), 0
        if not per_item and dims[k] is None:
            return _batched_queries(route, tensors, dims, size)
        rows = [KernelRoute.apply(route, *(t if d is None else t.select(d, b).contiguous()
                                           for t, d in zip(tensors, dims)))
                for b in range(size)]
        return torch.stack(rows), 0


def _batched_tables(route, tensors, dim, size):
    """The batch of tables (or stacks) at `dim` of the table through the
    stack route: (B, n) or (B, nch, n)."""
    k = route.nparams
    vals = tensors[k].movedim(dim, 0)
    stack = route.stack or route
    flat = vals.reshape(-1, vals.shape[-1]).contiguous()
    out = KernelRoute.apply(stack, *tensors[:k], flat, *tensors[k + 1:])
    return out.reshape(size, *vals.shape[1:-1], out.shape[-1])


def _batched_queries(route, tensors, dims, size):
    """The batch of query sets through one launch over all of them:
    ((B, n), 0), or ((nch, B, n), 1) on a stack route."""
    k = route.nparams
    obs = []
    for o, d in zip(tensors[k + 1:], dims[k + 1:]):
        o = o.unsqueeze(0).expand(size, *o.shape) if d is None else o.movedim(d, 0)
        obs.append(o.reshape(-1).contiguous())
    out = KernelRoute.apply(route, *tensors[:k + 1], *obs)
    return out.reshape(*out.shape[:-1], size, -1), int(route.stacked)


def impl_mode() -> str:
    """The implementation INTERPN_TPU_IMPL forces, read now: 'gather',
    'factorized', or 'auto' (unset, 'auto', 'pallas' or any other value:
    the device decides)."""
    mode = os.environ.get(IMPL_ENV, "auto")
    return mode if mode in ("gather", "factorized") else "auto"


def _on_card(vals: torch.Tensor) -> bool:
    return vals.device.type == "cuda"


def _impl(vals: torch.Tensor) -> str:
    """'kernel' for a CUDA tensor, 'gather' otherwise or where
    INTERPN_TPU_IMPL forces the gather tree or the factorized products
    (whose stacks and splines take the gather tree)."""
    return "kernel" if _on_card(vals) and impl_mode() == "auto" else "gather"


def f64_engine() -> str:
    """The engine INTERPN_TPU_F64 forces, read now: 'df64', 'i8', or 'auto'
    (unset, 'auto' or any other value: the native kernels)."""
    mode = os.environ.get(F64_ENV, "auto")
    return mode if mode in ("df64", "i8") else "auto"


def f64_route(vals, dims, method, engine=None):
    """(engine, keywords of its wrapper): ('df64', {}) or ('i8', {'prep':
    the table's `i8.prepare`}) where `engine` (by default the one
    INTERPN_TPU_F64 forces, read now) takes this call, else (None, {}).
    `method` is 'linear', 'cubic' or a spline degree (3, 5). The table's
    finiteness is cached with its split (`df64.table_split`, which K8's
    cached taps are made from) or its decomposition."""
    engine = f64_engine() if engine is None else engine
    if engine == "auto" or _impl(vals) != "kernel" or vals.dtype != torch.float64:
        return None, {}
    if engine == "i8" and _i8.supported(dims, method):
        prep = _i8.prepare(dims, vals)
        return ("i8", {"prep": prep}) if prep is not None else (None, {})
    if _df64.supported(dims, method) and _df64.table_split(vals)[2]:
        return "df64", {}
    return None, {}


def _engine(vals, method) -> str:
    """The engine a kernel call asks its op for (`ops/library.py`): the one
    INTERPN_TPU_F64 forces, read now, on an f64 CUDA table of a method that
    an engine takes, else 'native'. It reads no table data, so a traced
    call (`torch.export`) records it and the program keeps it; the op
    admits it for the table (`f64_route`)."""
    engine = f64_engine()
    if (engine == "auto" or method == "nearest" or vals.dtype != torch.float64
            or _impl(vals) != "kernel"):
        return "native"
    return engine


_REGULAR_GATHER = {"linear": _linear_reg_gather, "cubic": _cubic_reg_gather,
                   "nearest": _nearest_reg_gather}
_RECT_GATHER = {"linear": _linear_rect_gather, "cubic": _cubic_rect_gather,
                "nearest": _nearest_rect_gather}


@functools.cache
def kernel_route(family: str, method, key, lin: bool = True) -> Route:
    """The single-table Route of `family` ("regular": `key` the dims,
    params (starts, steps); "rectilinear": `key` the number of axes, params
    the grids; "bspline": `method` the degree, `key` the number of axes,
    params the knots), with its stack route as `.stack`. `lin` is cubic's
    `linearize_extrapolation` (passed to cubic only). The kernel callables
    are the family's custom ops (`ops/library.py`)."""
    lin = bool(lin)
    extra = (lin,) if method == "cubic" else ()
    if family == "regular":
        dims = key
        parts = (
            lambda st, sp, v, *ob: _library.regular(dims, st, sp, v, ob, method, lin,
                                                    _engine(v, method)),
            lambda st, sp, v, *ob: _REGULAR_GATHER[method](dims, st, sp, v, ob, *extra),
            lambda st, sp, v, *ob: _library.regular_stack(dims, st, sp, v, ob, method, lin),
            lambda st, sp, v, *ob: _fused.plain_regular_stack(dims, st, sp, v, ob, method, lin),
        )
        nparams = 2
    elif family == "rectilinear":
        ng = nparams = key
        parts = (
            lambda *a: _library.rectilinear(a[:ng], a[ng], a[ng + 1:], method, lin,
                                            _engine(a[ng], method)),
            lambda *a: _RECT_GATHER[method](a[:ng], a[ng], a[ng + 1:], *extra),
            lambda *a: _library.rectilinear_stack(a[:ng], a[ng], a[ng + 1:], method, lin),
            lambda *a: _fused.gather_rectilinear_stack(a[:ng], a[ng], a[ng + 1:], method, lin),
        )
    elif family == "bspline":
        ng = nparams = key
        k = method
        parts = (
            lambda *a: _library.bspline(a[:ng], a[ng], a[ng + 1:], k, _engine(a[ng], k)),
            lambda *a: _bspline_gather(a[:ng], a[ng], a[ng + 1:], k),
            lambda *a: _library.bspline_stack(a[:ng], a[ng], a[ng + 1:], k),
            lambda *a: _fused.plain_bspline_stack(a[:ng], a[ng], a[ng + 1:], k),
        )
    else:
        raise ValueError(f"no kernel route for family {family!r}")
    stack = Route(parts[2], parts[3], nparams, True, None, False)
    return Route(parts[0], parts[1], nparams, False, stack, method != "nearest")


@tracing.traced(tracing.DISPATCH)
def _route(route, params, vals, obs):
    """route.gather(*params, vals, *obs) on the CPU; on a CUDA tensor the
    kernel on flat contiguous queries, reshaped to (*obs[0].shape) or, on a
    stack route, (nch, *obs[0].shape)."""
    if _impl(vals) == "gather":
        return route.gather(*params, vals, *obs)
    shape = obs[0].shape
    lead = (int(vals.shape[0]),) if route.stacked else ()
    tensors = [t.contiguous() for t in params] + [vals.contiguous()]
    tensors += [o.reshape(-1).contiguous() for o in obs]
    return KernelRoute.apply(route, *tensors).reshape(*lead, *shape)


_FACTORIZED_REGULAR = {"linear": _fz.linear_regular_factorized,
                       "cubic": _fz.cubic_regular_factorized,
                       "nearest": _fz.nearest_regular_factorized}
_FACTORIZED_RECT = {"linear": _fz.linear_rectilinear_factorized,
                    "cubic": _fz.cubic_rectilinear_factorized,
                    "nearest": _fz.nearest_rectilinear_factorized}


@tracing.traced(tracing.ENTRY)
def _regular(method, dims, starts, steps, vals, obs, *lin):
    dims = tuple(int(d) for d in dims)
    if impl_mode() == "factorized":
        return _FACTORIZED_REGULAR[method](dims, starts, steps, vals, obs, *lin)
    return _route(kernel_route("regular", method, dims, *lin), (starts, steps), vals, obs)


def linear_regular(dims, starts, steps, vals, obs, *, vals_finite=None):
    """Multilinear eval on a regular grid; obs is a tuple of ndims tensors of
    one shape, and the result has that shape."""
    return _regular("linear", dims, starts, steps, vals, obs)


def cubic_regular(dims, starts, steps, vals, obs, linearize_extrapolation: bool, *,
                  vals_finite=None):
    """Multicubic eval on a regular grid (every dim >= 4)."""
    return _regular("cubic", dims, starts, steps, vals, obs, bool(linearize_extrapolation))


def nearest_regular(dims, starts, steps, vals, obs, *, vals_finite=None):
    """Nearest-neighbor eval on a regular grid."""
    return _regular("nearest", dims, starts, steps, vals, obs)


@tracing.traced(tracing.ENTRY)
def _rect_route(method, grids, vals, obs, *lin):
    grids = tuple(grids)
    if impl_mode() == "factorized":
        return _FACTORIZED_RECT[method](grids, vals, obs, *lin)
    return _route(kernel_route("rectilinear", method, len(grids), *lin), grids, vals, obs)


def linear_rectilinear(grids, vals, obs, *, vals_finite=None):
    """Multilinear eval on a rectilinear grid; grids is a tuple of sorted
    1-D tensors, one per dim."""
    return _rect_route("linear", grids, vals, obs)


def cubic_rectilinear(grids, vals, obs, linearize_extrapolation: bool, *, vals_finite=None):
    """Multicubic eval on a rectilinear grid (every axis >= 4 entries)."""
    return _rect_route("cubic", grids, vals, obs, bool(linearize_extrapolation))


def nearest_rectilinear(grids, vals, obs, *, vals_finite=None):
    """Nearest-neighbor eval on a rectilinear grid."""
    return _rect_route("nearest", grids, vals, obs)


@tracing.traced(tracing.ENTRY)
def bspline_eval(knots, coeffs, obs, k: int, *, vals_finite=None):
    """Tensor-product B-spline of degree k (3: cubic_spline, 5: quintic) at
    `obs`, shaped like obs[0]. `knots` and `coeffs` come from
    `ops.bspline.prep_bspline` (carried into tensors by
    `convert.bspline_from_numpy`); out-of-bounds queries extrapolate the end
    span's polynomial."""
    knots = tuple(knots)
    return _route(kernel_route("bspline", int(k), len(knots)), knots, coeffs, obs)
