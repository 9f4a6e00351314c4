"""The Hopper kernels' callables as `torch.library` custom ops.

This module has no counterpart in the JAX package: there a Pallas kernel is
a `pallas_call` inside the traced program, which `jax.export` serializes
with it. Here a kernel is launched through ctypes (`ops/fused.py`), which
`torch.export` cannot see into; as a custom op it becomes one node of an
exported graph, and a loaded program calls it again through this
registration (`aot.py`).

Six ops in the namespace `interpn_tpu_torch`, one per grid family and
form, each the callable that `ops/dispatch.py::kernel_route` builds its
`Route.kernel` from:

* `regular(dims, starts, steps, vals, obs, method, linearize, engine)`
  and `regular_stack(dims, starts, steps, vals, obs, method, linearize)`:
  K1 / K5 (`fused.eval_regular[_stack]`);
* `rectilinear(grids, vals, obs, method, linearize, engine)` and
  `rectilinear_stack(grids, vals, obs, method, linearize)`: K2 / K3 / K6
  (`fused.eval_rectilinear[_stack]`);
* `bspline(knots, coeffs, obs, k, engine)` and `bspline_stack(knots,
  coeffs, obs, k)`: K4 / K7 (`fused.eval_bspline[_stack]`).

`obs` is a list of flat contiguous query tensors of one length n; the
result is a new (n,) tensor, (nch, n) for a stack of nch tables. Each op's
one implementation, for every device, is the wrapper it names: on a CUDA
tensor the wrapper launches the kernel or raises, on a CPU tensor it runs
the kernel's plain version. That is the port's routing by device, not a
fallback. The fake implementations give the result's shape alone, so
`torch.export` and `opcheck` trace the ops without running them.

`engine` is `native`, `df64` or `i8`: the f64 engine the caller asks for
(`dispatch.kernel_route` passes the one INTERPN_TPU_F64 forces on an f64
CUDA table, read when the call is made or traced). The op takes it where
`dispatch.f64_route` admits that engine for this table (K8 or K9, its
preparation from the per-table caches) and runs the native kernel
otherwise; it never reads the environment. An exported program so keeps
the engine it was traced with, as a `jax.export` program keeps the engine
chosen at export. Stacks take no engine (none of K8 and K9 takes a stack).

The ops have no autograd formula: `dispatch.KernelRoute` calls them in its
forward and takes derivatives from the gather tree. Called directly on
tensors that require grad they raise.
"""

import torch
from torch import Tensor

from . import df64 as _df64
from . import fused as _fused
from . import i8 as _i8

NAMESPACE = "interpn_tpu_torch"
ENGINES = ("native", "df64", "i8")
_ENGINE_MODULES = {"df64": _df64, "i8": _i8}


def _resolve(engine: str, vals: Tensor, dims, method):
    """(module of the engine's wrappers or None for the native kernels,
    keywords of its wrapper) for a call that asks for `engine`."""
    if engine == "native":
        return None, {}
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    from . import dispatch  # imported here: dispatch imports this module

    taken, kw = dispatch.f64_route(vals, dims, method, engine)
    return _ENGINE_MODULES.get(taken), kw


def _one(vals: Tensor, obs: list[Tensor]) -> Tensor:
    return vals.new_empty((obs[0].shape[0],))


def _stack(vals: Tensor, obs: list[Tensor]) -> Tensor:
    return vals.new_empty((vals.shape[0], obs[0].shape[0]))


@torch.library.custom_op(f"{NAMESPACE}::regular", mutates_args=())
def regular(dims: list[int], starts: Tensor, steps: Tensor, vals: Tensor, obs: list[Tensor],
            method: str, linearize: bool, engine: str) -> Tensor:
    """K1 (or K8 / K9 where `engine` takes the table) on a regular grid."""
    dims = tuple(dims)
    module, kw = _resolve(engine, vals, dims, method)
    if module is None:
        return _fused.eval_regular(dims, starts, steps, vals, obs, method, linearize)
    return module.eval_regular(dims, starts, steps, vals, obs, method, linearize, **kw)


@torch.library.custom_op(f"{NAMESPACE}::regular_stack", mutates_args=())
def regular_stack(dims: list[int], starts: Tensor, steps: Tensor, vals: Tensor,
                  obs: list[Tensor], method: str, linearize: bool) -> Tensor:
    """K5 over an (nch, prod(dims)) stack on a regular grid."""
    return _fused.eval_regular_stack(tuple(dims), starts, steps, vals, obs, method, linearize)


@torch.library.custom_op(f"{NAMESPACE}::rectilinear", mutates_args=())
def rectilinear(grids: list[Tensor], vals: Tensor, obs: list[Tensor], method: str,
                linearize: bool, engine: str) -> Tensor:
    """K2 / K3 (or K8 / K9 where `engine` takes the table) on a
    rectilinear grid."""
    dims = tuple(int(g.shape[0]) for g in grids)
    module, kw = _resolve(engine, vals, dims, method)
    if module is None:
        return _fused.eval_rectilinear(grids, vals, obs, method, linearize)
    return module.eval_rectilinear(grids, vals, obs, method, linearize, **kw)


@torch.library.custom_op(f"{NAMESPACE}::rectilinear_stack", mutates_args=())
def rectilinear_stack(grids: list[Tensor], vals: Tensor, obs: list[Tensor], method: str,
                      linearize: bool) -> Tensor:
    """K6 over an (nch, prod(dims)) stack on a rectilinear grid."""
    return _fused.eval_rectilinear_stack(grids, vals, obs, method, linearize)


@torch.library.custom_op(f"{NAMESPACE}::bspline", mutates_args=())
def bspline(knots: list[Tensor], coeffs: Tensor, obs: list[Tensor], k: int,
            engine: str) -> Tensor:
    """K4 (or K8 where `engine` takes the table: the spline engine is
    df64 under either forced engine) for a degree-k B-spline."""
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    module, _ = _resolve(engine, coeffs, dims, k)
    if module is None:
        return _fused.eval_bspline(knots, coeffs, obs, k)
    return _df64.eval_bspline(knots, coeffs, obs, k)


@torch.library.custom_op(f"{NAMESPACE}::bspline_stack", mutates_args=())
def bspline_stack(knots: list[Tensor], coeffs: Tensor, obs: list[Tensor], k: int) -> Tensor:
    """K7 over an (nch, prod(dims)) stack of coefficient tables."""
    return _fused.eval_bspline_stack(knots, coeffs, obs, k)


@regular.register_fake
def _(dims, starts, steps, vals, obs, method, linearize, engine):
    return _one(vals, obs)


@regular_stack.register_fake
def _(dims, starts, steps, vals, obs, method, linearize):
    return _stack(vals, obs)


@rectilinear.register_fake
def _(grids, vals, obs, method, linearize, engine):
    return _one(vals, obs)


@rectilinear_stack.register_fake
def _(grids, vals, obs, method, linearize):
    return _stack(vals, obs)


@bspline.register_fake
def _(knots, coeffs, obs, k, engine):
    return _one(coeffs, obs)


@bspline_stack.register_fake
def _(knots, coeffs, obs, k):
    return _stack(coeffs, obs)


NAMES = ("regular", "regular_stack", "rectilinear", "rectilinear_stack", "bspline",
         "bspline_stack")


def overload(name: str):
    """The op's default overload (`torch.ops.interpn_tpu_torch.<name>.default`),
    the target of its node in an exported graph."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default
