"""Interpolators that cross `torch.func` transform boundaries.

Counterpart of `interpn_tpu/functional.py`. The pydantic model classes hold
numpy state and are no argument of a transform. `TorchInterpolator` is
registered with `torch.utils._pytree`: its *tensors are leaves* (the grid
arrays and the value table, or a spline's knots and coefficients) and its
configuration (method, grid kind, dims, extrapolation mode) is static
structure. So, with no kernel of its own:

* **vmap over tables**: `torch.func.vmap(f, in_dims=(itp.batch_axes(),
  None))(batched_itp, obs)` maps over a batch of tables sharing one grid;
  on the card the batch goes to the family's stack kernel in one launch
  (K1 -> K5, K2/K3 -> K6, K4 -> K7; `ops/dispatch.py::KernelRoute`), each
  row bit for bit the single-table call;
* **autodiff**: `torch.func.grad`, `vjp`, `jvp`, `jacrev` and `jacfwd`
  into the table and the queries, the kernel forward and the gather tree's
  derivatives (`ops/dispatch.py`), as the JAX package's custom-JVP routing.

Evaluation goes through `ops.dispatch` and `ops.pchip`, the functions the
model classes and `raw` call, so a call on a CUDA table is bitwise the
`ops` call and launches its kernel (K1, K2, K3 or K4) once.

Not ported: the JAX package's `jit` argument without retrace (the port
does not trace) and the `scan` carry (`torch.func` has no `scan`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import config
from .ops import dispatch as _dispatch
from .ops import pchip as _pchip

__all__ = ["TorchInterpolator"]

_METHODS = ("linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic")
_SPLINE_DEGREE = {"cubic_spline": 3, "quintic": 5}
_FLOATS = (torch.float32, torch.float64)


def _transformed(t) -> bool:
    """Whether `t` is a tensor under a `torch.func` transform."""
    return isinstance(t, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(t)


def _table(vals) -> torch.Tensor:
    """A tensor as it is, an array on `config.default_device()`; a table
    of neither float dtype as float64."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals), device=config.default_device())
    return vals if vals.dtype in _FLOATS else vals.to(torch.float64)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """`x` as a tensor on `ref`'s device in `ref`'s dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(np.asarray(x), device=ref.device, dtype=ref.dtype)


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)


def _spline_leaves(grids_host, vals, k):
    """(knots tuple, coefficients): the leaves of the global B-spline
    methods. The collocation solve runs once here, on the host in float64
    (content-cached), and the leaves carry knots and coefficients in the
    table's dtype on its device, so vmap and grad apply to the
    coefficients. Building needs the table's values."""
    from .ops import bspline as _bspline

    if _transformed(vals) or (isinstance(vals, torch.Tensor) and vals.requires_grad):
        raise TypeError(
            "cubic_spline/quintic construction solves the collocation "
            "system on the host and needs concrete table values; build "
            "the interpolator outside the transform (it is a pytree: pass it in)"
        )
    ref = _table(vals)
    knots, coeffs = _bspline.prep_bspline_cached(
        [_host(g) for g in grids_host], _host(vals).reshape(-1), k)
    return tuple(_like(t, ref) for t in knots), _like(coeffs, ref)


class TorchInterpolator:
    """Immutable pytree over (grid arrays, value table) with static config.

    Build with `regular`, `rectilinear` or `from_model`; call with a
    sequence of per-dimension query tensors (or arrays). Numpy inputs go to
    `config.default_device()`, tensors stay where they are; the grid and
    queries take the table's dtype. NaN and inf coordinates propagate as
    NaN, as `eval_torch` of the classes.
    """

    def __init__(self, *, method, kind, dims, linearize_extrapolation, grid_arrays, vals):
        # internal; no validation here: unflatten passes transformed tensors through
        self.method = method
        self.kind = kind
        self.dims = dims
        self.linearize_extrapolation = linearize_extrapolation
        self.grid_arrays = tuple(grid_arrays)
        self.vals = vals

    # ---- constructors ------------------------------------------------------------------
    @classmethod
    def regular(cls, dims, starts, steps, vals, *, method="linear",
                linearize_extrapolation=True):
        """Regular grid: `dims` ints, `starts` / `steps` of length ndims,
        `vals` the C-order table (flat or shaped)."""
        dims = tuple(int(d) for d in dims)
        cls._check(method, len(dims))
        lin = bool(linearize_extrapolation)
        if method in _SPLINE_DEGREE:
            s, h = _host(starts).reshape(-1), _host(steps).reshape(-1)
            grids_host = [s[i] + h[i] * np.arange(d) for i, d in enumerate(dims)]
            knots, coeffs = _spline_leaves(grids_host, vals, _SPLINE_DEGREE[method])
            return cls(method=method, kind="regular", dims=dims,
                       linearize_extrapolation=lin, grid_arrays=knots, vals=coeffs)
        vals = _table(vals).reshape(-1)
        return cls(method=method, kind="regular", dims=dims, linearize_extrapolation=lin,
                   grid_arrays=(_like(starts, vals).reshape(-1),
                                _like(steps, vals).reshape(-1)),
                   vals=vals)

    @classmethod
    def rectilinear(cls, grids, vals, *, method="linear", linearize_extrapolation=True):
        """Rectilinear grid: one strictly increasing 1-D array per axis."""
        grids = tuple(grids)
        cls._check(method, len(grids))
        lin = bool(linearize_extrapolation)
        if method in _SPLINE_DEGREE:
            knots, coeffs = _spline_leaves(grids, vals, _SPLINE_DEGREE[method])
            return cls(method=method, kind="rectilinear", dims=None,
                       linearize_extrapolation=lin, grid_arrays=knots, vals=coeffs)
        vals = _table(vals).reshape(-1)
        return cls(method=method, kind="rectilinear", dims=None, linearize_extrapolation=lin,
                   grid_arrays=tuple(_like(g, vals).reshape(-1) for g in grids), vals=vals)

    @classmethod
    def from_model(cls, model):
        """Lift a model class instance (already validated) into a pytree;
        the model's arrays become leaves."""
        from .models import _base

        base_name = type(model).__name__.replace("Regular", "").replace("Rectilinear", "")
        if base_name == "TensorSpline":
            method = model.method  # "pchip" | "cubic_spline" | "quintic"
        else:
            method = {"Multilinear": "linear", "Multicubic": "cubic",
                      "Nearest": "nearest"}[base_name]
        lin = bool(getattr(model, "linearize_extrapolation", True))
        if isinstance(model, _base.RegularGridMixin):
            return cls.regular(model.dims, model.starts.data, model.steps.data,
                               model.vals.data, method=method, linearize_extrapolation=lin)
        return cls.rectilinear([g.data for g in model.grids], model.vals.data,
                               method=method, linearize_extrapolation=lin)

    @staticmethod
    def _check(method, ndims):
        if method not in _METHODS:
            raise ValueError(f"Method '{method}' is not defined")
        limit = 6 if method == "nearest" else 8
        if not 1 <= ndims <= limit:
            raise AssertionError("Dimension mismatch")

    # ---- pytree protocol -----------------------------------------------------------------
    def tree_flatten(self):
        children = [*self.grid_arrays, self.vals]
        aux = (self.method, self.kind, self.dims, self.linearize_extrapolation)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        method, kind, dims, lin = aux
        children = list(children)
        return cls(method=method, kind=kind, dims=dims, linearize_extrapolation=lin,
                   grid_arrays=children[:-1], vals=children[-1])

    # ---- evaluation ----------------------------------------------------------------------
    @property
    def ndims(self):
        return len(self.dims) if self.kind == "regular" else len(self.grid_arrays)

    def __call__(self, obs, *, vals_finite=None):
        """Evaluate at `obs` (a sequence of ndims equally shaped tensors or
        arrays); returns a tensor of that shape. `vals_finite` is accepted
        and ignored, as by every `ops` evaluator."""
        obs = [_like(o, self.vals) for o in obs]
        if len(obs) != self.ndims or any(o.shape != obs[0].shape for o in obs):
            raise AssertionError("Dimension mismatch")
        shape = obs[0].shape
        flat = tuple(o.reshape(-1) for o in obs)
        if self.method in _SPLINE_DEGREE:
            # both grid kinds hold (knots, coefficients) leaves
            out = _dispatch.bspline_eval(self.grid_arrays, self.vals, flat,
                                         _SPLINE_DEGREE[self.method])
        elif self.kind == "regular":
            starts, steps = self.grid_arrays
            if self.method == "pchip":
                # nonlinear in the table: the gather tree on every device
                out = _pchip.pchip_regular(self.dims, starts, steps, self.vals, flat)
            else:
                lin = (self.linearize_extrapolation,) if self.method == "cubic" else ()
                fn = getattr(_dispatch, f"{self.method}_regular")
                out = fn(self.dims, starts, steps, self.vals, flat, *lin)
        elif self.method == "pchip":
            out = _pchip.pchip_rectilinear(self.grid_arrays, self.vals, flat)
        else:
            lin = (self.linearize_extrapolation,) if self.method == "cubic" else ()
            fn = getattr(_dispatch, f"{self.method}_rectilinear")
            out = fn(self.grid_arrays, self.vals, flat, *lin)
        return out.reshape(shape)

    def batch_axes(self, *, vals=0, grids=None):
        """An `in_dims` / `out_dims` tree for `torch.func.vmap`: self's
        structure with a batch dim (or None) in each leaf's place. The
        default maps over a batch of tables sharing one unbatched grid."""
        n = len(self.grid_arrays)
        return self.tree_unflatten(
            (self.method, self.kind, self.dims, self.linearize_extrapolation),
            (*([grids] * n), vals),
        )

    def __repr__(self):
        grid = f"dims={self.dims}" if self.kind == "regular" else f"ndims={self.ndims}"
        return (f"TorchInterpolator({self.method}, {self.kind}, {grid}, "
                f"vals={tuple(getattr(self.vals, 'shape', ()))})")


pytree.register_pytree_node(
    TorchInterpolator,
    TorchInterpolator.tree_flatten,
    lambda children, aux: TorchInterpolator.tree_unflatten(aux, children),
    serialized_type_name="interpn_tpu_torch.functional.TorchInterpolator",
)
