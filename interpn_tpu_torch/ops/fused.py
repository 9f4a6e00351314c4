"""Fused evaluation: the wrappers of the Hopper kernels.

* `eval_regular` / `eval_regular_stack` launch `csrc/fused_regular.cu` /
  `fused_regular_stack.cu` (linear, cubic, nearest), the counterpart of
  `interpn_tpu/ops/pallas_v3.py::eval_regular` (K1) and
  `eval_regular_stack` (K5).
* `eval_rectilinear` / `eval_rectilinear_stack` launch
  `csrc/fused_rectilinear.cu` / `fused_rectilinear_stack.cu`, the
  counterpart of `pallas_v3.eval_rectilinear_pre` (K2: linear, cubic),
  `pallas_v3.eval_rectilinear` (K3: nearest) and
  `pallas_v3.eval_rectilinear_stack` (K6).
* `eval_bspline` / `eval_bspline_stack` launch `csrc/fused_bspline.cu` /
  `fused_bspline_stack.cu`, the counterpart of `pallas_v3.eval_bspline`
  (K4, and K2's spline use) and `pallas_v3.eval_bspline_stack` (K7).

A stack is (nch, prod(dims)) tables on one grid, evaluated at the same
queries into an (nch, n) block: the stack source instantiates its family's
kernel (`csrc/*.cuh`) with a loop over the tables after the one locate and
weight build per query; the single-table source has no loop. The TPU kernels contract weight matrices against the whole table on
the MXU; the Hopper kernels read only each query's stencil, so they need
none of the TPU caps (batch floor, VMEM-bounded grid size, finite-table
guard). See the sources for what bounds them on the card.

On a CPU tensor each wrapper runs its kernel's plain version (the `plain_*`
functions below: the gather trees of `ops/linear.py`, `ops/cubic.py`,
`ops/nearest.py` and `ops/bspline.py`, over each channel for a stack). On a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import cache

import torch

from .. import _build
from .bspline import bspline_gather
from .cubic import cubic_rectilinear, cubic_regular
from .linear import linear_rectilinear, linear_regular
from .nearest import nearest_rectilinear, nearest_regular

METHODS = ("linear", "cubic", "nearest")  # kLinear, kCubic, kNearest in csrc
DEGREES = (3, 5)  # cubic_spline, quintic
SOURCES = tuple(f"fused_{family}{stack}" for family in ("regular", "rectilinear", "bspline")
                for stack in ("", "_stack"))
_SINGLE = (*(f"{grid}_{m}" for grid in ("regular", "rectilinear") for m in METHODS),
           *(f"bspline_k{k}" for k in DEGREES))
KERNELS = (*_SINGLE, *(f"{name}_stack" for name in _SINGLE))

# Kernel launches by name; a run resets and reads them to show that its main
# path went through the kernels.
launches = dict.fromkeys(KERNELS, 0)

_THREADS = 256  # kThreads in the sources
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM at 256 threads a block
_MAX_DIMS = 8
_INT32_LIMIT = 2**31
_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_PTRS = ctypes.POINTER(_VOIDP)
_DIMS = [_INT, ctypes.POINTER(_INT)]  # ndims, dims
_TAIL = [_VOIDP, _PTRS, _VOIDP, ctypes.c_longlong, _INT, _INT, _VOIDP]
_FAMILY_ARGTYPES = {
    # (method, linearize, is_f64 | degree, is_f64), ndims, dims, the grid
    # (starts, steps | columns | knots), then vals, obs, out, n, nch, blocks,
    # stream; a family's single-table and stack sources take the same
    "regular": [_INT, _INT, _INT] + _DIMS + [_VOIDP, _VOIDP] + _TAIL,
    "rectilinear": [_INT, _INT, _INT] + _DIMS + [_PTRS] + _TAIL,
    "bspline": [_INT, _INT] + _DIMS + [_PTRS] + _TAIL,
}
_ARGTYPES = {s: (s.replace("fused_", "interpn_"), _FAMILY_ARGTYPES[s.split("_")[1]])
             for s in SOURCES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@cache
def _fn(source: str):
    """The kernel entry of `csrc/<source>.cu`, built first if needed."""
    name, argtypes = _ARGTYPES[source]
    fn = getattr(_build.load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _method(method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    return METHODS.index(method)


def _device(tensors) -> torch.device:
    """The one device of `tensors`; ValueError for a mix or a device with no
    kernel and no plain version."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("grid, vals and obs tensors must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


# --- the plain versions -------------------------------------------------------------


def plain_regular(dims, starts, steps, vals, obs, method="linear", linearize=True):
    """The gather tree that `eval_regular` launches the kernel of."""
    if method == "cubic":
        return cubic_regular(dims, starts, steps, vals, obs, linearize)
    plain = linear_regular if method == "linear" else nearest_regular
    return plain(dims, starts, steps, vals, obs)


def plain_rectilinear(grids, vals, obs, method="linear", linearize=True):
    """The gather tree that `eval_rectilinear` launches the kernel of."""
    if method == "cubic":
        return cubic_rectilinear(grids, vals, obs, linearize)
    plain = linear_rectilinear if method == "linear" else nearest_rectilinear
    return plain(grids, vals, obs)


def _per_channel(single, vals_stack):
    return torch.stack([single(v) for v in vals_stack])


def plain_regular_stack(dims, starts, steps, vals_stack, obs, method="linear",
                        linearize=True):
    """`plain_regular` over each table of the stack: (nch, *obs[0].shape)."""
    return _per_channel(
        lambda v: plain_regular(dims, starts, steps, v, obs, method, linearize), vals_stack)


def plain_rectilinear_stack(grids, vals_stack, obs, method="linear", linearize=True):
    """`plain_rectilinear` over each table of the stack."""
    return _per_channel(
        lambda v: plain_rectilinear(grids, v, obs, method, linearize), vals_stack)


plain_bspline = bspline_gather


def plain_bspline_stack(knots, coeffs_stack, obs, k: int):
    """`plain_bspline` over each coefficient table of the stack."""
    return _per_channel(lambda c: bspline_gather(knots, c, obs, k), coeffs_stack)


# --- the wrappers ---------------------------------------------------------------------


def eval_regular(dims, starts, steps, vals, obs, method="linear", linearize=True):
    """Evaluation on a regular grid, f32 or f64, 1-8D (cubic: every dim
    >= 4). Args as `ops.linear.linear_regular`; every obs entry is a 1-D
    tensor of the same length; `linearize` is the cubic method's
    `linearize_extrapolation`. Returns a new (n,) tensor."""
    return _regular(dims, starts, steps, vals, obs, method, linearize, stacked=False)


def eval_regular_stack(dims, starts, steps, vals_stack, obs, method="linear", linearize=True):
    """`eval_regular` over an (nch, prod(dims)) stack of tables: one locate
    per query for all of them. Returns a new (nch, n) tensor."""
    return _regular(dims, starts, steps, vals_stack, obs, method, linearize, stacked=True)


def _regular(dims, starts, steps, vals, obs, method, linearize, *, stacked):
    code = _method(method)
    dims = tuple(int(d) for d in dims)
    obs = tuple(obs)
    if _device((vals, starts, steps, *obs)).type == "cpu":
        plain = plain_regular_stack if stacked else plain_regular
        return plain(dims, starts, steps, vals, obs, method, linearize)
    n = _check(dims, starts, steps, vals, obs, method, stacked)
    return _launch(
        _name("fused_regular", stacked), _name(f"regular_{method}", stacked),
        (code, int(bool(linearize)), _is_f64(vals)), dims, vals, obs, n, stacked,
        starts.data_ptr(), steps.data_ptr(),
    )


def eval_rectilinear(grids, vals, obs, method="linear", linearize=True):
    """Evaluation on a rectilinear grid, f32 or f64, 1-8D (cubic: every
    axis >= 4 entries). `grids` holds one sorted 1-D tensor per axis; the
    rest as `eval_regular`. Returns a new (n,) tensor."""
    return _rectilinear(grids, vals, obs, method, linearize, stacked=False)


def eval_rectilinear_stack(grids, vals_stack, obs, method="linear", linearize=True):
    """`eval_rectilinear` over an (nch, prod(dims)) stack of tables. Returns
    a new (nch, n) tensor."""
    return _rectilinear(grids, vals_stack, obs, method, linearize, stacked=True)


def _rectilinear(grids, vals, obs, method, linearize, *, stacked):
    code = _method(method)
    grids = tuple(grids)
    obs = tuple(obs)
    if _device((vals, *grids, *obs)).type == "cpu":
        plain = plain_rectilinear_stack if stacked else plain_rectilinear
        return plain(grids, vals, obs, method, linearize)
    n = _check_rectilinear(grids, vals, obs, method, stacked)
    dims = tuple(int(g.shape[0]) for g in grids)
    return _launch(
        _name("fused_rectilinear", stacked), _name(f"rectilinear_{method}", stacked),
        (code, int(bool(linearize)), _is_f64(vals)), dims, vals, obs, n, stacked,
        (_VOIDP * len(grids))(*(g.data_ptr() for g in grids)),
    )


def eval_bspline(knots, coeffs, obs, k: int):
    """Tensor-product B-spline of degree k (3 or 5), f32 or f64, 1-8D.
    `knots` holds one not-a-knot vector per axis (dim + k + 1 entries, from
    `ops.bspline.prep_bspline`); `coeffs` the flat C-order coefficient
    table. Returns a new (n,) tensor."""
    return _bspline(knots, coeffs, obs, k, stacked=False)


def eval_bspline_stack(knots, coeffs_stack, obs, k: int):
    """`eval_bspline` over an (nch, prod(dims)) stack of coefficient tables:
    one weight build per query for all of them. Returns a new (nch, n)
    tensor."""
    return _bspline(knots, coeffs_stack, obs, k, stacked=True)


def _bspline(knots, coeffs, obs, k, *, stacked):
    if k not in DEGREES:
        raise ValueError(f"spline degree must be one of {DEGREES}, got {k!r}")
    knots = tuple(knots)
    obs = tuple(obs)
    if _device((coeffs, *knots, *obs)).type == "cpu":
        plain = plain_bspline_stack if stacked else plain_bspline
        return plain(knots, coeffs, obs, k)
    if any(t.dim() != 1 for t in knots):
        raise ValueError("knots must be 1-D tensors, one per dim")
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    n = _check_common(dims, coeffs, obs, knots, k + 1, stacked)
    return _launch(
        _name("fused_bspline", stacked), _name(f"bspline_k{k}", stacked), (k, _is_f64(coeffs)),
        dims, coeffs, obs, n, stacked,
        (_VOIDP * len(knots))(*(t.data_ptr() for t in knots)),
    )


def _need(method: str) -> int:
    return 4 if method == "cubic" else 2


def _check(dims, starts, steps, vals, obs, method="linear", stacked=False) -> int:
    n = _check_common(dims, vals, obs, (starts, steps), _need(method), stacked)
    if starts.shape != (len(dims),) or steps.shape != (len(dims),):
        raise ValueError("starts, steps and obs must have one entry per dim")
    return n


def _check_rectilinear(grids, vals, obs, method="linear", stacked=False) -> int:
    if any(g.dim() != 1 for g in grids):
        raise ValueError("grids must be 1-D tensors, one per dim")
    dims = tuple(int(g.shape[0]) for g in grids)
    return _check_common(dims, vals, obs, grids, _need(method), stacked)


def _name(name: str, stacked: bool) -> str:
    return f"{name}_stack" if stacked else name


def _is_f64(vals) -> int:
    return int(vals.dtype == torch.float64)


def _check_common(dims, vals, obs, params, need, stacked) -> int:
    """Refuse what the kernels do not take (a stack's vals are
    (nch, prod(dims)), a single table's flat); return the query count."""
    ndims = len(dims)
    if not 1 <= ndims <= _MAX_DIMS:
        raise ValueError(f"ndims must be in 1..{_MAX_DIMS}, got {ndims}")
    if len(obs) != ndims:
        raise ValueError("grid parameters and obs must have one entry per dim")
    if min(dims) < need:
        raise ValueError(f"every dim needs at least {need} points, got {dims}")
    size = math.prod(dims)
    if size >= _INT32_LIMIT:
        raise ValueError(f"grid of {size} points needs int64 indices")
    nch = int(vals.shape[0]) if stacked and vals.dim() == 2 else 1
    if vals.shape != ((nch, size) if stacked else (size,)):
        want = f"(nch, {size})" if stacked else f"flat with {size} entries"
        raise ValueError(f"vals must be {want}, got {tuple(vals.shape)}")
    dtype = vals.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    n = obs[0].shape[0] if obs[0].dim() == 1 else -1
    for t in (*params, vals, *obs):
        if t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs vals {dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if any(o.dim() != 1 or o.shape[0] != n for o in obs):
        raise ValueError("obs must be 1-D tensors of one length")
    if n >= _INT32_LIMIT:
        raise ValueError(f"{n} queries need int64 indices")
    return n


def _launch(source, kernel, head, dims, vals, obs, n, stacked, *grid_args):
    """Launch `csrc/<source>.cu` on the current stream; count the launch."""
    nch = int(vals.shape[0]) if stacked else 1
    out = torch.empty((nch, n) if stacked else (n,), dtype=vals.dtype, device=vals.device)
    if n == 0 or nch == 0:
        return out
    ndims = len(dims)
    index = vals.device.index
    if index is None:
        index = torch.cuda.current_device()
    blocks = min(-(-n // _THREADS), _sm_count(index) * _BLOCKS_PER_SM)
    with torch.cuda.device(index):
        rc = _fn(source)(
            *head,
            ndims,
            (_INT * ndims)(*dims),
            *grid_args,
            vals.data_ptr(),
            (_VOIDP * ndims)(*(o.data_ptr() for o in obs)),
            out.data_ptr(),
            n,
            nch,
            blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1
    return out
