"""Fused evaluation: the wrappers of the Hopper kernels.

* `eval_regular` launches `csrc/fused_regular.cu` (linear, cubic, nearest),
  the counterpart of `interpn_tpu/ops/pallas_v3.py::eval_regular` (K1).
* `eval_rectilinear` launches `csrc/fused_rectilinear.cu`, the counterpart of
  `pallas_v3.eval_rectilinear_pre` (K2: linear, cubic) and
  `pallas_v3.eval_rectilinear` (K3: nearest).

The TPU kernels contract weight matrices against the whole table on the
MXU; the Hopper kernels read only each query's stencil, so they need none of
the TPU caps (batch floor, VMEM-bounded grid size, finite-table guard). See
the sources for what bounds them on the card.

On a CPU tensor each wrapper runs its kernel's plain version, the gather
tree (`ops/linear.py`, `ops/cubic.py`, `ops/nearest.py`). On a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import cache

import torch

from .. import _build
from .cubic import cubic_rectilinear as plain_cubic_rectilinear
from .cubic import cubic_regular as plain_cubic_regular
from .linear import linear_rectilinear as plain_linear_rectilinear
from .linear import linear_regular as plain_linear_regular
from .nearest import nearest_rectilinear as plain_nearest_rectilinear
from .nearest import nearest_regular as plain_nearest_regular

METHODS = ("linear", "cubic", "nearest")  # kLinear, kCubic, kNearest in csrc
KERNELS = tuple(f"{grid}_{m}" for grid in ("regular", "rectilinear") for m in METHODS)

# Kernel launches by name; a run resets and reads them to show that its main
# path went through the kernels.
launches = dict.fromkeys(KERNELS, 0)

_THREADS = 256  # kThreads in the sources
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM at 256 threads a block
_MAX_DIMS = 8
_INT32_LIMIT = 2**31
_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_HEAD = [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)]  # method, lin, f64, ndims, dims
_TAIL = [_VOIDP, ctypes.POINTER(_VOIDP), _VOIDP, ctypes.c_longlong, _INT, _VOIDP]
_ARGTYPES = {
    # (starts, steps) | grids, then vals, obs, out, n, blocks, stream
    "fused_regular": ("interpn_regular", _HEAD + [_VOIDP, _VOIDP] + _TAIL),
    "fused_rectilinear": ("interpn_rectilinear", _HEAD + [ctypes.POINTER(_VOIDP)] + _TAIL),
}


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


def eval_regular(dims, starts, steps, vals, obs, method="linear", linearize=True):
    """Evaluation on a regular grid, f32 or f64, 1-8D (cubic: every dim
    >= 4). Args as `ops.linear.linear_regular`; every obs entry is a 1-D
    tensor of the same length; `linearize` is the cubic method's
    `linearize_extrapolation`. Returns a new (n,) tensor."""
    code = _method(method)
    dims = tuple(int(d) for d in dims)
    obs = tuple(obs)
    if _device((vals, starts, steps, *obs)).type == "cpu":
        if method == "cubic":
            return plain_cubic_regular(dims, starts, steps, vals, obs, linearize)
        plain = plain_linear_regular if method == "linear" else plain_nearest_regular
        return plain(dims, starts, steps, vals, obs)
    n = _check(dims, starts, steps, vals, obs, method)
    return _launch(
        "fused_regular", f"regular_{method}", code, linearize, dims, vals, obs, n,
        starts.data_ptr(), steps.data_ptr(),
    )


def eval_rectilinear(grids, vals, obs, method="linear", linearize=True):
    """Evaluation on a rectilinear grid, f32 or f64, 1-8D (cubic: every
    axis >= 4 entries). `grids` holds one sorted 1-D tensor per axis; the
    rest as `eval_regular`. Returns a new (n,) tensor."""
    code = _method(method)
    grids = tuple(grids)
    obs = tuple(obs)
    if _device((vals, *grids, *obs)).type == "cpu":
        if method == "cubic":
            return plain_cubic_rectilinear(grids, vals, obs, linearize)
        plain = plain_linear_rectilinear if method == "linear" else plain_nearest_rectilinear
        return plain(grids, vals, obs)
    dims = tuple(int(g.shape[0]) for g in grids)
    n = _check_rectilinear(grids, vals, obs, method)
    return _launch(
        "fused_rectilinear", f"rectilinear_{method}", code, linearize, dims, vals, obs, n,
        (_VOIDP * len(grids))(*(g.data_ptr() for g in grids)),
    )


def _check_common(dims, vals, obs, params, method) -> int:
    """Refuse what the kernels do not take; return the query count."""
    ndims = len(dims)
    if not 1 <= ndims <= _MAX_DIMS:
        raise ValueError(f"ndims must be in 1..{_MAX_DIMS}, got {ndims}")
    if len(obs) != ndims:
        raise ValueError("grid parameters and obs must have one entry per dim")
    need = 4 if method == "cubic" else 2
    if min(dims) < need:
        raise ValueError(f"{method} needs every dim to have at least {need} points, got {dims}")
    if math.prod(dims) >= _INT32_LIMIT:
        raise ValueError(f"grid of {math.prod(dims)} points needs int64 indices")
    if vals.shape != (math.prod(dims),):
        raise ValueError(f"vals must be flat with {math.prod(dims)} entries")
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


def _check(dims, starts, steps, vals, obs, method="linear") -> int:
    n = _check_common(dims, vals, obs, (starts, steps), method)
    if starts.shape != (len(dims),) or steps.shape != (len(dims),):
        raise ValueError("starts, steps and obs must have one entry per dim")
    return n


def _check_rectilinear(grids, vals, obs, method="linear") -> int:
    if any(g.dim() != 1 for g in grids):
        raise ValueError("grids must be 1-D tensors, one per dim")
    dims = tuple(int(g.shape[0]) for g in grids)
    return _check_common(dims, vals, obs, grids, method)


def _launch(source, kernel, code, linearize, dims, vals, obs, n, *grid_args):
    """Launch `csrc/<source>.cu` on the current stream; count the launch."""
    out = torch.empty(n, dtype=vals.dtype, device=vals.device)
    if n == 0:
        return out
    ndims = len(dims)
    index = vals.device.index
    if index is None:
        index = torch.cuda.current_device()
    blocks = min(-(-n // _THREADS), _sm_count(index) * _BLOCKS_PER_SM)
    with torch.cuda.device(index):
        rc = _fn(source)(
            code,
            int(bool(linearize)),
            int(vals.dtype == torch.float64),
            ndims,
            (_INT * ndims)(*dims),
            *grid_args,
            vals.data_ptr(),
            (_VOIDP * ndims)(*(o.data_ptr() for o in obs)),
            out.data_ptr(),
            n,
            blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1
    return out
