"""Fused regular-grid evaluation: the wrapper of the Hopper kernel
`csrc/fused_regular.cu`.

Counterpart of `interpn_tpu/ops/pallas_v3.py::eval_regular` for
method="linear". The TPU kernel (`_pallas_v3`, body
`_build_kernel(rect=False)`) contracts weight matrices against the whole
table on the MXU; the Hopper kernel reads only the 2^N-corner stencil of each
query, so it needs none of the TPU caps (batch floor, VMEM-bounded grid
size, finite-table guard). See the source for what bounds it on the card.

On a CPU tensor `eval_regular` runs the kernel's plain version, the gather
tree of `ops/linear.py`. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import cache

import torch

from .. import _build
from .linear import linear_regular as plain_linear_regular

# Kernel launches by `eval_regular`; a run resets and reads it to show that
# its main path went through the kernel.
launches = 0

_THREADS = 256  # kThreads in the source
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM at 256 threads a block
_MAX_DIMS = 8
_INT32_LIMIT = 2**31
_VOIDP = ctypes.c_void_p


@cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_regular")
    fn = lib.interpn_linear_regular
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        _VOIDP, _VOIDP, _VOIDP, ctypes.POINTER(_VOIDP), _VOIDP,
        ctypes.c_longlong, ctypes.c_int, _VOIDP,
    ]
    fn.restype = ctypes.c_int
    return lib


@cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def eval_regular(dims, starts, steps, vals, obs, method: str = "linear"):
    """Multilinear evaluation on a regular grid, f32 or f64, 1-8D.

    Args as `ops.linear.linear_regular`; every obs entry is a 1-D tensor of
    the same length. Returns a new (n,) tensor.
    """
    if method != "linear":
        raise NotImplementedError(
            f"method={method!r} has no Hopper kernel yet (ROADMAP item 5)"
        )
    dims = tuple(int(d) for d in dims)
    device = vals.device
    if any(t.device != device for t in (starts, steps, *obs)):
        raise ValueError("starts, steps, vals and obs must be on one device")
    if device.type == "cpu":
        return plain_linear_regular(dims, starts, steps, vals, obs)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return _launch(dims, starts, steps, vals, tuple(obs))


def _check(dims, starts, steps, vals, obs) -> int:
    """Refuse what the kernel does not take; return the query count."""
    ndims = len(dims)
    if not 1 <= ndims <= _MAX_DIMS:
        raise ValueError(f"ndims must be in 1..{_MAX_DIMS}, got {ndims}")
    if len(obs) != ndims or starts.shape != (ndims,) or steps.shape != (ndims,):
        raise ValueError("starts, steps and obs must have one entry per dim")
    if min(dims) < 2:
        raise ValueError(f"every dim needs at least 2 points, got {dims}")
    if math.prod(dims) >= _INT32_LIMIT:
        raise ValueError(f"grid of {math.prod(dims)} points needs int64 indices")
    if vals.shape != (math.prod(dims),):
        raise ValueError(f"vals must be flat with {math.prod(dims)} entries")
    dtype = vals.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    n = obs[0].shape[0] if obs[0].dim() == 1 else -1
    for t in (starts, steps, *obs):
        if t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs vals {dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if any(o.dim() != 1 or o.shape[0] != n for o in obs):
        raise ValueError("obs must be 1-D tensors of one length")
    if n >= _INT32_LIMIT:
        raise ValueError(f"{n} queries need int64 indices")
    return n


def _launch(dims, starts, steps, vals, obs):
    global launches
    n = _check(dims, starts, steps, vals, obs)
    out = torch.empty(n, dtype=vals.dtype, device=vals.device)
    if n == 0:
        return out
    fn = _lib().interpn_linear_regular
    ndims = len(dims)
    index = vals.device.index
    if index is None:
        index = torch.cuda.current_device()
    blocks = min(-(-n // _THREADS), _sm_count(index) * _BLOCKS_PER_SM)
    with torch.cuda.device(index):
        rc = fn(
            int(vals.dtype == torch.float64),
            ndims,
            (ctypes.c_int * ndims)(*dims),
            starts.data_ptr(),
            steps.data_ptr(),
            vals.data_ptr(),
            (_VOIDP * ndims)(*(o.data_ptr() for o in obs)),
            out.data_ptr(),
            n,
            blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_regular kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
