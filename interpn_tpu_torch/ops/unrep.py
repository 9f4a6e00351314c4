"""The regular entries' unrepresentable-coordinate flag.

True when a query's cell index does not fit an isize: the reference's
"Unrepresentable coordinate value" error for NaN, inf and far-out
coordinates. On a CUDA tensor one launch of `csrc/unrep_flag.cu`, which
reads each query column once (`_kernel`); on a CPU tensor its plain
version, `plain`. The entries read the flag to the host and raise before
they write `out` (`_entry.write_checked`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..utils import tracing

_TWO63 = 9223372036854775808.0  # 2^63, exactly representable in f32 and f64
_VOIDP = ctypes.c_void_p

# Launches of the flag's kernel, one a flag on a CUDA tensor with queries; a
# run reads it to show that the flag went through the kernel. Kept apart
# from `ops.fused.launches`, which counts the evaluation wrappers' kernels.
launches = 0


@tracing.traced(tracing.UNREP_FLAG, events=True)
def flag(starts, steps, obs) -> torch.Tensor:
    """The flag as a 0-d bool tensor on the queries' device, not read to
    the host here. `starts`, `steps` and every obs column are 1-D,
    contiguous, of one float dtype and on one device; the obs columns of
    one length."""
    n = _check_inputs(starts, steps, obs)
    if starts.device.type == "cuda":
        return _kernel(starts, steps, obs, n)
    return plain(starts, steps, obs)


def plain(starts, steps, obs) -> torch.Tensor:
    """The flag by elementwise passes over each column."""
    bad = torch.zeros((), dtype=torch.bool, device=starts.device)
    for k, x in enumerate(obs):
        floc = torch.floor((x - starts[k]) / steps[k])
        ok = (floc >= -_TWO63) & (floc < _TWO63)  # False for NaN too
        bad = bad | (~ok).any()
    return bad


def _check_inputs(starts, steps, obs) -> int:
    """Refuse what the flag's kernel does not take; return the query count."""
    ndims = len(obs)
    if not 1 <= ndims <= 8 or starts.shape != (ndims,) or steps.shape != (ndims,):
        raise ValueError("starts, steps and obs must have one entry per dim, 1-8 dims")
    dtype, device = starts.dtype, starts.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the flag takes float32 or float64, got {dtype}")
    n = obs[0].numel()
    for t in (starts, steps, *obs):
        if t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs starts {dtype}")
        if t.device != device:
            raise ValueError(f"device mismatch: {t.device} vs starts {device}")
        if not t.is_contiguous():
            raise ValueError("the flag's inputs must be contiguous")
    if any(x.dim() != 1 or x.numel() != n for x in obs):
        raise ValueError("obs must be 1-D tensors of one length")
    return n


@functools.cache
def entry():
    """`interpn_unrep_flag` of `csrc/unrep_flag.cu`, built first if needed:
    is_f64, ndims, starts, steps, obs, n, flag, stream."""
    fn = _build.load("unrep_flag").interpn_unrep_flag
    fn.argtypes = [ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP, ctypes.POINTER(_VOIDP),
                   ctypes.c_longlong, _VOIDP, _VOIDP]
    fn.restype = ctypes.c_int
    return fn


def info(dtype) -> dict:
    """Registers a thread, static shared bytes, local (spill) bytes a thread
    and resident blocks an SM of the flag's kernel for `dtype`, on the
    current CUDA device (`interpn_unrep_flag_info`)."""
    fn = _build.load("unrep_flag").interpn_unrep_flag_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    got = (ctypes.c_int * 4)()
    rc = fn(int(dtype == torch.float64), got)
    if rc != 0:
        raise RuntimeError(f"unrep_flag info failed: CUDA error {rc}")
    return dict(zip(("registers", "static_smem", "local_bytes", "blocks_per_sm"), got))


def _kernel(starts, steps, obs, n) -> torch.Tensor:
    """The flag of `n` queries on CUDA tensors: zeroed, then one launch of
    the kernel on the current stream, which sets it where a query is
    unrepresentable; none for n == 0. Counts the launch."""
    global launches
    device = starts.device
    bad = torch.zeros((), dtype=torch.bool, device=device)
    if n == 0:
        return bad
    with torch.cuda.device(device):
        rc = entry()(
            int(starts.dtype == torch.float64), len(obs), starts.data_ptr(), steps.data_ptr(),
            (_VOIDP * len(obs))(*(x.data_ptr() for x in obs)), n, bad.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"unrep_flag launch failed: CUDA error {rc}")
    launches += 1
    return bad
