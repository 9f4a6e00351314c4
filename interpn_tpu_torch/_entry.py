"""What the port's entries share, `raw`'s flat functions and the classes
(`models/_device.py`): the device of a call, a dtype's name, and the write
of a result into the caller's `out`.

The reference's checked order, on a regular grid: evaluate, queue the
unrepresentable-coordinate flag (`ops.unrep.flag`), read it to the host,
then copy into `out`, so that `out` is untouched when the call raises.
`write_checked` reads and copies; `copy_into` copies alone, where the
reference raises nothing (rectilinear grids, bounds checks, the spline
methods).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import default_device
from .utils import tracing


def call_device(*arrays) -> torch.device:
    """The one device of the tensors among `arrays`, or
    `config.default_device()` when all are numpy."""
    devices = {a.device for a in arrays if isinstance(a, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(
            f"tensors of one call must share a device, got {sorted(map(str, devices))}"
        )
    return devices.pop() if devices else default_device()


@functools.cache
def dtype_name(dt) -> str:
    """The dtype's name ("float32"); cached, as numpy's `.name` costs
    microseconds on the native engine's small-batch path."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


@tracing.traced(tracing.FINISH)
def copy_into(result: torch.Tensor, out):
    """Write `result` into `out` (a numpy array or a tensor) in place and
    return `out`."""
    if isinstance(out, torch.Tensor):
        out.copy_(result.reshape(out.shape))
    else:
        np.copyto(out, tracing.host_numpy(result).reshape(out.shape))
    return out


def write_checked(result: torch.Tensor, flag: torch.Tensor, out):
    """The reference's "Unrepresentable coordinate value" where `flag`, the
    0-d bool tensor of `ops.unrep.flag`, is set (read to the host here,
    before anything is written); else `copy_into(result, out)`."""
    if tracing.host_bool(flag):
        raise AssertionError("Unrepresentable coordinate value")
    return copy_into(result, out)
