"""Device timing over distinct input batches.

Counterpart of `interpn_tpu/utils/profiling.py::device_timeit`. Distinct
batches keep each call from finding its inputs in the 50 MB L2 cache left by
the previous one. There is no CPU fallback: a time from the CPU is not a
device time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


class Timing(NamedTuple):
    device_ms: float  # device time of the work fn launched, per call
    loop_ms: float  # CUDA-event time per call of a back-to-back loop


def cuda_time(fn: Callable, batches: Sequence, *, warmup: int = 2) -> Timing:
    """Time fn(batch) over `batches` on the current CUDA stream.

    `device_ms` sums the durations of the device work fn launched (kernels
    and copies, as torch.profiler's own table totals them), so it leaves out
    any time the device waits for the host. `loop_ms` is the time between
    CUDA events around a loop that issues the calls back to back: what a
    caller sees, host overhead included.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    for b in batches[:warmup]:
        fn(b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches:
        fn(b)
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
    # device-side events only: an operator's row repeats its kernels' time
    device_us = sum(
        e.self_device_time_total
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    if device_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    n = len(batches)
    return Timing(device_ms=device_us / 1e3 / n, loop_ms=start.elapsed_time(end) / n)
