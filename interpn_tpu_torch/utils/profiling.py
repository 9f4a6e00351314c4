"""Device timing over distinct input batches.

Counterpart of `interpn_tpu/utils/profiling.py::device_timeit`. Distinct
batches keep each call from finding its inputs in the 50 MB L2 cache left by
the previous one. There is no CPU fallback: a time from the CPU is not a
device time.

Two timers:

* `cuda_time`, for a kernel: CUDA events around a pass that the device
  starts only after the host has queued all of it. A spin kernel
  (`torch.cuda._sleep`) ahead of the pass holds the stream while the host
  queues; the start event, recorded right after the spin, must still be
  pending when the host has queued the end event, else the spin doubles and
  the pass runs again. The events then bracket device work and the ~1 us
  gaps between back-to-back launches, and no host time. Nothing here reads
  a trace, so nothing can come back short. The spin never exceeds 2^27
  cycles (~68 ms at 1.98 GHz), so a pass that cannot get ahead (a function
  that synchronises) costs a bounded wait and says so.
* `profiled_time`, for a plain version of many small launches, whose queue
  outruns any head start: the sum of the device events that torch.profiler
  records. On an H100 the profiler was seen to drop events anywhere in a
  trace (up to 11 of a pass's 20 kernels, or every event of a one-call
  trace) and to report some long kernels at half their event-timed
  duration, so it serves only the plain versions' times, which are many
  short kernels. The time is scaled by the events recorded, not by the
  calls made, and a pass that recorded none runs again, at most three times
  in all.

Neither timer catches an exception of the timed function, and neither raises
for a timing that failed: the result says how far the timing got.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

PROFILER_TRIES = 3
_SPIN_MAX = 1 << 27
# Cycles of the head-start spin; doubled for the process, up to _SPIN_MAX,
# whenever a pass found it too short (2^22 cycles is about 2 ms at 1.98 GHz).
_spin_cycles = 1 << 22


class Timing(NamedTuple):
    device_ms: float  # CUDA-event time per call of the pass behind the head start
    loop_ms: float  # CUDA-event time per call of a back-to-back loop, host included
    spin_cycles: int  # the head start that pass was given
    ahead: bool  # True when the host had queued the whole pass before it started


class Profiled(NamedTuple):
    device_ms: float | None  # device time per call; None when nothing was recorded
    events: int  # device events recorded in the pass used
    per_call: int  # device events one call launches, rounded from that pass
    tries: int  # passes profiled, at most PROFILER_TRIES


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")


def cuda_time(fn: Callable, batches: Sequence, *, warmup: int = 2) -> Timing:
    """Time fn(batch) over `batches` on the current CUDA stream.

    `device_ms` is the event time of the pass behind a head start, per
    call; `ahead` says whether the head start held (else it did not at
    _SPIN_MAX cycles either, and the time includes host gaps). `loop_ms` is
    the event time of a plain back-to-back loop: what a caller sees, host
    included.
    """
    global _spin_cycles
    _require_cuda()
    for b in batches[:warmup]:
        fn(b)
    torch.cuda.synchronize()
    n = len(batches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches:
        fn(b)
    end.record()
    end.synchronize()
    loop_ms = start.elapsed_time(end) / n
    while True:
        cycles = _spin_cycles
        torch.cuda._sleep(cycles)
        start.record()
        for b in batches:
            fn(b)
        end.record()
        ahead = not start.query()  # the spin still held the stream
        end.synchronize()
        if ahead or cycles >= _SPIN_MAX:
            break
        _spin_cycles = min(cycles * 2, _SPIN_MAX)
    return Timing(start.elapsed_time(end) / n, loop_ms, cycles, ahead)


def _device_events(run: Callable[[], None]) -> tuple[int, float]:
    """(device events, their summed microseconds) that torch.profiler
    records while `run()` runs; operator rows repeat their kernels' time and
    are left out."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)


def profiled_time(fn: Callable, batches: Sequence, *, warmup: int = 2) -> Profiled:
    """Device time per call of fn(batch) over `batches`, from the device
    events torch.profiler records: their summed time over the events
    recorded, times the events of one call (the recorded events over the
    calls, rounded; at least 1). A pass that recorded no event runs again,
    at most PROFILER_TRIES times in all.
    """
    _require_cuda()
    for b in batches[:warmup]:
        fn(b)
    torch.cuda.synchronize()
    n = len(batches)

    def run():
        for b in batches:
            fn(b)

    for tries in range(1, PROFILER_TRIES + 1):
        events, device_us = _device_events(run)
        if events:
            per_call = max(1, round(events / n))
            return Profiled(device_us / 1e3 / events * per_call, events, per_call, tries)
    return Profiled(None, 0, 0, tries)
