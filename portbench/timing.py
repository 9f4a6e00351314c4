"""Device time of a call by CUDA events behind a head start.

A frozen copy of the method of the port's `utils/profiling.py::cuda_time`,
kept here so that no change to the program can change how the benchmark
times it. A spin kernel (`torch.cuda._sleep`) ahead of the pass holds the
stream while the host queues the whole pass; the start event, recorded right
after the spin, must still be pending when the host has queued the end
event, else the spin doubles and the pass runs again. When it held
(`ahead`), the events bracket device work and the ~1 us gaps between
back-to-back launches, and no host time. A call that synchronises inside
can never get ahead: after the spin reaches SPIN_MAX cycles (~68 ms at
1.98 GHz) the pass is reported with `ahead` False.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

SPIN_START = 1 << 22  # about 2 ms at 1.98 GHz
SPIN_MAX = 1 << 27


class Timing(NamedTuple):
    seconds: float  # CUDA-event seconds a call in the pass behind the head start
    spin_cycles: int  # the head start that pass was given
    ahead: bool  # True when the host had queued the whole pass before it started


def head_start_time(fn: Callable, args: Sequence, spin: int = SPIN_START) -> Timing:
    """Time fn(a) for a in `args`, back to back, behind a head start, after
    one warm-up call each on the first two. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    for a in args[:2]:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    while True:
        torch.cuda._sleep(spin)
        start.record()
        for a in args:
            fn(a)
        end.record()
        ahead = not start.query()  # the spin still held the stream
        end.synchronize()
        if ahead or spin >= SPIN_MAX:
            return Timing(start.elapsed_time(end) / 1e3 / len(args), spin, ahead)
        spin = min(spin * 2, SPIN_MAX)
