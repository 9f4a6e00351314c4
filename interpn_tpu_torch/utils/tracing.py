"""Spans inside the port, on the profiler's clock.

What the port reports about itself, in one place:

* `ops.fused.launches`: the launch counter, one count a wrapper launch by
  kernel name, layout launches (pack, cubic pack, interleave) included;
  `fused.reset_launches()` zeroes it. It counts always.
* `ops.unrep.launches`: the unrepresentable-value flag's kernel launches
  (`csrc/unrep_flag.cu`), kept apart from `ops.fused.launches`. It counts
  always.
* the spans below, recorded only while a `torch.profiler` session records.

**Switch.** Each span is declared once, by the decorator `traced(sid)` on
the function it brackets; this module alone tests the switch. A call of a
traced function tests `profiler._is_profiler_enabled`: torch's own
module-level bool (`torch.autograd.profiler`), True while a profiler
session records. With no profiler open the call costs that one attribute
test and the wrapper's frame, and goes on: no clock read, no allocation, no
profiler range. Nothing records while a graph is traced
(`torch.compiler.is_compiling()`, which `torch.export` sets), so a span
adds no node to an exported program. The reads of a device value to the
host are traced here too, `host_bool` and `host_numpy`, so that the port
reads the device through them alone.

**On.** A span does two things:

1. At its close it writes (span id, start ns, end ns, depth, event slot)
   into `RING`, a preallocated ring of `CAPACITY` records; both stamps
   come from `time.perf_counter_ns`, the clock a caller stamps its own
   window with. Depth is the number of spans open around it on its
   thread; the event slot is -1 but for `unrep_flag` on a CUDA tensor.
2. It opens a profiler range named `interpn.<span>`
   (`torch._C._profiler._RecordFunctionFast`, a fraction of
   `record_function`'s cost), so that the port's phases sit on the trace
   beside the kernels they launch, on the host's timeline only.

Only the outermost `entry` records: a class method calls an `ops`
evaluator, which opens no second `entry` inside it.

**The spans**, from the entry down (a call of an `ops` evaluator from a
class method nests them in this order):

| Span | Brackets |
|---|---|
| `entry` | the public call: the classes' `eval_torch`, `eval_unchecked`, `gradient_torch`; the `ops` evaluators of one table (`ops/dispatch.py::_regular`, `_rect_route`, `bspline_eval`) and of a stack (`ops/stack.py`); `raw`'s evaluators (`_interpn_regular`, `_interpn_rectilinear`) |
| `checks` | `eval_torch` / `eval_unchecked`: size, dtype and grid checks, the native engine's test, the queries to the device, the cached tensors (`_torch_inputs`, `_out_inputs`) |
| `unrep_flag` | `ops.unrep.flag`: on a CUDA tensor the flag's zeroing and its kernel's launch (`csrc/unrep_flag.cu`), and a pair of CUDA events around them, its device time; on a CPU tensor its plain passes |
| `sync` | a read of a device value to the host, `host_bool` or `host_numpy`: the flag's read in `_entry.write_checked`, a copy into a numpy `out`, a tensor grid's checks in `raw`, the f64 engines' table caches; their count is the host-sync counter |
| `finish` | `_entry.copy_into`, the copy into `out` |
| `dispatch` | `ops/dispatch.py::_route`: `KernelRoute.apply` and the custom op's dispatcher down to the wrapper (on a CPU tensor, the gather tree) |
| `wrapper` | the kernel wrappers `fused._regular`, `_rectilinear`, `_bspline` and the f64 engines' `eval_*` |
| `route` | the route choice, `fused._chosen`, with the free-bytes query it takes (CUDA only) |
| `launch` | the ctypes call of every launch in `ops/fused.py` (`fused._launcher`), layout launches included |

**Reading.** `RING.between(lo, hi)` gives the records that opened at or
after `lo` and closed at or before `hi`, or None where the ring has
overwritten records that may lie in that window (it never gives part of
one). `RING.device_ns(rows)` gives each record's device time: its CUDA
events' elapsed time where it recorded events, else its host duration (on
a CPU tensor the host runs the passes); None where an event pair was
reused since.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

import numpy as np
import torch

SPANS = ("entry", "checks", "unrep_flag", "sync", "finish", "dispatch", "wrapper", "route",
         "launch")
ENTRY, CHECKS, UNREP_FLAG, SYNC, FINISH, DISPATCH, WRAPPER, ROUTE, LAUNCH = range(len(SPANS))
RANGES = tuple(f"interpn.{name}" for name in SPANS)
FIELDS = ("span", "start_ns", "end_ns", "depth", "event_slot")
CAPACITY = 1 << 20
EVENT_PAIRS = 1 << 14  # CUDA event pairs a device at most, then reused in turn


# the switch `traced` tests: `profiler._is_profiler_enabled`
profiler = torch.autograd.profiler
_RANGE = torch._C._profiler._RecordFunctionFast
_compiling = torch.compiler.is_compiling
_clock = time.perf_counter_ns


class Ring:
    """The last `capacity` closed spans: a (capacity, len(FIELDS)) int64
    table, written in the order the spans close, with no allocation a
    span (numpy's zeros are mapped as they are first written)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.table = np.zeros((capacity, len(FIELDS)), dtype=np.int64)
        self._cells = memoryview(self.table.reshape(-1))
        self._numbers = itertools.count()  # hands each record its number, atomically
        # records written since the process started (written by the last
        # writer: it may lag by a record while two threads write at once)
        self.written = 0
        self.events: dict[int, _EventPool] = {}  # by CUDA device index

    def write(self, sid: int, start: int, end: int, depth: int, slot: int) -> None:
        """Write one record."""
        number = next(self._numbers)
        self.written = number + 1
        k = number % self.capacity * len(FIELDS)
        cells = self._cells
        cells[k] = sid
        cells[k + 1] = start
        cells[k + 2] = end
        cells[k + 3] = depth
        cells[k + 4] = slot

    @property
    def overwritten(self) -> int:
        """Records overwritten since the process started."""
        return max(0, self.written - self.capacity)

    def kept(self) -> np.ndarray:
        """The records kept, oldest first (a view where none was
        overwritten)."""
        if not self.overwritten:
            return self.table[:self.written]
        cut = self.written % self.capacity
        return np.concatenate([self.table[cut:], self.table[:cut]])

    def between(self, lo: int, hi: int) -> np.ndarray | None:
        """The records that opened at or after `lo` and closed at or before
        `hi` (perf_counter_ns), oldest first; None where a record closed at
        or after `lo` may have been overwritten."""
        rows = self.kept()
        if self.overwritten and (not len(rows) or lo <= int(rows[0, 2])):
            return None
        return rows[(rows[:, 1] >= lo) & (rows[:, 2] <= hi)]

    def device_ns(self, rows: np.ndarray) -> np.ndarray | None:
        """Each record's device time in ns: its CUDA events' elapsed time
        where it took an event slot, else its host duration; None where an
        event pair was reused since the record was written."""
        out = (rows[:, 2] - rows[:, 1]).astype(np.float64)
        for j in np.flatnonzero(rows[:, 4] >= 0):
            start, slot = int(rows[j, 1]), int(rows[j, 4])
            pool = next((p for p in self.events.values() if p.owner[slot] == start), None)
            if pool is None:
                return None
            out[j] = pool.elapsed_ns(slot)
        return out


class _EventPool:
    """Up to `size` pairs of timing events on one CUDA device, made as the
    spans first need them and then taken again in turn; `owner[slot]` is
    the start stamp of the record that last used the pair (-1 while its
    span is open)."""

    def __init__(self, size: int = EVENT_PAIRS):
        self.size = size
        self.pairs: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.owner = np.full(size, -1, dtype=np.int64)
        self.taken = 0

    def take(self) -> int:
        slot = self.taken % self.size
        self.taken += 1
        if slot == len(self.pairs):
            self.pairs.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
        self.owner[slot] = -1
        return slot

    def elapsed_ns(self, slot: int) -> float:
        start, end = self.pairs[slot]
        return start.elapsed_time(end) * 1e6


RING = Ring()


class _Open(threading.local):
    def __init__(self):
        self.state = [0, False]  # [spans open, an `entry` span open] on this thread


_OPEN = _Open()


def _enter(sid: int) -> int:
    """The depth of span `sid` opening now on this thread, counted open; -1
    where it records nothing (an `entry` inside an `entry`, or a graph
    being traced)."""
    state = _OPEN.state
    entry = sid == ENTRY
    if (entry and state[1]) or _compiling():
        return -1
    if entry:
        state[1] = True
    depth = state[0]
    state[0] = depth + 1
    return depth


def _leave(sid: int, depth: int) -> None:
    state = _OPEN.state
    state[0] = depth
    if sid == ENTRY:
        state[1] = False


def traced(sid: int, events: bool = False):
    """Decorator: the function runs inside span `sid` while a profiler
    records, and as it is otherwise. The switch,
    `profiler._is_profiler_enabled`, is read at each call. Keyword
    arguments pass through, and `functools.wraps` keeps the function's
    name, docstring and signature. With `events` (the one span whose device
    time is read, `unrep_flag`) the span also records a pair of CUDA events
    around the work the function queues, where its first argument is a
    CUDA tensor."""

    def decorate(fn):
        @functools.wraps(fn)
        def traced_fn(*args, **kwargs):
            if not profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            if events:
                with _Span(sid, args[0].device):
                    return fn(*args, **kwargs)
            return _call(sid, fn, args, kwargs)

        return traced_fn

    return decorate


def _call(sid: int, fn, args, kwargs):
    """fn(*args, **kwargs) inside span `sid`."""
    depth = _enter(sid)
    if depth < 0:
        return fn(*args, **kwargs)
    rng = _RANGE(RANGES[sid])
    rng.__enter__()
    start = _clock()
    try:
        return fn(*args, **kwargs)
    finally:
        end = _clock()
        rng.__exit__(None, None, None)
        RING.write(sid, start, end, depth, -1)
        _leave(sid, depth)


class _Span:
    """Span `sid` as a context manager, as `_call` records it. `device`:
    the device whose work the span brackets; on a CUDA device it records a
    pair of events there, around the work the span's code queues."""

    __slots__ = ("sid", "device", "depth", "start", "range", "pool", "slot", "stream")

    def __init__(self, sid: int, device: torch.device):
        self.sid = sid
        self.device = device

    def __enter__(self):
        self.depth = depth = _enter(self.sid)
        if depth < 0:
            return self
        self.pool = None
        self.slot = -1
        dev = self.device
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            pool = RING.events.get(index)
            if pool is None:
                pool = RING.events[index] = _EventPool()
            self.pool, self.slot = pool, pool.take()
            self.stream = torch.cuda.current_stream(index)
            pool.pairs[self.slot][0].record(self.stream)
        self.range = _RANGE(RANGES[self.sid])
        self.range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        if self.depth < 0:
            return False
        end = _clock()
        self.range.__exit__(None, None, None)
        if self.pool is not None:
            self.pool.pairs[self.slot][1].record(self.stream)
            self.pool.owner[self.slot] = self.start
        RING.write(self.sid, self.start, end, self.depth, self.slot)
        _leave(self.sid, self.depth)
        return False


# The port's reads of a device value to the host, each in a `sync` span:
# their count is the host-sync counter. `host_bool` is `bool` itself
# behind the switch.
host_bool = traced(SYNC)(bool)


@traced(SYNC)
def host_numpy(t: torch.Tensor) -> np.ndarray:
    """`t` copied to the host as a numpy array."""
    return t.detach().cpu().numpy()
