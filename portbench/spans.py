"""The port's own spans in a run's window, for the per-layer metrics that
read them.

The program records spans only while a torch.profiler session records
(`interpn_tpu_torch/utils/tracing.py`), so only a `--trace 1` window has
any. Each record is (span id, start ns, end ns, depth, event slot) on
`time.perf_counter_ns`, the clock the harness stamps its window with.

`window(run)` keeps the records that opened at or after the window's first
call and closed at or before its last synchronise. It gives None where the
checkout's program has no tracing module (a checkout older than the spans),
where the window recorded no `entry` span (an untraced run), or where the
program's ring overwrote records that may lie in the window: a reader then
reports nothing rather than part of a reading.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from types import ModuleType

import numpy as np

MODULE = "interpn_tpu_torch.utils.tracing"


@dataclass
class Spans:
    rows: np.ndarray  # (records, 5) int64, as the program's ring holds them
    steps: int  # steps of the window
    tracing: ModuleType  # the program's tracing module

    def of(self, name: str) -> np.ndarray:
        """The records of the span `name`, oldest first by close."""
        names = self.tracing.SPANS
        if name not in names:
            return self.rows[:0]
        return self.rows[self.rows[:, 0] == names.index(name)]


def window(run) -> Spans | None:
    tracing = sys.modules.get(MODULE)
    if tracing is None:
        return None
    win = run.window
    rows = tracing.RING.between(win.starts[0], win.ends[-1])
    if rows is None:
        return None
    spans = Spans(rows, win.steps, tracing)
    return spans if len(spans.of("entry")) else None


def seconds(rows: np.ndarray) -> float:
    """The host time of the records, summed."""
    return float((rows[:, 2] - rows[:, 1]).sum()) / 1e9


def inside(inner: np.ndarray, outer: np.ndarray) -> np.ndarray:
    """A mask of the `inner` records that lie within some `outer` record
    (outer records of one span on one thread do not overlap)."""
    if not len(inner) or not len(outer):
        return np.zeros(len(inner), dtype=bool)
    outer = outer[np.argsort(outer[:, 1], kind="stable")]
    k = np.searchsorted(outer[:, 1], inner[:, 1], side="right") - 1
    held = k >= 0
    k = np.maximum(k, 0)
    return held & (inner[:, 2] <= outer[k, 2])


def first_within(outer: np.ndarray, inner: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(a mask of the `outer` records within which some `inner` record
    opens, the start of the first inner record that opens at or after each
    outer record's start)."""
    starts = np.sort(inner[:, 1])
    k = np.searchsorted(starts, outer[:, 1], side="left")
    if not len(starts):
        return np.zeros(len(outer), dtype=bool), np.zeros(len(outer), dtype=np.int64)
    first = starts[np.minimum(k, len(starts) - 1)]
    return (k < len(starts)) & (first <= outer[:, 2]), first
