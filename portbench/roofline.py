"""The least time one step's work can take on one H100 SXM: a frozen count.

The count belongs to the method and the shapes, not to an implementation,
so it stays the same whatever kernel computes the step. A step evaluates
`tables` tables of `dims` at `queries` queries. Its least time is the larger
of two times:

* bytes: each query coordinate, table entry and grid parameter (start and
  step an axis) read once and each result written once, at PEAK_BYTES_S;
* operations: the least work of the separable method at the dtype's peak,
  counting a multiply-add as two operations:
  - per query and axis, the cell and its weights (AXIS_FLOPS, derived
    below); one reciprocal of the step per axis and call is left out;
  - per query and table, the contraction of the w^N stencil with the axes'
    weights, one axis at a time: w^N + w^(N-1) + ... + w multiply-adds
    (sum of w^k for k = 1..N; w = 2 linear, 4 cubic).

Per-axis operations, each the fewest a query needs:
* linear, 5: u = (x - start) * (1/step) (2), floor (1), t = u - floor (1),
  1 - t (1). Clamping the cell for extrapolated queries is left out.
* cubic, 18: the same index and t (4); t^2 and t^3 (2); Catmull-Rom's four
  weights from them with shared terms: w3 = (t^3 - t^2) / 2 (2),
  w0 = t^2 - (t^3 + t) / 2 (3), w1 = 1.5 t^3 - 2.5 t^2 + 1 (4),
  w2 = 1 - w0 - w1 - w3 (3). The edge cells' selects are left out.
Leaving work out can only lower the least time, so a share of it never
overstates how close a step came to the chip's limit.

Peaks: NVIDIA's H100 SXM data sheet, dense: 3.35 TB/s of HBM3; 67 TFLOP/s
float32 outside the tensor cores; 67 TFLOP/s float64 on the tensor cores,
the highest rate at which any implementation could do float64 work. They
assume the card's full 700 W limit.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}
WIDTH = {"linear": 2, "cubic": 4}
AXIS_FLOPS = {"linear": 5, "cubic": 18}


def step_bytes(dims, dtype: str, tables: int, queries: int) -> int:
    """Bytes one step must move: queries' coordinates and results, the
    tables and the grid's starts and steps, each once."""
    size = ITEMSIZE[dtype]
    nd = len(dims)
    return size * (queries * (nd + tables) + tables * math.prod(dims) + 2 * nd)


def stencil_macs(nd: int, method: str) -> int:
    """Multiply-adds of one table's contraction at one query."""
    w = WIDTH[method]
    return sum(w**k for k in range(1, nd + 1))


def step_flops(dims, method: str, tables: int, queries: int) -> int:
    """Operations one step must do (a multiply-add counts two)."""
    nd = len(dims)
    return queries * (nd * AXIS_FLOPS[method] + tables * 2 * stencil_macs(nd, method))


def least(dims, method: str, dtype: str, tables: int, queries: int) -> tuple[float, str]:
    """(least seconds of one step, "bytes" or "operations": which bounds it)."""
    by_bytes = step_bytes(dims, dtype, tables, queries) / PEAK_BYTES_S
    by_flops = step_flops(dims, method, tables, queries) / PEAK_FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "operations")
