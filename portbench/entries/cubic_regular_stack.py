"""`ops.cubic_regular_stack`: a stack of tables on one grid (a property set
evaluated at each point), one (T, n) result a call."""

from __future__ import annotations

import torch

OUT = False


def build(problem):
    from interpn_tpu_torch import ops

    dev, dt = problem.tables.device, problem.tables.dtype
    starts = torch.as_tensor(problem.starts, dtype=dt, device=dev)
    steps = torch.as_tensor(problem.steps, dtype=dt, device=dev)
    tables = problem.tables
    dims = list(problem.dims)
    lin = problem.linearize
    return lambda obs, out: ops.cubic_regular_stack(dims, starts, steps, tables, obs, lin)
