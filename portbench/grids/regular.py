"""The regular grid kind: `dims` nodes an axis, evenly spaced from the
configuration's `starts` to its `stops`. It draws nothing from the seed."""

from __future__ import annotations

import numpy as np
import torch

METHODS = ("linear", "cubic")


def make(cfg: dict, seed: int, np_dtype) -> dict:
    """`starts` and `steps`, one number an axis, in `np_dtype`."""
    starts = np.asarray(cfg["starts"], dtype=np.float64)
    stops = np.asarray(cfg["stops"], dtype=np.float64)
    steps = (stops - starts) / (np.asarray(cfg["dims"], dtype=np.float64) - 1)
    return {"starts": starts.astype(np_dtype), "steps": steps.astype(np_dtype)}


def reference_args(grid: dict, dtype, device) -> tuple:
    """(starts, steps) as the reference's `evaluate` takes them."""
    return tuple(torch.tensor(grid[k].astype(np.float64), device=device).to(dtype)
                 for k in ("starts", "steps"))
