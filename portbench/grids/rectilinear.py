"""The rectilinear grid kind: strictly increasing nodes an axis, drawn from
the seed by the configuration's `axes` recipe.

`{"kind": "jittered", "jitter": j}`, 0 <= j < 1: with h = (stop - start) /
(dim - 1), node k is start + (k + u_k) h, where u is 0 at both ends and
uniform in [-j/2, j/2] inside, so neighbours stay at least (1 - j) h apart;
`jitter` 0 gives the regular nodes. The draws come from a numpy stream of
the grid's own, never from the generator that draws the tables and the
queries.
"""

from __future__ import annotations

import numpy as np
import torch

METHODS = ("linear", "cubic")
STREAM = 0x72656374  # the nodes' stream beside the seed: b"rect"


def make(cfg: dict, seed: int, np_dtype) -> dict:
    """`coords`: one strictly increasing array an axis, in `np_dtype`."""
    axes = cfg["axes"]
    if axes["kind"] != "jittered":
        raise ValueError(f"no axes recipe {axes['kind']!r}")
    jitter = float(axes["jitter"])
    if not 0 <= jitter < 1:
        raise ValueError(f"jitter {jitter} is outside [0, 1)")
    rng = np.random.default_rng((seed % 2**64, STREAM))
    coords = []
    for start, stop, dim in zip(cfg["starts"], cfg["stops"], cfg["dims"]):
        dim = int(dim)
        h = (float(stop) - float(start)) / (dim - 1)
        u = np.zeros(dim)
        u[1:-1] = rng.uniform(-jitter / 2, jitter / 2, dim - 2)
        x = (float(start) + (np.arange(dim) + u) * h).astype(np_dtype)
        if not np.all(np.diff(x) > 0):
            raise ValueError(f"nodes not strictly increasing in {np_dtype}: {x}")
        coords.append(x)
    return {"coords": coords}


def reference_args(grid: dict, dtype, device) -> tuple:
    """(coords,) as the reference's `evaluate` takes them: a list of 1-D
    tensors."""
    return ([torch.tensor(c.astype(np.float64), device=device).to(dtype)
             for c in grid["coords"]],)
