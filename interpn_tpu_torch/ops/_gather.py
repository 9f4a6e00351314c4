"""Flat gathers of the corner stencil.

Counterpart of `interpn_tpu/ops/_gather.py`. Stencil indices are in range by
construction (cell locations are clamped to the grid before offsets are
added), so plain indexing serves. The TPU-only one-hot band of
`take_small` has no counterpart: a GPU gathers per thread.
"""

from __future__ import annotations

import torch

from ..utils import corner_offsets


def take1(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[idx] for flat `vals` and integer `idx` of any shape."""
    return vals[idx]


def gather_corners(vals, base, dims, footprint: int) -> list[torch.Tensor]:
    """The full footprint**ndims corner stencil as a list of flat gathers,
    in the reference's vertex order (dim 0 in the lowest digit)."""
    offs = corner_offsets(dims, footprint)
    return [take1(vals, base if o == 0 else base + int(o)) for o in offs]


def gather_corners_matrix(vals, base, dims, footprint: int) -> torch.Tensor:
    """The corner stencil as one (footprint**ndims, *base.shape) tensor,
    vertex-major, in the same vertex order as `gather_corners`."""
    offs = torch.from_numpy(corner_offsets(dims, footprint)).to(base.device)
    return take1(vals, offs.reshape(-1, *([1] * base.dim())) + base)
