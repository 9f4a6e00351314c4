"""Grid-cell location on regular grids, vectorized over query batches.

Counterpart of `interpn_tpu/ops/locate.py::locate_regular_linear`, with the
same operation order, so that both packages compute the same cell and the
same normalized coordinate bit for bit.
"""

from __future__ import annotations

import torch


def locate_regular_linear(x, start, step, dim: int):
    """Lower corner + normalized coordinate for a 2-point stencil.

    loc = floor((x - start) / step) clamped to [0, dim-2]; t is measured from
    the clamped cell origin, so extrapolation shows as t outside [0, 1].

    NaN queries map to cell 0 before the int cast (a NaN cast to int32 is
    INT_MIN on the CPU), so they read in bounds and give t = NaN, as JAX's
    saturating cast does.
    """
    floc = torch.floor((x - start) / step)
    floc = torch.where(torch.isnan(floc), torch.zeros_like(floc), floc)
    loc = torch.clamp(floc, 0.0, float(max(dim - 2, 0))).to(torch.int32)
    t = (x - (start + step * loc.to(x.dtype))) / step
    return loc, t
