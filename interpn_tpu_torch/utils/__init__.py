"""Small numeric helpers shared across the port.

Copies of `interpn_tpu.utils` (stride and stencil helpers, and the grid
samplers `linspace` and `meshgrid`). They are numpy only, but importing
`interpn_tpu` would import jax, so the port keeps its own copy.
"""

from __future__ import annotations

import math

import numpy as np


def c_strides(dims: tuple[int, ...]) -> tuple[int, ...]:
    """C-order strides (in elements) for a grid with shape `dims`:
    stride[k] = prod(dims[k+1:])."""
    ndims = len(dims)
    strides = [1] * ndims
    acc = 1
    for k in range(ndims - 1, -1, -1):
        strides[k] = acc
        acc *= dims[k]
    return tuple(strides)


def nvals(dims: tuple[int, ...]) -> int:
    """Total number of grid points."""
    return math.prod(dims)


def corner_offsets(dims: tuple[int, ...], footprint: int) -> np.ndarray:
    """Flat C-order index offsets of the full corner stencil.

    Offset of vertex i is sum_k digit_k(i) * stride_k, where digit_k is the
    k-th base-`footprint` digit of i: dim 0 occupies the lowest digit, the
    reference's vertex order. Returns an int32 array of shape
    (footprint**ndims,).
    """
    ndims = len(dims)
    strides = c_strides(dims)
    verts = np.arange(footprint**ndims, dtype=np.int64)
    out = np.zeros(verts.shape[0], dtype=np.int64)
    for k in range(ndims):
        digit = (verts // footprint**k) % footprint
        out += digit * strides[k]
    return out.astype(np.int32)


def linspace(start: float, stop: float, n: int, dtype=np.float64) -> np.ndarray:
    """Evenly spaced samples, inclusive of both endpoints."""
    return np.linspace(start, stop, n, dtype=dtype)


def meshgrid(axes: list[np.ndarray]) -> np.ndarray:
    """C-order (indexing='ij') tensor-product coordinates.

    Returns an array of shape (prod(len(a) for a in axes), ndims) listing every
    grid point's coordinates in C order — the layout assumed by all `vals`
    arrays. Equivalent to the reference's `utils::meshgrid` (`src/utils.rs`).
    """
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)
