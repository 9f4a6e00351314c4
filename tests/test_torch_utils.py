"""The port's `utils` against `interpn_tpu.utils` on the CPU: `linspace` and
`meshgrid` on the axes that `tests/test_ops_properties.py` builds (its
observation meshes and its grids, 1-6D), bitwise, and the stride and
stencil helpers the port copied earlier."""

from __future__ import annotations

import numpy as np
import pytest

from interpn_tpu import utils as jutils

from interpn_tpu_torch import utils as tutils


def _obs_axes(ndims, n_per_axis, lo=-7.0, hi=7.0):
    """The axes of `test_ops_properties._obs_mesh`."""
    return [(lo * i, hi * (i + 1), n_per_axis) for i in range(ndims)]


def _grid_axes(ndims, n):
    """The grid axes of `test_ops_properties` (linspace(-5 i, 5 (i + 1), n))."""
    return [(-5.0 * i, 5.0 * (i + 1), n) for i in range(ndims)]


CASES = [(f"obs-{nd}d-{n}", _obs_axes(nd, n)) for nd in range(1, 7) for n in (3, 5)]
CASES += [(f"grid-{nd}d-{n}", _grid_axes(nd, n)) for nd in range(1, 7) for n in (2, 4)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,axes", CASES, ids=[c[0] for c in CASES])
def test_linspace_and_meshgrid_match_jax(name, axes, dtype):
    got = [tutils.linspace(*a, dtype=dtype) for a in axes]
    want = [jutils.linspace(*a, dtype=dtype) for a in axes]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        np.testing.assert_array_equal(g, w)
    pts, ref = tutils.meshgrid(got), jutils.meshgrid(want)
    assert pts.shape == ref.shape == (int(np.prod([a[2] for a in axes])), len(axes))
    assert pts.dtype == ref.dtype
    np.testing.assert_array_equal(pts, ref)


def test_meshgrid_is_the_c_order_of_vals():
    """Row i of meshgrid is grid point i in C order, the layout of every
    `vals` table: vals = f(meshgrid) reshaped to dims is f on the grid."""
    axes = [tutils.linspace(0.0, 1.0, 3), tutils.linspace(-2.0, 2.0, 5)]
    pts = tutils.meshgrid(axes)
    table = (pts[:, 0] * 10 + pts[:, 1]).reshape(3, 5)
    np.testing.assert_array_equal(table, axes[0][:, None] * 10 + axes[1][None, :])


@pytest.mark.parametrize("dims", [(2,), (3, 4), (4, 5, 6), (2, 3, 2, 3)])
@pytest.mark.parametrize("footprint", [2, 4])
def test_stride_helpers_match_jax(dims, footprint):
    assert tutils.c_strides(dims) == jutils.c_strides(dims)
    assert tutils.nvals(dims) == jutils.nvals(dims)
    np.testing.assert_array_equal(tutils.corner_offsets(dims, footprint),
                                  jutils.corner_offsets(dims, footprint))
