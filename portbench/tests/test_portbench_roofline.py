"""The frozen count of portbench/roofline.py on hand-worked cases."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import roofline  # noqa: E402


def test_linear_3d_f32_bytes():
    # 3 coordinates in and 1 result out at 4 bytes: 16 bytes a query; the
    # 20^3 table and 3 starts and 3 steps once
    assert roofline.step_bytes((20, 20, 20), "float32", 1, 1) == 16 + 8000 * 4 + 6 * 4
    assert roofline.step_bytes((20, 20, 20), "float32", 1, 10**8) == 16 * 10**8 + 32024


def test_cubic_4d_contraction():
    # 4^4 + 4^3 + 4^2 + 4 multiply-adds a table
    assert roofline.stencil_macs(4, "cubic") == 340
    assert roofline.stencil_macs(3, "linear") == 14
    # per query: 4 axes x 18 operations, and 340 multiply-adds at 2 per table
    assert roofline.step_flops((20,) * 4, "cubic", 8, 1) == 4 * 18 + 8 * 680


@pytest.mark.parametrize("dims,method,dtype,tables,queries,bound,seconds", [
    ((20, 20, 20), "linear", "float32", 1, 10**8, "bytes", 1.6e9 / 3.35e12),
    ((20,) * 4, "cubic", "float64", 1, 10**7, "bytes", (4e8 + 160000 * 8 + 64) / 3.35e12),
    ((20,) * 4, "cubic", "float64", 8, 10**6, "operations", 10**6 * (72 + 8 * 680) / 67e12),
])
def test_least_time(dims, method, dtype, tables, queries, bound, seconds):
    got, by = roofline.least(dims, method, dtype, tables, queries)
    assert by == bound
    assert got == pytest.approx(seconds, rel=1e-3)
