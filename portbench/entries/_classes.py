"""The port's persistent class for a configuration, built from the
problem's host copy of its one table: what the class entries time."""

from __future__ import annotations

from pathlib import Path


def model(problem):
    """The class of the problem's grid kind and method over its grid and
    first table, as a user builds it with `.new()` from numpy arrays."""
    from interpn_tpu_torch import models

    vals = problem.tables[0].cpu().numpy()
    dims, grid, lin = list(problem.dims), problem.arrays, problem.linearize
    build = {
        ("regular", "linear"): lambda: models.MultilinearRegular.new(
            dims, grid["starts"], grid["steps"], vals),
        ("regular", "cubic"): lambda: models.MulticubicRegular.new(
            dims, grid["starts"], grid["steps"], vals, linearize_extrapolation=lin),
        ("rectilinear", "linear"): lambda: models.MultilinearRectilinear.new(
            list(grid["coords"]), vals),
        ("rectilinear", "cubic"): lambda: models.MulticubicRectilinear.new(
            list(grid["coords"]), vals, linearize_extrapolation=lin),
    }
    return build[Path(problem.grid.__file__).stem, problem.method]()  # grids/<kind>.py
