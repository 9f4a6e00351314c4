"""The port's persistent class for a configuration, built from the
problem's host copy of its one table: what the class entries time."""

from __future__ import annotations


def model(problem):
    """MultilinearRegular or MulticubicRegular over the problem's grid and
    first table, as a user builds it with `.new()` from numpy arrays."""
    from interpn_tpu_torch.models import MulticubicRegular, MultilinearRegular

    vals = problem.tables[0].cpu().numpy()
    dims = list(problem.dims)
    if problem.method == "linear":
        return MultilinearRegular.new(dims, problem.starts, problem.steps, vals)
    return MulticubicRegular.new(dims, problem.starts, problem.steps, vals,
                                 linearize_extrapolation=problem.linearize)
