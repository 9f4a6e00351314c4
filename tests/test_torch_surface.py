"""The port's `ops` surface against the JAX package's on the CPU: every
evaluator takes the keyword-only `vals_finite`, `ops.__all__` covers the
JAX package's, the package's `__all__` equals the JAX package's, and the
forced f64 engines' per-table caches see an in-place update of a tensor
table.

Tolerance: the two packages' gather trees run the same operations in the
same order in float64, but XLA:CPU may contract a multiply-add into an FMA,
so values agree within rtol = atol = 1e-12, not bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu
import jax.numpy as jnp
from interpn_tpu import ops as jops
import interpn_tpu_torch
from interpn_tpu_torch import config
from interpn_tpu_torch import ops as tops
from interpn_tpu_torch.ops import df64, i8

DIMS = (5, 6, 4)
NCH = 3


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _inputs(seed=0, n=200):
    """A regular grid, its axes as a rectilinear grid, a stack of NCH tables
    and queries reaching past each side of the grid."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(DIMS))
    steps = rng.uniform(0.3, 1.0, len(DIMS))
    grids = [s + h * np.arange(d) for s, h, d in zip(starts, steps, DIMS)]
    stack = rng.standard_normal((NCH, math.prod(DIMS)))
    obs = [rng.uniform(g[0] - 1, g[-1] + 1, n) for g in grids]
    return starts, steps, grids, stack, obs


def _calls(starts, steps, grids, stack, obs, knots, coeffs):
    """(name, port call, JAX call) per evaluator, each taking the `vals_finite`
    keywords as a dict; the JAX package's B-spline evaluators take none."""
    t, j = (lambda a: torch.from_numpy(np.asarray(a))), jnp.asarray
    dims = DIMS
    cases = []
    for m, lin in (("linear", ()), ("nearest", ()), ("cubic", (True,))):
        cases.append((f"{m}_regular",
                      lambda kw, m=m, lin=lin: getattr(tops, f"{m}_regular")(
                          dims, t(starts), t(steps), t(stack[0]), tuple(map(t, obs)), *lin, **kw),
                      lambda kw, m=m, lin=lin: getattr(jops, f"{m}_regular")(
                          dims, j(starts), j(steps), j(stack[0]), tuple(map(j, obs)), *lin, **kw)))
        cases.append((f"{m}_rectilinear",
                      lambda kw, m=m, lin=lin: getattr(tops, f"{m}_rectilinear")(
                          tuple(map(t, grids)), t(stack[0]), tuple(map(t, obs)), *lin, **kw),
                      lambda kw, m=m, lin=lin: getattr(jops, f"{m}_rectilinear")(
                          tuple(map(j, grids)), j(stack[0]), tuple(map(j, obs)), *lin, **kw)))
        cases.append((f"{m}_regular_stack",
                      lambda kw, m=m, lin=lin: getattr(tops, f"{m}_regular_stack")(
                          dims, t(starts), t(steps), t(stack), tuple(map(t, obs)), *lin, **kw),
                      lambda kw, m=m, lin=lin: getattr(jops, f"{m}_regular_stack")(
                          dims, j(starts), j(steps), j(stack), tuple(map(j, obs)), *lin, **kw)))
        cases.append((f"{m}_rectilinear_stack",
                      lambda kw, m=m, lin=lin: getattr(tops, f"{m}_rectilinear_stack")(
                          tuple(map(t, grids)), t(stack), tuple(map(t, obs)), *lin, **kw),
                      lambda kw, m=m, lin=lin: getattr(jops, f"{m}_rectilinear_stack")(
                          tuple(map(j, grids)), j(stack), tuple(map(j, obs)), *lin, **kw)))
    from interpn_tpu.ops import bspline as jbspline

    cases.append(("bspline_eval",
                  lambda kw: tops.bspline_eval(tuple(map(t, knots)), t(coeffs[:, 0]),
                                               tuple(map(t, obs)), 3, **kw),
                  lambda kw: jops.bspline_eval(tuple(map(j, knots)), j(coeffs[:, 0]),
                                               tuple(map(j, obs)), 3)))
    cases.append(("bspline_eval_stack",
                  lambda kw: tops.bspline_eval_stack(tuple(map(t, knots)), t(coeffs.T.copy()),
                                                     tuple(map(t, obs)), 3, **kw),
                  lambda kw: jbspline.bspline_eval_stack(
                      tuple(map(j, knots)), j(coeffs.T.copy()), tuple(map(j, obs)), 3)))
    return cases


def _all_cases():
    starts, steps, grids, stack, obs = _inputs()
    knots, coeffs = tops.prep_bspline(grids, stack.T, 3)
    return _calls(starts, steps, grids, stack, obs, knots, coeffs)


@pytest.mark.parametrize("vals_finite", [None, True, False])
def test_every_evaluator_takes_vals_finite(vals_finite):
    """Each of the port's fourteen evaluators (seven single-table, seven
    stacks) takes `vals_finite` by keyword, ignores it, and agrees with the
    JAX package's evaluator given the same flag."""
    cases = _all_cases()
    assert len(cases) == 14
    for name, port, jax_call in cases:
        kw = {"vals_finite": vals_finite}
        got = port(kw).numpy()
        np.testing.assert_array_equal(got, port({}).numpy(), err_msg=name)
        want = np.asarray(jax_call({} if name.startswith("bspline") else kw))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=name)


def test_vals_finite_is_keyword_only():
    starts, steps, _, stack, obs = _inputs()
    t = torch.from_numpy
    with pytest.raises(TypeError):
        tops.linear_regular(DIMS, t(starts), t(steps), t(stack[0]),
                            tuple(t(o) for o in obs), True)


def test_ops_all_covers_the_jax_package():
    """Every name `interpn_tpu.ops` exports, the port's `ops` exports too;
    the package's `__all__` is the JAX package's (pydantic is installed
    here, so both export the eight model classes)."""
    missing = set(jops.__all__) - set(tops.__all__)
    assert missing == set()
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
    assert interpn_tpu_torch.__all__ == interpn_tpu.__all__
    for name in interpn_tpu_torch.__all__:
        assert hasattr(interpn_tpu_torch, name), name


def test_prep_bspline_exported_and_matches_jax():
    _, _, grids, stack, _ = _inputs(seed=3)
    got_knots, got = tops.prep_bspline(grids, stack[0], 3)
    want_knots, want = jops.prep_bspline(grids, stack[0], 3)
    for a, b in zip(got_knots, want_knots):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _prepare(engine, dims):
    if engine == "df64":
        return df64.table_split
    return lambda v: i8.prepare(dims, v)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_in_place_copy_refreshes_the_cache_entry(engine):
    """A tensor table's entry is keyed by its storage, layout and version
    counter (`ops/df64.py::cache_key`): `copy_` into the table bumps the
    counter, so the next call prepares the new values, as a fresh tensor of
    them would be prepared, and a call without a write hits the entry."""
    dims = (6, 7)
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.standard_normal(math.prod(dims)))
    new = torch.from_numpy(rng.standard_normal(math.prod(dims)))
    prepare = _prepare(engine, dims)
    first = prepare(table)
    assert prepare(table) is first
    assert prepare(table.reshape(-1)) is first  # a fresh view of the same storage
    key = df64.cache_key(table)
    table.copy_(new)
    assert df64.cache_key(table) != key
    second = prepare(table)
    assert second is not first
    assert not _same(second, first)
    assert _same(second, prepare(new.clone()))
    assert prepare(table) is second
