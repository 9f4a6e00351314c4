"""The int8 multipass f64 engine (K9's plain version, `ops/i8.py`) against
the JAX package's `pallas_i8` on the CPU, in interpret mode.

Tolerances:
* the host table decomposition and the group choice: bitwise (the same
  numpy float64 arithmetic and the same cost model).
* values: rtol = atol = 1e-13 against the JAX engine and, for queries inside
  the grid, against the port's gather trees (`tests/test_pallas_i8.py:88`).
  Not bitwise: the weights differ by a few ulp (XLA:CPU's FMAs, see
  tests/test_torch_df64.py), and XLA:CPU's float32 `log2`/`exp2` do not
  give exact powers of two everywhere, where the port's scales are exact.
"""

import math

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from jax.experimental import pallas as pl

from interpn_tpu.ops import pallas_i8 as ji8
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import cubic, fused, i8, linear


@pytest.fixture(autouse=True)
def _on_cpu_interpret(monkeypatch):
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    with config.device("cpu"):
        yield


def _regular(dims, seed, n=300, depth=2.0, offset=0.0):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(dims))
    steps = rng.uniform(0.3, 1.0, len(dims))
    vals = offset + rng.standard_normal(math.prod(dims))
    obs = [rng.uniform(starts[k] - depth * steps[k], starts[k] + steps[k] * (dims[k] - 1 + depth),
                       n) for k in range(len(dims))]
    return starts, steps, vals, obs


def _t(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


SHAPES = [(12, 12), (20, 20, 20), (10, 10, 10), (12,) * 4, (8,) * 5, (6,) * 6, (5,) * 7,
          (4,) * 8, (12,) * 5, (3000, 5), (2, 3, 4)]


def test_group_choice_matches_jax():
    for dims in SHAPES:
        assert i8._choose_group(dims) == ji8._choose_group(dims), dims
        assert i8._shape(dims) == ji8._shape(dims), dims
    assert i8.NPASSES == ji8.NPASSES == 35


@pytest.mark.parametrize("dims,offset", [((12, 12), 0.0), ((10, 10, 10), 300.0),
                                         ((12,) * 4, 0.0), ((9, 8, 10), -5.0)], ids=str)
def test_decomposition_bitwise_equal_to_jax(dims, offset):
    _, _, vals, _ = _regular(dims, seed=len(dims), offset=offset)
    vals[3] = vals[7]  # a repeated value and a constant row do not upset it
    want = ji8.prepare(dims, vals)
    got = i8.decompose(dims, vals)
    _, lead, k = i8._shape(dims)
    np.testing.assert_array_equal(got[0], np.asarray(want[0])[:, :lead, :k])
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, np.asarray(w)[:lead])
    assert got[4] == want[4]
    # the port's layout: cell-major pieces, one row of 8 per table cell
    pieces, ch, cl, sv, c0 = i8.prepare(dims, vals)
    assert pieces.shape == (math.prod(dims), 8) and pieces.dtype == torch.int8
    np.testing.assert_array_equal(pieces.numpy().T.reshape(got[0].shape), got[0])
    assert ch.shape == cl.shape == sv.shape == (lead,) and c0 == got[4]


CASES = [((12, 12), "linear", True), ((10, 10, 10), "cubic", True),
         ((10, 10, 10), "cubic", False), ((12,) * 4, "cubic", True)]  # g = 2, m = 2


@pytest.mark.parametrize("dims,method,lin", CASES, ids=[f"{m}-{lin}-{len(d)}d"
                                                       for d, m, lin in CASES])
def test_plain_matches_jax_regular(dims, method, lin):
    starts, steps, vals, obs = _regular(dims, seed=sum(dims), depth=2.0 if len(dims) <= 3 else 0.5)
    want = np.asarray(ji8.eval_regular(dims, *_j((starts, steps, vals)), _j(obs), method, lin))
    before = dict(fused.launches)
    got = i8.eval_regular(dims, *_t((starts, steps, vals)), _t(obs), method, lin).numpy()
    assert fused.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dims,method,lin", [((10, 10, 10), "cubic", True),
                                             ((10, 10, 10), "cubic", False),
                                             ((20, 20, 20), "linear", True),
                                             ((12,) * 4, "cubic", True)], ids=str)
def test_plain_interior_matches_gather(dims, method, lin):
    rng = np.random.default_rng(3)
    starts, steps = np.zeros(len(dims)), np.ones(len(dims))
    vals = rng.standard_normal(math.prod(dims))
    obs = [rng.uniform(0, d - 1.0, 400) for d in dims]
    got = i8.eval_regular(dims, *_t((starts, steps, vals)), _t(obs), method, lin).numpy()
    args = (dims, *_t((starts, steps, vals)), _t(obs))
    want = (linear.linear_regular(*args) if method == "linear"
            else cubic.cubic_regular(*args, lin)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_plain_matches_jax_rectilinear():
    rng = np.random.default_rng(7)
    dims = (9, 8, 10)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    vals = rng.standard_normal(math.prod(dims))
    obs = [rng.uniform(g[0], g[-1], 400) for g in grids]
    want = np.asarray(ji8.eval_rectilinear(_j(grids), jnp.asarray(vals), _j(obs), "cubic"))
    got = i8.eval_rectilinear(_t(grids), torch.from_numpy(vals), _t(obs), "cubic").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    gather = cubic.cubic_rectilinear(_t(grids), torch.from_numpy(vals), _t(obs), True).numpy()
    np.testing.assert_allclose(got, gather, rtol=1e-13, atol=1e-13)


def test_scales_are_exact_powers_of_two():
    """f = ceil(log2(max(peak, 1e-30))) from the float bits: exact at and
    around every power of two for peaks up to 2^126 (2^-f stays normal),
    inf and NaN passed through."""
    e = np.arange(-99, 126)
    p = np.concatenate([2.0**e, 2.0**e * (1 + 2.0**-23), 2.0**e * (1 - 2.0**-24),
                        np.random.default_rng(0).uniform(1e-6, 1e6, 1000), [1e-31, 0.0]])
    p = p.astype(np.float32)
    scale, inv = (a.numpy().astype(np.float64) for a in i8._scales(torch.from_numpy(p)))
    f = np.ceil(np.log2(np.maximum(p.astype(np.float64), float(np.float32(1e-30)))))
    np.testing.assert_array_equal(scale, np.exp2(f))
    np.testing.assert_array_equal(inv, np.exp2(-f))
    scale, inv = i8._scales(torch.tensor([np.inf, np.nan], dtype=torch.float32))
    assert scale[0] == np.inf and inv[0] == 0 and scale[1].isnan() and inv[1].isnan()


def test_exact_i32_split_and_quantization_match_jax():
    rng = np.random.default_rng(4)
    acc = rng.integers(-2**31, 2**31 - 1, 1000).astype(np.int32)
    got = i8._exact_i32_to_df(torch.from_numpy(acc))
    want = ji8._exact_i32_to_df(jnp.asarray(acc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy().astype(np.float64) + got[1].numpy(), acc)
    # the weight pieces, with scales that both compute exactly (peaks in [1, 4])
    w64 = rng.uniform(-1, 1, (16, 500)) * np.exp2(rng.integers(0, 2, 500))
    wh = w64.astype(np.float32)
    wl = (w64 - wh).astype(np.float32)
    pieces, fq = i8._quantize_weights(*_t((wh, wl)))
    jpieces, jfq = ji8._quantize_weights(jnp.asarray(wh), jnp.asarray(wl), 500)
    np.testing.assert_array_equal(fq.numpy(), np.asarray(jfq)[0])
    np.testing.assert_array_equal(pieces.numpy(), np.stack([np.asarray(p) for p in jpieces]))


def test_prepare_cached_and_refuses_nonfinite():
    _, _, vals, _ = _regular((10, 10, 10), seed=1)
    first = i8.prepare((10, 10, 10), vals)
    assert i8.prepare((10, 10, 10), vals.copy()) is first
    assert i8.prepare((20, 50), vals) is not first  # another view of the table
    t = torch.from_numpy(vals.copy())
    p = i8.prepare((10, 10, 10), t)
    assert i8.prepare((10, 10, 10), t.reshape(-1)) is p
    t[0] = np.nan
    assert i8.prepare((10, 10, 10), t) is None
    with pytest.raises(ValueError, match="finite"):
        i8.eval_regular((10, 10, 10), torch.zeros(3, dtype=torch.float64),
                        torch.ones(3, dtype=torch.float64), t,
                        tuple(torch.zeros(4, dtype=torch.float64) for _ in range(3)), "linear")


@pytest.mark.parametrize("kind,dims,method", [("regular", (12, 12), "linear"),
                                              ("regular", (10, 10, 10), "cubic"),
                                              ("rectilinear", (9, 8, 10), "cubic")], ids=str)
def test_entries_on_cpu_run_the_plain_chain(kind, dims, method):
    """K9's entries on CPU tensors are the plain chain bit for bit, launch
    nothing, and hold the JAX engine's 1e-13 (queries up to one cell past
    each side)."""
    rng = np.random.default_rng(sum(dims) + 1)
    before = dict(fused.launches)
    if kind == "regular":
        starts, steps, vals, obs = _regular(dims, seed=sum(dims) + 1, n=120, depth=1.0)
        args = (dims, *_t((starts, steps, vals)), _t(obs), method, True)
        got, plain = i8.eval_regular(*args), i8.plain_regular(*args)
        want = ji8.eval_regular(dims, *_j((starts, steps, vals)), _j(obs), method, True)
    else:
        grids = [np.cumsum(0.2 + rng.random(d)) for d in dims]
        vals = rng.standard_normal(math.prod(dims))
        obs = [rng.uniform(g[0], g[-1], 120) for g in grids]
        args = (_t(grids), torch.from_numpy(vals), _t(obs), method, True)
        got, plain = i8.eval_rectilinear(*args), i8.plain_rectilinear(*args)
        want = ji8.eval_rectilinear(_j(grids), jnp.asarray(vals), _j(obs), method)
    assert fused.launches == before
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)
