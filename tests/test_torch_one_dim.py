"""The port's 1D interpolants (`interpn_tpu_torch.ops.one_dim`) against the
JAX package's on the CPU, with the same numpy inputs made from a seed.

Bars: the hold and nearest values exact, the linear ones at f64 rtol =
atol = 1e-13 * max(1, max|vals|) and f32 1e-5 * the same. Regular grids
give NaN where the reference raises "Unrepresentable number" (NaN, +-inf
and locations whose cell index reaches 2^63); rectilinear grids bisect
instead, NaN locating in the first cell.
"""

import numpy as np
import pytest
import torch

import interpn_tpu  # noqa: F401  (enables x64)
from interpn_tpu.ops import one_dim as jone
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import one_dim as tone

INTERPOLANTS = ["Linear1D", "LinearHoldLast1D", "Left1D", "Right1D", "Nearest1D"]
EXACT = {"Left1D", "Right1D", "Nearest1D"}
BAR = {np.float32: 1e-5, np.float64: 1e-13}


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _case(dtype, seed=0, n=40):
    """A table, its regular and jittered axes, and locations inside, beyond
    both edges, at the nodes and at the special values of each grid kind."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(dtype)
    start, step = dtype(-3.25), dtype(0.5)
    x_reg = (start + step * np.arange(n)).astype(dtype)
    x_rect = np.sort(x_reg + rng.uniform(-0.2, 0.2, n)).astype(dtype)
    locs = np.concatenate([rng.uniform(x_reg[0] - 10, x_reg[-1] + 10, 300), x_reg, x_rect])
    big = [2.0**62, -(2.0**62), 2.0**63, -(2.0**63), 2.0**64, 1e30, -1e30]
    special = [np.nan, np.inf, -np.inf]
    locs_reg = np.concatenate([locs, special, big]).astype(dtype)
    locs_rect = np.concatenate([locs, special]).astype(dtype)
    return vals, start, step, x_rect, locs_reg, locs_rect


def _grids(mod, dtype, seed=0):
    vals, start, step, x_rect, locs_reg, locs_rect = _case(dtype, seed)
    reg = mod.RegularGrid1D(start, step, vals)
    rect = mod.RectilinearGrid1D(x_rect, vals)
    return [("regular", reg, locs_reg), ("rectilinear", rect, locs_rect)], vals


@pytest.mark.parametrize("name", INTERPOLANTS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpolant_matches_jax(name, dtype):
    port_grids, vals = _grids(tone, dtype)
    jax_grids, _ = _grids(jone, dtype)
    bar = BAR[dtype] * max(1.0, float(np.abs(vals).max()))
    for (kind, tgrid, locs), (_, jgrid, _) in zip(port_grids, jax_grids):
        got = getattr(tone, name)(tgrid).eval(locs)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.from_numpy(vals).dtype
        got = got.numpy()
        want = np.asarray(getattr(jone, name)(jgrid).eval(locs))
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=kind)
        else:
            np.testing.assert_allclose(got, want, rtol=bar, atol=bar, err_msg=kind)
        if kind == "regular":  # NaN and +-inf give NaN
            assert np.isnan(got[-10:-7]).all()


def test_regular_unrepresentable_locations_give_nan():
    """NaN, +-inf and |floor((x - start) / step)| >= 2^63 give NaN from
    every interpolant; 2^62 is an ordinary far-out location."""
    grid = tone.RegularGrid1D(0.0, 1.0, np.array([10.0, 20.0, 30.0]))
    locs = np.array([np.nan, np.inf, -np.inf, 2.0**63, -(2.0**63), 1e300, 2.0**62, 1.0])
    for name in INTERPOLANTS:
        out = getattr(tone, name)(grid).eval(locs).numpy()
        assert np.isnan(out[:6]).all(), name
        assert np.isfinite(out[7]), name


def test_rectilinear_nonfinite_locations():
    """NaN locates in the first cell with no extrapolation flag, +-inf at
    the edges; each interpolant's own arithmetic decides the value."""
    grid = tone.RectilinearGrid1D(np.array([0.0, 1.0, 2.0]), np.array([10.0, 20.0, 30.0]))
    locs = np.array([np.nan, np.inf, -np.inf])
    np.testing.assert_array_equal(tone.Nearest1D(grid).eval(locs).numpy(), [20.0, 20.0, 10.0])
    np.testing.assert_array_equal(tone.Left1D(grid).eval(locs).numpy(), [10.0, 30.0, 10.0])
    np.testing.assert_array_equal(tone.Right1D(grid).eval(locs).numpy(), [20.0, 30.0, 10.0])
    hold = tone.LinearHoldLast1D(grid).eval(locs).numpy()
    assert np.isnan(hold[0]) and hold[1] == 30.0 and hold[2] == 10.0
    lin = tone.Linear1D(grid).eval(locs).numpy()
    assert np.isnan(lin[0]) and lin[1] == np.inf and lin[2] == -np.inf


@pytest.mark.parametrize("out_kind", ["numpy", "tensor"])
def test_eval_into_out_and_length_mismatch(out_kind):
    interp = tone.Linear1D(tone.RegularGrid1D(0.0, 1.0, np.array([1.0, 2.0, 4.0])))
    out = np.zeros(3) if out_kind == "numpy" else torch.zeros(3, dtype=torch.float64)
    assert interp.eval(np.array([0.5, 1.5, 2.5]), out) is out
    np.testing.assert_allclose(np.asarray(out), [1.5, 3.0, 5.0])
    with pytest.raises(ValueError, match="^Length mismatch$"):
        interp.eval(np.zeros(2), np.zeros(3))
    np.testing.assert_array_equal(interp.eval_alloc(np.array([1.0])).numpy(), [2.0])


@pytest.mark.parametrize("make", [
    lambda m: m.RectilinearGrid1D(np.arange(3.0), np.arange(4.0)),
    lambda m: m.RectilinearGrid1D(np.arange(1.0), np.arange(1.0)),
    lambda m: m.RegularGrid1D(0.0, 1.0, np.array([1.0])),
], ids=["rect-lengths", "rect-one-point", "regular-one-point"])
def test_construction_length_mismatch(make):
    with pytest.raises(ValueError) as want:
        make(jone)
    with pytest.raises(ValueError) as got:
        make(tone)
    assert str(got.value) == str(want.value) == "Length mismatch"


def test_scalar_start_and_step_take_the_table_dtype():
    """Python floats for start and step become 0-d tensors of the table's
    dtype and device, so an f32 table computes in f32."""
    vals = torch.arange(5, dtype=torch.float32)
    grid = tone.RegularGrid1D(0.1, 0.3, vals)
    assert grid.start.dtype == grid.step.dtype == torch.float32
    out = tone.Linear1D(grid).eval(torch.tensor([0.25, 0.7], dtype=torch.float32))
    assert out.dtype == torch.float32
    want = jone.Linear1D(jone.RegularGrid1D(np.float32(0.1), np.float32(0.3), vals.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want.eval(np.float32([0.25, 0.7]))),
                               rtol=1e-6, atol=1e-6)


def test_numpy_table_without_a_device_raises(monkeypatch):
    """A numpy table goes to the CUDA device; with none and no device asked
    for, building the grid raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with config.device(None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tone.RegularGrid1D(0.0, 1.0, np.arange(3.0))
        # a tensor table computes where it lives
        grid = tone.RectilinearGrid1D(torch.arange(3.0), torch.arange(3.0))
        assert tone.Left1D(grid).eval(np.array([0.5])).device.type == "cpu"
