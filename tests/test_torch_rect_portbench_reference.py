"""The benchmark's plain rectilinear reference (`portbench/reference/
rectilinear.py`, which decides `correct` in the rectilinear cells) against
the port and against the JAX package, on the CPU.

Grids come from the benchmark's own grid kind (`portbench/grids/
rectilinear.py`, jitter 0.4, as `rect4d20_f64_cubic` sets it), tables from
a seeded `torch.Generator`, and a fifth of the queries lie outside the grid
on one axis by up to half its span, so every region of the method (the
interior Hermite cubic, the edge quadratics, the linearized extrapolation)
is reached.

* The port's `MulticubicRectilinear` / `MultilinearRectilinear`
  (`eval_torch` on CPU tensors, by the gather tree and by the plain version
  of the kernel that the card runs bit for bit) against the reference: the
  largest gap over the reference's largest magnitude at most 1e-12 in
  float64. In float32 the port computes in float32 and the reference in
  float64 on the same float32 inputs; the bar, 1e-5, is float32's unit
  roundoff (6e-8) times the sum of the weights' magnitudes over a stencil
  (at most ~20 here: the linearized extrapolation's weights grow with the
  distance outside) times ~8 for the rounding of the locate's differences
  and the weights' products.
* The reference against the JAX package's classes (f64, 3D and 4D, both
  extrapolation modes): at most 1e-12, which ties the benchmark's reference
  to the repository's reference without the benchmark importing JAX.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import interpn_tpu as it
import interpn_tpu_torch as tt
from interpn_tpu_torch import config
from interpn_tpu_torch.ops import dispatch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.grids import rectilinear as rect_grid  # noqa: E402
from portbench.reference import rectilinear as reference  # noqa: E402

DIMS = [(5, 6, 4), (4, 5, 4, 6)]
N = 600
BAR = {torch.float64: 1e-12, torch.float32: 1e-5}
METHODS = [("linear", True), ("cubic", True), ("cubic", False)]


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")  # the JAX package's device path
    with config.device("cpu"):
        yield


def _case(dims, dtype, seed):
    """(cfg, coords as numpy arrays in `dtype`, the (1, prod(dims)) table,
    the (N, n) queries), all from `seed`."""
    cfg = {"dims": list(dims), "starts": [0.0, -1.0, 2.0, 0.5][:len(dims)],
           "stops": [3.0, 1.0, 5.0, 4.0][:len(dims)],
           "axes": {"kind": "jittered", "jitter": 0.4}}
    np_dt = np.dtype(str(dtype).removeprefix("torch."))
    coords = rect_grid.make(cfg, seed, np_dt)["coords"]
    gen = torch.Generator().manual_seed(seed)
    table = torch.rand((1, math.prod(dims)), generator=gen, dtype=torch.float64).to(dtype)
    lo = torch.tensor(cfg["starts"], dtype=torch.float64)
    span = torch.tensor(cfg["stops"], dtype=torch.float64) - lo
    x = lo[:, None] + span[:, None] * torch.rand((len(dims), N), generator=gen,
                                                 dtype=torch.float64)
    k = N // 5  # outside on one axis, by up to half the span
    axis = torch.randint(0, len(dims), (k,), generator=gen)
    by = (1e-3 + 0.5 * torch.rand(k, generator=gen, dtype=torch.float64)) * span[axis]
    low = torch.rand(k, generator=gen) < 0.5
    x[axis, torch.arange(k)] = torch.where(low, lo[axis] - by, lo[axis] + span[axis] + by)
    return cfg, coords, table, x.to(dtype)


def _reference(method, dims, coords, table, obs, linearize):
    """The reference in float64 on the inputs as given."""
    c64 = [torch.tensor(c.astype(np.float64)) for c in coords]
    return reference.evaluate(method, dims, c64, table.to(torch.float64),
                              obs.to(torch.float64), linearize)[0]


def _gap(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).to(torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def _port(method, coords, table, linearize):
    vals = table[0].numpy()
    if method == "cubic":
        return tt.MulticubicRectilinear.new(list(coords), vals,
                                            linearize_extrapolation=linearize)
    return tt.MultilinearRectilinear.new(list(coords), vals)


@pytest.mark.parametrize("method,linearize", METHODS)
@pytest.mark.parametrize("dims", DIMS, ids=["3d", "4d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_the_port_agrees_with_the_benchmarks_reference(monkeypatch, impl, dtype, dims, method,
                                                       linearize):
    """`impl` "kernel" runs the plain version of K2 that the card's kernel
    equals bit for bit; "gather" the port's gather tree."""
    monkeypatch.setattr(dispatch, "_impl", lambda vals: impl)
    for seed in (3, 2**31 + 977):
        _, coords, table, obs = _case(dims, dtype, seed)
        got = _port(method, coords, table, linearize).eval_torch(tuple(obs.unbind(0)))
        assert got.dtype == dtype and got.shape == (N,)
        want = _reference(method, dims, coords, table, obs, linearize)
        assert _gap(got, want) <= BAR[dtype]


@pytest.mark.parametrize("method,linearize", METHODS)
@pytest.mark.parametrize("dims", DIMS, ids=["3d", "4d"])
def test_the_benchmarks_reference_agrees_with_the_jax_package(dims, method, linearize):
    for seed in (5, 2**31 + 978):
        _, coords, table, obs = _case(dims, torch.float64, seed)
        vals = table[0].numpy()
        if method == "cubic":
            model = it.MulticubicRectilinear.new(list(coords), vals,
                                                 linearize_extrapolation=linearize)
        else:
            model = it.MultilinearRectilinear.new(list(coords), vals)
        got = model.eval([o.numpy() for o in obs.unbind(0)])
        want = _reference(method, dims, coords, table, obs, linearize)
        assert _gap(got, want) <= 1e-12
