"""Randomized torch-against-JAX fuzzer of the PyTorch port, on the CPU.

One leg per family the port has; each round of a leg draws a random
configuration (method, grid kind, dtype, rank, sizes, extrapolating
queries) and runs the same numpy inputs through `interpn_tpu_torch` (on
the CPU: the gather trees and the kernels' plain versions) and through the
JAX package:

* `gather`: the gather trees of linear, cubic and nearest on both grid
  kinds, and rectilinear cubic's weight contraction (K2's plain version);
* `raw`: the 16 flat functions (numpy in, `out` written);
* `interpn`: `interpn()` with every method, splines and pchip included;
* `interpn_stack`: `interpn_stack()` with every method;
* `pchip`: `ops.pchip_regular` / `pchip_rectilinear` and their stacks;
* `one_dim`: the five 1D interpolants;
* `classes`: the eight model classes, values and JSON bytes;
* `functional`: `TorchInterpolator` against `JaxInterpolator`;
* `compat`: `compat.RegularGridInterpolator` against the JAX package's,
  trailing value axes, fill values, NaN and descending axes included.

Rectilinear rounds draw, one time in four, jittered axes of 100 points with
a standard normal table, where the weights of an extrapolated cubic corner
cancel. Bars: f64 1e-12 and f32 1e-4, relative (rtol) and absolute
(atol, times the table's or the spline coefficients' largest magnitude);
nearest and the step interpolants exact. An f32 result outside the bar
passes where the port is no farther from the float64 result than twice
the JAX package's distance.

Run: JAX_PLATFORMS=cpu python scripts/fuzz_torch.py [--rounds 20] [--seed 0]
[--legs gather,raw,...]. The exit code is non-zero on the first
disagreement, which is printed with its leg, round and configuration.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("INTERPN_TPU_NATIVE", "0")  # the JAX package's device path

import numpy as np  # noqa: E402
import torch  # noqa: E402

import interpn_tpu as jit  # noqa: E402  (enables x64)
import jax.numpy as jnp  # noqa: E402
from interpn_tpu import compat as jcompat  # noqa: E402
from interpn_tpu import ops as jops  # noqa: E402
from interpn_tpu.functional import JaxInterpolator  # noqa: E402
from interpn_tpu.ops import cubic as jcubic  # noqa: E402
from interpn_tpu.ops import linear as jlinear  # noqa: E402
from interpn_tpu.ops import nearest as jnearest  # noqa: E402
from interpn_tpu.ops import one_dim as jone  # noqa: E402

import interpn_tpu_torch as tt  # noqa: E402
from interpn_tpu_torch import compat as tcompat  # noqa: E402
from interpn_tpu_torch import config  # noqa: E402
from interpn_tpu_torch import ops as tops  # noqa: E402
from interpn_tpu_torch.functional import TorchInterpolator  # noqa: E402
from interpn_tpu_torch.ops import cubic as tcubic  # noqa: E402
from interpn_tpu_torch.ops import linear as tlinear  # noqa: E402
from interpn_tpu_torch.ops import nearest as tnearest  # noqa: E402
from interpn_tpu_torch.ops import one_dim as tone  # noqa: E402

BAR = {np.float32: 1e-4, np.float64: 1e-12}
N = 64
METHODS = ("linear", "cubic", "nearest")
SPLINES = {"cubic_spline": 3, "quintic": 5}


class Disagreement(AssertionError):
    pass


def agree(port, jax_out, dtype, scale, what, exact=False, ref64=None):
    """Raise unless the port's result agrees with the JAX package's: bitwise
    where `exact`, else within the dtype's bar (rtol, and atol times
    `scale`); an f32 result outside it passes where the port stands no
    farther from `ref64()` (the float64 result) than twice the JAX
    package's distance."""
    port = np.asarray(port, dtype=np.float64)
    want = np.asarray(jax_out, dtype=np.float64)
    if port.shape != want.shape:
        raise Disagreement(f"{what}: shape {port.shape} vs {want.shape}")
    same = (port == want) | (np.isnan(port) & np.isnan(want))
    if exact:
        if not same.all():
            raise Disagreement(f"{what}: {int((~same).sum())} results not bitwise equal")
        return
    bar = BAR[dtype] * max(1.0, scale)
    ok = same | (np.abs(port - want) <= bar + BAR[dtype] * np.abs(want))
    if not ok.all() and dtype == np.float32 and ref64 is not None:
        ref = np.asarray(ref64(), dtype=np.float64)
        ok |= np.abs(port - ref) <= 2 * np.abs(want - ref) + bar
    if not ok.all():
        i = int(np.argmax(~ok))
        raise Disagreement(f"{what}: {int((~ok).sum())} results outside {bar:.3g}, e.g. "
                           f"port {port.flat[i]!r} vs JAX {want.flat[i]!r}")


# --- random configurations ------------------------------------------------------------


def rect_axes(rng, dims, jittered=False):
    """Rectilinear axes: spaced gaps with a floor, or jittered 100-point axes
    over [0, 10]."""
    if jittered:
        axes = []
        for _ in dims:
            g = np.linspace(0.0, 10.0, 100)
            g[1:-1] += rng.uniform(-0.3, 0.3, 98) * (g[1] - g[0])
            axes.append(np.sort(g))
        return axes
    return [np.cumsum(0.1 + rng.random(d)) + rng.uniform(-5, 0) for d in dims]


def grid_case(rng, method="linear", regular=None, jittered=None, ndims=None, dtype=None,
              min_pts=None):
    """A dict with the grid (regular: dims, starts, steps; else axes), the
    table, queries reaching past the edges, the dtype and the axes."""
    if regular is None:
        regular = False if jittered else bool(rng.integers(0, 2))
    dtype = (np.float64 if rng.integers(0, 2) else np.float32) if dtype is None else dtype
    jittered = (not regular and rng.random() < 0.25) if jittered is None else jittered
    ndims = (int(rng.integers(2, 4)) if jittered else int(rng.integers(1, 5))
             if ndims is None else ndims)
    min_pts = min_pts or {"cubic": 4, "pchip": 4, "cubic_spline": 4, "quintic": 6}.get(
        method, 2)
    dims = [100] * ndims if jittered else [int(rng.integers(min_pts, min_pts + 4))
                                            for _ in range(ndims)]
    if regular:
        starts = rng.uniform(-3, 3, ndims)
        steps = rng.uniform(0.2, 2.0, ndims)
        axes = [s + h * np.arange(d) for s, h, d in zip(starts, steps, dims)]
    else:
        starts = steps = None
        axes = rect_axes(rng, dims, jittered)
    vals = rng.standard_normal(math.prod(dims))
    span = [(a[0] - 0.25 * (a[-1] - a[0]), a[-1] + 0.25 * (a[-1] - a[0])) for a in axes]
    obs = [rng.uniform(lo, hi, N) for lo, hi in span]
    cast = (lambda a: None if a is None else np.asarray(a).astype(dtype))  # noqa: E731
    return dict(regular=regular, dtype=dtype, dims=dims, starts=cast(starts),
                steps=cast(steps), axes=[cast(a) for a in axes], vals=cast(vals),
                obs=[cast(o) for o in obs], jittered=jittered, method=method)


def describe(c) -> str:
    kind = "regular" if c["regular"] else ("jittered 100-point" if c["jittered"]
                                           else "rectilinear")
    return f"{c['method']} {kind} dims={c['dims']} {np.dtype(c['dtype']).name}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# --- the legs -------------------------------------------------------------------------


def leg_gather(rng, jittered=None):
    method = str(rng.choice(METHODS))
    c = grid_case(rng, method, jittered=jittered)
    lin = (bool(rng.integers(0, 2)),) if method == "cubic" else ()
    dims, vals, obs = tuple(c["dims"]), c["vals"], c["obs"]
    tmod = {"linear": tlinear, "cubic": tcubic, "nearest": tnearest}[method]
    jmod = {"linear": jlinear, "cubic": jcubic, "nearest": jnearest}[method]
    if c["regular"]:
        def run(tmod, conv, dtype):
            return getattr(tmod, f"{method}_regular")(
                dims, conv(c["starts"].astype(dtype)), conv(c["steps"].astype(dtype)),
                conv(vals.astype(dtype)), tuple(conv(o.astype(dtype)) for o in obs), *lin)
    else:
        def run(tmod, conv, dtype):
            return getattr(tmod, f"{method}_rectilinear")(
                tuple(conv(a.astype(dtype)) for a in c["axes"]), conv(vals.astype(dtype)),
                tuple(conv(o.astype(dtype)) for o in obs), *lin)
    want = np.asarray(run(jmod, _j, c["dtype"]))
    ref64 = (lambda: run(tmod, _t, np.float64).numpy())  # noqa: E731
    agree(run(tmod, _t, c["dtype"]).numpy(), want, c["dtype"], 1.0, describe(c),
          exact=method == "nearest", ref64=ref64)
    if method == "cubic" and not c["regular"]:
        got = tcubic.cubic_rectilinear_weighted(
            tuple(_t(a) for a in c["axes"]), _t(vals), tuple(_t(o) for o in obs), *lin)
        agree(got.numpy(), want, c["dtype"], 1.0, f"{describe(c)}: weight contraction",
              ref64=ref64)
    return describe(c)


def raw_args(c, method, lin):
    suffix = "f32" if c["dtype"] == np.float32 else "f64"
    kind = "regular" if c["regular"] else "rectilinear"
    name = f"interpn_{method}_{kind}_{suffix}"
    grid = ((np.array(c["dims"]), c["starts"], c["steps"], c["vals"]) if c["regular"]
            else (c["axes"], c["vals"]))
    return name, grid, lin


def leg_raw(rng):
    method = str(rng.choice(METHODS + ("bounds",)))
    c = grid_case(rng, "cubic" if method == "cubic" else "linear",
                  ndims=int(rng.integers(1, 7)) if method == "nearest" else None)
    c["method"] = method
    if method == "bounds":
        suffix = "f32" if c["dtype"] == np.float32 else "f64"
        kind = "regular" if c["regular"] else "rectilinear"
        name = f"check_bounds_{kind}_{suffix}"
        grid = ((np.array(c["dims"]), c["starts"], c["steps"]) if c["regular"]
                else (c["axes"],))
        outs = [np.zeros(len(c["dims"]), bool) for _ in range(2)]
        obs = [np.clip(o, a[0], a[-1]) if rng.integers(0, 2) else o
               for o, a in zip(c["obs"], c["axes"])]
        for mod, out in zip((tt.raw, jit.raw), outs):
            getattr(mod, name)(*grid, obs, 1e-8, out)
        if not np.array_equal(*outs):
            raise Disagreement(f"{name}: {outs[0]} vs {outs[1]}")
        return f"{name} {describe(c)}"
    lin = (bool(rng.integers(0, 2)),) if method == "cubic" else ()
    name, grid, lin = raw_args(c, method, lin)
    outs = [np.zeros(N, c["dtype"]) for _ in range(2)]
    for mod, out in zip((tt.raw, jit.raw), outs):
        getattr(mod, name)(*grid, *lin, c["obs"], out)
    agree(outs[0], outs[1], c["dtype"], 1.0, f"{name} {describe(c)}",
          exact=method == "nearest",
          ref64=lambda: _raw64(c, method, lin))
    return f"{name} {describe(c)}"


def _raw64(c, method, lin):
    c64 = dict(c, dtype=np.float64, vals=c["vals"].astype(np.float64),
               starts=None if c["starts"] is None else c["starts"].astype(np.float64),
               steps=None if c["steps"] is None else c["steps"].astype(np.float64),
               axes=[a.astype(np.float64) for a in c["axes"]])
    name, grid, lin = raw_args(c64, method, lin)
    out = np.zeros(N)
    getattr(tt.raw, name)(*grid, *lin, [o.astype(np.float64) for o in c["obs"]], out)
    return out


def _spline_scale(c, method):
    if method not in SPLINES:
        return 1.0
    _, coeffs = tops.prep_bspline([a.astype(np.float64) for a in c["axes"]],
                                  c["vals"].astype(np.float64), SPLINES[method])
    return float(np.abs(coeffs).max())


def leg_interpn(rng):
    method = str(rng.choice(METHODS + ("pchip", *SPLINES)))
    c = grid_case(rng, method)
    kw = dict(method=method, assume_regular=c["regular"] and bool(rng.integers(0, 2)))
    if method == "cubic":
        kw["linearize_extrapolation"] = bool(rng.integers(0, 2))
    got = tt.interpn(c["obs"], c["axes"], c["vals"], **kw)
    want = jit.interpn(c["obs"], c["axes"], c["vals"], **kw)

    def ref64():
        return tt.interpn([o.astype(np.float64) for o in c["obs"]],
                          [a.astype(np.float64) for a in c["axes"]],
                          c["vals"].astype(np.float64), **kw)
    agree(got, want, c["dtype"], _spline_scale(c, method), f"interpn {describe(c)}",
          exact=method == "nearest", ref64=ref64)
    return describe(c)


def leg_interpn_stack(rng):
    method = str(rng.choice(METHODS + ("pchip", *SPLINES)))
    c = grid_case(rng, method, jittered=False)
    nch = int(rng.integers(1, 5))
    stack = np.stack([c["vals"]] + [rng.standard_normal(c["vals"].size).astype(c["dtype"])
                                    for _ in range(nch - 1)])
    kw = dict(method=method)
    if method == "cubic":
        kw["linearize_extrapolation"] = bool(rng.integers(0, 2))
    got = tt.interpn_stack(c["obs"], c["axes"], stack, **kw)
    want = jit.interpn_stack(c["obs"], c["axes"], stack, **kw)
    scale = max(_spline_scale(dict(c, vals=v), method) for v in stack)
    agree(got, want, c["dtype"], scale, f"interpn_stack of {nch} {describe(c)}",
          exact=method == "nearest")
    return f"{nch} tables {describe(c)}"


def leg_pchip(rng):
    c = grid_case(rng, "pchip", dtype=np.float64)
    nch = int(rng.integers(1, 4))
    stack = np.stack([c["vals"]] + [rng.standard_normal(c["vals"].size)
                                    for _ in range(nch - 1)])
    tobs = tuple(_t(o) for o in c["obs"])
    if c["regular"]:
        head = (tuple(c["dims"]),)
        targs, jargs = (_t(c["starts"]), _t(c["steps"])), (c["starts"], c["steps"])
        fn = "pchip_regular"
    else:
        head = ()
        targs, jargs = (tuple(_t(a) for a in c["axes"]),), (c["axes"],)
        fn = "pchip_rectilinear"
    from interpn_tpu_torch.ops import pchip as tpchip

    got = getattr(tops, fn)(*head, *targs, _t(c["vals"]), tobs).numpy()
    want = np.asarray(getattr(jops, fn)(*head, *jargs, c["vals"], c["obs"]))
    agree(got, want, np.float64, 1.0, f"{fn} {describe(c)}")
    rows = getattr(tpchip, f"{fn}_stack")(*head, *targs, _t(stack), tobs).numpy()
    for r in range(nch):
        agree(rows[r], np.asarray(getattr(jops, fn)(*head, *jargs, stack[r], c["obs"])),
              np.float64, 1.0, f"{fn}_stack row {r} {describe(c)}")
    return f"{fn} {describe(c)}, stack of {nch}"


ONE_DIM = ("Linear1D", "LinearHoldLast1D", "Left1D", "Right1D", "Nearest1D")


def leg_one_dim(rng):
    name = str(rng.choice(ONE_DIM))
    dtype = np.float64 if rng.integers(0, 2) else np.float32
    n = int(rng.integers(2, 40))
    vals = rng.standard_normal(n).astype(dtype)
    if rng.integers(0, 2):
        start, step = dtype(rng.uniform(-3, 3)), dtype(rng.uniform(0.2, 2.0))
        args, kind = (start, step, vals), "RegularGrid1D"
        lo, hi = start, start + step * (n - 1)
    else:
        x = np.cumsum(0.1 + rng.random(n)).astype(dtype)
        args, kind = (x, vals), "RectilinearGrid1D"
        lo, hi = x[0], x[-1]
    locs = rng.uniform(lo - 2, hi + 2, N).astype(dtype)
    got = getattr(tone, name)(getattr(tone, kind)(*args)).eval(locs).numpy()
    want = np.asarray(getattr(jone, name)(getattr(jone, kind)(*args)).eval(locs))
    what = f"{name} on {kind} of {n} {np.dtype(dtype).name}"
    agree(got, want, dtype, float(np.abs(vals).max()), what,
          exact=name in ("Left1D", "Right1D", "Nearest1D"))
    return what


CLASSES = ("MultilinearRegular", "MulticubicRegular", "NearestRegular",
           "MultilinearRectilinear", "MulticubicRectilinear", "NearestRectilinear",
           "TensorSplineRegular", "TensorSplineRectilinear")


def leg_classes(rng):
    name = str(rng.choice(CLASSES))
    method = (str(rng.choice(("pchip", *SPLINES))) if name.startswith("TensorSpline")
              else {"Multilinear": "linear", "Multicubic": "cubic", "Nearest": "nearest"}[
                  name.removesuffix("Regular").removesuffix("Rectilinear")])
    c = grid_case(rng, method, regular=name.endswith("Regular"), jittered=False)
    kw = {"method": method} if name.startswith("TensorSpline") else {}
    if name.startswith("Multicubic"):
        kw["linearize_extrapolation"] = bool(rng.integers(0, 2))
    args = ((c["dims"], c["starts"], c["steps"], c["vals"]) if c["regular"]
            else (c["axes"], c["vals"]))
    port, ref = getattr(tt, name).new(*args, **kw), getattr(jit, name).new(*args, **kw)
    what = f"{name} {kw} {describe(c)}"
    scale = _spline_scale(c, method) if not c["regular"] else (
        _spline_scale(dict(c, axes=[a.astype(np.float64) for a in c["axes"]]), method))
    agree(port.eval(c["obs"]), ref.eval(c["obs"]), c["dtype"], scale, what,
          exact=method == "nearest")
    text = port.model_dump_json()
    if text != ref.model_dump_json():
        raise Disagreement(f"{what}: JSON bytes differ")
    again = getattr(tt, name).model_validate_json(text)
    if again.model_dump_json() != text:
        raise Disagreement(f"{what}: JSON does not round-trip")
    agree(again.eval(c["obs"]), port.eval(c["obs"]), c["dtype"], 1.0, what, exact=True)
    return what


def leg_functional(rng):
    method = str(rng.choice(METHODS + ("pchip", *SPLINES)))
    c = grid_case(rng, method, jittered=False, dtype=np.float64)
    if c["regular"]:
        args = (c["dims"], c["starts"], c["steps"], c["vals"])
        port = TorchInterpolator.regular(*args, method=method)
        ref = JaxInterpolator.regular(*args, method=method)
    else:
        port = TorchInterpolator.rectilinear(c["axes"], c["vals"], method=method)
        ref = JaxInterpolator.rectilinear(c["axes"], c["vals"], method=method)
    agree(port(c["obs"]).numpy(), np.asarray(ref(c["obs"])), np.float64,
          float(np.abs(port.vals.numpy()).max()), f"TorchInterpolator {describe(c)}",
          exact=method == "nearest")
    return describe(c)


def leg_compat(rng):
    method = str(rng.choice(("linear", "nearest", "slinear", "hermite", "pchip", "cubic",
                             "quintic")))
    c = grid_case(rng, {"quintic": "quintic"}.get(method, "cubic"), regular=False,
                  jittered=False, dtype=np.float64)
    shape = tuple(c["dims"])
    trailing = tuple(int(t) for t in rng.integers(1, 4, int(rng.integers(0, 3))))
    values = rng.standard_normal(shape + trailing)
    points = list(c["axes"])
    if rng.integers(0, 2):  # a descending axis
        points[0] = points[0][::-1].copy()
        values = np.flip(values, axis=0).copy()
    fill = [None, np.nan, -7.0][int(rng.integers(0, 3))]
    xi = np.stack(c["obs"], axis=-1)
    xi[0, 0] = np.nan
    kw = dict(method=method, bounds_error=False, fill_value=fill)
    got = tcompat.RegularGridInterpolator(points, values, **kw)(xi)
    want = jcompat.RegularGridInterpolator(points, values, **kw)(xi)
    scale = 1.0
    if method in ("cubic", "quintic"):
        flat = np.moveaxis(values.reshape(shape + (-1,)), -1, 0)
        scale = max(_spline_scale(dict(c, vals=v.ravel()), {"cubic": "cubic_spline"}.get(
            method, method)) for v in flat)
    agree(got, want, np.float64, scale,
          f"compat {method} trailing={trailing} fill={fill} {describe(c)}",
          exact=method == "nearest")
    return f"{method} trailing={trailing} fill={fill} {describe(c)}"


LEGS = {"gather": leg_gather, "raw": leg_raw, "interpn": leg_interpn,
        "interpn_stack": leg_interpn_stack, "pchip": leg_pchip, "one_dim": leg_one_dim,
        "classes": leg_classes, "functional": leg_functional, "compat": leg_compat}


def run_round(leg: str, rng: np.random.Generator, **kw) -> str:
    """One round of `leg` (the port on the CPU); returns what it drew."""
    with config.device("cpu"):
        return LEGS[leg](rng, **kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--legs", default=",".join(LEGS))
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for leg in args.legs.split(","):
        for i in range(args.rounds):
            try:
                run_round(leg, rng)
            except Disagreement as e:
                sys.exit(f"leg {leg}, round {i} (seed {args.seed}): {e}")
        print(f"{leg}: {args.rounds} rounds clean", flush=True)
    print("ALL CLEAN")


if __name__ == "__main__":
    main()
