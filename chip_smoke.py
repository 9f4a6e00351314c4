#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (interpn_tpu_torch) on one GPU.

Builds every kernel of the port from `interpn_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives every ported path
(linear, cubic and nearest on regular and rectilinear grids) through the
entry points a user calls at the JAX package's benchmark configurations
(`bench.py`: 20^3, 20^4, 12^5 and 100^3 grids, 1e6 queries uniform in
[-0.5, 10.5]), and times each kernel beside its plain version, its bound and,
where one PyTorch call computes the same function, that call.

    python3 chip_smoke.py

Phases: 1 build (seconds, registers, spills), 2 kernel vs plain (f32/f64,
1-8D, both cubic extrapolation modes, NaN and +-inf), 3 node exactness,
4 the paths (launch counts and checks), 5 timing. A failed phase raises and
the script exits non-zero. The last two lines are the kernels' JSON record
and {"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before any result.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

N_MAIN = 1_000_000  # queries on each path
N_CHECK = 100_000  # queries per kernel-vs-plain case (fewer for 5-8D cubic)
N_BATCHES = 20  # distinct batches per timing
N_REF = 2000  # queries held against the float64 numpy reference
LO, HI = -0.5, 10.5  # query range: the [0, 10] grid plus extrapolation
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}  # rtol = atol, kernel vs plain
REF_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.float64: dict(rtol=1e-10, atol=1e-10)}
CHECK_DIMS = [(50,), (20,) * 2, (20,) * 3, (12,) * 4, (8,) * 5, (6,) * 6, (5,) * 7, (4,) * 8]
SOURCES = ("fused_regular", "fused_rectilinear")
METHOD_CODE = {"linear": 0, "cubic": 1, "nearest": 2}  # kLinear, kCubic, kNearest
# NVIDIA H100 SXM data sheet at its 700 W limit: HBM rate and the dense rates
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
SHORT = {torch.float32: "f32", torch.float64: "f64"}


@dataclass(frozen=True)
class Path:
    kernel: str  # key of ops.fused.launches: "<kind>_<method>"
    dtype: torch.dtype
    n: int  # points per axis
    ndims: int

    @property
    def kind(self) -> str:
        return self.kernel.split("_")[0]

    @property
    def method(self) -> str:
        return self.kernel.split("_")[1]

    @property
    def label(self) -> str:
        return f"{self.kind} {self.method} {self.n}^{self.ndims} {SHORT[self.dtype]}"


F32, F64 = torch.float32, torch.float64
# The JAX package's benchmark configurations (bench.py --full); the first path
# of each kernel is its headline in the kernels record.
PATHS = [
    Path("regular_linear", F32, 20, 3),
    Path("regular_linear", F64, 20, 3),
    Path("regular_linear", F32, 100, 3),
    Path("regular_cubic", F32, 20, 3),
    Path("regular_cubic", F64, 20, 3),
    Path("regular_cubic", F32, 20, 4),
    Path("regular_cubic", F64, 12, 5),
    Path("regular_nearest", F32, 20, 3),
    Path("regular_nearest", F64, 20, 3),
    Path("rectilinear_linear", F32, 20, 3),
    Path("rectilinear_cubic", F32, 20, 3),
    Path("rectilinear_cubic", F64, 20, 3),
    Path("rectilinear_cubic", F32, 100, 3),
    Path("rectilinear_nearest", F32, 20, 3),
]
# The TPU kernel each replaces: K1 `_pallas_v3`, K2 `_pallas_v3_pre` (rectilinear
# linear and cubic), K3 `_pallas_v3_rect` (rectilinear nearest)
REPLACES = {
    **dict.fromkeys(("regular_linear", "regular_cubic", "regular_nearest"),
                    "interpn_tpu/ops/pallas_v3.py:586"),
    **dict.fromkeys(("rectilinear_linear", "rectilinear_cubic"),
                    "interpn_tpu/ops/pallas_v3.py:847"),
    "rectilinear_nearest": "interpn_tpu/ops/pallas_v3.py:769",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# --- inputs --------------------------------------------------------------------


def bench_grid(n: int, ndims: int):
    """The JAX package's benchmark grid: n points on [0, 10] per axis,
    vals = sin(x0) + 0.37 * (x1 + ...), as float64 numpy."""
    x = np.linspace(0.0, 10.0, n)
    mesh = np.meshgrid(*([x] * ndims), indexing="ij")
    vals = np.sin(mesh[0])
    for m in mesh[1:]:
        vals = vals + m * 0.37
    return x, vals


def bench_rect_axes(n: int, ndims: int, seed: int = 5):
    """bench.py's jittered rectilinear axes over the same [0, 10] span."""
    rng = np.random.default_rng(seed)
    axes = []
    for _ in range(ndims):
        g = np.linspace(0.0, 10.0, n)
        g[1:-1] += rng.uniform(-0.3, 0.3, n - 2) * (g[1] - g[0])
        axes.append(np.sort(g))
    return axes


def path_inputs(p: Path):
    """Numpy inputs of a path in its dtype: (axes, grid args of raw, vals)."""
    npd = np.float32 if p.dtype == F32 else np.float64
    x, vals = bench_grid(p.n, p.ndims)
    vals = vals.ravel().astype(npd)
    if p.kind == "regular":
        xd = x.astype(npd)
        axes = [xd] * p.ndims
        starts = np.zeros(p.ndims, npd)
        steps = np.full(p.ndims, xd[1] - xd[0], npd)  # what interpn() derives
        return axes, (np.array([p.n] * p.ndims), starts, steps, vals), vals
    axes = [a.astype(npd) for a in bench_rect_axes(p.n, p.ndims)]
    return axes, (axes, vals), vals


def random_case(kind, dims, dtype, n, rng, device):
    """A random grid of `kind` and n queries reaching half the grid past each
    side, with NaN and +-inf mixed in: (grid tensors, obs tensors)."""
    nd = len(dims)
    vals = torch.as_tensor(rng.standard_normal(math.prod(dims)), dtype=dtype, device=device)
    if kind == "regular":
        starts = rng.uniform(-1, 1, nd)
        steps = rng.uniform(0.3, 1.0, nd)
        lo, hi = starts, starts + steps * (np.array(dims) - 1)
        grid = tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (starts, steps))
    else:
        axes = [np.cumsum(0.2 + rng.random(d)) for d in dims]
        lo, hi = [a[0] for a in axes], [a[-1] for a in axes]
        grid = (tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in axes),)
    obs = []
    for k in range(nd):
        span = hi[k] - lo[k]
        o = rng.uniform(lo[k] - 0.5 * span, hi[k] + 0.5 * span, n)
        o[rng.integers(0, n, 30)] = rng.choice([np.nan, np.inf, -np.inf], 30)
        obs.append(torch.as_tensor(o, dtype=dtype, device=device))
    return (*grid, vals), tuple(obs)


# --- the kernels and their plain versions ------------------------------------------


def kernel_and_plain(kind, method, lin=True):
    """(kernel wrapper, plain version), both taking (*grid, vals, obs)."""
    from interpn_tpu_torch.ops import cubic, fused, linear, nearest

    if kind == "regular":
        def kern(st, sp, v, ob, dims):
            return fused.eval_regular(dims, st, sp, v, ob, method, lin)

        if method == "cubic":
            def plain(st, sp, v, ob, dims):
                return cubic.cubic_regular(dims, st, sp, v, ob, lin)
        else:
            fn = linear.linear_regular if method == "linear" else nearest.nearest_regular

            def plain(st, sp, v, ob, dims):
                return fn(dims, st, sp, v, ob)
        return kern, plain

    def kern(g, v, ob, dims=None):
        return fused.eval_rectilinear(g, v, ob, method, lin)

    if method == "cubic":
        def plain(g, v, ob, dims=None):
            return cubic.cubic_rectilinear(g, v, ob, lin)
    else:
        fn = linear.linear_rectilinear if method == "linear" else nearest.nearest_rectilinear

        def plain(g, v, ob, dims=None):
            return fn(g, v, ob)
    return kern, plain


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin].double() - b[fin].double()).abs().max()) if fin.any() else 0.0


def not_bitwise(a: torch.Tensor, b: torch.Tensor) -> int:
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def hold(got, want, dtype, what):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype], equal_nan=True,
                               msg=lambda m: f"{what}: {m}")


# --- the float64 numpy reference -------------------------------------------------


def catmull_rom(t):
    """Weights of the uniform cubic Hermite spline with centered-difference
    slopes over its 4 stencil points, at t in [0, 1] from point 1."""
    return np.stack([(-t**3 + 2 * t**2 - t) / 2, (3 * t**3 - 5 * t**2 + 2) / 2,
                     (-3 * t**3 + 4 * t**2 + t) / 2, (t**3 - t**2) / 2], axis=1)


def hermite_nonuniform(t, r0, r1):
    """Weights over (v0..v3) of the cubic Hermite spline on [g1, g2] with
    distance-weighted centered-difference slopes; t = (x-g1)/h12,
    r0 = h01/h12, r1 = h23/h12 (slopes in units of h12)."""
    h00, h10 = 2 * t**3 - 3 * t**2 + 1, t**3 - 2 * t**2 + t
    h01, h11 = -2 * t**3 + 3 * t**2, t**3 - t**2
    z = np.zeros_like(t)
    k0 = np.stack([-1 / ((1 + r0) * r0), 1 / ((1 + r0) * r0) - r0 / (1 + r0), r0 / (1 + r0), z], 1)
    k1 = np.stack([z, -r1 / (1 + r1), r1 / (1 + r1) - 1 / ((1 + r1) * r1), 1 / ((1 + r1) * r1)], 1)
    w = h10[:, None] * k0 + h11[:, None] * k1
    w[:, 1] += h00
    w[:, 2] += h01
    return w


def axis_weights(p: Path, axis, x):
    """(stencil start, weights (n, m), usable mask) of one axis, in float64,
    independent of the port: the usable mask drops queries where float32
    rounding may pick another nearest node, and cubic queries outside the
    interior cells (the saturated edge cells differ in their slopes)."""
    x = x.astype(np.float64)
    g = axis.astype(np.float64)
    d = len(g)
    ok = np.ones(len(x), bool)
    if p.method == "cubic":
        if p.kind == "regular":
            h = g[1] - g[0]
            loc = np.floor((x - g[0]) / h).astype(np.int64) - 1
            ok = (loc >= 0) & (loc <= d - 4)
            loc = np.clip(loc, 0, d - 4)
            return loc, catmull_rom((x - (g[0] + h * (loc + 1))) / h), ok
        loc = np.searchsorted(g, x, side="left") - 2
        ok = (loc >= 0) & (loc <= d - 4)
        loc = np.clip(loc, 0, d - 4)
        h01, h12, h23 = (g[loc + i + 1] - g[loc + i] for i in range(3))
        return loc, hermite_nonuniform((x - g[loc + 1]) / h12, h01 / h12, h23 / h12), ok
    if p.kind == "regular":
        h = g[1] - g[0]
        loc = np.clip(np.floor((x - g[0]) / h), 0, d - 2).astype(np.int64)
        t = (x - (g[0] + h * loc)) / h
    else:
        loc = np.clip(np.searchsorted(g, x, side="left") - 1, 0, d - 2)
        t = (x - g[loc]) / (g[loc + 1] - g[loc])
    if p.method == "nearest":
        ok = np.abs(t - 0.5) > 1e-3
        return loc, np.stack([t <= 0.5, t > 0.5], axis=1).astype(np.float64), ok
    return loc, np.stack([1 - t, t], axis=1), ok


def numpy_reference(p: Path, axes, vals, obs):
    """Float64 tensor-product evaluation, and the mask of queries it speaks
    for: the sum over the stencil of the product of per-axis weights times
    the table entry."""
    grid = np.asarray(vals, np.float64).reshape([len(a) for a in axes])
    per_axis = [axis_weights(p, a, x) for a, x in zip(axes, obs)]
    out = np.zeros(len(obs[0]))
    for corner in itertools.product(*(range(w.shape[1]) for _, w, _ in per_axis)):
        w = np.prod([w[:, j] for (_, w, _), j in zip(per_axis, corner)], axis=0)
        out += w * grid[tuple(loc + j for (loc, _, _), j in zip(per_axis, corner))]
    return out, np.logical_and.reduce([ok for _, _, ok in per_axis])


# --- bounds ----------------------------------------------------------------------


def operations_per_query(p: Path) -> int:
    """IEEE operations (add, sub, mul, div, compare) one query needs in the
    kernel's source: per axis its locate, then per tree node its reduction
    (linear: one lerp, 3; cubic: the Hermite node, 17 regular and 27 with the
    nonuniform differences of a rectilinear grid)."""
    nd = p.ndims
    search = math.ceil(math.log2(p.n + 1)) if p.kind == "rectilinear" else 0
    if p.method == "cubic":
        per_axis, per_node, nodes = (9, 17, (4**nd - 1) // 3) if p.kind == "regular" else \
            (12 + search, 27, (4**nd - 1) // 3)
    else:
        per_axis = (7 if p.kind == "regular" else 3 + search) + (p.method == "nearest")
        per_node, nodes = (3, 2**nd - 1) if p.method == "linear" else (0, 0)
    return nd * per_axis + per_node * nodes


def bound(p: Path, n_queries: int) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it: each
    query coordinate, table entry and grid parameter read once and each
    result written once at the HBM rate, against the operations at the
    dtype's peak rate."""
    item = torch.tensor([], dtype=p.dtype).element_size()
    grid_params = 2 * p.ndims if p.kind == "regular" else p.n * p.ndims
    nbytes = (n_queries * (p.ndims + 1) + p.n**p.ndims + grid_params) * item
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = n_queries * operations_per_query(p) / PEAK_OPS[p.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phases ---------------------------------------------------------------------------


def build_phase():
    from interpn_tpu_torch import _build
    from interpn_tpu_torch.ops import fused

    cached = {s: _build.library_path(s).exists() for s in SOURCES}
    seconds = _build.build_all(SOURCES)
    for source in SOURCES:
        fused._fn(source)  # load and bind
        ptxas = _build.library_path(source).with_suffix(".log").read_text()
        table = {}
        for m in re.finditer(
            r"_kernelI([fd])Li(\d)ELi(\d)E\S*' for \S+\n[^\n]*\n\s+\d+ bytes stack frame, "
            r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", ptxas):
            t, nd, code, spill, regs = m.groups()
            method = list(METHOD_CODE)[int(code)]
            table.setdefault((method, "f32" if t == "f" else "f64"), {})[int(nd)] = (
                int(regs), int(spill))
        if len(table) != 6 or any(len(v) != 8 for v in table.values()):
            raise AssertionError(f"{source}: unexpected kernels in the ptxas log: {table}")
        built = "already built" if cached[source] else f"built in {seconds[source]:.3f} s"
        log(f"phase 1 build: {source}.cu {built} (one nvcc per source, all at once)")
        for (method, dt), by_nd in sorted(table.items()):
            cells = ", ".join(f"{nd}D {r}/{s}" for nd, (r, s) in sorted(by_nd.items()))
            log(f"phase 1   {source} {method} {dt}: registers/spill-store bytes {cells}")


def kernel_vs_plain_phase(cuda):
    rng = np.random.default_rng(0)
    families = [(kind, method, lins)
                for kind in ("regular", "rectilinear")
                for method, lins in (("linear", (True,)), ("cubic", (True, False)),
                                     ("nearest", (True,)))]
    for kind, method, lins in families:
        for dtype in (F32, F64):
            worst, mismatched, cases = 0.0, 0, 0
            dims_list = CHECK_DIMS[:6] if method == "nearest" else CHECK_DIMS
            for dims, lin in itertools.product(dims_list, lins):
                n = min(N_CHECK, 2**28 // 4 ** len(dims)) if method == "cubic" else N_CHECK
                grid, obs = random_case(kind, dims, dtype, n, rng, cuda)
                kern, plain = kernel_and_plain(kind, method, lin)
                got, want = kern(*grid, obs, dims=dims), plain(*grid, obs, dims=dims)
                hold(got, want, dtype, f"{kind} {method} lin={lin} {dims} {dtype}")
                worst = max(worst, max_abs_err(got, want))
                mismatched += not_bitwise(got, want)
                cases += 1
            lins_s = " (linearize True and False)" if method == "cubic" else ""
            log(f"phase 2 kernel vs plain {kind} {method} {SHORT[dtype]}: {cases} cases, "
                f"{len(dims_list[0])}-{len(dims_list[-1])}D{lins_s}, up to {N_CHECK} queries "
                f"(extrapolation, NaN, +-inf) within rtol=atol={TOL[dtype]:g}; "
                f"max_abs_err {worst:.3e}, {mismatched} results not bitwise equal")


def nodes_phase(cuda):
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(1)
    vals = rng.standard_normal(8000)
    idx = np.stack(np.meshgrid(*[np.arange(20)] * 3, indexing="ij")).reshape(3, -1)
    interior = torch.from_numpy(np.all(idx <= 18, axis=0)).to(cuda)
    axes = [np.cumsum(0.2 + rng.random(20)) for _ in range(3)]
    for dtype in (F32, F64):
        grid = convert.regular_grid_from_numpy(
            (20, 20, 20), np.zeros(3), np.full(3, 0.5), vals, device=cuda, dtype=dtype)
        obs = convert.obs_from_numpy([i * 0.5 for i in idx], device=cuda, dtype=dtype)
        got = fused.eval_regular(*grid, obs)
        if not torch.equal(got[interior], grid[3][interior]):
            raise AssertionError(f"{dtype}: linear, interior nodes not reproduced exactly")
        rgrids, rvals = convert.rectilinear_grid_from_numpy(axes, vals, device=cuda, dtype=dtype)
        robs = tuple(g[torch.from_numpy(i).to(cuda)] for g, i in zip(rgrids, idx))
        for method, lin in (("cubic", True), ("cubic", False), ("nearest", True)):
            if not torch.equal(fused.eval_regular(*grid, obs, method, lin), grid[3]):
                raise AssertionError(f"{dtype}: regular {method} lin={lin}, nodes not exact")
            if not torch.equal(fused.eval_rectilinear(rgrids, rvals, robs, method, lin), rvals):
                raise AssertionError(f"{dtype}: rectilinear {method} lin={lin}, nodes not exact")
    log(f"phase 3 nodes: all {int(interior.sum())} interior nodes of a 20^3 step-0.5 grid "
        "reproduce vals exactly through linear, and all 8000 nodes through cubic (linearize "
        "True and False) and nearest, on that grid and on a jittered rectilinear 20^3 grid "
        "(f32, f64)")


def drive_path(p: Path, cuda, rng):
    """Phase 4 for one path: raw from numpy (the default device is the card),
    raw from CUDA tensors, interpn(); launch counts; results checked.
    Returns (launches of its kernel, kernel-vs-plain max_abs_err)."""
    from interpn_tpu_torch import interpn, raw
    from interpn_tpu_torch.ops import fused

    npd = np.float32 if p.dtype == F32 else np.float64
    axes, grid_np, vals = path_inputs(p)
    obs_np = [rng.uniform(LO, HI, N_MAIN).astype(npd) for _ in range(p.ndims)]
    grid_t = [[torch.from_numpy(a).to(cuda) for a in g] if isinstance(g, list)
              else torch.from_numpy(g).to(cuda) for g in grid_np]
    obs_t = [torch.from_numpy(o).to(cuda) for o in obs_np]
    lin = (True,) if p.method == "cubic" else ()
    fn = getattr(raw, f"interpn_{p.method}_{p.kind}_{SHORT[p.dtype]}")
    out_np = np.zeros(N_MAIN, npd)
    out_t = torch.zeros(N_MAIN, dtype=p.dtype, device=cuda)
    torch.cuda.synchronize()

    fused.reset_launches()
    counts = []
    fn(*grid_np, *lin, obs_np, out_np)
    counts.append(fused.launches[p.kernel])
    fn(*grid_t, *lin, obs_t, out_t)
    counts.append(fused.launches[p.kernel])
    via_interpn = interpn(obs_np, axes, vals.reshape([p.n] * p.ndims), method=p.method,
                          assume_regular=p.kind == "regular")
    counts.append(fused.launches[p.kernel])
    torch.cuda.synchronize()
    others = {k: v for k, v in fused.launches.items() if k != p.kernel and v}
    if counts != [1, 2, 3] or others:
        raise AssertionError(f"{p.label}: launch counts after each call {counts}, others {others}")
    launches = fused.launches[p.kernel]

    results = {"raw(numpy)": out_np, "raw(cuda)": out_t.cpu().numpy(), "interpn": via_interpn}
    for name, r in results.items():
        if r.shape != (N_MAIN,) or r.dtype != npd or not np.isfinite(r).all():
            raise AssertionError(f"{p.label} {name}: {r.shape} {r.dtype}, finite="
                                 f"{np.isfinite(r).all()}")
        np.testing.assert_array_equal(r, out_np, err_msg=f"{p.label} {name}")
    # the kernel against its plain version at the path's shape, on the card
    kern, plain = kernel_and_plain(p.kind, p.method)
    dims = (p.n,) * p.ndims
    grid_args = (*grid_t[1:3], grid_t[3]) if p.kind == "regular" else (tuple(grid_t[0]), grid_t[1])
    k_out = kern(*grid_args, tuple(obs_t), dims=dims)
    p_out = plain(*grid_args, tuple(obs_t), dims=dims)
    hold(k_out, p_out, p.dtype, f"{p.label} kernel vs plain")
    err, off = max_abs_err(k_out, p_out), not_bitwise(k_out, p_out)
    # the CPU gather tree on the first N_REF queries
    sub = [torch.from_numpy(o[:N_REF]) for o in obs_np]
    cpu_args = tuple(tuple(t.cpu() for t in a) if isinstance(a, tuple) else a.cpu()
                     for a in grid_args)
    cpu = plain(*cpu_args, tuple(sub), dims=dims).numpy()
    np.testing.assert_allclose(out_np[:N_REF], cpu, rtol=TOL[p.dtype], atol=TOL[p.dtype],
                               err_msg=f"{p.label} vs the CPU gather tree")
    # an independent float64 numpy reference where it speaks
    ref, ok = numpy_reference(p, axes, vals, [o[:N_REF] for o in obs_np])
    np.testing.assert_allclose(out_np[:N_REF][ok], ref[ok], **REF_TOL[p.dtype],
                               err_msg=f"{p.label} vs the float64 numpy reference")
    log(f"phase 4 path {p.label} x {N_MAIN} queries: raw from numpy (default device cuda), "
        f"raw from CUDA tensors, interpn(); {p.kernel} launches after each call {counts}, "
        f"no other kernel; finite, equal across entry points, within {TOL[p.dtype]:g} of the "
        f"CPU gather tree on {N_REF} queries and of a float64 numpy reference on the {ok.sum()} "
        f"of them it covers (rtol {REF_TOL[p.dtype]['rtol']:g}, atol "
        f"{REF_TOL[p.dtype]['atol']:g}); kernel vs plain max_abs_err {err:.3e}, {off} results "
        "not bitwise equal")
    return launches, err


def grid_sample_call(vals: torch.Tensor, n: int, mode: str):
    """The one PyTorch call that computes regular 3D linear (or nearest)
    interpolation inside a [0, 10]^3 grid: F.grid_sample on the table as a
    (1, 1, n, n, n) volume, queries normalized to [-1, 1] beforehand (its
    last coordinate runs along the table's last axis)."""
    import torch.nn.functional as F

    volume = vals.reshape(1, 1, n, n, n)

    def prepare(ob):
        return (torch.stack([ob[2], ob[1], ob[0]], dim=-1) / 5.0 - 1.0).reshape(1, 1, 1, -1, 3)

    def call(g):
        return F.grid_sample(volume, g, mode=mode, padding_mode="border", align_corners=True)

    return prepare, call


def timing_phase(p: Path, cuda, gen, smi):
    """Phase 5 for one path: device time of the kernel and of its plain
    version over distinct batches, in turns (plain, kernel, kernel, plain);
    the bound; and the library call where there is one."""
    from interpn_tpu_torch import convert, raw
    from interpn_tpu_torch.ops import fused
    from interpn_tpu_torch.utils.profiling import cuda_time

    axes, grid_np, vals = path_inputs(p)
    dims = (p.n,) * p.ndims
    if p.kind == "regular":
        grid = tuple(torch.from_numpy(a).to(cuda) for a in grid_np[1:])
    else:
        grid = (convert.obs_from_numpy(axes, device=cuda, dtype=p.dtype),
                torch.from_numpy(vals).to(cuda))
    kern, plain = kernel_and_plain(p.kind, p.method)

    def batches(lo, hi):
        return [tuple(torch.rand(N_MAIN, generator=gen, device=cuda, dtype=p.dtype) * (hi - lo)
                      + lo for _ in range(p.ndims)) for _ in range(N_BATCHES)]

    main = batches(LO, HI)
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kern if name == "kernel" else plain
        runs[name].append(cuda_time(lambda ob, fn=fn: fn(*grid, ob, dims=dims), main))
    k_dev, p_dev = (min(t.device_ms for t in runs[k]) for k in ("kernel", "plain"))
    k_loop = min(t.loop_ms for t in runs["kernel"])
    b_ms, b_by = bound(p, N_MAIN)
    item = torch.tensor([], dtype=p.dtype).element_size()
    chunked = " (chunked into 2 GB corner matrices)" if p.method == "cubic" and \
        4**p.ndims * N_MAIN * item > 2 * 1024**3 else ""
    log(f"phase 5 timing {p.label}, {N_BATCHES} distinct batches of {N_MAIN} queries [{smi}]: "
        f"kernel {k_dev:.4f} ms/call device time = {N_MAIN / k_dev * 1e3:,.0f} q/s, "
        f"{k_loop:.4f} ms/call back to back; bound {b_ms:.4f} ms by {b_by} "
        f"({b_ms / k_dev:.1%} of it); plain version{chunked} {p_dev:.4f} ms/call device time, "
        f"device-time speedup {p_dev / k_dev:.1f}x")

    # the raw entry point from CUDA tensors, on the host clock
    out = torch.empty(N_MAIN, dtype=p.dtype, device=cuda)
    lin = (True,) if p.method == "cubic" else ()
    fn = getattr(raw, f"interpn_{p.method}_{p.kind}_{SHORT[p.dtype]}")
    raw_grid = (grid_np[0], *grid[:2], grid[2]) if p.kind == "regular" else (list(grid[0]), grid[1])
    for b in main[:2]:
        fn(*raw_grid, *lin, list(b), out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in main:
        fn(*raw_grid, *lin, list(b), out)
    torch.cuda.synchronize()
    raw_ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    checks = "unrepresentable-value check, " if p.kind == "regular" else ""
    log(f"phase 5 timing {p.label} through raw.{fn.__name__} from CUDA tensors (validation, "
        f"{checks}copy into out) [{smi}]: "
        f"{raw_ms:.4f} ms/call host clock = {N_MAIN / raw_ms * 1e3:,.0f} q/s")
    del main

    lib_ms = None
    if p.kind == "regular" and p.ndims == 3 and p.method in ("linear", "nearest"):
        mode = "bilinear" if p.method == "linear" else "nearest"
        prepare, call = grid_sample_call(grid[2], p.n, mode)
        inside = batches(0.0, 10.0)  # grid_sample clamps where the port extrapolates
        prepared = [prepare(b) for b in inside]
        got = kern(*grid, inside[0], dims=dims)
        lib = call(prepared[0]).reshape(-1)
        if p.method == "linear":
            tol = 1e-5 if p.dtype == F32 else 1e-12
            torch.testing.assert_close(lib, got, rtol=tol, atol=tol)
            agree = "agrees within 1e-5" if p.dtype == F32 else "agrees within 1e-12"
        else:
            same = float((lib == got).double().mean())
            if same < 0.999:
                raise AssertionError(f"grid_sample nearest agrees on only {same:.4%}")
            agree = f"selects the same entry for {same:.4%} of queries (ties round to even)"
        k_in = min(cuda_time(lambda ob: kern(*grid, ob, dims=dims), inside).device_ms
                   for _ in range(2))
        lib_ms = min(cuda_time(call, prepared).device_ms for _ in range(2))
        log(f"phase 5 timing {p.label} on queries inside the grid [{smi}]: kernel "
            f"{k_in:.4f} ms/call device time; F.grid_sample(mode={mode!r}, "
            f"align_corners=True, padding_mode='border') {lib_ms:.4f} ms/call device time "
            f"on the same queries, normalized beforehand ({agree})")
        del inside, prepared
    return {"ms": k_dev, "plain_ms": p_dev, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def kernels_record(driven, timed) -> list[dict]:
    """One entry per kernel, from its headline path (its first in PATHS)."""
    kernels = []
    for kernel in dict.fromkeys(p.kernel for p in PATHS):
        p = next(q for q in PATHS if q.kernel == kernel)
        launches, err = driven[p]
        kernels.append({
            "name": f"fused_{kernel}",
            "route": "cuda",
            "source": f"interpn_tpu_torch/csrc/fused_{p.kind}.cu",
            "replaces": REPLACES[kernel],
            "config": p.label,
            "launches": launches,
            "max_abs_err": err,
            **timed[p],
        })
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from interpn_tpu_torch import config

    config.require_ieee_fp32()
    cuda = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    build_phase()
    kernel_vs_plain_phase(cuda)
    nodes_phase(cuda)

    rng = np.random.default_rng(2)
    driven = {p: drive_path(p, cuda, rng) for p in PATHS}

    gen = torch.Generator(device=cuda)
    gen.manual_seed(1234)
    timed = {p: timing_phase(p, cuda, gen, smi) for p in PATHS}

    log(smi)
    log(json.dumps({"kernels": kernels_record(driven, timed)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
