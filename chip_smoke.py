#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (interpn_tpu_torch) on one GPU.

Builds every kernel of the port from `interpn_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives every ported path
(linear, cubic and nearest on regular and rectilinear grids, the cubic and
quintic B-splines, and stacks of 8 tables) through the entry points a user
calls at the JAX package's benchmark configurations (`bench.py`: 20^3, 20^4,
12^5, 100^3 and 100^2 grids, 1e6 queries uniform in [-0.5, 10.5]), and
times each kernel beside its plain version, its bound and, where one PyTorch
call computes the same function, that call.

    python3 chip_smoke.py

Phases: 1 build (seconds, registers, spills), 2 kernel vs plain, bitwise
(f32/f64, 1-8D, both cubic extrapolation modes, spline degrees 3 and 5,
stacks of 1, 3 and 8, NaN and +-inf), 3 nodes (exact, splines within
1e-11), 4 the paths (launch counts and checks), 5 timing: each kernel from
CUDA events behind a head start (`utils/profiling.py::cuda_time`), each
plain version from the profiler's device events (`profiled_time`). A failed
check raises and the script exits non-zero; a timing never does. Phase
lines carry the seconds since start; the last three lines are bare: the
card's name and power limit, the kernels' JSON record and {"ok": true,
"device": {...}}. Without a CUDA device it exits non-zero before any
result.
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
N_BATCHES = 20  # distinct batches per timing of a kernel
N_PLAIN = 5  # of them for the plain version, whose profile holds ~1-3k events a call
N_REF = 2000  # queries held against the float64 numpy reference
LO, HI = -0.5, 10.5  # query range: the [0, 10] grid plus extrapolation
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}  # rtol = atol, kernel vs plain
REF_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.float64: dict(rtol=1e-10, atol=1e-10)}
CHECK_DIMS = [(50,), (20,) * 2, (20,) * 3, (12,) * 4, (8,) * 5, (6,) * 6, (5,) * 7, (4,) * 8]
STACKS = (1, 3, 8)  # tables per stack in phase 2, in turn
NCH = 8  # tables of each stack path, as bench.py's stack row
SPLINE = {"cubic_spline": 3, "quintic": 5}
# NVIDIA H100 SXM data sheet at its 700 W limit: HBM rate and the dense rates
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
SHORT = {torch.float32: "f32", torch.float64: "f64"}


@dataclass(frozen=True)
class Path:
    kernel: str  # key of ops.fused.launches: "<kind>_<method>[_stack]", kind bspline: k3, k5
    dtype: torch.dtype
    n: int  # points per axis
    ndims: int

    @property
    def kind(self) -> str:
        return self.kernel.split("_")[0]

    @property
    def method(self) -> str:
        m = self.kernel.split("_")[1]
        return {"k3": "cubic_spline", "k5": "quintic"}.get(m, m)

    @property
    def k(self) -> int:
        return SPLINE[self.method]

    @property
    def stacked(self) -> bool:
        return self.kernel.endswith("_stack")

    @property
    def nch(self) -> int:
        return NCH if self.stacked else 1

    @property
    def label(self) -> str:
        what = self.method if self.kind == "bspline" else f"{self.kind} {self.method}"
        stack = f"stack of {NCH} " if self.stacked else ""
        return f"{stack}{what} {self.n}^{self.ndims} {SHORT[self.dtype]}"


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
    Path("bspline_k3", F32, 20, 3),
    Path("bspline_k3", F64, 20, 3),
    Path("bspline_k3", F64, 100, 2),
    Path("bspline_k5", F32, 20, 3),
    Path("regular_linear_stack", F32, 20, 3),
    Path("regular_cubic_stack", F32, 20, 3),
    Path("regular_nearest_stack", F32, 20, 3),
    Path("rectilinear_linear_stack", F32, 20, 3),
    Path("rectilinear_cubic_stack", F32, 20, 3),
    Path("rectilinear_nearest_stack", F32, 20, 3),
    Path("bspline_k3_stack", F32, 20, 3),
]
GAP_PATH = Path("regular_nearest", F32, 20, 3)  # its kernel is also profiled, for the gaps
# The TPU kernel each replaces: K1 `_pallas_v3`, K2 `_pallas_v3_pre` (rectilinear
# linear and cubic), K3 `_pallas_v3_rect` (rectilinear nearest), K4
# `_pallas_v3_knots` (and K2's spline use), K5 `_pallas_v3_stack`, K6
# `_pallas_v3_pre_stack`, K7 `_pallas_v3_knots_stack`
_V3 = "interpn_tpu/ops/pallas_v3.py"
REPLACES = {
    "regular": f"{_V3}:586", "rectilinear": f"{_V3}:847", "rectilinear_nearest": f"{_V3}:769",
    "bspline": f"{_V3}:880", "regular_stack": f"{_V3}:1195",
    "rectilinear_stack": f"{_V3}:1254", "bspline_stack": f"{_V3}:1289",
}


def replaces(p: Path) -> str:
    stack = "_stack" if p.stacked else ""
    return REPLACES.get(p.kernel, REPLACES[f"{p.kind}{stack}"])


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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
    """Numpy inputs of a path in its dtype: (axes, grid args of raw, vals);
    a stack's tables are vals + c for c < NCH, as bench.py's stack row."""
    npd = np.float32 if p.dtype == F32 else np.float64
    x, vals = bench_grid(p.n, p.ndims)
    vals = vals.ravel()
    vals = (np.stack([vals + c for c in range(NCH)]) if p.stacked else vals).astype(npd)
    if p.kind == "bspline":
        return [x.astype(npd)] * p.ndims, None, vals
    if p.kind == "regular":
        xd = x.astype(npd)
        axes = [xd] * p.ndims
        starts = np.zeros(p.ndims, npd)
        steps = np.full(p.ndims, xd[1] - xd[0], npd)  # what interpn() derives
        return axes, (np.array([p.n] * p.ndims), starts, steps, vals), vals
    axes = [a.astype(npd) for a in bench_rect_axes(p.n, p.ndims)]
    return axes, (axes, vals), vals


def random_obs(lo, hi, n, rng, dtype, device):
    """n queries per axis reaching half the grid past each side, with NaN
    and +-inf mixed in."""
    obs = []
    for a, b in zip(lo, hi):
        o = rng.uniform(a - 0.5 * (b - a), b + 0.5 * (b - a), n)
        o[rng.integers(0, n, 30)] = rng.choice([np.nan, np.inf, -np.inf], 30)
        obs.append(torch.as_tensor(o, dtype=dtype, device=device))
    return tuple(obs)


def random_case(kind, dims, dtype, n, rng, device, nch=None):
    """A random grid of `kind` with one table (or a stack of nch) and
    `random_obs` queries: (grid tensors, obs tensors)."""
    nd = len(dims)
    shape = math.prod(dims) if nch is None else (nch, math.prod(dims))
    vals = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    if kind == "regular":
        starts = rng.uniform(-1, 1, nd)
        steps = rng.uniform(0.3, 1.0, nd)
        lo, hi = starts, starts + steps * (np.array(dims) - 1)
        grid = tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (starts, steps))
    else:
        axes = [np.cumsum(0.2 + rng.random(d)) for d in dims]
        lo, hi = [a[0] for a in axes], [a[-1] for a in axes]
        grid = (tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in axes),)
    return (*grid, vals), random_obs(lo, hi, n, rng, dtype, device)


def spline_case(dims, k, dtype, n, rng, device, nch):
    """Jittered axes with their not-a-knot knots, nch random coefficient
    tables and `random_obs` queries: (knots, (nch, prod) coeffs, obs)."""
    from interpn_tpu_torch.ops.bspline import not_a_knot_knots

    axes = [np.cumsum(0.2 + rng.random(d)) for d in dims]
    knots = tuple(torch.as_tensor(not_a_knot_knots(a, k), dtype=dtype, device=device)
                  for a in axes)
    coeffs = torch.as_tensor(rng.standard_normal((nch, math.prod(dims))), dtype=dtype,
                             device=device)
    obs = random_obs([a[0] for a in axes], [a[-1] for a in axes], n, rng, dtype, device)
    return knots, coeffs, obs


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


def stack_kernel_and_plain(kind, method, lin=True):
    """(stack kernel wrapper, plain version), both taking (*grid, vals_stack,
    obs) as `kernel_and_plain`'s."""
    from interpn_tpu_torch.ops import fused

    if kind == "regular":
        def kern(st, sp, v, ob, dims):
            return fused.eval_regular_stack(dims, st, sp, v, ob, method, lin)

        def plain(st, sp, v, ob, dims):
            return fused.plain_regular_stack(dims, st, sp, v, ob, method, lin)
        return kern, plain

    def kern(g, v, ob, dims=None):
        return fused.eval_rectilinear_stack(g, v, ob, method, lin)

    def plain(g, v, ob, dims=None):
        return fused.plain_rectilinear_stack(g, v, ob, method, lin)
    return kern, plain


def bspline_kernel_and_plain(k, stacked):
    """(K4 or K7 wrapper, plain version), both taking (knots, coeffs, obs)."""
    from interpn_tpu_torch.ops import fused

    if stacked:
        return (lambda kn, c, ob, dims=None: fused.eval_bspline_stack(kn, c, ob, k),
                lambda kn, c, ob, dims=None: fused.plain_bspline_stack(kn, c, ob, k))
    return (lambda kn, c, ob, dims=None: fused.eval_bspline(kn, c, ob, k),
            lambda kn, c, ob, dims=None: fused.plain_bspline(kn, c, ob, k))


def path_kernel_and_plain(p: Path):
    if p.kind == "bspline":
        return bspline_kernel_and_plain(p.k, p.stacked)
    if p.stacked:
        return stack_kernel_and_plain(p.kind, p.method)
    return kernel_and_plain(p.kind, p.method)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin].double() - b[fin].double()).abs().max()) if fin.any() else 0.0


def not_bitwise(a: torch.Tensor, b: torch.Tensor) -> int:
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def bitwise(got, want, what) -> int:
    """Raise unless got equals want (NaN where it is NaN); return the number
    of results compared."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not_bitwise(got, want):
        raise AssertionError(f"{what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}, "
                             f"{not_bitwise(got, want) if got.shape == want.shape else '-'} "
                             "results not bitwise equal")
    return got.numel()


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


def spline_reference(axes, vals, obs, k):
    """Float64 scipy reference of the not-a-knot spline: per axis
    `make_interp_spline` fits, evaluated through B-spline design matrices,
    on the queries inside the grid (where scipy evaluates without
    extrapolating); returns (values, mask of those queries)."""
    from scipy.interpolate import BSpline, make_interp_spline

    c = np.asarray(vals, np.float64).reshape([len(a) for a in axes])
    knots = []
    for ax, a in enumerate(axes):
        spl = make_interp_spline(np.asarray(a, np.float64), c, k=k, axis=ax)
        c = np.moveaxis(spl.c, 0, ax)
        knots.append(spl.t)
    x = [np.asarray(o, np.float64) for o in obs]
    ok = np.logical_and.reduce([(xi >= a[0]) & (xi <= a[-1]) for xi, a in zip(x, axes)])
    out = c
    for ax, (xi, t) in enumerate(zip(x, knots)):
        d = BSpline.design_matrix(xi[ok], t, k).toarray()
        out = np.tensordot(d, out, axes=(1, 0)) if ax == 0 else np.einsum("qi,qi...->q...", d, out)
    full = np.full(len(x[0]), np.nan)
    full[ok] = out
    return full, ok


# --- bounds ----------------------------------------------------------------------


def operations_per_query(p: Path) -> int:
    """IEEE operations (add, sub, mul, div, compare) one query needs in the
    kernel's source: per axis its locate, then per table per tree node its
    reduction (linear: one lerp, 3; cubic: the Hermite node, 17 regular and 27
    with the nonuniform differences of a rectilinear grid; B-spline: per
    axis the bisection of n + k + 1 knots and 7k(k+1)/2 for Cox-de Boor, per
    table one multiply and one add per stencil entry)."""
    nd = p.ndims
    if p.kind == "bspline":
        k = p.k
        per_axis = math.ceil(math.log2(p.n + 2 * k + 2)) + 7 * k * (k + 1) // 2
        return nd * per_axis + p.nch * (2 * (k + 1) ** nd - 1)
    search = math.ceil(math.log2(p.n + 1)) if p.kind == "rectilinear" else 0
    if p.method == "cubic":
        per_axis, per_node, nodes = (9, 17, (4**nd - 1) // 3) if p.kind == "regular" else \
            (12 + search, 27, (4**nd - 1) // 3)
    else:
        per_axis = (7 if p.kind == "regular" else 3 + search) + (p.method == "nearest")
        per_node, nodes = (3, 2**nd - 1) if p.method == "linear" else (0, 0)
    return nd * per_axis + p.nch * per_node * nodes


def bound(p: Path, n_queries: int) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it: each
    query coordinate, table entry and grid parameter (knot) read once and
    each result written once at the HBM rate, against the operations at the
    dtype's peak rate."""
    item = torch.tensor([], dtype=p.dtype).element_size()
    if p.kind == "regular":
        grid_params = 2 * p.ndims
    elif p.kind == "rectilinear":
        grid_params = p.n * p.ndims
    else:
        grid_params = (p.n + p.k + 1) * p.ndims
    nbytes = (n_queries * (p.ndims + p.nch) + p.nch * p.n**p.ndims + grid_params) * item
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = n_queries * operations_per_query(p) / PEAK_OPS[p.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phases ---------------------------------------------------------------------------


def build_phase():
    from interpn_tpu_torch import _build
    from interpn_tpu_torch.ops import fused

    sources = fused.SOURCES
    cached = {s: _build.library_path(s).exists() for s in sources}
    seconds = _build.build_all(sources)
    for source in sources:
        fused._fn(source)  # load and bind
        ptxas = _build.library_path(source).with_suffix(".log").read_text()
        table = {}
        for m in re.finditer(
            r"_kernelI([fd])Li(\d)ELi(\d)E\S*' for \S+\n[^\n]*\n\s+\d+ bytes stack frame, "
            r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", ptxas):
            t, nd, code, spill, regs = m.groups()  # code: the method, or the spline degree
            spline = source.startswith("fused_bspline")
            method = f"k={code}" if spline else fused.METHODS[int(code)]
            table.setdefault((method, "f32" if t == "f" else "f64"), {})[int(nd)] = (
                int(regs), int(spill))
        families = 4 if spline else 6
        if len(table) != families or any(len(v) != 8 for v in table.values()):
            raise AssertionError(f"{source}: unexpected kernels in the ptxas log: {table}")
        built = "already built" if cached[source] else f"built in {seconds[source]:.3f} s"
        log(f"phase 1 build: {source}.cu {built} (one nvcc per source, all at once)")
        for (method, dt), by_nd in sorted(table.items()):
            cells = ", ".join(f"{nd}D {r}/{s}" for nd, (r, s) in sorted(by_nd.items()))
            log(f"phase 1   {source} {method} {dt}: registers/spill-store bytes {cells}")


def kernel_vs_plain_phase(cuda):
    """Phase 2: every kernel bitwise against its plain version on the same
    inputs, each stack kernel (stacks of 1, 3 and 8 in turn) beside its
    single-table kernel on the stack's first table; that table's results
    bitwise equal through both kernels."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(3)
    for k in SPLINE.values():
        for dtype in (F32, F64):
            results = 0
            for i, dims in enumerate(CHECK_DIMS):
                dims = tuple(max(d, k + 1) for d in dims)
                n = max(64, min(N_CHECK, 2**26 // (k + 1) ** len(dims)))
                knots, coeffs, obs = spline_case(dims, k, dtype, n, rng, cuda, STACKS[i % 3])
                what = f"bspline k={k} {dims} {SHORT[dtype]}"
                one = fused.eval_bspline(knots, coeffs[0], obs, k)
                results += bitwise(one, fused.plain_bspline(knots, coeffs[0], obs, k), what)
                many = fused.eval_bspline_stack(knots, coeffs, obs, k)
                results += bitwise(many, fused.plain_bspline_stack(knots, coeffs, obs, k),
                                   f"{what} stack of {len(coeffs)}")
                bitwise(many[0], one, f"{what}: first table of the stack vs K4")
            log(f"phase 2 kernel vs plain bspline k={k} {SHORT[dtype]}: K4 and K7 (stacks of "
                f"1, 3, 8 in turn) at 1-8D, up to {N_CHECK} queries (extrapolation, NaN, "
                f"+-inf): all {results} results bitwise equal to the gather tree; each "
                "stack's first table bitwise equal to K4")
    families = [(kind, method, lins)
                for kind in ("regular", "rectilinear")
                for method, lins in (("linear", (True,)), ("cubic", (True, False)),
                                     ("nearest", (True,)))]
    for kind, method, lins in families:
        for dtype in (F32, F64):
            results = 0
            dims_list = CHECK_DIMS[:6] if method == "nearest" else CHECK_DIMS
            for i, (dims, lin) in enumerate(itertools.product(dims_list, lins)):
                nch = STACKS[i % 3]
                n = min(N_CHECK, 2**28 // 4 ** len(dims) // nch) if method == "cubic" else N_CHECK
                grid, obs = random_case(kind, dims, dtype, n, rng, cuda, nch)
                kern, plain = stack_kernel_and_plain(kind, method, lin)
                what = f"{kind} {method} lin={lin} {dims} {SHORT[dtype]}"
                got = kern(*grid, obs, dims=dims)
                results += bitwise(got, plain(*grid, obs, dims=dims), f"{what} stack of {nch}")
                kern1, plain1 = kernel_and_plain(kind, method, lin)
                single = (*grid[:-1], grid[-1][0], obs)
                one = kern1(*single, dims=dims)
                results += bitwise(one, plain1(*single, dims=dims), what)
                bitwise(got[0], one, f"{what}: first table of the stack vs the single-table "
                        "kernel")
            lins_s = " (linearize True and False)" if method == "cubic" else ""
            k_names = ("K1 and K5" if kind == "regular" else
                       f"{'K3' if method == 'nearest' else 'K2'} and K6")
            log(f"phase 2 kernel vs plain {k_names} {kind} {method} {SHORT[dtype]}: "
                f"{len(dims_list[0])}-{len(dims_list[-1])}D{lins_s}, up to {N_CHECK} queries "
                f"(extrapolation, NaN, +-inf), stacks of 1, 3, 8 in turn: all {results} "
                "results bitwise equal to the gather tree; each stack's first table bitwise "
                "equal to the single-table kernel")


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
    spline_nodes(cuda, rng, axes, idx)


def spline_nodes(cuda, rng, axes, idx):
    """Phase 3 for K4-K7: the fitted splines pass through the table at every
    node within 1e-11 in f64 (the JAX package's bar, tests/test_bspline.py:
    the coefficients are solved, so not bit for bit); the stack kernels
    reproduce every table at the nodes exactly (cubic, nearest) as the
    single-table kernels do."""
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import bspline, fused

    tables = rng.standard_normal((8000, NCH))
    obs = convert.obs_from_numpy([a[i] for a, i in zip(axes, idx)], device=cuda,
                                 dtype=F64)
    worst = 0.0
    for k in SPLINE.values():
        knots, coeffs = bspline.prep_bspline(axes, tables, k)
        kt, ct = convert.bspline_from_numpy(knots, np.ascontiguousarray(coeffs.T),
                                            device=cuda, dtype=F64)
        want = torch.as_tensor(tables.T, device=cuda)
        for got in (fused.eval_bspline_stack(kt, ct, obs, k),
                    fused.eval_bspline(kt, ct[0], obs, k)[None]):
            torch.testing.assert_close(got, want[: len(got)], rtol=1e-11, atol=1e-11)
            worst = max(worst, float((got - want[: len(got)]).abs().max()))
    for dtype in (F32, F64):
        vals = torch.as_tensor(tables.T, dtype=dtype, device=cuda).contiguous()
        grid = convert.regular_grid_from_numpy(
            (20, 20, 20), np.zeros(3), np.full(3, 0.5), tables[:, 0], device=cuda, dtype=dtype)
        reg_obs = convert.obs_from_numpy([i * 0.5 for i in idx], device=cuda, dtype=dtype)
        grids = convert.obs_from_numpy(axes, device=cuda, dtype=dtype)
        rect_obs = tuple(g[torch.from_numpy(i).to(cuda)] for g, i in zip(grids, idx))
        for method, lin in (("cubic", True), ("cubic", False), ("nearest", True)):
            if not torch.equal(fused.eval_regular_stack(*grid[:3], vals, reg_obs, method, lin),
                               vals):
                raise AssertionError(f"{dtype}: regular stack {method} lin={lin}, nodes")
            if not torch.equal(fused.eval_rectilinear_stack(grids, vals, rect_obs, method, lin),
                               vals):
                raise AssertionError(f"{dtype}: rectilinear stack {method} lin={lin}, nodes")
    log(f"phase 3 nodes: cubic_spline and quintic fitted in f64 on a jittered 20^3 grid "
        f"(K4 and K7 with {NCH} tables) reproduce all 8000 nodes within rtol=atol=1e-11 "
        f"(worst {worst:.3e}); stacks of {NCH} tables through K5 and K6 reproduce every "
        "table exactly at every node by cubic (linearize True and False) and nearest, on "
        "the step-0.5 and the jittered 20^3 grids (f32, f64)")


def raw_fn(p: Path):
    from interpn_tpu_torch import raw

    return getattr(raw, f"interpn_{p.method}_{p.kind}_{SHORT[p.dtype]}")


def cuda_entry(p: Path, grid):
    """(what, fn(obs) -> result) of the path's entry point from CUDA tensors:
    raw into a preallocated out for a single-table interpolator, the op for
    a spline or a stack; `grid` is `path_grid`'s."""
    from interpn_tpu_torch import ops

    dims = (p.n,) * p.ndims
    lin = (True,) if p.method == "cubic" else ()
    if p.kind == "bspline" or p.stacked:
        name = (f"bspline_eval{'_stack' if p.stacked else ''}" if p.kind == "bspline"
                else f"{p.method}_{p.kind}_stack")
        fn = getattr(ops, name)
        what = f"ops.{name} from CUDA tensors"
        if p.kind == "bspline":
            return what, lambda b: fn(*grid, b, p.k)
        if p.kind == "regular":
            return what, lambda b: fn(dims, *grid, b, *lin)
        return what, lambda b: fn(*grid, b, *lin)
    fn = raw_fn(p)
    out = torch.empty(N_MAIN, dtype=p.dtype, device=grid[-1].device)
    raw_grid = ((np.array(dims), *grid[:2], grid[2]) if p.kind == "regular"
                else (list(grid[0]), grid[1]))

    def call(b):
        fn(*raw_grid, *lin, list(b), out)
        return out
    checks = "unrepresentable-value check, " if p.kind == "regular" else ""
    return f"raw.{fn.__name__} from CUDA tensors (validation, {checks}copy into out)", call


def drive_path(p: Path, cuda, rng):
    """Phase 4 for one path: interpn() (interpn_stack() for a stack) from
    numpy, where the default device is the card; raw from numpy too for a
    single-table interpolator; then `cuda_entry` from CUDA tensors; launch
    counts; results checked. Returns (launches of its kernel,
    kernel-vs-plain max_abs_err)."""
    import interpn_tpu_torch
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import fused

    npd = np.float32 if p.dtype == F32 else np.float64
    axes, grid_np, vals = path_inputs(p)
    shape = [p.n] * p.ndims
    obs_np = [rng.uniform(LO, HI, N_MAIN).astype(npd) for _ in range(p.ndims)]
    obs_t = convert.obs_from_numpy(obs_np, device=cuda, dtype=p.dtype)
    grid = path_grid(p, cuda)
    regular = p.kind == "regular"
    if p.stacked:
        entry = "interpn_stack()"
        calls = {entry: lambda: interpn_tpu_torch.interpn_stack(
            obs_np, axes, vals.reshape([NCH, *shape]), method=p.method, assume_regular=regular)}
    else:
        entry = "interpn()"
        calls = {entry: lambda: interpn_tpu_torch.interpn(
            obs_np, axes, vals.reshape(shape), method=p.method, assume_regular=regular)}
    if p.kind != "bspline" and not p.stacked:
        out_np = np.zeros(N_MAIN, npd)
        lin = (True,) if p.method == "cubic" else ()

        def raw_numpy():
            raw_fn(p)(*grid_np, *lin, obs_np, out_np)
            return out_np
        calls["raw from numpy"] = raw_numpy
    what, on_cuda = cuda_entry(p, grid)
    calls[what] = lambda: on_cuda(obs_t).cpu().numpy()
    torch.cuda.synchronize()

    fused.reset_launches()
    results, counts = {}, []
    for name, call in calls.items():
        results[name] = call()
        counts.append(fused.launches[p.kernel])
    torch.cuda.synchronize()
    others = {k: v for k, v in fused.launches.items() if k != p.kernel and v}
    if counts != list(range(1, len(calls) + 1)) or others:
        raise AssertionError(f"{p.label}: launch counts after each call {counts}, others {others}")
    launches = fused.launches[p.kernel]

    via_entry = results[entry]
    out_shape = (NCH, N_MAIN) if p.stacked else (N_MAIN,)
    for name, r in results.items():
        if r.shape != out_shape or r.dtype != npd or not np.isfinite(r).all():
            raise AssertionError(f"{p.label} {name}: {r.shape} {r.dtype}, finite="
                                 f"{np.isfinite(r).all()}")
        np.testing.assert_array_equal(r, via_entry, err_msg=f"{p.label} {name}")
    # the kernel against its plain version at the path's shape, on the card
    kern, plain = path_kernel_and_plain(p)
    k_out = kern(*grid, obs_t, dims=tuple(shape))
    p_out = plain(*grid, obs_t, dims=tuple(shape))
    bitwise(k_out, p_out, f"{p.label} kernel vs plain")
    err = max_abs_err(k_out, p_out)
    del k_out, p_out
    # the CPU gather tree on the first N_REF queries
    cpu_args = tuple(tuple(t.cpu() for t in a) if isinstance(a, tuple) else a.cpu()
                     for a in grid)
    sub = tuple(torch.from_numpy(o[:N_REF]) for o in obs_np)
    cpu = plain(*cpu_args, sub, dims=tuple(shape)).numpy()
    np.testing.assert_allclose(via_entry[..., :N_REF], cpu, rtol=TOL[p.dtype], atol=TOL[p.dtype],
                               err_msg=f"{p.label} vs the CPU gather tree")
    # an independent float64 reference where it speaks, table by table
    covered = 0
    for c, table in enumerate(vals if p.stacked else [vals]):
        sub_np = [o[:N_REF] for o in obs_np]
        if p.kind == "bspline":
            ref, ok = spline_reference(axes, table, sub_np, p.k)
        else:
            ref, ok = numpy_reference(p, axes, table, sub_np)
        got = via_entry[c, :N_REF] if p.stacked else via_entry[:N_REF]
        np.testing.assert_allclose(got[ok], ref[ok], **REF_TOL[p.dtype],
                                   err_msg=f"{p.label} table {c} vs the float64 reference")
        covered = int(ok.sum())
    ref_name = ("a scipy make_interp_spline / BSpline.design_matrix float64 reference"
                if p.kind == "bspline" else "a float64 numpy reference")
    log(f"phase 4 path {p.label} x {N_MAIN} queries: {', '.join(calls)}; {p.kernel} launches "
        f"after each call {counts}, no other kernel; finite, equal across entry points, kernel "
        f"bitwise equal to its plain version, within {TOL[p.dtype]:g} of the CPU gather tree on "
        f"{N_REF} queries and of {ref_name} on the {covered} of them it covers, every table "
        f"(rtol {REF_TOL[p.dtype]['rtol']:g}, atol {REF_TOL[p.dtype]['atol']:g})")
    return launches, err


def grid_sample_call(vals: torch.Tensor, n: int, mode: str, nch: int = 1):
    """The one PyTorch call that computes regular 3D linear (or nearest)
    interpolation of nch tables inside a [0, 10]^3 grid: F.grid_sample on
    the tables as an (1, nch, n, n, n) volume, queries normalized to [-1, 1]
    beforehand (its last coordinate runs along the table's last axis)."""
    import torch.nn.functional as F

    volume = vals.reshape(1, nch, n, n, n)

    def prepare(ob):
        return (torch.stack([ob[2], ob[1], ob[0]], dim=-1) / 5.0 - 1.0).reshape(1, 1, 1, -1, 3)

    def call(g):
        return F.grid_sample(volume, g, mode=mode, padding_mode="border", align_corners=True)

    return prepare, call


def path_grid(p: Path, cuda):
    """The kernel's grid arguments of a path, on the card: (starts, steps,
    vals), (axes, vals) or (knots, coeffs)."""
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import bspline

    axes, grid_np, vals = path_inputs(p)
    if p.kind == "bspline":
        tables = np.ascontiguousarray(vals.T if p.stacked else vals, dtype=np.float64)
        knots, coeffs = bspline.prep_bspline(axes, tables, p.k)
        return convert.bspline_from_numpy(
            knots, np.ascontiguousarray(coeffs.T) if p.stacked else coeffs,
            device=cuda, dtype=p.dtype)
    if p.kind == "regular":
        return (*(torch.from_numpy(a).to(cuda) for a in grid_np[1:3]),
                torch.from_numpy(vals).to(cuda))
    return (convert.obs_from_numpy(axes, device=cuda, dtype=p.dtype),
            torch.from_numpy(vals).to(cuda))


def profiled_ms(fn, batches, what) -> tuple[float | None, str]:
    """The profiler's device time per call (None when it recorded nothing
    in three tries) and a note of the events it recorded."""
    from interpn_tpu_torch.utils.profiling import profiled_time

    t = profiled_time(fn, batches)
    return t.device_ms, (f"{what}: {t.events} device events recorded over {len(batches)} "
                         f"calls, {t.per_call} a call, try {t.tries}")


def timing_phase(p: Path, cuda, gen, smi):
    """Phase 5 for one path: the kernel's device time from CUDA events
    behind a head start and the plain version's from the profiler, over
    distinct batches, in turns (plain, kernel, kernel, plain); on GAP_PATH
    the kernel's profiler time too, whose difference from the events is the
    gaps between launches; the bound; the entry point on the host clock; and
    the library call where there is one. A timing that fails is reported,
    never raised; `ahead` in the result says whether the kernel's events
    bracketed device work only."""
    from interpn_tpu_torch.utils.profiling import cuda_time

    dims = (p.n,) * p.ndims
    grid = path_grid(p, cuda)
    kern, plain = path_kernel_and_plain(p)

    def batches(lo, hi):
        return [tuple(torch.rand(N_MAIN, generator=gen, device=cuda, dtype=p.dtype) * (hi - lo)
                      + lo for _ in range(p.ndims)) for _ in range(N_BATCHES)]

    main = batches(LO, HI)
    k_fn = lambda ob: kern(*grid, ob, dims=dims)  # noqa: E731
    p_fn = lambda ob: plain(*grid, ob, dims=dims)  # noqa: E731
    k_runs, p_runs, notes = [], [], []
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            k_runs.append(cuda_time(k_fn, main))
        else:
            ms, note = profiled_ms(p_fn, main[:N_PLAIN], "plain")
            p_runs.append(ms)
            notes.append(note)
    k_best = min(k_runs, key=lambda t: t.device_ms)
    k_dev, k_loop = k_best.device_ms, min(t.loop_ms for t in k_runs)
    ahead = all(t.ahead for t in k_runs)
    p_dev = min((t for t in p_runs if t is not None), default=None)
    b_ms, b_by = bound(p, N_MAIN)
    gaps = ""
    if p == GAP_PATH:  # the profiler leaves the gaps out; once, on the shortest kernel
        k_prof, k_note = profiled_ms(k_fn, main, "kernel")
        gaps = (f"; kernel by the profiler {k_prof:.4f} ms/call ({k_note}), so "
                f"{(k_dev - k_prof) * 1e3:.2f} us/launch of gaps between launches"
                if k_prof is not None else f"; kernel by the profiler: not recorded ({k_note})")
    plain_s = (f"plain version {p_dev:.4f} ms/call by the profiler ({'; '.join(notes)}), "
               f"device-time speedup {p_dev / k_dev:.1f}x" if p_dev is not None else
               f"plain version: not recorded ({'; '.join(notes)})")
    log(f"phase 5 timing {p.label}, {N_BATCHES} distinct batches of {N_MAIN} queries "
        f"({N_PLAIN} for the plain version) [{smi}]: "
        f"kernel {k_dev:.4f} ms/call by CUDA events behind a head start of "
        f"{k_best.spin_cycles} cycles "
        f"({'held' if ahead else 'DID NOT hold: the time includes host gaps'}) = "
        f"{N_MAIN * p.nch / k_dev * 1e3:,.0f} table-queries/s, {k_loop:.4f} ms/call back to "
        f"back; bound {b_ms:.4f} ms by {b_by} ({b_ms / k_dev:.1%} of it); {plain_s}{gaps}")

    # the entry point from CUDA tensors, on the host clock
    what, entry = cuda_entry(p, grid)
    for b in main[:2]:
        entry(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in main:
        entry(b)
    torch.cuda.synchronize()
    entry_ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    log(f"phase 5 timing {p.label} through {what} [{smi}]: {entry_ms:.4f} ms/call host clock "
        f"= {N_MAIN / entry_ms * 1e3:,.0f} q/s")
    del main

    lib_ms = None
    if p.kind == "regular" and p.ndims == 3 and p.method in ("linear", "nearest"):
        mode = "bilinear" if p.method == "linear" else "nearest"
        prepare, call = grid_sample_call(grid[2], p.n, mode, p.nch)
        inside = batches(0.0, 10.0)  # grid_sample clamps where the port extrapolates
        prepared = [prepare(b) for b in inside]
        got = kern(*grid, inside[0], dims=dims)
        lib = call(prepared[0]).reshape(got.shape)
        if p.method == "linear":
            tol = 1e-5 if p.dtype == F32 else 1e-12
            torch.testing.assert_close(lib, got, rtol=tol, atol=tol)
            agree = f"agrees within {tol:g}"
        else:
            same = float((lib == got).double().mean())
            if same < 0.999:
                raise AssertionError(f"grid_sample nearest agrees on only {same:.4%}")
            agree = f"selects the same entry for {same:.4%} of queries (ties round to even)"
        k_in = min(cuda_time(lambda ob: kern(*grid, ob, dims=dims), inside).device_ms
                   for _ in range(2))
        lib_ms = min(cuda_time(call, prepared).device_ms for _ in range(2))
        log(f"phase 5 timing {p.label} on queries inside the grid [{smi}]: kernel "
            f"{k_in:.4f} ms/call; F.grid_sample(mode={mode!r}, align_corners=True, "
            f"padding_mode='border') on the {p.nch}-channel volume {lib_ms:.4f} ms/call on "
            f"the same queries, normalized beforehand, both by CUDA events behind a head "
            f"start ({agree})")
        del inside, prepared
    return {"ms": k_dev, "ahead": ahead, "plain_ms": p_dev, "bound_ms": b_ms, "bound_by": b_by,
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
            "source": f"interpn_tpu_torch/csrc/fused_{p.kind}{'_stack' if p.stacked else ''}.cu",
            "replaces": replaces(p),
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

    # the last three lines, unprefixed: the card, the kernels, the result
    print(smi)
    print(json.dumps({"kernels": kernels_record(driven, timed)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
