#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (interpn_tpu_torch) on one GPU.

Builds every kernel of the port from `interpn_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives every ported path
(linear, cubic and nearest on regular and rectilinear grids, the cubic and
quintic B-splines, stacks of 8 tables, and the f64 contraction engines K8
and K9 under INTERPN_TPU_F64=df64|i8) through the entry points a user calls
at the JAX package's benchmark configurations (`bench.py`: 20^3, 20^4,
12^5, 100^3 and 100^2 grids, 1e6 queries uniform in [-0.5, 10.5]), and
times each kernel beside its plain version, its bound and, where one PyTorch
call computes the same function, that call; beside the kernels it holds and
times the native CPU engine (numpy inputs on the CPU device) and the
factorized products (INTERPN_TPU_IMPL=factorized).

    python3 chip_smoke.py

Phases: 1 build (seconds, registers, spills; for K1/K5, K2/K3/K6 and
K4/K7 also shared memory and blocks an SM of every instantiation; the
regular entries' unrepresentable-coordinate flag, `csrc/unrep_flag.cu`), 2
kernel vs plain, bitwise (f32/f64, 1-8D, both cubic extrapolation modes, spline degrees 3 and 5,
stacks of 1, 3 and 8, NaN and +-inf; K1's linear and nearest routes
(staged, quads, direct) and cubic routes (staged, taps at 2D, four lanes
on the taps from 3D, direct) under and over each cap, 100^3 and tables at
odd offsets; the two packs and the interleave; K2/K6's cubic routes
(staged, staged tables, taps, interleaved, direct) at and over each cap,
on tables holding a NaN and infinities, at every node, and at the bench
paths in both modes and dtypes; K2 linear's and K3's routes (staged,
guided, direct) on one table at 1-8D at and over each cap, on jittered,
geometric, two-point and 1000-point axes, at every knot, one ulp either
side, every midpoint, NaN, +-inf, +-0 and far outside, nearest exact at
the nodes; K6 linear's and nearest's stack routes
(interleaved, staged, direct) on stacks of 1-17 tables at 1-8D and at and
over the staging cap, each row against K2 / K3; K4's routes (staged
groups, direct) at and over the cap and on the bench tables; K5 cubic's and K7's
stack routes (staged groups, interleaved, direct) on stacks of 1, 3, 4, 8,
9 and 17 tables of 20^3 and 21^3 (1 to 6 groups), aligned and at odd
offsets, with NaN and +-inf in the tables, each row against K1 / K4; a
staged launch over its cap raises; a K5 linear stack of 8 tables of 200^3
interleaved while the card has its interleaved copy's bytes free and, with
a filler holding the free memory below that, direct, bitwise the plain
version both times; K8 and K9 on f64 2-8D, one
launch each from the queries against the plain chain that builds the
float64 weights in torch, and K8 at the float range's edges), 3 nodes
(exact, splines within 1e-11, K8 to the table's hi + lo, K9 within
1e-13), 4 the paths (launch counts, the quads route's pack and the taps
routes' cubic pack beside K1 and the interleave beside K5 and K6, the cubic pack
beside K2 at 100^3, no torch weight build on an engine path, the route of
each grid and spline kernel, and checks; rectilinear cubic also against
the gather tree at f32 1e-4, f64 1e-13; on a single regular table the
flag's kernel once a call, and equal to its plain version with NaN, +-inf
and far-out values planted), 5 timing: each kernel from CUDA
events behind a head start (`utils/profiling.py::cuda_time`), each plain
version from the profiler's device events (`profiled_time`), for K8/K9
also the whole call through the op a user calls, the four layout
kernels and the flag's kernel (3 x 1e6 and 1e8 f32, 3 x 1e7 f64), 6 the slice without kernels of its own: pchip (a torch gather
tree; regular 20^3 f64 and f32, rectilinear 20^3 f64 against scipy's
pchip, a stack of 8 through interpn_stack), the five 1D interpolants, and
the eight model classes at 20^3 f32 (the spline classes under each
method), each class's eval_torch bitwise its ops call with its kernel K1,
K2, K3 or K4 launched once a call, its table put on the card once, eval
into a CUDA out bitwise with the flag's kernel once (the regular
reference methods), eval from numpy against raw or interpn(), each timed,
7 torch.func
through the kernel routes and the scipy adapter: TorchInterpolator on each
method and both grid kinds at 20^3 f32 (the call bitwise its ops call, its
kernel once; vmap over 8 tables one launch of the stack kernel, bitwise
the stack op and row for row the single-table call, no gather tree
forward; vmap over 4 query sets one launch; grad and jvp into the table
and the queries with the kernel forward, within 1e-5 of the gather tree's
derivatives), one K8 path under INTERPN_TPU_F64=df64 vmapped and
differentiated, and compat.RegularGridInterpolator from numpy (linear,
nearest, slinear and pchip within 1e-12 of scipy's RGI, hermite, cubic and
quintic bitwise raw / interpn(), a trailing axis of 8 channels one stack
launch, the float32 opt-in), each timed beside the call it reduces to, 8
the serving artifacts and the parallel evaluators: MultilinearRegular 20^3
f32 exported by `aot.export_eval` on the card with buckets of 1024, 65536
and 1e6 queries (each program the regular custom op once and a reshape, no
gather tree), served in a fresh process that imports only
`interpn_tpu_torch.aot`, at 1e6 and 999,999 (padded) queries, each bitwise
eval_torch with K1 launched once a call; the seven other classes
(TensorSplineRegular with pchip, TensorSplineRectilinear with
cubic_spline) exported at one bucket of 1e6 and served bitwise, K1-K4
once a call, pchip's program its gather tree; and on
make_mesh() (the card) and four cuda:0 entries, prepared_evaluator on the
main path, sharded_evaluator on every method and grid kind, the splines
prepared, prepared_stack_evaluator on 8 tables (K5, K6, K7), each shard on
its device, one launch a shard, the shards joined bitwise the
single-device op; MulticubicRegular 20^3 f64 under INTERPN_TPU_F64=df64
and again under =i8, exported on the card, served in a fresh process with
the variable unset at 1e6 and 999,999 queries, each bitwise eval_torch
under the setting with K8 / K9 once a call, and prepared_evaluator under
each, one launch a shard, joined bitwise the op; each timed beside the call
it stands for, 9 the CPU engines: the native C++ engine built on the card's
host (g++, its version and seconds), its six evaluators and two bounds
checks at 20^3 f32 and f64 held to the port's plain CPU version and to the
kernels on the card (f32 1e-5, f64 1e-13, nearest exact but at midpoint
ties), threaded bitwise one thread; raw.interpn_linear_regular_f32 from
numpy at 1 to 1e6 queries timed on the native engine (auto threads and one)
and through the card's round trip, and the crossover; and
INTERPN_TPU_IMPL=factorized on regular and rectilinear linear, cubic and
nearest at 20^3 and 64^3 f32 with 1e6 queries on the card, timed by CUDA
events beside the kernels, both held to the gather tree. A failed check
raises and the script exits non-zero; a timing never does. Phase
lines carry the seconds since start; the last three lines are bare: the
card's name and power limit, the kernels' JSON record and {"ok": true,
"device": {...}}. Without a CUDA device it exits non-zero before any
result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
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
N_NODES = 20_000  # grid nodes at most a table in the rectilinear routes' node check
LO, HI = -0.5, 10.5  # query range: the [0, 10] grid plus extrapolation
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}  # rtol = atol, kernel vs plain
# rtol = atol, a weight contraction vs the gather tree: the JAX package's
# bars (tests/test_pallas_v3.py, tests/test_pallas_df64.py)
GATHER_TOL = {torch.float32: 1e-4, torch.float64: 1e-13}
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
    engine: str | None = None  # INTERPN_TPU_F64 for the path: "df64" (K8) or "i8" (K9)

    @property
    def counter(self) -> str:
        """The key of ops.fused.launches that the path launches."""
        return self.engine or self.kernel

    @property
    def companion(self) -> str | None:
        """The key of ops.fused.launches that the path launches beside its
        kernel, once a call: the layout kernel of its route (the quads
        route's pack, the taps routes' cubic pack, the interleaved route's
        interleave)."""
        if self.engine:
            return None
        from interpn_tpu_torch.ops import fused

        layouts = {"regular": fused.STACK_LAYOUTS if self.stacked else fused.LAYOUTS,
                   "rectilinear": fused.RECT_LAYOUTS, "bspline": fused.BSPLINE_LAYOUTS}[self.kind]
        return layouts.get(self.route)

    @property
    def route(self) -> str | None:
        """The layout its kernel reads (`fused.regular_route`,
        `fused.rectilinear_route`, `fused.bspline_route`); None for an
        engine path."""
        if self.engine:
            return None
        from interpn_tpu_torch.ops import fused

        nch = NCH if self.stacked else None
        if self.kind == "bspline":
            return fused.bspline_route((self.n,) * self.ndims, self.dtype, self.k, nch)
        choose = fused.regular_route if self.kind == "regular" else fused.rectilinear_route
        return choose((self.n,) * self.ndims, self.dtype, self.method, nch)

    @property
    def native(self) -> "Path":
        """The same path on the native kernels."""
        return Path(self.kernel, self.dtype, self.n, self.ndims)

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
        engine = f" through {ENGINE_NAMES[self.engine]}" if self.engine else ""
        return f"{stack}{what} {self.n}^{self.ndims} {SHORT[self.dtype]}{engine}"


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
    # K2 linear and K3 on their other routes and on a long axis
    Path("rectilinear_linear", F64, 20, 3),
    Path("rectilinear_linear", F32, 100, 3),
    Path("rectilinear_nearest", F32, 1000, 2),
    Path("bspline_k3", F32, 20, 3),
    Path("bspline_k3", F64, 20, 3),
    Path("bspline_k3", F64, 100, 2),
    Path("bspline_k5", F32, 20, 3),
    Path("regular_linear_stack", F32, 20, 3),
    Path("regular_cubic_stack", F32, 20, 3),
    # K5 cubic on the tables' cubic packs (tap lanes), as the stack8 cell runs it
    Path("regular_cubic_stack", F64, 20, 4),
    Path("regular_nearest_stack", F32, 20, 3),
    Path("rectilinear_linear_stack", F32, 20, 3),
    Path("rectilinear_cubic_stack", F32, 20, 3),
    Path("rectilinear_nearest_stack", F32, 20, 3),
    Path("bspline_k3_stack", F32, 20, 3),
    # the f64 contraction engines under INTERPN_TPU_F64, set around each call;
    # the first path of each engine is its headline
    Path("regular_cubic", F64, 20, 3, "df64"),
    Path("regular_linear", F64, 20, 3, "df64"),
    Path("regular_cubic", F64, 12, 5, "df64"),
    Path("rectilinear_cubic", F64, 20, 3, "df64"),
    Path("bspline_k3", F64, 20, 3, "df64"),
    Path("bspline_k3", F64, 100, 2, "df64"),
    Path("regular_cubic", F64, 20, 3, "i8"),
    Path("regular_linear", F64, 20, 3, "i8"),
    Path("regular_cubic", F64, 12, 5, "i8"),
    Path("rectilinear_cubic", F64, 20, 3, "i8"),
]
ENGINE_NAMES = {"df64": "K8 (INTERPN_TPU_F64=df64)", "i8": "K9 (INTERPN_TPU_F64=i8)"}
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


REPLACES_F64 = {"df64": "interpn_tpu/ops/pallas_df64.py:479",
                "i8": "interpn_tpu/ops/pallas_i8.py:638"}
# H100 SXM, dense int8 on the tensor cores (a multiply-add is two operations)
PEAK_INT8_OPS = 1979e12


def replaces(p: Path) -> str:
    if p.engine:
        return REPLACES_F64[p.engine]
    stack = "_stack" if p.stacked else ""
    return REPLACES.get(p.kernel, REPLACES[f"{p.kind}{stack}"])


def served(method: str, route: str, stacked: bool, ndims: int, family="regular") -> bool:
    """Whether K1 (K5 where `stacked`) has an instantiation for the method
    on the route (csrc/regular.cuh::serves): staged serves linear and
    single-table cubic, staged groups the cubic stacks, quads single-table
    linear, interleaved the linear and nearest stacks, taps cubic (one
    table or a stack) at 2D, tap lanes from 3D.
    For the rectilinear `family`, K2 (K6) (csrc/rectilinear.cuh::rect_serves):
    direct every method; staged cubic; staged tables and interleaved the
    cubic stacks; taps single-table cubic from 2D; interleaved the linear
    and nearest stacks, staged the linear ones; guided one linear or
    nearest table, staged one linear table. For the B-spline `family`,
    K4 (K7) (csrc/bspline.cuh::spline_serves): direct and staged groups;
    interleaved the stacks."""
    from interpn_tpu_torch.ops import fused

    if family == "bspline":  # K4, K7 of any degree (csrc/bspline.cuh::spline_serves)
        return route in ("direct", "staged_groups") or (stacked and route == "interleaved")
    if family == "rectilinear":
        if route == "direct":
            return True
        if method != "cubic":
            if not stacked:
                return route == "guided" or (route == "staged" and method == "linear")
            return route == "interleaved" or (route == "staged" and method == "linear")
        if route == "taps":
            return not stacked and ndims >= 2
        return route == "staged" or (stacked and route in ("staged_tables", "interleaved"))
    if route == "staged_tables":
        return False
    if route == "staged_groups":
        return method == "cubic" and stacked
    if route == "staged":
        return method == "linear" or (method == "cubic" and not stacked)
    if route == "quads":
        return method == "linear" and not stacked
    if route == "interleaved":
        return method != "cubic" and stacked
    if route in fused.TAP_ROUTES:
        return method == "cubic" and (ndims == 2 if route == "taps" else ndims >= 3)
    return route == "direct"


@contextlib.contextmanager
def env_set(name, value):
    """name=value in the environment for the body (unset for None), then as
    before."""
    before = os.environ.pop(name, None)
    if value:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if before is not None:
            os.environ[name] = before


def f64_engine(engine):
    """INTERPN_TPU_F64=engine for the body (unset for None)."""
    return env_set("INTERPN_TPU_F64", engine)


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

    def plain(g, v, ob, dims=None):
        return fused.plain_rectilinear(g, v, ob, method, lin)
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


def engine_kernel_and_plain(p: Path, grid):
    """(K8 or K9's wrapper, its plain chain) for the path's engine on
    `path_grid`'s tensors, each fn(obs) -> (n,) float64: the wrapper
    (`ops.df64.eval_*`, `ops.i8.eval_*`) launches the kernel on CUDA
    tensors, the plain chain (`plain_*`: the float64 weights in torch, the
    contraction, the recombination) runs on the same tensors."""
    from interpn_tpu_torch.ops import df64, i8

    dims = (p.n,) * p.ndims
    module = df64 if p.engine == "df64" else i8
    if p.kind == "bspline":
        return (lambda ob: df64.eval_bspline(grid[0], grid[1], ob, p.k),
                lambda ob: df64.plain_bspline(grid[0], grid[1], ob, p.k))
    if p.kind == "regular":
        return (lambda ob: module.eval_regular(dims, *grid, ob, p.method),
                lambda ob: module.plain_regular(dims, *grid, ob, p.method))
    return (lambda ob: module.eval_rectilinear(*grid, ob, p.method),
            lambda ob: module.plain_rectilinear(*grid, ob, p.method))


def engine_call(p: Path, grid):
    """The engine's call through the op a user calls under INTERPN_TPU_F64
    (the route's table check and cache lookups, the kernel route) from
    `path_grid`'s tensors: fn(obs) -> (n,) float64."""
    from interpn_tpu_torch import ops

    dims = (p.n,) * p.ndims
    if p.kind == "bspline":
        return lambda ob: ops.bspline_eval(*grid, ob, p.k)
    fn = getattr(ops, f"{p.method}_{p.kind}")
    lin = (True,) if p.method == "cubic" else ()
    if p.kind == "regular":
        return lambda ob: fn(dims, *grid, ob, *lin)
    return lambda ob: fn(*grid, ob, *lin)


@contextlib.contextmanager
def weight_builds():
    """Count the calls of the torch float64 weight build (`weights_f64`,
    `spline_weights_f64`, wherever the engines' modules look them up) in
    the body: yields the list they append to."""
    from interpn_tpu_torch.ops import df64, i8

    calls = []
    saved = [(m, name, getattr(m, name)) for m in (df64, i8)
             for name in ("weights_f64", "spline_weights_f64") if hasattr(m, name)]

    def counting(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    for m, name, fn in saved:
        setattr(m, name, counting(name, fn))
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


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


# Operations of one rectilinear cubic axis past its bisection, by the region
# its coordinate falls in (`cubic_axis` and `RectUnitAxis` in
# csrc/interp_common.cuh): the grid differences, the coordinate, the
# difference weights, the reciprocals of the divisors and the two endpoint
# compares, then the four weights, the node on each unit basis, counting no
# operation on two constants, none that is a product with 0 or +-1 or a sum
# with 0, and no quotient that a select takes from a reciprocal. Interior
# cells: 17 + 51 (10, 16, 15 and 10 a weight); an edge cell, whose k1 comes
# from dy and k0 and needs no a1, c1 or q1: 11 + 47; outside the grid with
# linearized extrapolation, where the node is the line through y0 with
# slope k1: 9 + 14. (The Hermite tree's count was 12 + 4 * 27.)
RECT_AXIS_OPS = {"interior": 17 + 51, "edge": 11 + 47, "outside": 9 + 14}


def rect_axis_operations(axes, obs, lin=True) -> float:
    """RECT_AXIS_OPS summed over the axes, by the region of each coordinate
    (`cubic_axis`: iloc = partition_point - 2), averaged over the queries
    `obs`: what this run's data needs."""
    total = 0.0
    for g, x in zip(axes, obs):
        d = g.numel()
        iloc = torch.searchsorted(g, x.contiguous()) - 2
        low = iloc <= -1
        edge = low | (iloc >= d - 3)
        outside = (iloc < -1) | (~low & (iloc > d - 3))
        ops = torch.where(edge, RECT_AXIS_OPS["edge"], RECT_AXIS_OPS["interior"])
        if lin:
            ops = torch.where(outside, RECT_AXIS_OPS["outside"], ops)
        total += ops.double().mean().item()
    return total


def operations_per_query(p: Path, obs=None) -> float:
    """IEEE operations (add, sub, mul, div, compare) one query needs at
    least: per axis its locate, then per table per tree node its reduction
    (linear: one lerp, 3; regular cubic: the Hermite node, 17; B-spline: per
    axis the bisection of n + k + 1 knots and 7k(k+1)/2 for Cox-de Boor, per
    table one multiply and one add per stencil entry). Rectilinear cubic:
    per axis the bisection and `rect_axis_operations` on the queries `obs`
    (linearized extrapolation), then per table a multiply and an add per
    stencil entry, 2 * 4^N - 1, which is what the kernel computes."""
    nd = p.ndims
    if p.kind == "bspline":
        k = p.k
        per_axis = math.ceil(math.log2(p.n + 2 * k + 2)) + 7 * k * (k + 1) // 2
        return nd * per_axis + p.nch * (2 * (k + 1) ** nd - 1)
    search = math.ceil(math.log2(p.n + 1)) if p.kind == "rectilinear" else 0
    if p.method == "cubic" and p.kind == "rectilinear":
        axes = [torch.as_tensor(a, device=obs[0].device) for a in path_inputs(p)[0]]
        return nd * search + rect_axis_operations(axes, obs) + p.nch * (2 * 4**nd - 1)
    if p.method == "cubic":
        per_axis, per_node, nodes = 9, 17, (4**nd - 1) // 3
    else:
        per_axis = (7 if p.kind == "regular" else 3 + search) + (p.method == "nearest")
        per_node, nodes = (3, 2**nd - 1) if p.method == "linear" else (0, 0)
    return nd * per_axis + p.nch * per_node * nodes


# The fewest float32 operations of the double-float steps of csrc/df64.cuh
# (an add, subtract or multiply one, an FMA two, as in the float32 rate),
# TwoProd's exact error taken from one FMA (the same value as the kernels'
# Veltkamp split): df_madd, two_sum, df_mul, df_add
MADD, TWO_SUM, DF_MUL, DF_ADD = 18, 6, 10, 11
# K9 per quantized weight: two scalings, then per piece a scaling, rint, a
# multiply, a subtract and two_sum; per stencil row: 8 levels of conversion
# from int32 (two for s <= 5, after an integer 12-bit split not counted),
# scaling and df_add, the 4 scale restores, the centre's df_add and the
# closing two_sum (its df_mul counted apart)
QUANT = 2 + 7 * (4 + TWO_SUM)
ROW = 8 * DF_ADD + 2 * (6 * 2 + 2 * 1) + 4 + DF_ADD + TWO_SUM


def engine_operations(p: Path) -> tuple[int, int, int]:
    """(float32, float64, int8) operations one query needs in K8 or K9, at
    least, whatever the kernel's layout. Both: per axis the float64 locate
    and weights (as `operations_per_query` counts the locate and a node;
    each weight a node on a unit basis for cubic, 1 - t for linear, the
    Cox-de Boor build for a spline) and the hi/lo split of each weight (3),
    K9 also wsum. K8: a df_madd per stencil entry and per partial of the
    tree, a two_sum per tree node. K9: the trailing combined weights once,
    their peak and 7-piece quantization, S_w; per stencil row of the
    leading axes the recombination, restore and centre, and per stencil
    cell the 35 int8 piece-pair multiply-adds (2 operations each); a df_mul
    and df_add per tail entry."""
    from interpn_tpu_torch.ops import df64, i8

    nd = p.ndims
    fp = df64.FOOTPRINT[p.k if p.kind == "bspline" else p.method]
    if p.kind == "bspline":
        per_axis = math.ceil(math.log2(p.n + 2 * p.k + 2)) + 7 * p.k * (p.k + 1) // 2
    else:
        search = math.ceil(math.log2(p.n + 1)) if p.kind == "rectilinear" else 0
        if p.method == "cubic":
            locate, node = (9, 17) if p.kind == "regular" else (12 + search, 27)
        else:
            locate, node = (7, 1) if p.kind == "regular" else (4 + search, 1)
        per_axis = locate + fp * node
    f64 = nd * (per_axis + 3 * fp)
    if p.engine == "df64":
        madds = (fp ** (nd + 1) - fp) // (fp - 1)
        nodes = (fp**nd - 1) // (fp - 1)
        return MADD * madds + TWO_SUM * nodes, f64, 0
    f64 += nd * fp  # wsum
    g = i8._choose_group((p.n,) * nd)
    e, r = fp**g, fp ** (nd - g)
    f32 = (e * (g - 1) * DF_MUL + e + QUANT * e + g * (fp - 1) * DF_ADD + (g - 1) * DF_MUL
           + (ROW + DF_MUL) * r + (r - 1) // (fp - 1) * fp * (DF_MUL + DF_ADD))
    return f32, f64, r * e * 2 * i8.NPASSES


def engine_bytes(p: Path, n_queries: int) -> int:
    """K8/K9's inputs read once and output written once: per query the
    float64 coordinates and the float64 result; the grid (starts and steps,
    the axes, or the knots); the table once, at 8 bytes a cell (K8: its
    hi/lo split, whatever layout the kernel reads it in; K9: its 8 pieces)
    and, for K9, 12 bytes a row."""
    from interpn_tpu_torch.ops import i8

    per_query = 8 * p.ndims + 8
    if p.kind == "regular":
        grid = 16 * p.ndims
    else:
        grid = 8 * (p.n + (p.k + 1 if p.kind == "bspline" else 0)) * p.ndims
    table = 8 * p.n**p.ndims
    if p.engine == "i8":
        table += 12 * i8._shape((p.n,) * p.ndims)[1]
    return n_queries * per_query + grid + table


def bound(p: Path, n_queries: int, obs=None) -> tuple[float, str]:
    """The least time (ms) the card could take for `n_queries` queries
    (rectilinear cubic: those of `obs`), and what bounds it: each query
    coordinate, table entry and grid parameter (knot) read once and each
    result written once at the HBM rate, against the operations at the
    dtype's peak rate (K8, K9: `engine_bytes` against `engine_operations`,
    float32, float64 and int8 each on their own units)."""
    if p.engine:
        t_bytes = engine_bytes(p, n_queries) / PEAK_BYTES * 1e3
        f32, f64, i8_ops = engine_operations(p)
        t_ops = max(n_queries * f32 / PEAK_OPS[F32], n_queries * f64 / PEAK_OPS[F64],
                    n_queries * i8_ops / PEAK_INT8_OPS) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    item = torch.tensor([], dtype=p.dtype).element_size()
    if p.kind == "regular":
        grid_params = 2 * p.ndims
    elif p.kind == "rectilinear":
        grid_params = p.n * p.ndims
    else:
        grid_params = (p.n + p.k + 1) * p.ndims
    nbytes = (n_queries * (p.ndims + p.nch) + p.nch * p.n**p.ndims + grid_params) * item
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = n_queries * operations_per_query(p, obs) / PEAK_OPS[p.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phases ---------------------------------------------------------------------------


def build_phase():
    from interpn_tpu_torch import _build
    from interpn_tpu_torch.ops import fused

    sources = fused.SOURCES
    cached = {s: _build.library_path(s).exists() for s in (*sources, FLAG)}
    seconds = _build.build_all([*sources, FLAG])
    for source in sources:
        fused._fn(source)  # load and bind
        ptxas = _build.library_path(source).with_suffix(".log").read_text()
        built = "already built" if cached[source] else f"built in {seconds[source]:.3f} s"
        if source in ("fused_df64", "fused_i8"):
            engine_build_log(source, ptxas, built)
            continue
        if source.startswith(("fused_regular", "fused_rectilinear")):
            regular_build_log(source, ptxas, built)
            continue
        table = {}
        for m in re.finditer(
            r"_kernelI([fd])Li(\d)ELi(\d)E\S*' for \S+\n[^\n]*\n\s+\d+ bytes stack frame, "
            r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", ptxas):
            t, nd, k, spill, regs = m.groups()
            table.setdefault((f"k={k}", "f32" if t == "f" else "f64"), {})[int(nd)] = (
                int(regs), int(spill))
        if len(table) != 4 or any(len(v) != 8 for v in table.values()):
            raise AssertionError(f"{source}: unexpected kernels in the ptxas log: {table}")
        log(f"phase 1 build: {source}.cu {built} (one nvcc per source, all at once)")
        for (method, dt), by_nd in sorted(table.items()):
            cells = ", ".join(f"{nd}D {r}/{s}" for nd, (r, s) in sorted(by_nd.items()))
            log(f"phase 1   {source} {method} {dt}: registers/spill-store bytes {cells}")
        bspline_build_log(source)
    built = "already built" if cached[FLAG] else f"built in {seconds[FLAG]:.3f} s"
    flag_build_log(_build.library_path(FLAG).with_suffix(".log").read_text(), built)


# the regular entries' unrepresentable-coordinate flag (csrc/unrep_flag.cu),
# built and loaded apart from the wrappers' sources at the first flag on a
# CUDA tensor
FLAG = "unrep_flag"


def flag_build_log(ptxas, built):
    """Phase 1 for the flag's kernel: registers and spill stores of its f32
    and f64 instantiations from the ptxas log, and the registers, shared
    and local bytes and blocks an SM that its launch sizes the grid by
    (`ops.unrep.info`)."""
    from interpn_tpu_torch.ops import unrep

    found = re.findall(
        r"unrep_flag_kernelI([fd])E\S*' for \S+\n[^\n]*\n\s+(\d+) bytes stack frame, "
        r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", ptxas)
    if sorted(t for t, _, _, _ in found) != ["d", "f"]:
        raise AssertionError(f"{FLAG}: kernels in the ptxas log {found}, expected f32 and f64")
    unrep.entry()  # load and bind
    log(f"phase 1 build: {FLAG}.cu {built}")
    cells = []
    for t, stack, spill, regs in sorted(found, reverse=True):
        dtype = F32 if t == "f" else F64
        i = unrep.info(dtype)
        cells.append(f"{SHORT[dtype]} {regs}/{spill}/{stack} ({i['registers']}/"
                     f"{i['static_smem']}/{i['local_bytes']}/{i['blocks_per_sm']})")
    log(f"phase 1   {FLAG} registers/spill-store bytes/stack-frame bytes (registers/static "
        f"shared bytes/local bytes/blocks an SM of 256 threads): {', '.join(cells)}")


def bspline_build_log(source):
    """Phase 1 for K4 and K7: registers, static shared memory, local
    (spill) bytes and the blocks an SM holds at once as the launch sizes its
    grid (with the route's reservation of dynamic shared memory) of every
    instantiation (degree, route, dtype, 1-8D)."""
    from interpn_tpu_torch.ops import fused

    stacked = source.endswith("_stack")
    for k, route in itertools.product(fused.DEGREES, fused.ROUTES):
        if not served("cubic", route, stacked, 8, "bspline"):
            continue
        for dtype in (F32, F64):
            cells = []
            for nd in range(1, 9):
                i = fused.regular_info(k, dtype, nd, route, stacked, "bspline")
                cells.append(f"{nd}D {i['registers']}/{i['static_smem']}/{i['local_bytes']}/"
                             f"{i['blocks_per_sm']}")
            log(f"phase 1   {source} k={k} {route} {SHORT[dtype]}: registers/static shared "
                f"bytes/local bytes/blocks an SM {', '.join(cells)}")


# the layout kernel that the entry launches before the kernel, by route (a
# stack's cubic packs by the same kernel)
LAYOUT_KERNELS = {"quads": "pack_kernel", "interleaved": "interleave_kernel",
                  "taps": "cubic_pack_kernel", "tap_lanes": "cubic_pack_kernel"}


def regular_build_log(source, ptxas, built):
    """Phase 1 for K1 and K5 (K2/K3 and K6 for the rectilinear sources):
    registers, static shared memory and local (spill) bytes of every
    instantiation (method, route, dtype, 1-8D), and the blocks an SM holds
    at once as the launch sizes its grid: with the route's reservation of
    dynamic shared memory (the largest staged table, STAGE_BYTES, on the
    staged route; none on the others), for every (method, route) that has
    instantiations (`served`); and the registers and spill stores of the
    layout kernels (the packs, the interleave) from the ptxas log."""
    from interpn_tpu_torch.ops import fused

    stacked = source.endswith("_stack")
    family = source.removeprefix("fused_").removesuffix("_stack")
    log(f"phase 1 build: {source}.cu {built} (one nvcc per source, all at once)")
    layouts = re.findall(
        r"interp\d+(\w+?_kernel)I([fd])E\S*' for \S+\n[^\n]*\n\s+\d+ bytes stack frame, "
        r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", ptxas)
    # each source builds the layout kernels of the routes it serves, f32 and
    # f64, and no other
    want = {LAYOUT_KERNELS[r] for r in LAYOUT_KERNELS
            if any(served(m, r, stacked, nd, family) for m in fused.METHODS for nd in range(1, 9))}
    if sorted((name, t) for name, t, _, _ in layouts) != sorted(itertools.product(want, "fd")):
        raise AssertionError(f"{source}: layout kernels in the ptxas log {layouts}, "
                             f"expected {sorted(want)} in f32 and f64")
    log(f"phase 1   {source} layout kernels: registers/spill-store bytes "
        + ", ".join(f"{name} {'f32' if t == 'f' else 'f64'} {regs}/{spill}"
                    for name, t, spill, regs in sorted(layouts)))
    for method, route in itertools.product(fused.METHODS, fused.ROUTES):
        if not any(served(method, route, stacked, nd, family) for nd in range(1, 9)):
            continue
        for dtype in (F32, F64):
            cells = []
            for nd in range(1, 9):
                if not served(method, route, stacked, nd, family):
                    continue
                i = fused.regular_info(method, dtype, nd, route, stacked, family)
                cells.append(f"{nd}D {i['registers']}/{i['static_smem']}/{i['local_bytes']}/"
                             f"{i['blocks_per_sm']}")
            log(f"phase 1   {source} {method} {route} {SHORT[dtype]}: "
                f"registers/static shared bytes/local bytes/blocks an SM"
                f"{' at a table of STAGE_BYTES' if route == 'staged' else ''} "
                f"{', '.join(cells)}")


# K8's instantiations (2-8D by footprint 2, 4, 6) and K9's by route: dp4a
# (2-8D by footprint 2, 4 by trailing group g with footprint^g <= 16) and
# mma (footprint^g from 32 to 2048)
ENGINE_KERNELS = {"fused_df64": {"df64": 21}, "fused_i8": {"dp4a": 35, "mma": 18}}


def engine_build_log(source, ptxas, built):
    """Phase 1 for K8 and K9 (ENGINE_KERNELS): registers, spill stores and
    stack frame of each instantiation; and for the instantiations the
    engine paths launch, K9's route, shared bytes a block and the blocks an
    SM holds (`fused.engine_info`)."""
    from interpn_tpu_torch.ops import df64, fused, i8

    kinds = {"df64_kernel": "df64", "i8_kernel": "mma", "i8_dp4a_kernel": "dp4a"}
    table = {}
    for m in re.finditer(
            r"interp\d+(\w+?_kernel)ILi(\d)ELi(\d)E(?:Li(\d)E)?\S*' for \S+\n[^\n]*\n\s+(\d+) "
            r"bytes stack frame, (\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
            ptxas):
        name, nd, fp, g, stack, spill, regs = m.groups()
        kind = kinds[name]
        key = f"{kind} footprint {fp}" + (f" g={g}" if g else "")
        table.setdefault(kind, {}).setdefault(key, {})[int(nd)] = (int(regs), int(spill),
                                                                   int(stack))
    counts = {kind: sum(len(v) for v in keys.values()) for kind, keys in table.items()}
    if counts != ENGINE_KERNELS[source]:
        raise AssertionError(f"{source}: unexpected kernels in the ptxas log: {counts}")
    log(f"phase 1 build: {source}.cu {built} (one nvcc per source, all at once)")
    for kind in table:
        for key, by_nd in sorted(table[kind].items()):
            cells = ", ".join(f"{nd}D {r}/{s}/{f}" for nd, (r, s, f) in sorted(by_nd.items()))
            log(f"phase 1   {source} f64 {key}: registers/spill-store bytes/stack-frame bytes "
                f"{cells}")
    engine = source.removeprefix("fused_")
    cells = []
    for p in PATHS:
        if p.engine != engine:
            continue
        fp = df64.FOOTPRINT[p.k if p.kind == "bspline" else p.method]
        g = i8._choose_group((p.n,) * p.ndims) if engine == "i8" else None
        info = fused.engine_info(engine, fp, p.ndims, g)
        route = f" ({fused.i8_route(fp, g)})" if engine == "i8" else ""
        cells.append(f"{p.label}{route}: {info['registers']}/{info['local_bytes']}/"
                     f"{info['shared_bytes']}/{info['blocks_per_sm']}")
    log(f"phase 1   {source} registers/local bytes/shared bytes a block/blocks an SM of "
        f"the engine paths' instantiations: {'; '.join(cells)}")


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


# per ndims, a table under STAGE_BYTES in f32 and f64 and one over it in both
ROUTE_DIMS = [((50,), (40_000,)), ((20, 20), (200, 200)), ((20,) * 3, (40,) * 3),
              ((12,) * 4, (14,) * 4), ((6,) * 5, (8,) * 5), ((4,) * 6, (6,) * 6),
              ((3,) * 7, (5,) * 7), ((3,) * 8, (4,) * 8)]


def cubic_cap_dims(ndims, dtype):
    """Cubic tables (d0, 4, ..., 4) of `ndims` axes at each cap of the
    cubic route and one row over it: the table at STAGE_BYTES (staged,
    then the pack) and at L1_BYTES (f64 at 2-3D: direct, then the pack),
    the pack at TAP_BYTES (the pack, then direct); a cap that even a 4-row
    table exceeds gives only its row over."""
    from interpn_tpu_torch.ops import fused

    rest = 4 ** (ndims - 1)
    item = torch.empty((), dtype=dtype).element_size()
    at = [fused.STAGE_BYTES // (rest * item), fused.L1_BYTES // (rest * item),
          fused.TAP_BYTES // (4 * rest * item) + 3]
    rows = sorted({d for a in at for d in (a, a + 1) if d >= 4})
    return [(d, *(4,) * (ndims - 1)) for d in rows]


def regular_routes_phase(cuda):
    """Phase 2 for K1's routes: linear and nearest at 1-8D on a table under
    the staging cap and one over it (staged, quads, direct), cubic at 1-8D
    at and over each of its caps (`cubic_cap_dims`: staged, taps, tap
    lanes, direct) in both extrapolation modes, the
    bench's 100^3 table (quads, and its pack against `plain_pack`), and
    tables that are views at an odd offset (the staged copy's unaligned head
    and tail), each bitwise against its plain version with extrapolated,
    NaN and +-inf queries; every cubic pack against `plain_cubic_pack`; and
    the interleave of stacks of 1-16 tables against `plain_interleave`."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(13)
    routes, results = {}, 0
    cases = [(dims, dtype, 0) for pair in ROUTE_DIMS for dims in pair for dtype in (F32, F64)]
    cases += [(dims, dtype, 0) for nd in range(1, 9) for dtype in (F32, F64)
              for dims in cubic_cap_dims(nd, dtype)]
    cases += [((100,) * 3, F32, 0), ((100,) * 3, F64, 0)]
    cases += [(dims, dtype, off) for dims in ((20,) * 3, (30,) * 3, (12,) * 4, (7, 9), (3,))
              for dtype in (F32, F64) for off in (1, 2, 3)]
    for dims, dtype, off in cases:
        n = min(N_CHECK // 5, 2**26 // 4 ** len(dims))
        grid, obs = random_case("regular", dims, dtype, n, rng, cuda)
        if off:  # the same table as a view `off` entries into a larger tensor
            base = torch.empty(off + grid[2].numel(), dtype=dtype, device=cuda)
            base[off:] = grid[2]
            grid = (grid[0], grid[1], base[off:])
        methods = [(m, True) for m in ("linear", "nearest")]
        if min(dims) >= 4:
            methods += [("cubic", True), ("cubic", False)]
        for method, lin in methods:
            route = fused.regular_route(dims, dtype, method)
            routes[method, route] = routes.get((method, route), 0) + 1
            what = f"regular {method} lin={lin} {dims} {SHORT[dtype]} {route} offset {off}"
            got = fused.eval_regular(dims, *grid, obs, method, lin)
            results += bitwise(got, fused.plain_regular(dims, *grid, obs, method, lin), what)
        if fused.regular_route(dims, dtype, "linear") == "quads":
            bitwise(fused.pack(dims, grid[2]), fused.plain_pack(dims, grid[2]),
                    f"pack {dims} {SHORT[dtype]}")
        if min(dims) >= 4 and fused.regular_route(dims, dtype, "cubic") in fused.TAP_ROUTES:
            bitwise(fused.cubic_pack(dims, grid[2]), fused.plain_cubic_pack(dims, grid[2]),
                    f"cubic pack {dims} {SHORT[dtype]} offset {off}")
    stacks = 0
    for dims, nch in itertools.product(((50,), (20,) * 3, (12,) * 4, (4,) * 8), (1, 3, 8, 9, 16)):
        for dtype in (F32, F64):
            vals = torch.as_tensor(rng.standard_normal((nch, math.prod(dims))), dtype=dtype,
                                   device=cuda)
            stacks += bitwise(fused.interleave(vals), fused.plain_interleave(vals),
                              f"interleave of {nch} {dims} {SHORT[dtype]} tables")
    cubic = [r for r in fused.ROUTES if ("cubic", r) in routes]
    if cubic != [r for r in fused.ROUTES
                 if any(served("cubic", r, False, nd) for nd in range(1, 9))]:
        raise AssertionError(f"phase 2 ran K1 cubic on the routes {cubic} only")
    log(f"phase 2 kernel vs plain K1 routes: linear and nearest at 1-8D under and over the "
        f"staging cap of {fused.STAGE_BYTES} bytes, cubic (linearize True and False) at 1-8D "
        f"at and over each cap of its route, 100^3, and views at odd offsets 1-3 (f32, f64; "
        f"{', '.join(f'{m} {r} {c}' for (m, r), c in sorted(routes.items()))} launches): "
        f"all {results} results bitwise equal to the gather tree; every packed copy equal to "
        f"plain_pack and every cubic pack to plain_cubic_pack; the interleave of stacks of 1, "
        f"3, 8, 9, 16 tables at 1, 3, 4, 8D (f32, f64): all {stacks} values equal to "
        f"plain_interleave")


def rectilinear_routes_phase(cuda):
    """Phase 2 for the cubic routes of K2 and K6: one table at 1-8D at and
    over each cap of `fused.rectilinear_route` (`cubic_cap_dims`: staged,
    taps, tap lanes, direct) and stacks of 1, 3, 4 and 8 tables (staged,
    interleaved, direct), in f32 and f64 and both extrapolation modes, each
    bitwise against its plain version with extrapolated, NaN and +-inf
    queries, on the random table and on the same table holding a NaN, +inf
    and -inf inside stencils (where the contraction is not finite the
    kernel gives the gather tree's value); every node of each grid exact;
    staged_tables stacks of 21^3 tables, whose bytes are no multiple of
    16, aligned and as a view at an odd offset; and the bench paths (20^3
    f32 and f64, 100^3 f32, the stack of 8 at 20^3 f32) in both modes and
    both dtypes. Fails unless every route ran."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(17)
    cases = [(dims, dtype, None) for nd in range(1, 9) for dtype in (F32, F64)
             for dims in cubic_cap_dims(nd, dtype)]
    cases += [(dims, dtype, nch) for dims in ((9,), (20,) * 3, (12,) * 4, (4,) * 8)
              for dtype in (F32, F64) for nch in (1, 3, 4, 8)]
    routes, results, nodes = {}, 0, 0
    for dims, dtype, nch in cases:
        n = min(N_CHECK // 5, 2**26 // 4 ** len(dims) // (nch or 1))
        (grids, vals), obs = random_case("rectilinear", dims, dtype, n, rng, cuda, nch)
        spoilt = vals.clone().reshape(-1)
        spots = rng.choice(spoilt.numel(), 3, replace=False)
        spoilt[torch.as_tensor(spots, device=cuda)] = torch.tensor(
            [math.nan, math.inf, -math.inf], dtype=dtype, device=cuda)
        spoilt = spoilt.reshape(vals.shape)
        # every node of each table (of a large grid, evenly spaced N_NODES)
        idx = np.stack(np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")).reshape(
            len(dims), -1)[:, :: 1 + math.prod(dims) // N_NODES]
        at_nodes = tuple(g[torch.as_tensor(i, device=cuda)] for g, i in zip(grids, idx))
        flat_idx = torch.as_tensor(np.ravel_multi_index(idx, dims), device=cuda)
        route = fused.rectilinear_route(dims, dtype, "cubic", nch)
        routes[route] = routes.get(route, 0) + 1
        for table, lin in itertools.product((vals, spoilt), (True, False)):
            what = (f"rectilinear cubic lin={lin} {dims} {SHORT[dtype]} "
                    f"{'one table' if nch is None else f'stack of {nch}'} {route}"
                    f"{' with NaN and +-inf entries' if table is spoilt else ''}")
            if nch is None:
                got = fused.eval_rectilinear(grids, table, obs, "cubic", lin)
                want = fused.plain_rectilinear(grids, table, obs, "cubic", lin)
                node_vals = fused.eval_rectilinear(grids, table, at_nodes, "cubic", lin)
                node_want = table[flat_idx]
            else:
                got = fused.eval_rectilinear_stack(grids, table, obs, "cubic", lin)
                want = fused.plain_rectilinear_stack(grids, table, obs, "cubic", lin)
                node_vals = fused.eval_rectilinear_stack(grids, table, at_nodes, "cubic", lin)
                node_want = table[:, flat_idx]
            results += bitwise(got, want, what)
            if table is vals:
                nodes += bitwise(node_vals, node_want, f"{what} at the nodes")
    # staged_tables on 21^3 tables, whose bytes are no multiple of 16, so
    # that each table's copy loads an unaligned head and tail apart from its
    # cp.async middle: the stack aligned and as a view an odd number of
    # entries into its storage
    unaligned = 0
    for (dtype, nch), offset in itertools.product(((F32, 4), (F64, 3)), (0, 1)):
        dims = (21,) * 3
        (grids, vals), obs = random_case("rectilinear", dims, dtype, N_CHECK // 5, rng, cuda,
                                         nch)
        storage = torch.zeros(offset + vals.numel() + 5, dtype=dtype, device=cuda)
        view = storage[offset:offset + vals.numel()].view(vals.shape)
        view.copy_(vals)
        route = fused.rectilinear_route(dims, dtype, "cubic", nch)
        if route != "staged_tables":
            raise AssertionError(f"a stack of {nch} {dims} {SHORT[dtype]} takes {route}")
        routes[route] = routes.get(route, 0) + 1
        for lin in (True, False):
            unaligned += bitwise(
                fused.eval_rectilinear_stack(grids, view, obs, "cubic", lin),
                fused.plain_rectilinear_stack(grids, view, obs, "cubic", lin),
                f"rectilinear cubic lin={lin} {dims} {SHORT[dtype]} stack of {nch} {route} "
                f"at an offset of {offset} entries")
    results += unaligned
    bench =[Path("rectilinear_cubic", dt, n, 3) for dt in (F32, F64) for n in (20, 100)]
    bench += [Path("rectilinear_cubic_stack", dt, 20, 3) for dt in (F32, F64)]
    for p in bench:
        grids, vals = path_grid(p, cuda)
        obs = tuple(torch.as_tensor(rng.uniform(LO, HI, N_CHECK), dtype=p.dtype, device=cuda)
                    for _ in range(p.ndims))
        routes[p.route] = routes.get(p.route, 0) + 1
        kern, plain = (fused.eval_rectilinear_stack, fused.plain_rectilinear_stack) \
            if p.stacked else (fused.eval_rectilinear, fused.plain_rectilinear)
        for lin in (True, False):
            results += bitwise(kern(grids, vals, obs, "cubic", lin),
                               plain(grids, vals, obs, "cubic", lin),
                               f"{p.label} lin={lin} ({p.route})")
    ran = [r for r in fused.ROUTES if r in routes]
    if ran != [r for r in fused.ROUTES if served("cubic", r, True, 8, "rectilinear")
               or served("cubic", r, False, 8, "rectilinear")]:
        raise AssertionError(f"phase 2 ran K2/K6 cubic on the routes {ran} only")
    log(f"phase 2 kernel vs plain K2/K6 cubic routes: one table at 1-8D at and over each cap "
        f"of its route, stacks of 1, 3, 4, 8 at 1, 3, 4, 8D, and the bench paths 20^3 and "
        f"100^3 and stacks of {NCH} at 20^3 (f32, f64; linearize True and False; "
        f"{', '.join(f'{r} {c}' for r, c in routes.items())} cases): all {results} results "
        f"bitwise equal to the plain version (weights, contraction, the gather tree where it "
        f"is not finite), on random tables and on the same tables with a NaN, +inf and -inf "
        f"inside stencils, {unaligned} of them on staged_tables stacks of 21^3 tables "
        f"(bytes no multiple of 16) aligned and at an odd offset; all {nodes} node values "
        f"exact")


def over_cap(launch, what):
    """A staged launch over its cap must raise (the C entry's
    cudaErrorInvalidValue), not give way to another route."""
    try:
        launch()
    except RuntimeError as e:
        if "CUDA error 1" not in str(e):
            raise
        return
    raise AssertionError(f"{what}: a staged launch over its cap ran")


def lerp_cap_dims(ndims, dtype):
    """Tables (d0, 4, ..., 4) of `ndims` axes at and one row over each cap of
    one linear or nearest table's route (`fused.rectilinear_route`): table
    and guide within STAGE_BYTES (staged, f32 linear), the table within
    L1_BYTES (guided f32 linear from 3D), the guide within COLUMN_BYTES
    (guided); a cap that even a 2-row table exceeds gives only its row
    over."""
    from interpn_tpu_torch.ops import fused

    item = torch.empty((), dtype=dtype).element_size()
    rest = (4,) * (ndims - 1)

    def in_l1(dims):
        return math.prod(dims) * item <= fused.L1_BYTES

    out = set()
    for fits in (lambda dims: fused.guide_fits("staged", dims, dtype), in_l1,
                 lambda dims: fused.guide_fits("guided", dims, dtype)):
        d0 = 2
        while fits((d0, *rest)):
            d0 += 1
        out |= {(d, *rest) for d in (d0 - 1, d0) if d >= 2}
    return sorted(out)


def adversarial_obs(grids, n, rng):
    """n queries an axis drawn from: every knot, one ulp either side of it,
    every cell's midpoint, NaN, +-inf, +-0, points far outside the grid
    (+-1e30, +-the dtype's largest) and points spread over the grid and a
    span past each side."""
    obs = []
    for g in grids:
        a = g.cpu().numpy()
        npd = a.dtype.type
        big = np.finfo(npd).max
        span = a[-1] - a[0]
        pool = np.concatenate([
            a, np.nextafter(a, npd(np.inf)), np.nextafter(a, npd(-np.inf)),
            (a[:-1] + (a[1:] - a[:-1]) * npd(0.5)).astype(npd),
            np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, big, -big], dtype=npd),
            rng.uniform(a[0] - span, a[-1] + span, 64).astype(npd)])
        obs.append(torch.as_tensor(rng.choice(pool, n), device=g.device))
    return tuple(obs)


def rect_axes(kind, d, rng):
    """A sorted rectilinear axis of d points: jittered (`random_case`'s, from
    `rng`) or geometric over [0, 10] (cells growing by 1.3 from one to the
    next at 20 points: the finest buckets of the guided locate hold several
    knots)."""
    if kind == "geometric":
        a = np.cumsum(1.3 ** np.linspace(0.0, 19.0, d))
        return 10.0 * (a - a[0]) / (a[-1] - a[0])
    return np.cumsum(0.2 + rng.random(d))


def rectilinear_table_routes_phase(cuda):
    """Phase 2 for K2 linear and K3 (one linear or nearest table): tables at
    1-8D at and one row over each cap of their route (`lerp_cap_dims`:
    staged, guided, direct), a two-point axis, a 1000-point axis (1000^2)
    and axes above the column cap, on jittered and geometric axes, in f32
    and f64, with `adversarial_obs` queries: through the wrapper (one
    launch) and on every route that takes the table, each bitwise against
    the plain version; a guided or staged launch over its cap raises; every
    node exact through nearest. Fails unless every route ran."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(31)
    cases = [(dims, dtype, kind) for nd in range(1, 9) for dtype in (F32, F64)
             for i, dims in enumerate(lerp_cap_dims(nd, dtype))
             for kind in (("jittered", "geometric")[i % 2],)]
    cases += [(dims, dtype, kind) for dims in ((2,), (2, 20, 2), (20,) * 3, (1000, 1000),
                                               (3000, 2), (20, 20, 1400))
              for dtype in (F32, F64) for kind in ("jittered", "geometric")]
    ran, results, nodes = {}, 0, 0
    for dims, dtype, kind in cases:
        n = N_CHECK // 10
        grids = tuple(torch.as_tensor(rect_axes(kind, d, rng), dtype=dtype, device=cuda)
                      for d in dims)
        vals = torch.as_tensor(rng.standard_normal(math.prod(dims)), dtype=dtype, device=cuda)
        obs = adversarial_obs(grids, n, rng)
        cols = (fused._VOIDP * len(dims))(*(g.data_ptr() for g in grids))
        for method in ("linear", "nearest"):
            what = f"{'K3' if method == 'nearest' else 'K2'} {method} {dims} {SHORT[dtype]} {kind}"
            want = fused.plain_rectilinear(grids, vals, obs, method)
            route = fused.rectilinear_route(dims, dtype, method)
            fused.reset_launches()
            results += bitwise(fused.eval_rectilinear(grids, vals, obs, method), want,
                               f"{what} ({route})")
            if fused.launches != {k: int(k == f"rectilinear_{method}") for k in fused.launches}:
                raise AssertionError(f"{what}: launches {fused.launches}")
            ran[method, route, "picked"] = ran.get((method, route, "picked"), 0) + 1

            def on(r):
                return fused._relaid_launch("rectilinear", r, fused.RECT_LAYOUTS, dims, vals,
                                            obs, method, True, n, False, cols)
            for r in fused.ROUTES:
                if not served(method, r, False, len(dims), "rectilinear"):
                    continue
                if r != "direct" and not fused.guide_fits(r, dims, dtype):
                    over_cap(lambda: on(r), f"{what} {r}")
                    ran[method, r, "over the cap"] = ran.get((method, r, "over the cap"), 0) + 1
                    continue
                results += bitwise(on(r), want, f"{what} {r}")
            if method == "nearest" and math.prod(dims) <= 10 * N_NODES:
                idx = np.stack(np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")).reshape(
                    len(dims), -1)[:, :: 1 + math.prod(dims) // N_NODES]
                at = tuple(g[torch.as_tensor(i, device=cuda)] for g, i in zip(grids, idx))
                flat = torch.as_tensor(np.ravel_multi_index(idx, dims), device=cuda)
                nodes += bitwise(fused.eval_rectilinear(grids, vals, at, "nearest"), vals[flat],
                                 f"{what} at the nodes")
    want = {(m, r, "picked") for m in ("linear", "nearest") for r in fused.ROUTES
            if served(m, r, False, 3, "rectilinear") and (r != "staged" or m == "linear")}
    want |= {(m, r, "over the cap") for m in ("linear", "nearest") for r in ("guided", "staged")
             if served(m, r, False, 3, "rectilinear")}
    if set(ran) != want:
        raise AssertionError(f"phase 2 ran K2 linear / K3 on {sorted(ran)} only, want "
                             f"{sorted(want)}")
    log(f"phase 2 kernel vs plain K2 linear and K3 routes: one table at 1-8D at and one row "
        f"over each cap of its route (STAGE_BYTES for table and guide, COLUMN_BYTES "
        f"{fused.COLUMN_BYTES} for the guide), a two-point axis, 1000^2 and axes above the "
        f"column cap, jittered and geometric axes (f32, f64; "
        f"{', '.join(f'{m} {r} {w} {c}' for (m, r, w), c in sorted(ran.items()))} cases), "
        f"queries at every knot, one ulp either side, every midpoint, NaN, +-inf, +-0 and far "
        f"outside: all {results} results bitwise equal to the plain version through the "
        f"wrapper (one launch) and on every route; every guided or staged launch over its cap "
        f"raised; all {nodes} nearest node values exact")


def rectilinear_stack_routes_phase(cuda):
    """Phase 2 for K6 linear and nearest (K5's layouts on rectilinear
    stacks): stacks of 1, 3, 4, 7, 8, 9 and 17 tables at 1, 3, 4 and 8D and
    f32 linear stacks at and one row over STAGE_BYTES, aligned and as a view
    at an odd offset, each table holding a NaN, +inf and -inf, in f32 and
    f64, with extrapolated, NaN and +-inf queries: through the wrapper (one
    launch, and the interleave where it interleaves) and on every route that
    takes the stack (direct, interleaved, staged for linear within its cap),
    each bitwise against the plain version and each row bitwise against
    K2 / K3 on its table; a staged launch over the cap raises. Fails unless
    every route ran."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(23)
    ran, results = {}, 0
    cases = [(dims, dtype, nch, off) for dims in ((50,), (20,) * 3, (12,) * 4, (4,) * 8)
             for dtype in (F32, F64) for nch in (1, 3, 4, 7, 8, 9, 17) for off in (0, 3)]
    for nch in (1, 3, 8):  # f32 linear stacks at the staging cap and one row over
        at = fused.STAGE_BYTES // (nch * 16 * 16 * 4)
        cases += [((d0, 16, 16), F32, nch, off) for d0 in (at, at + 1) for off in (0, 1)]
    for dims, dtype, nch, off in cases:
        n = min(N_CHECK // 5, 2**24 // 2 ** len(dims) // nch)
        (grids, vals), obs = random_case("rectilinear", dims, dtype, n, rng, cuda, nch)
        flat = vals.reshape(-1)
        spots = torch.as_tensor(rng.choice(flat.numel(), 3 * nch, replace=False), device=cuda)
        flat[spots] = torch.tensor([math.nan, math.inf, -math.inf] * nch, dtype=dtype,
                                   device=cuda)
        vals = at_offset(vals, off) if off else vals
        cols = (fused._VOIDP * len(dims))(*(g.data_ptr() for g in grids))
        size = math.prod(dims) * nch * torch.empty((), dtype=dtype).element_size()
        for method in ("linear", "nearest"):
            what = (f"K6 {method} stack of {nch} {dims} {SHORT[dtype]} offset {off}")
            want = fused.plain_rectilinear_stack(grids, vals, obs, method)
            rows = [fused.eval_rectilinear(grids, vals[c], obs, method) for c in range(nch)]
            route = fused.rectilinear_route(dims, dtype, method, nch)
            fused.reset_launches()
            results += bitwise(fused.eval_rectilinear_stack(grids, vals, obs, method), want,
                               f"{what} ({route})")
            layout = fused.RECT_LAYOUTS.get(route)
            if fused.launches != {k: int(k in (f"rectilinear_{method}_stack", layout))
                                  for k in fused.launches}:
                raise AssertionError(f"{what}: launches {fused.launches}")
            routes = ["direct", "interleaved"]
            if method == "linear":
                routes.append("staged")

            def on(r):
                return fused._relaid_launch("rectilinear", r, fused.RECT_LAYOUTS, dims, vals,
                                            obs, method, True, n, True, cols)
            for r in routes:
                if r == "staged" and size > fused.STAGE_BYTES:
                    over_cap(lambda: on(r), f"{what} staged")
                    ran["over the cap", r] = ran.get(("over the cap", r), 0) + 1
                    continue
                got = on(r)
                results += bitwise(got, want, f"{what} {r}")
                for c in range(nch):
                    bitwise(got[c], rows[c], f"{what} {r}: table {c} vs the single-table "
                            "kernel")
                ran[method, r] = ran.get((method, r), 0) + 1
    want = {(m, r) for m in ("linear", "nearest") for r in fused.ROUTES
            if served(m, r, True, 3, "rectilinear")} | {("over the cap", "staged")}
    if set(ran) != want:
        raise AssertionError(f"phase 2 ran K6 linear/nearest on {sorted(ran)} only")
    log(f"phase 2 kernel vs plain K6 linear and nearest stack routes: stacks of 1, 3, 4, 7, "
        f"8, 9, 17 tables at 1, 3, 4, 8D and f32 linear stacks at and one row over "
        f"{fused.STAGE_BYTES} bytes, aligned and at an odd offset, with a NaN, +inf and -inf "
        f"in every table (f32, f64; {', '.join(f'{m} {r} {c}' for (m, r), c in ran.items())} "
        f"cases): all {results} results bitwise equal to the plain version, through the "
        "wrapper (one launch, and the interleave where it interleaves) and on every route, "
        "each table's row bitwise equal to K2 / K3 on that table; a staged launch over the "
        "cap raised")


def bspline_table_routes_phase(cuda):
    """Phase 2 for K4's routes: one coefficient table of degree 3 and 5 at
    and one row over the staging cap (GROUP_BYTES) and the
    bench tables (20^3, 100^2), aligned and as a view at an odd offset,
    holding a NaN, +inf and -inf, in f32 and f64, with extrapolated, NaN and
    +-inf queries: through the wrapper (one launch) and on every route that
    takes the table (direct, staged, staged groups within their caps), each
    bitwise against the plain version; a staged launch over its cap raises.
    Fails unless every route ran."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(29)
    ran, results = {}, 0
    caps = {"staged_groups": fused.GROUP_BYTES}
    for k, dtype in itertools.product(SPLINE.values(), (F32, F64)):
        item = torch.empty((), dtype=dtype).element_size()
        shapes = [(20,) * 3, (100,) * 2]
        for cap in caps.values():
            at = cap // (36 * item)
            shapes += [(at, 6, 6), (at + 1, 6, 6)]
        for dims, off in itertools.product(shapes, (0, 3)):
            knots, coeffs, obs = spline_case(dims, k, dtype, N_CHECK // 10, rng, cuda, 1)
            coeffs = coeffs.reshape(-1)
            coeffs[torch.as_tensor(rng.choice(coeffs.numel(), 3, replace=False),
                                   device=cuda)] = torch.tensor(
                [math.nan, math.inf, -math.inf], dtype=dtype, device=cuda)
            coeffs = at_offset(coeffs, off) if off else coeffs
            what = f"K4 k={k} {dims} {SHORT[dtype]} offset {off}"
            want = fused.plain_bspline(knots, coeffs, obs, k)
            route = fused.bspline_route(dims, dtype, k)
            fused.reset_launches()
            results += bitwise(fused.eval_bspline(knots, coeffs, obs, k), want,
                               f"{what} ({route})")
            if fused.launches != {name: int(name == f"bspline_k{k}") for name in fused.launches}:
                raise AssertionError(f"{what}: launches {fused.launches}")
            cols = (fused._VOIDP * len(dims))(*(t.data_ptr() for t in knots))

            def on(r):
                return fused._launch("fused_bspline", f"bspline_k{k}", (k, int(dtype == F64)),
                                     dims, coeffs, obs, obs[0].shape[0], False, cols, None,
                                     route=r)
            for r in ("direct", *caps):
                if r in caps and math.prod(dims) * item > caps[r]:
                    over_cap(lambda: on(r), f"{what} {r}")
                    ran[r, "over the cap"] = ran.get((r, "over the cap"), 0) + 1
                    continue
                results += bitwise(on(r), want, f"{what} {r}")
                ran[r, "within"] = ran.get((r, "within"), 0) + 1
    want = {("direct", "within")} | {(r, w) for r in caps for w in ("within", "over the cap")}
    if set(ran) != want:
        raise AssertionError(f"phase 2 ran K4 on {sorted(ran)} only")
    log(f"phase 2 kernel vs plain K4 routes: one table of degree 3 and 5 at and one row over "
        f"{fused.GROUP_BYTES} bytes, 20^3 and 100^2, aligned "
        f"and at an odd offset, with a NaN, +inf and -inf in the table (f32, f64; "
        f"{', '.join(f'{r} {w} {c}' for (r, w), c in ran.items())} cases): all {results} "
        f"results bitwise equal to the plain version; every staged launch over the cap raised")


def stack_routes(dims, dtype, family):
    """Every route of a K5 cubic (`family` "regular") or K7 ("bspline")
    stack of tables of `dims` that takes it: staged groups (each table
    within GROUP_BYTES), direct; for K5 also the tables' cubic packs (taps
    at 2D, tap lanes from 3D, at any size); for K7 also interleaved."""
    from interpn_tpu_torch.ops import fused

    routes = ["direct"]
    if math.prod(dims) * torch.empty((), dtype=dtype).element_size() <= fused.GROUP_BYTES:
        routes.append("staged_groups")
    if family == "regular" and len(dims) >= 2:
        routes.append("taps" if len(dims) == 2 else "tap_lanes")
    if family == "bspline":
        routes.append("interleaved")
    return routes


def at_offset(vals, offset):
    """`vals` as a view `offset` entries into a larger storage."""
    storage = torch.zeros(offset + vals.numel() + 5, dtype=vals.dtype, device=vals.device)
    view = storage[offset:offset + vals.numel()].view(vals.shape)
    view.copy_(vals)
    return view


# K5 cubic stacks of tables just above GROUP_BYTES, which the wrapper reads
# through the tables' cubic packs: (dtype, dims, tables)
PACKED_STACKS = [(F32, (240, 240), 8), (F32, (39,) * 3, 8), (F32, (16, 16, 16, 15), 3),
                 (F64, (13, 13, 13, 14), 8), (F64, (8,) * 5, 9), (F64, (20,) * 4, 8)]


def stack_routes_phase(cuda):
    """Phase 2 for the stack routes of K5 cubic and K7: stacks of 1, 3, 4,
    8, 9 and 17 tables of 20^3 and 21^3 entries (bytes no multiple of 16;
    1 to 6 groups, as the C entry splits them), and K5 stacks of tables
    above GROUP_BYTES (PACKED_STACKS),
    aligned and as a view at an odd offset, each table holding a NaN, +inf
    and -inf, in f32 and f64 (K5 in both extrapolation modes, K7 of degree
    3 and 5), with extrapolated, NaN and +-inf queries: through the wrapper
    (one launch, and the interleave or the stack's cubic pack where its
    route lays one out) and on every route that takes the stack
    (`stack_routes`), each bitwise against the plain version, each row
    bitwise against K1 / K4 on its table. Fails unless every route ran."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(19)
    ran, results = {}, 0

    def spoil(vals):
        flat = vals.reshape(-1)
        spots = torch.as_tensor(rng.choice(flat.numel(), 3 * len(vals), replace=False),
                                device=cuda)
        flat[spots] = torch.tensor([math.nan, math.inf, -math.inf] * len(vals),
                                   dtype=vals.dtype, device=cuda)
        return vals

    def k5(dims, dtype, nch, offset, n):
        nonlocal results
        (st, sp, vals), obs = random_case("regular", dims, dtype, n, rng, cuda, nch)
        vals = spoil(vals)
        vals = at_offset(vals, offset) if offset else vals
        for lin in (True, False):
            want = fused.plain_regular_stack(dims, st, sp, vals, obs, "cubic", lin)
            rows = [fused.eval_regular(dims, st, sp, vals[c], obs, "cubic", lin)
                    for c in range(nch)]
            route = fused.regular_route(dims, dtype, "cubic", nch)
            fused.reset_launches()
            what = f"K5 cubic lin={lin} stack of {nch} {dims} {SHORT[dtype]} offset {offset}"
            results += bitwise(fused.eval_regular_stack(dims, st, sp, vals, obs, "cubic", lin),
                               want, f"{what} ({route})")
            layout = fused.STACK_LAYOUTS.get(route)
            if fused.launches != {k: int(k in ("regular_cubic_stack", layout))
                                  for k in fused.launches}:
                raise AssertionError(f"{what}: launches {fused.launches}")
            for r in stack_routes(dims, dtype, "regular"):
                got = fused._relaid_launch("regular", r, fused.STACK_LAYOUTS, dims, vals, obs,
                                           "cubic", lin, obs[0].shape[0], True, st.data_ptr(),
                                           sp.data_ptr())
                results += bitwise(got, want, f"{what} {r}")
                for c in range(nch):
                    bitwise(got[c], rows[c], f"{what} {r}: table {c} vs K1")
                ran["K5", r] = ran.get(("K5", r), 0) + 1
        return route

    packed = set()
    for (dtype, dims, nch), offset in itertools.product(PACKED_STACKS, (0, 3)):
        packed.add(k5(dims, dtype, nch, offset, N_CHECK // 20))
    if packed != set(fused.TAP_ROUTES):
        raise AssertionError(f"PACKED_STACKS took the routes {packed}, want {fused.TAP_ROUTES}")
    for dtype, n, nch, offset in itertools.product((F32, F64), (20, 21), (1, 3, 4, 8, 9, 17),
                                                   (0, 3)):
        dims = (n,) * 3
        k5(dims, dtype, nch, offset, N_CHECK // 5)
        for k in SPLINE.values():
            knots, coeffs, sobs = spline_case(dims, k, dtype, N_CHECK // 5, rng, cuda, nch)
            coeffs = spoil(coeffs)
            coeffs = at_offset(coeffs, offset) if offset else coeffs
            want = fused.plain_bspline_stack(knots, coeffs, sobs, k)
            rows = [fused.eval_bspline(knots, coeffs[c], sobs, k) for c in range(nch)]
            route = fused.bspline_route(dims, dtype, k, nch)
            fused.reset_launches()
            what = f"K7 k={k} stack of {nch} {dims} {SHORT[dtype]} offset {offset}"
            results += bitwise(fused.eval_bspline_stack(knots, coeffs, sobs, k), want,
                               f"{what} ({route})")
            layout = fused.BSPLINE_LAYOUTS.get(route)
            if fused.launches != {name: int(name in (f"bspline_k{k}_stack", layout))
                                  for name in fused.launches}:
                raise AssertionError(f"{what}: launches {fused.launches}")
            cols = (fused._VOIDP * 3)(*(t.data_ptr() for t in knots))
            for r in stack_routes(dims, dtype, "bspline"):
                work = (torch.empty(coeffs.numel(), dtype=dtype, device=cuda)
                        if r == "interleaved" else None)
                got = fused._launch("fused_bspline_stack", f"bspline_k{k}_stack",
                                    (k, int(dtype == F64)), dims, coeffs, sobs, sobs[0].shape[0],
                                    True, cols, None if work is None else work.data_ptr(),
                                    route=r)
                results += bitwise(got, want, f"{what} {r}")
                for c in range(nch):
                    bitwise(got[c], rows[c], f"{what} {r}: table {c} vs K4")
                ran["K7", r] = ran.get(("K7", r), 0) + 1
    for family, kernel in (("regular", "K5"), ("bspline", "K7")):
        want = [r for r in fused.ROUTES if any(served("cubic", r, True, nd, family)
                                               for nd in (2, 3))]
        if [r for r in fused.ROUTES if (kernel, r) in ran] != want:
            raise AssertionError(f"phase 2 ran {kernel} on the routes "
                                 f"{[r for k, r in ran if k == kernel]} only")
    log(f"phase 2 kernel vs plain K5 cubic and K7 stack routes: stacks of 1, 3, 4, 8, 9, 17 "
        f"tables of 20^3 and 21^3 (bytes no multiple of 16), and K5 {PACKED_STACKS} (the "
        f"tables' cubic packs through the wrapper), aligned and at an odd offset, "
        f"with a NaN, +inf and -inf in every table (f32, f64; K5 linearize True and False, K7 "
        f"k=3 and 5; {', '.join(f'{k} {r} {c}' for (k, r), c in ran.items())} cases): all "
        f"{results} results bitwise equal to the plain version, through the wrapper (one "
        "launch, and the interleave or the stack's pack where its route lays one out) and on "
        "every route, each table's row "
        "bitwise equal to K1 / K4 on that table")
    interleave_admission(cuda)


def hold_free_below(cuda, target: int):
    """A filler allocation that leaves about `target` bytes of the card free
    (within a few MiB: the allocator rounds), or raises."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(cuda)[0]
    for step in range(8):
        try:
            return torch.empty(free - target + step * (64 << 20), dtype=torch.uint8, device=cuda)
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
    raise AssertionError(f"could not hold the card's free memory near {target} bytes")


def interleave_admission(cuda):
    """Phase 2, the interleave's admission by bytes: a K5 linear stack of
    NCH tables of 200^3 f32 (256 MB; its interleaved copy, which the
    wrapper allocates each call, as large) interleaves while the card has
    the copy's bytes free, and with a filler holding the free memory at
    half the copy the wrapper takes the direct route instead (where the
    interleave would run out of memory): one K5 launch and no interleave,
    bitwise the plain version on the same inputs both times."""
    from interpn_tpu_torch.ops import fused

    rng = np.random.default_rng(23)
    dims = (200,) * 3
    (st, sp, vals), obs = random_case("regular", dims, F32, N_CHECK // 5, rng, cuda, NCH)
    copy = vals.numel() * vals.element_size()
    want = fused.plain_regular_stack(dims, st, sp, vals, obs, "linear")
    routes = {}
    for held in (False, True):
        filler = hold_free_below(cuda, copy // 2) if held else None
        free = fused.free_bytes(vals)
        route = fused.regular_route(dims, F32, "linear", NCH, free)
        fused.reset_launches()
        got = fused.eval_regular_stack(dims, st, sp, vals, obs, "linear")
        torch.cuda.synchronize()
        launches = {k: v for k, v in fused.launches.items() if v}
        del filler
        torch.cuda.empty_cache()
        what = f"K5 linear stack of {NCH} 200^3 f32, {free} bytes free"
        bitwise(got, want, f"{what} ({route})")
        expect = {"regular_linear_stack": 1, **({"regular_interleave": 1}
                                               if route == "interleaved" else {})}
        if launches != expect:
            raise AssertionError(f"{what}: launches {launches}, want {expect}")
        routes[held] = (route, free)
    if routes[False][0] != "interleaved" or routes[True][0] != "direct":
        raise AssertionError(f"interleave admission: routes {routes}, want interleaved with "
                             f"{copy} bytes free and direct below")
    log(f"phase 2 interleave admission: K5 linear stack of {NCH} tables of 200^3 f32, its "
        f"interleaved copy {copy} bytes: interleaved with {routes[False][1]} bytes free, direct "
        f"with {routes[True][1]} free (a filler held), one K5 launch and the interleave only "
        "where it interleaved, each bitwise the plain version")


def engine_vs_plain_phase(cuda):
    """Phase 2 for K8 and K9: each wrapper (one launch: the float64 weights,
    the contraction and the recombination in the kernel) bitwise against its
    plain chain (the weights in torch, `plain_df64` / `plain_i8`, the
    recombination) on the same CUDA tensors, on f64 grids of 2-8D, regular
    and rectilinear, linear and cubic in both extrapolation modes, K8 also
    on splines of degree 3 and 5, with extrapolated, NaN and +-inf queries;
    K8 at the float range's edges, where TwoProd's steps overflow or
    underflow (`twoprod_edges`); then a table holding a NaN, which a forced
    engine leaves to the native kernel."""
    from interpn_tpu_torch.ops import df64, dispatch, fused, i8

    rng = np.random.default_rng(7)
    grid_cases = [(kind, method, lin) for kind in ("regular", "rectilinear")
                  for method, lin in (("linear", True), ("cubic", True), ("cubic", False))]
    for engine in ("df64", "i8"):
        module = df64 if engine == "df64" else i8
        cases = grid_cases + ([("bspline", k, True) for k in SPLINE.values()]
                              if engine == "df64" else [])
        results = 0
        for dims, (kind, method, lin) in itertools.product(CHECK_DIMS[1:], cases):
            fp = df64.FOOTPRINT[method]
            n = max(64, min(N_CHECK, 2**26 // fp ** len(dims)))
            if kind == "bspline":
                dims = tuple(max(d, fp) for d in dims)
                knots, coeffs, obs = spline_case(dims, method, F64, n, rng, cuda, 1)
                kern = lambda: df64.eval_bspline(knots, coeffs[0], obs, method)  # noqa: E731
                plain = lambda: df64.plain_bspline(knots, coeffs[0], obs, method)  # noqa: E731
            else:
                grid, obs = random_case(kind, dims, F64, n, rng, cuda)
                if kind == "regular":
                    args = (dims, *grid, obs, method, lin)
                    kern = lambda: module.eval_regular(*args)  # noqa: E731
                    plain = lambda: module.plain_regular(*args)  # noqa: E731
                else:
                    args = (*grid, obs, method, lin)
                    kern = lambda: module.eval_rectilinear(*args)  # noqa: E731
                    plain = lambda: module.plain_rectilinear(*args)  # noqa: E731
            what = f"{engine} {kind} {method} lin={lin} {dims}"
            results += engine_bitwise(engine, kern, plain, what)
        if engine == "df64":
            results += twoprod_edges(cuda, rng)
        # a table with a NaN keeps the native kernel under a forced engine
        grid, obs = random_case("regular", (20, 20, 20), F64, 10_000, rng, cuda)
        bad = grid[2].clone()
        bad[17] = float("nan")
        with f64_engine(engine):
            fused.reset_launches()
            got = dispatch.cubic_regular((20,) * 3, grid[0], grid[1], bad, obs, True)
            if {k: v for k, v in fused.launches.items() if v} != {"regular_cubic": 1}:
                raise AssertionError(f"{engine}: a NaN table launched {fused.launches}")
        bitwise(got, fused.plain_regular((20,) * 3, grid[0], grid[1], bad, obs, "cubic"),
                f"{engine}: NaN table through the native kernel")
        extra = (", splines k = 3 and 5, tables at the float range's edges" if engine == "df64"
                 else "")
        routes = (f", on the dp4a route up to {fused.DP4A_ENTRIES} trailing entries and the "
                  "mma route above" if engine == "i8" else "")
        log(f"phase 2 kernel vs plain {'K8' if engine == 'df64' else 'K9'} ({engine}) f64: "
            f"2-8D regular and rectilinear, linear and cubic "
            f"(linearize True and False){extra}, up to {N_CHECK} queries (extrapolation, NaN, "
            f"+-inf){routes}: all {results} float64 results of one launch each bitwise equal "
            "to the plain chain (weights in torch, contraction, recombination); a table "
            "holding a NaN under the forced engine launched the native K1 once and no engine")


def engine_bitwise(engine, kern, plain, what) -> int:
    """Hold one engine call against its plain chain: one launch, no torch
    weight build, bitwise; return the number of results compared."""
    from interpn_tpu_torch.ops import fused

    before = fused.launches[engine]
    with weight_builds() as built:
        got = kern()
    if fused.launches[engine] != before + 1 or built:
        raise AssertionError(f"{what}: {fused.launches[engine] - before} launches, weight "
                             f"builds {built}")
    return bitwise(got, plain(), what)


def twoprod_edges(cuda, rng) -> int:
    """K8 where TwoProd's steps leave the float range (where an FMA would
    part from them, csrc/df64.cuh): tables whose entries reach 2^113-2^118
    (Veltkamp's split of 4097 a overflows from 2^116) and tables whose
    entries, near 2^-100, multiply with the weights to 2^-100-2^-125
    (Dekker's partial products underflow below 2^-103), ordinary entries
    beside them, regular cubic and linear 3D with extrapolated, NaN and
    +-inf queries."""
    from interpn_tpu_torch.ops import df64

    results = 0
    dims = (9, 8, 10)
    for method, scale in itertools.product(("cubic", "linear"), (2.0**115, 2.0**-100)):
        grid, obs = random_case("regular", dims, F64, 20_000, rng, cuda)
        vals = grid[2] * scale
        vals[::7] = grid[2][::7]
        args = (dims, grid[0], grid[1], vals, obs, method, True)
        results += engine_bitwise("df64", lambda: df64.eval_regular(*args),
                                  lambda: df64.plain_regular(*args),
                                  f"df64 TwoProd edge {scale:g} {method}")
    return results


def engine_nodes(cuda):
    """Phase 3 for K8 and K9, on the 20^3 step-0.5 grid in f64, at every
    interior node, by linear and by cubic in both modes: K8 reproduces the
    table's double-float value hi + lo exactly (the split keeps about 48 of
    a double's 53 bits, so not the table itself) and the table within
    2^-47 relative; K9 the table within 1e-13 relative to its largest
    magnitude (the fixed-point error is absolute on a row's scale)."""
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import df64, i8

    rng = np.random.default_rng(11)
    vals = rng.standard_normal(8000)
    idx = np.stack(np.meshgrid(*[np.arange(20)] * 3, indexing="ij")).reshape(3, -1)
    interior = torch.from_numpy(np.all(idx <= 18, axis=0)).to(cuda)
    grid = convert.regular_grid_from_numpy(
        (20, 20, 20), np.zeros(3), np.full(3, 0.5), vals, device=cuda, dtype=F64)
    obs = convert.obs_from_numpy([i * 0.5 for i in idx], device=cuda, dtype=F64)
    want = grid[3][interior]
    vh, vl, _ = df64.table_split(grid[3])
    want_df = (vh.double() + vl.double())[interior]
    worst = {"K8": 0.0, "K9": 0.0}
    for method, lin in (("linear", True), ("cubic", True), ("cubic", False)):
        got = df64.eval_regular(*grid, obs, method, lin)[interior]
        if not torch.equal(got, want_df):
            raise AssertionError(f"K8 {method} lin={lin}: interior nodes not hi + lo exactly")
        torch.testing.assert_close(got, want, rtol=2.0**-47, atol=0)
        worst["K8"] = max(worst["K8"], float(((got - want).abs() / want.abs()).max()))
        got = i8.eval_regular(*grid, obs, method, lin)[interior]
        scale = float(grid[3].abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-13 * scale)
        worst["K9"] = max(worst["K9"], float((got - want).abs().max()) / scale)
    log(f"phase 3 nodes: all {int(interior.sum())} interior nodes of the 20^3 step-0.5 grid "
        "(f64), by linear and cubic (linearize True and False): K8 reproduces the table's "
        f"double-float value hi + lo exactly (worst {worst['K8']:.3e} relative to the f64 "
        f"table), K9 the table within 1e-13 of its largest magnitude (worst "
        f"{worst['K9']:.3e})")


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
    engine_nodes(cuda)


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
    counts; results checked; on a single regular table the flag's kernel
    counted and held against its plain version (`flag_vs_plain`). Returns
    (launches of its kernel, kernel-vs-plain max_abs_err, launches of its
    companion by name, launches of the flag's kernel)."""
    import interpn_tpu_torch
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import fused, unrep

    npd = np.float32 if p.dtype == F32 else np.float64
    axes, grid_np, vals = path_inputs(p)
    shape = [p.n] * p.ndims
    obs_np = [rng.uniform(LO, HI, N_MAIN).astype(npd) for _ in range(p.ndims)]
    obs_t = convert.obs_from_numpy(obs_np, device=cuda, dtype=p.dtype)
    grid = path_grid(p, cuda)
    regular = p.kind == "regular"
    flagged = regular and not p.stacked
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
    unrep.launches = 0
    results, counts, flags = {}, [], []
    with weight_builds() as built:  # the torch float64 weight build, on no path
        for name, call in calls.items():
            results[name] = call()
            counts.append(fused.launches[p.counter])
            flags.append(unrep.launches)
    torch.cuda.synchronize()
    others = {k: v for k, v in fused.launches.items() if k not in (p.counter, p.companion) and v}
    expected = list(range(1, len(calls) + 1))
    # every call of a single regular table goes through a regular raw shim,
    # which computes the flag once on the card; no other path computes it
    flags_expected = expected if flagged else [0] * len(calls)
    if counts != expected or others or built or (p.companion and
                                                 fused.launches[p.companion] != len(calls)):
        raise AssertionError(f"{p.label}: launch counts after each call {counts}, others "
                             f"{others}, {p.companion} {fused.launches.get(p.companion)}, "
                             f"torch weight builds {built}")
    if flags != flags_expected:
        raise AssertionError(f"{p.label}: flag launches after each call {flags}, want "
                             f"{flags_expected}")
    launches = fused.launches[p.counter]
    companions = {p.companion: fused.launches[p.companion]} if p.companion else {}
    companion = "".join(f", {k} launches {v} (one a call)" for k, v in companions.items())

    via_entry = results[entry]
    out_shape = (NCH, N_MAIN) if p.stacked else (N_MAIN,)
    for name, r in results.items():
        if r.shape != out_shape or r.dtype != npd or not np.isfinite(r).all():
            raise AssertionError(f"{p.label} {name}: {r.shape} {r.dtype}, finite="
                                 f"{np.isfinite(r).all()}")
        np.testing.assert_array_equal(r, via_entry, err_msg=f"{p.label} {name}")
    # the kernel against its plain version at the path's shape, on the card
    kern, plain = path_kernel_and_plain(p.native)
    tol = TOL[p.dtype]
    if p.engine:  # K8/K9 against their plain chains on the path's queries
        kern_e, plain_e = engine_kernel_and_plain(p, grid)
        k_out, p_out = kern_e(obs_t), plain_e(obs_t)
        bitwise(k_out, p_out, f"{p.label} kernel vs plain")
        err = max_abs_err(k_out, p_out)
        # the JAX package's bars of its f64 engines against the gather tree:
        # linear 1e-13, cubic 1e-12 (tests/test_pallas_df64.py:55,66), splines
        # 1e-11 of the largest coefficient where the queries extrapolate, as
        # these do (tests/test_bspline_engines.py:64)
        tol = 1e-13 if p.method == "linear" else 1e-12
        atol = 1e-11 * max(float(grid[1].abs().max()), 1.0) if p.kind == "bspline" else tol
    else:
        k_out = kern(*grid, obs_t, dims=tuple(shape))
        p_out = plain(*grid, obs_t, dims=tuple(shape))
        bitwise(k_out, p_out, f"{p.label} kernel vs plain")
        err = max_abs_err(k_out, p_out)
        atol = tol
    del k_out, p_out
    # the CPU gather tree on the first N_REF queries
    cpu_args = tuple(tuple(t.cpu() for t in a) if isinstance(a, tuple) else a.cpu()
                     for a in grid)
    sub = tuple(torch.from_numpy(o[:N_REF]) for o in obs_np)
    cpu = plain(*cpu_args, sub, dims=tuple(shape)).numpy()
    np.testing.assert_allclose(via_entry[..., :N_REF], cpu, rtol=tol, atol=atol,
                               err_msg=f"{p.label} vs the CPU plain version")
    gather_note = ""
    if p.kind == "rectilinear" and p.method == "cubic" and not p.engine:
        # the weights' contraction against the gather tree, at the JAX
        # package's bars for the cubic gather tree
        gather = fused.gather_rectilinear_stack if p.stacked else fused.gather_rectilinear
        bar = GATHER_TOL[p.dtype]
        np.testing.assert_allclose(via_entry[..., :N_REF],
                                   gather(*cpu_args, sub, "cubic").numpy(), rtol=bar, atol=bar,
                                   err_msg=f"{p.label} vs the CPU gather tree")
        gather_note = f", within rtol=atol={bar:g} of the CPU gather tree"
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
    weights = ", no torch float64 weight build" if p.engine else ""
    route = f" ({p.route} route)" if p.route else ""
    flag_note = (f", flag launches after each call {flags}, {flag_vs_plain(p, grid, obs_t)}"
                 if flagged else "")
    log(f"phase 4 path {p.label}{route} x {N_MAIN} queries: {', '.join(calls)}; {p.counter} "
        f"launches after each call {counts}{companion}{flag_note}, no other kernel{weights}; "
        "finite, "
        f"equal across entry points, kernel "
        f"bitwise equal to its plain version, within rtol {tol:g}, atol {atol:.3g} of the CPU "
        f"plain version{gather_note} on "
        f"{N_REF} queries and of {ref_name} on the {covered} of them it covers, every table "
        f"(rtol {REF_TOL[p.dtype]['rtol']:g}, atol {REF_TOL[p.dtype]['atol']:g})")
    return launches, err, companions, flags[-1]


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
    plain_n = N_MAIN  # queries a call of the plain version
    if p.engine:  # K8/K9's one launch from the queries, against the plain chain
        k_fn, p_fn = engine_kernel_and_plain(p, grid)
        timed_in, plain_in = main, main[:N_PLAIN]
        if p.n**p.ndims > 100_000:
            # the 12^5 plain chains run some 20-30k launches a call, whose
            # profile alone took a minute: a tenth of the queries a call
            plain_n = N_MAIN // 10
            plain_in = [tuple(o[:plain_n] for o in b) for b in main[:N_PLAIN]]
    else:
        timed_in, plain_in = main, main[:N_PLAIN]
        k_fn = lambda ob: kern(*grid, ob, dims=dims)  # noqa: E731
        p_fn = lambda ob: plain(*grid, ob, dims=dims)  # noqa: E731
    k_runs, p_runs, notes = [], [], []
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            k_runs.append(cuda_time(k_fn, timed_in))
        else:
            ms, note = profiled_ms(p_fn, plain_in, "plain")
            p_runs.append(ms)
            notes.append(note)
    del timed_in, plain_in
    whole = {}
    if p.engine:
        # the whole call through the op a user calls (the route's table check
        # and cache lookups, the kernel route, the one launch)
        t = cuda_time(engine_call(p, grid), main)
        whole = {"call_ms": t.device_ms}
        log(f"phase 5 timing {p.label}, the whole engine call through ops (route, cached "
            f"table layout, one launch) [{smi}]: "
            f"{t.device_ms:.4f} ms/call by CUDA events behind a head start "
            f"({'held' if t.ahead else 'DID NOT hold'}), {t.loop_ms:.4f} ms/call back to back")
    k_best = min(k_runs, key=lambda t: t.device_ms)
    k_dev, k_loop = k_best.device_ms, min(t.loop_ms for t in k_runs)
    ahead = all(t.ahead for t in k_runs)
    p_dev = min((t for t in p_runs if t is not None), default=None)
    b_ms, b_by = bound(p, N_MAIN, main[0])
    gaps = ""
    if p == GAP_PATH:  # the profiler leaves the gaps out; once, on the shortest kernel
        k_prof, k_note = profiled_ms(k_fn, main, "kernel")
        gaps = (f"; kernel by the profiler {k_prof:.4f} ms/call ({k_note}), so "
                f"{(k_dev - k_prof) * 1e3:.2f} us/launch of gaps between launches"
                if k_prof is not None else f"; kernel by the profiler: not recorded ({k_note})")
    plain_of = f" of {plain_n} queries" if plain_n != N_MAIN else ""
    plain_s = (f"plain version {p_dev:.4f} ms/call{plain_of} by the profiler "
               f"({'; '.join(notes)}), device-time speedup "
               f"{p_dev / k_dev * N_MAIN / plain_n:.1f}x at equal queries"
               if p_dev is not None else f"plain version: not recorded ({'; '.join(notes)})")
    log(f"phase 5 timing {p.label}, {N_BATCHES} distinct batches of {N_MAIN} queries "
        f"({N_PLAIN}{plain_of} for the plain version) [{smi}]: "
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
    # no PyTorch call computes a double-float or int8 multipass contraction
    if p.kind == "regular" and p.ndims == 3 and p.method in ("linear", "nearest") and not p.engine:
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
            "library_ms": lib_ms, **whole}


# the layout kernels (their counter in ops.fused.launches) and the path
# whose route launches each
LAYOUT_PATHS = {"regular_pack": Path("regular_linear", F32, 100, 3),
                "regular_cubic_pack": Path("regular_cubic", F32, 20, 4),
                "regular_interleave": Path("regular_linear_stack", F32, 20, 3),
                "regular_cubic_stack_pack": Path("regular_cubic_stack", F64, 20, 4),
                "rectilinear_interleave": Path("rectilinear_linear_stack", F32, 20, 3)}


def flag_vs_plain(p: Path, grid, obs_t) -> str:
    """The flag's kernel (`ops.unrep.flag` on CUDA tensors) against its
    plain version (`ops.unrep.plain`) on the path's grid and queries: as
    they are (all representable), then with one value planted in turn (NaN
    at the first query, +inf at the last, -inf and a far-out finite value
    in the middle of the last axis, NaN in the scalar head of a column one
    value off 16 bytes); one launch a call. Returns the log's note."""
    from interpn_tpu_torch.ops import unrep

    starts, steps = grid[0], grid[1]
    far = torch.finfo(p.dtype).max / 2  # (far - start) / step is beyond 2^63
    n, last = obs_t[0].numel(), len(obs_t) - 1
    plants = [("as drawn", None, 0, None), ("NaN first", 0, 0, math.nan),
              ("+inf last", last, n - 1, math.inf), ("-inf middle", last, n // 2, -math.inf),
              ("far-out middle", last, n // 2, far), ("NaN unaligned head", 0, 1, math.nan)]
    for what, axis, i, value in plants:
        cols = list(obs_t)
        if axis is not None:
            cols[axis] = cols[axis].clone()
            cols[axis][i] = value
        if what.endswith("unaligned head"):  # every column starts one value on
            cols = [c[1:] for c in cols]
        before = unrep.launches
        got = unrep.flag(starts, steps, cols)
        want = unrep.plain(starts, steps, cols)
        if unrep.launches != before + 1 or bool(got) != bool(want) or bool(got) != (
                axis is not None):
            raise AssertionError(f"{p.label} flag {what}: kernel {bool(got)}, plain "
                                 f"{bool(want)}, launches {unrep.launches - before}")
    return (f"the flag's kernel equal to its plain version at {n} x {len(obs_t)} queries as "
            f"drawn and with {', '.join(w for w, *_ in plants[1:])} planted, one launch each")


def layout_phase(name, cuda, smi, driven) -> dict:
    """Phase 5 for a layout kernel (`name`: the quads route's pack, the taps
    routes' cubic pack of one table or of a stack, the interleaved route's
    interleave) on its path's table: bitwise against its plain version; its
    device time and the plain version's from CUDA events behind a head start
    (the profiler came back from the pack's one-call trace empty on this
    card), in turns (plain, kernel, kernel, plain), each call laying out the
    one table as the path does; its bound (the table read once, the copy
    written once); and the one PyTorch call that computes the same copy:
    `.contiguous()` of the table's 2x2 windows (`unfold`) for the pack, of
    its windows of four along axis 0 for the cubic pack (each table's for a
    stack's), the plain version's `.t().contiguous()` itself for the
    interleave. Returns its entry of the kernels record."""
    from interpn_tpu_torch.ops import fused
    from interpn_tpu_torch.utils.profiling import cuda_time

    p = LAYOUT_PATHS[name]
    dims = (p.n,) * p.ndims
    vals = path_grid(p, cuda)[-1]
    if name == fused.PACK:
        kern, plain = (lambda v: fused.pack(dims, v)), (lambda v: fused.plain_pack(dims, v))
        lib = (lambda v: v.reshape(dims[0], dims[1], -1).unfold(0, 2, 1).unfold(1, 2, 1)
               .transpose(-1, -2).contiguous())
        lib_name, what = "the unfold windows' .contiguous()", "the pack of the quads route"
    elif name == fused.CUBIC_PACK:
        kern = lambda v: fused.cubic_pack(dims, v)  # noqa: E731
        plain = lambda v: fused.plain_cubic_pack(dims, v)  # noqa: E731
        lib = lambda v: v.reshape(dims).unfold(0, 4, 1).contiguous()  # noqa: E731
        lib_name, what = "the unfold windows' .contiguous()", "the cubic pack of the taps routes"
    elif name == fused.CUBIC_STACK_PACK:
        kern = lambda v: fused.cubic_stack_pack(dims, v)  # noqa: E731
        plain = lambda v: fused.plain_cubic_stack_pack(dims, v)  # noqa: E731
        lib = lambda v: v.reshape(-1, *dims).unfold(1, 4, 1).contiguous()  # noqa: E731
        lib_name, what = ("the unfold windows' .contiguous()",
                          "the cubic pack of the taps routes of a stack")
    else:
        kern = lambda v: fused.interleave(v, p.kind)  # noqa: E731
        plain = lib = fused.plain_interleave
        lib_name, what = ".t().contiguous()", "the interleave of the interleaved route"
    got, want = kern(vals), plain(vals)
    bitwise(got, want, f"{name} vs its plain version")
    if lib is not plain:
        bitwise(lib(vals).reshape(want.shape), want, f"{lib_name} vs {name}'s plain version")
    err = max_abs_err(got, want)
    b_ms = (vals.numel() + got.numel()) * vals.element_size() / PEAK_BYTES * 1e3
    del got, want
    same = [vals] * N_BATCHES
    k_runs, p_runs = [], []
    for step in ("plain", "kernel", "kernel", "plain"):
        if step == "kernel":
            k_runs.append(cuda_time(kern, same))
        else:
            p_runs.append(cuda_time(plain, same))
    lib_ms = (None if lib is plain else
              min(cuda_time(lib, same).device_ms for _ in range(2)))
    k_best = min(k_runs, key=lambda t: t.device_ms)
    ahead = all(t.ahead for t in k_runs)
    p_dev = min(t.device_ms for t in p_runs)
    lib_ms = p_dev if lib_ms is None else lib_ms
    log(f"phase 5 timing {what} on the {p.label} table [{smi}]: kernel "
        f"{k_best.device_ms:.4f} ms/call by CUDA events behind a head start "
        f"({'held' if ahead else 'DID NOT hold'}), {k_best.loop_ms:.4f} ms/call back to back; "
        f"bound {b_ms:.4f} ms by bytes ({b_ms / k_best.device_ms:.1%} of it); plain version "
        f"{p_dev:.4f} ms/call and {lib_name} {lib_ms:.4f} ms/call, by CUDA events behind a "
        "head start")
    return {
        "name": f"fused_{name}",
        "route": "cuda",
        "source": f"interpn_tpu_torch/csrc/fused_{p.kind}{'_stack' if p.stacked else ''}.cu",
        "replaces": replaces(p),
        "config": f"{what.split(' of the ')[0].removeprefix('the ')} of the {p.label} table",
        "launches": driven[p][2][name],
        "max_abs_err": err,
        "ms": k_best.device_ms,
        "ahead": ahead,
        "plain_ms": p_dev,
        "bound_ms": b_ms,
        "bound_by": "bytes",
        "library_ms": lib_ms,
    }


# the flag's timings: queries and axes a call, by dtype, and the path whose grid it reads
FLAG_SIZES = ((F32, N_MAIN, 3), (F32, 100_000_000, 3), (F64, 10_000_000, 3))
FLAG_PATH = PATHS[0]  # 20^3 f32 linear: its kernels-record entry


def flag_phase(cuda, smi, driven) -> dict:
    """Phase 5 for the flag's kernel (`ops.unrep.flag` on CUDA tensors) at
    each of FLAG_SIZES on the 20^3 grid: unset on the drawn queries, as its
    plain version (`ops.unrep.plain`) is, one launch a call; its device
    time and the plain version's by CUDA events behind a head start, in
    turns (plain, kernel, kernel, plain), over distinct batches where
    N_BATCHES of them fit in 1 GiB (one batch again and again above, each
    far beyond the L2); and its bound (the columns read once). Returns its
    entry of the kernels record, at the first size."""
    from interpn_tpu_torch.ops import unrep
    from interpn_tpu_torch.utils.profiling import cuda_time

    gen = torch.Generator(device=cuda)
    gen.manual_seed(20)
    entry = None
    for dtype, n, ndims in FLAG_SIZES:
        starts, steps = path_grid(Path("regular_linear", dtype, 20, ndims), cuda)[:2]
        itemsize = torch.finfo(dtype).bits // 8
        distinct = N_BATCHES if N_BATCHES * ndims * n * itemsize <= 2**30 else 1
        batches = [tuple(torch.rand(n, generator=gen, device=cuda, dtype=dtype) * (HI - LO) + LO
                         for _ in range(ndims)) for _ in range(distinct)]
        obs = batches[0]
        calls = []

        def kern(ob):
            calls.append(1)
            return unrep.flag(starts, steps, ob)

        def plain(ob):
            return unrep.plain(starts, steps, ob)
        before = unrep.launches
        if bool(kern(obs)) or bool(plain(obs)):
            raise AssertionError(f"flag at {ndims} x {n} {SHORT[dtype]}: set on drawn queries")
        timed = (batches * N_BATCHES)[:N_BATCHES]
        k_runs, p_runs = [], []
        for step in ("plain", "kernel", "kernel", "plain"):
            (k_runs if step == "kernel" else p_runs).append(
                cuda_time(kern if step == "kernel" else plain, timed))
        launched = unrep.launches - before
        if launched != len(calls):
            raise AssertionError(f"flag at {ndims} x {n} {SHORT[dtype]}: {launched} launches "
                                 f"in {len(calls)} calls")
        k_best = min(k_runs, key=lambda t: t.device_ms)
        ahead = all(t.ahead for t in k_runs)
        p_dev = min(t.device_ms for t in p_runs)
        b_ms = ndims * n * itemsize / PEAK_BYTES * 1e3
        log(f"phase 5 timing the flag's kernel at {ndims} x {n:,} {SHORT[dtype]} queries, "
            f"{distinct} distinct batch{'es' if distinct > 1 else ''} [{smi}]: {k_best.device_ms:.4f} ms/call by CUDA events behind a head start "
            f"({'held' if ahead else 'DID NOT hold'}; one launch a call, {launched} in all), "
            f"{k_best.loop_ms:.4f} ms/call back to back; bound {b_ms:.4f} ms by bytes "
            f"({b_ms / k_best.device_ms:.1%} of it); plain version {p_dev:.4f} ms/call by "
            f"CUDA events behind a head start ({p_dev / k_best.device_ms:.1f}x)")
        if entry is None:
            entry = {
                "name": FLAG,
                "route": "cuda",
                "source": f"interpn_tpu_torch/csrc/{FLAG}.cu",
                "replaces": "none: the JAX package's flag is jnp ops "
                            "(interpn_tpu/raw.py::_unrep_flag)",
                "config": f"{FLAG_PATH.label} grid, {ndims} x {n} queries",
                "launches": driven[FLAG_PATH][3],
                "max_abs_err": 0.0,  # a flag: equal or not (phase 4 raises where not)
                "ms": k_best.device_ms,
                "ahead": ahead,
                "plain_ms": p_dev,
                "bound_ms": b_ms,
                "bound_by": "bytes",
                "library_ms": None,
            }
        del obs, batches, timed
    return entry


# --- phase 6: pchip, the 1D interpolants and the model classes ----------------------

N_SCIPY = 10_000  # pchip queries held against scipy's
N_SLICE_BATCHES = 5  # distinct batches a timing of phase 6
N_HOST = 5  # calls a host-clock timing of a class entry
N_GRAD = 10_000  # queries of the gradient check


def slice_batches(gen, ndims, dtype, cuda):
    return [tuple(torch.rand(N_MAIN, generator=gen, device=cuda, dtype=dtype) * (HI - LO) + LO
                  for _ in range(ndims)) for _ in range(N_SLICE_BATCHES)]


def gather_tree_timing(fn, batches) -> dict:
    """A gather tree's time per call: CUDA events around the calls (behind
    a head start where the host gets ahead of the device, else the host's
    queueing included) and the profiler's device events, whose sum is the
    time the device was busy; `launches` is the device events a call."""
    from interpn_tpu_torch.utils.profiling import cuda_time, profiled_time

    t = cuda_time(fn, batches)
    prof = profiled_time(fn, batches[:3])
    return {"ms": t.device_ms, "ahead": t.ahead, "loop_ms": t.loop_ms,
            "busy_ms": prof.device_ms, "launches": prof.per_call}


def timing_note(t, b_ms=None) -> str:
    busy = (f"device busy {t['busy_ms']:.4f} ms/call by the profiler "
            f"({t['busy_ms'] / t['ms']:.1%} of the events' time)"
            if t["busy_ms"] is not None else "device busy time: not recorded")
    bound_s = f"; byte bound {b_ms:.4f} ms ({b_ms / t['ms']:.2%} of it)" if b_ms else ""
    return (f"{t['ms']:.4f} ms/call by CUDA events "
            f"({'behind a head start' if t['ahead'] else 'host queueing included'}), "
            f"{t['loop_ms']:.4f} ms/call back to back, {busy}, {t['launches']} device "
            f"launches a call{bound_s}")


def pchip_phase(cuda, smi, gen) -> list[dict]:
    """pchip on the card (a torch gather tree, no hand kernel): regular
    20^3 f64 and f32 and rectilinear 20^3 f64 at 1e6 queries in [-0.5,
    10.5], f64 against scipy's RegularGridInterpolator(method="pchip") on
    N_SCIPY of them, f32 against the f64 result, each against the CPU tree;
    interpn_stack pchip of 8 tables at 20^3 f32 from numpy, each row bitwise
    the single-table call. Each timed; no kernel of ops.fused launches."""
    import scipy.interpolate as si

    import interpn_tpu_torch
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.ops import fused, pchip

    rows = []
    x, vals = bench_grid(20, 3)
    dims = (20,) * 3
    rng = np.random.default_rng(6)
    obs_np = [rng.uniform(LO, HI, N_MAIN) for _ in range(3)]
    f64_results = {}
    for kind, dtype in (("regular", F64), ("regular", F32), ("rectilinear", F64)):
        npd = np.float32 if dtype == F32 else np.float64
        axes = [x] * 3 if kind == "regular" else bench_rect_axes(20, 3)
        axes = [a.astype(npd) for a in axes]
        table = vals.ravel().astype(npd)
        if kind == "regular":
            grid = convert.obs_from_numpy((np.zeros(3, npd), np.full(3, axes[0][1] - axes[0][0])),
                                          device=cuda, dtype=dtype)
            args = (dims, *grid)
            fn_name = "pchip_regular"
        else:
            args = (convert.obs_from_numpy(axes, device=cuda, dtype=dtype),)
            fn_name = "pchip_rectilinear"
        v = torch.from_numpy(table).to(cuda)

        def fn(ob, args=args, v=v, fn_name=fn_name):
            return getattr(pchip, fn_name)(*args, v, ob)

        obs_t = convert.obs_from_numpy(obs_np, device=cuda, dtype=dtype)
        fused.reset_launches()
        got = fn(obs_t)
        torch.cuda.synchronize()
        kernels = {k: n for k, n in fused.launches.items() if n}
        if kernels or got.shape != (N_MAIN,) or got.dtype != dtype or not got.isfinite().all():
            raise AssertionError(f"pchip {kind} {SHORT[dtype]}: {got.shape} {got.dtype}, "
                                 f"finite={bool(got.isfinite().all())}, kernels {kernels}")
        label = f"pchip {kind} 20^3 {SHORT[dtype]}"
        # the CPU tree on the same inputs
        cpu_args = ((dims, *(t.cpu() for t in args[1:])) if kind == "regular"
                    else (tuple(t.cpu() for t in args[0]),))
        sub = tuple(torch.from_numpy(o[:N_REF].astype(npd)) for o in obs_np)
        cpu = getattr(pchip, fn_name)(*cpu_args, v.cpu(), sub)
        tol = TOL[dtype]
        torch.testing.assert_close(got[:N_REF].cpu(), cpu, rtol=tol, atol=tol)
        differ = not_bitwise(got[:N_REF].cpu(), cpu)
        ref = si.RegularGridInterpolator(tuple(a.astype(np.float64) for a in axes),
                                         table.astype(np.float64).reshape(dims), method="pchip",
                                         bounds_error=False, fill_value=None)(
            np.stack([o[:N_SCIPY].astype(npd).astype(np.float64) for o in obs_np], -1))
        g = got[:N_SCIPY].double().cpu().numpy()
        rel = float(np.max(np.abs(g - ref) / np.maximum(1.0, np.abs(ref))))
        bar = 1e-12 if dtype == F64 else REF_TOL[F32]["rtol"]
        if not rel < bar:
            raise AssertionError(f"{label}: max relative error {rel:.3g} against scipy's pchip")
        if dtype == F64:
            f64_results[kind] = got
        else:
            rel32 = float(((got.double() - f64_results[kind]).abs()
                           / f64_results[kind].abs().clamp(min=1.0)).max())
            if not rel32 < bar:
                raise AssertionError(f"{label}: {rel32:.3g} from the f64 result")
        t = gather_tree_timing(fn, slice_batches(gen, 3, dtype, cuda))
        item = 8 if dtype == F64 else 4
        grid_params = 6 if kind == "regular" else 60
        b_ms = (N_MAIN * 4 + 20**3 + grid_params) * item / PEAK_BYTES * 1e3
        log(f"phase 6 {label} x {N_MAIN} queries through ops.{fn_name} from CUDA tensors: "
            f"finite, no ops.fused kernel launched; within rtol=atol={tol:g} of the CPU tree on "
            f"{N_REF} queries ({differ} not bitwise); max relative error {rel:.3g} against "
            f"scipy's RegularGridInterpolator(method='pchip') on {N_SCIPY} (bar {bar:g}) "
            f"[{smi}]: {timing_note(t, b_ms)}")
        rows.append({"path": label, "entry": f"ops.{fn_name}", **t, "bound_ms": b_ms,
                     "scipy_rel": rel})
    del f64_results

    # interpn_stack of 8 tables from numpy, and the stack function it calls
    npd = np.float32
    stack = np.stack([vals.ravel() + c for c in range(NCH)]).astype(npd)
    obs32 = [o.astype(npd) for o in obs_np]
    via_entry = interpn_tpu_torch.interpn_stack(obs32, [x.astype(npd)] * 3,
                                                stack.reshape(NCH, *dims), method="pchip",
                                                assume_regular=True)
    st, sp = convert.obs_from_numpy((np.zeros(3, npd), np.full(3, npd(x[1]) - npd(x[0]))),
                                    device=cuda, dtype=F32)
    v8 = torch.from_numpy(stack).to(cuda)
    obs_t = convert.obs_from_numpy(obs32, device=cuda, dtype=F32)
    for c in range(NCH):
        one = pchip.pchip_regular(dims, st, sp, v8[c], obs_t).cpu().numpy()
        np.testing.assert_array_equal(via_entry[c], one, err_msg=f"pchip stack row {c}")

    def fn8(ob):
        return pchip.pchip_regular_stack(dims, st, sp, v8, ob)

    t = gather_tree_timing(fn8, slice_batches(gen, 3, F32, cuda))
    b_ms = (N_MAIN * (3 + NCH) + NCH * 20**3 + 6) * 4 / PEAK_BYTES * 1e3
    label = f"pchip stack of {NCH} regular 20^3 f32"
    log(f"phase 6 {label} x {N_MAIN} queries: interpn_stack() from numpy, each row bitwise "
        f"equal to ops.pchip_regular on its table; pchip.pchip_regular_stack from CUDA tensors "
        f"[{smi}]: {timing_note(t, b_ms)}")
    rows.append({"path": label, "entry": "pchip.pchip_regular_stack", **t, "bound_ms": b_ms})
    return rows


def one_dim_reference(name, grid, vals, x, start=None, step=None):
    """The 1D interpolant `name` in float64 numpy: (values, mask of the
    queries it speaks for; Nearest1D leaves out near ties, where float32
    distances may order the two nodes the other way)."""
    n = len(vals)
    if start is not None:
        i = np.clip(np.floor((x - start) / step), 0, n - 2).astype(np.int64)
        x0 = start + step * i
        x1 = x0 + step
    else:
        i = np.clip(np.searchsorted(grid, x, side="left") - 1, 0, n - 2)
        x0, x1 = grid[i], grid[i + 1]
    y0, y1 = vals[i], vals[i + 1]
    lo, hi = x < (grid[0] if start is None else start), x > (grid[-1] if start is None else
                                                             start + step * (n - 1))
    lin = y0 + (y1 - y0) / (x1 - x0) * (x - x0)
    ok = np.ones(x.shape, bool)
    if name == "Linear1D":
        return lin, ok
    if name == "LinearHoldLast1D":
        return np.where(lo, y0, np.where(hi, y1, lin)), ok
    if name == "Left1D":
        return np.where(hi, y1, y0), ok
    if name == "Right1D":
        return np.where(lo, y0, y1), ok
    d0, d1 = np.abs(x - x0), np.abs(x - x1)
    ok = np.abs(d1 - d0) > 4 * np.spacing(np.float32(np.abs(x).max()))
    return np.where(d1 >= d0, y0, y1), ok


def one_dim_phase(cuda, smi, gen) -> list[dict]:
    """The 1D interpolants on the card: Linear1D on bench.py's regular
    1000-point f32 grid (vals = sin(x)) and the other four on a jittered
    1000-point grid, at 1e6 queries in [-0.5, 10.5], each against a float64
    numpy version of its rule, and timed."""
    from interpn_tpu_torch.ops import one_dim

    rows = []
    x = np.linspace(0.0, 10.0, 1000)
    vals = np.sin(x).astype(np.float32)
    start, step = np.float32(0.0), np.float32(x[1] - x[0])
    rect_x = bench_rect_axes(1000, 1)[0].astype(np.float32)
    v = torch.from_numpy(vals).to(cuda)
    reg = one_dim.RegularGrid1D(start, step, v)
    rect = one_dim.RectilinearGrid1D(torch.from_numpy(rect_x).to(cuda), v)
    batches = slice_batches(gen, 1, F32, cuda)
    for name in ("Linear1D", "LinearHoldLast1D", "Left1D", "Right1D", "Nearest1D"):
        regular = name == "Linear1D"
        interp = getattr(one_dim, name)(reg if regular else rect)
        locs = batches[0][0]
        got = interp.eval(locs)
        if got.shape != (N_MAIN,) or got.dtype != F32 or got.device != locs.device:
            raise AssertionError(f"{name}: {got.shape} {got.dtype} {got.device}")
        xs = locs.double().cpu().numpy()
        grid64 = (np.float64(start) + np.float64(step) * np.arange(1000) if regular
                  else rect_x.astype(np.float64))
        ref, ok = one_dim_reference(name, grid64, vals.astype(np.float64), xs,
                                    *((np.float64(start), np.float64(step)) if regular else ()))
        g = got.double().cpu().numpy()
        if name in ("Left1D", "Right1D", "Nearest1D"):
            np.testing.assert_array_equal(g[ok], ref[ok], err_msg=name)
            how = "equal to"
        else:
            np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5, err_msg=name)
            how = "within rtol=atol=1e-5 of"
        t = gather_tree_timing(lambda ob, interp=interp: interp.eval(ob[0]), batches)
        b_ms = (2 * N_MAIN + 1000 * (1 if regular else 2)) * 4 / PEAK_BYTES * 1e3
        kind = "regular" if regular else "rectilinear"
        label = f"{name} {kind} 1000 f32"
        log(f"phase 6 {label} x {N_MAIN} queries from CUDA tensors: {how} a float64 numpy "
            f"version of its rule on the {int(ok.sum())} queries it speaks for [{smi}]: "
            f"{timing_note(t, b_ms)}")
        rows.append({"path": label, "entry": f"{name}.eval", **t, "bound_ms": b_ms})
    return rows


def host_ms(fn) -> float:
    """Host-clock ms a call of fn(), synchronised, the mean of N_HOST calls
    after one more."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_HOST):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / N_HOST


def classes_phase(cuda, smi) -> list[dict]:
    """The eight model classes (the spline classes under each method) at
    20^3 f32 on the bench grid and table, 1e6 queries: warmup; eval_torch
    from CUDA tensors twice, bitwise equal to the ops call on tensors made
    apart from the class and to each other, its kernel (K1, K2, K3, K4)
    launched once a call and the cached table not uploaded again; eval from
    numpy equal to raw's (or interpn()'s) result; gradient_torch against
    the CPU gather tree's gradient; each entry on the host clock."""
    import pydantic

    import interpn_tpu_torch as itt
    from interpn_tpu_torch import convert, ops, raw
    from interpn_tpu_torch.ops import fused, unrep

    rows = []
    x, vals = bench_grid(20, 3)
    dims = [20] * 3
    npd = np.float32
    x32 = x.astype(npd)
    table = vals.ravel().astype(npd)
    starts, steps = np.zeros(3, npd), np.full(3, x32[1] - x32[0], npd)
    axes = [a.astype(npd) for a in bench_rect_axes(20, 3)]
    rng = np.random.default_rng(7)
    obs_np = [rng.uniform(LO, HI, N_MAIN).astype(npd) for _ in range(3)]
    obs_t = convert.obs_from_numpy(obs_np, device=cuda, dtype=F32)
    reference = {"Multilinear": "linear", "Multicubic": "cubic", "Nearest": "nearest"}
    cases = [(f"{family}{kind}", {}) for kind in ("Regular", "Rectilinear")
             for family in reference]
    cases += [(f"TensorSpline{kind}", {"method": m}) for kind in ("Regular", "Rectilinear")
              for m in ("pchip", "cubic_spline", "quintic")]
    for name, kw in cases:
        regular = name.endswith("Regular")
        args = (dims, starts, steps, table) if regular else (axes, table)
        grid_axes = [x32] * 3 if regular else axes
        method = kw.get("method") or reference[name.removesuffix("Regular")
                                               .removesuffix("Rectilinear")]
        kind = "regular" if regular else "rectilinear"
        k = SPLINE.get(method)
        counter = f"bspline_k{k}" if k else (None if method == "pchip" else f"{kind}_{method}")
        model = getattr(itt, name).new(*args, **kw)
        model.warmup(1024)
        cached = model._dev.tensors(cuda)
        ptrs = [t.data_ptr() for t in cached if isinstance(t, torch.Tensor)]
        fused.reset_launches()
        unrep.launches = 0
        got = model.eval_torch(obs_t)
        torch.cuda.synchronize()
        launched = {c: n for c, n in fused.launches.items() if n}
        again = model.eval_torch(obs_t)
        bitwise(again, got, f"{name} {method}: second eval_torch")
        if (counter and launched.get(counter) != 1) or (not counter and launched):
            raise AssertionError(f"{name} {method}: launches {launched}, want {counter} once")
        if unrep.launches:
            raise AssertionError(f"{name} {method}: eval_torch launched the flag's kernel "
                                 f"{unrep.launches} times, want none")
        checked = ""
        if regular and method in reference.values():
            # eval into a CUDA out (the checked cell's call): the flag once, on the card
            out_t = torch.full_like(got, math.nan)
            if model.eval(list(obs_t), out=out_t) is not out_t or unrep.launches != 1:
                raise AssertionError(f"{name} {method}: eval into a CUDA out, flag launches "
                                     f"{unrep.launches}, want 1")
            bitwise(out_t, got, f"{name} {method}: eval into a CUDA out vs eval_torch")
            checked = ("; eval into a CUDA out bitwise equal to eval_torch, the flag's kernel "
                       "launched once there and not by eval_torch")
        if model._dev.tensors(cuda) is not cached or ptrs != [
                t.data_ptr() for t in cached if isinstance(t, torch.Tensor)]:
            raise AssertionError(f"{name} {method}: the table was put on the card again")
        # the ops call on tensors made apart from the class
        if k:
            # a regular model solves on axes rebuilt from starts and steps in float64
            spline_axes = ([starts[i].astype(np.float64) + steps[i].astype(np.float64)
                            * np.arange(20) for i in range(3)] if regular
                           else [a.astype(np.float64) for a in axes])
            knots, coeffs = ops.prep_bspline(spline_axes, table.astype(np.float64), k)
            want = ops.bspline_eval(*convert.bspline_from_numpy(knots, coeffs, device=cuda,
                                                                dtype=F32), obs_t, k)
        elif regular:
            g = convert.regular_grid_from_numpy(*args, device=cuda, dtype=F32)
            lin = (True,) if method == "cubic" else ()
            want = getattr(ops, f"{method}_regular")(*g, obs_t, *lin)
        else:
            g = convert.rectilinear_grid_from_numpy(*args, device=cuda, dtype=F32)
            lin = (True,) if method == "cubic" else ()
            want = getattr(ops, f"{method}_rectilinear")(*g, obs_t, *lin)
        bitwise(got, want, f"{name} {method}: eval_torch vs the ops call")
        if not got.isfinite().all():
            raise AssertionError(f"{name} {method}: not finite")
        got_np = got.cpu().numpy()
        via_numpy = model.eval(obs_np)
        np.testing.assert_array_equal(via_numpy, got_np, err_msg=f"{name} {method} eval")
        out_np = np.zeros(N_MAIN, npd)
        if method in reference.values():
            fn = getattr(raw, f"interpn_{method}_{kind}_f32")
            lin = (True,) if method == "cubic" else ()

            def entry(fn=fn, lin=lin, args=args):
                return fn(*args, *lin, obs_np, out_np)
            what = f"raw.{fn.__name__}"
        else:
            def entry(method=method, grid_axes=grid_axes, regular=regular):
                return itt.interpn(obs_np, grid_axes, table.reshape(dims), method=method,
                                   assume_regular=regular, out=out_np)
            what = "interpn()"
        entry()
        if k and regular:
            # interpn() solves on the float32 axes themselves, the model on axes
            # rebuilt in float64: equal within the f32 bar of the coefficients
            bar = 1e-5 * max(1.0, float(np.abs(coeffs).max()))
            np.testing.assert_allclose(out_np, got_np, rtol=bar, atol=bar,
                                       err_msg=f"{name} {method} vs {what}")
            how = f"within rtol=atol={bar:.3g} of"
        else:
            np.testing.assert_array_equal(out_np, got_np, err_msg=f"{name} {method} vs {what}")
            how = "equal to"
        ms = {"eval_torch_ms": host_ms(lambda m=model: m.eval_torch(obs_t)),
              "eval_numpy_ms": host_ms(lambda m=model: m.eval(obs_np)),
              "entry_ms": host_ms(entry)}
        label = f"{name}{f' {method}' if k or method == 'pchip' else ''} 20^3 f32"
        kernel = (f"launches {launched}" if counter else
                  "no ops.fused kernel launched (pchip is a gather tree)")
        log(f"phase 6 class {label} x {N_MAIN} queries: warmup(1024), eval_torch from CUDA "
            f"tensors twice bitwise equal to the ops call and to each other, {kernel}, the "
            f"cached table not put on the card again{checked}; "
            f"eval from numpy equal to eval_torch and {how} {what} from numpy [{smi}]: "
            "eval_torch "
            f"{ms['eval_torch_ms']:.4f} ms/call, eval (numpy in and out) "
            f"{ms['eval_numpy_ms']:.4f} ms/call, {what} (numpy) {ms['entry_ms']:.4f} ms/call, "
            "host clock")
        rows.append({"path": f"class {label}", "entry": what, "kernel": counter,
                     "launches": launched, **ms})

    # gradient_torch through K1 against the CPU gather tree's gradient
    model = itt.MultilinearRegular.new(dims, starts, steps, table)
    sub = [o[:N_GRAD] for o in obs_np]
    grads = model.gradient_torch([torch.from_numpy(o).to(cuda) for o in sub])
    g = convert.regular_grid_from_numpy(dims, starts, steps, table, device="cpu", dtype=F32)
    ob = tuple(torch.from_numpy(o).requires_grad_() for o in sub)
    want = torch.autograd.grad(ops.linear_regular(*g, ob).sum(), ob)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    log(f"phase 6 class MultilinearRegular gradient_torch on {N_GRAD} CUDA queries: within "
        f"rtol=atol=1e-5 of the CPU gather tree's gradient on every axis (pydantic "
        f"{pydantic.VERSION} on this machine)")
    return rows


def slice_phase(cuda, smi) -> None:
    """Phase 6: pchip, the 1D interpolants and the model classes; the
    numbers of its timed paths in one log line for PERF.md."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(66)
    t0 = time.perf_counter()
    rows = pchip_phase(cuda, smi, gen) + one_dim_phase(cuda, smi, gen) + classes_phase(cuda, smi)
    log(f"phase 6 record [{smi}] ({time.perf_counter() - t0:.1f} s): {json.dumps(rows)}")


# --- phase 7: torch.func through the kernel routes, TorchInterpolator, compat --------

TRANSFORM_METHODS = ("linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic")
N_QSETS = 4  # query sets of a vmap over queries, N_MAIN // N_QSETS each
N_F64_TABLES = 4  # tables of the vmap under INTERPN_TPU_F64=df64


def grid_launches() -> dict:
    """The grid kernels launched since the counts were set to 0 (layout
    kernels left out)."""
    from interpn_tpu_torch.ops import fused

    torch.cuda.synchronize()
    layouts = {fused.PACK, fused.CUBIC_PACK, fused.INTERLEAVE, fused.CUBIC_STACK_PACK,
               fused.RECT_CUBIC_PACK, fused.RECT_INTERLEAVE, fused.BSPLINE_INTERLEAVE}
    return {c: n for c, n in fused.launches.items() if n and c not in layouts}


def counted(fn, want: dict, what: str):
    """fn() with the launch counts set to 0 just before it; raise unless
    the grid kernels it launched are `want`."""
    from interpn_tpu_torch.ops import fused

    fused.reset_launches()
    out = fn()
    got = grid_launches()
    if got != want:
        raise AssertionError(f"{what}: launched {got}, want {want}")
    return out


@contextlib.contextmanager
def gather_forward_refused():
    """For the body, every gather tree a kernel route can run forward
    (`ops.dispatch`'s single-table and stack gathers) raises: a vmap on
    CUDA tensors must reach the kernels alone."""
    from interpn_tpu_torch.ops import dispatch, fused

    def refuse(*a, **k):
        raise AssertionError("a gather tree ran forward under vmap on CUDA tensors")

    saved = [(fused, n, getattr(fused, n)) for n in (
        "gather_rectilinear_stack", "plain_regular_stack", "plain_bspline_stack")]
    saved.append((dispatch, "_bspline_gather", dispatch._bspline_gather))
    tables = {name: dict(getattr(dispatch, name)) for name in ("_REGULAR_GATHER",
                                                               "_RECT_GATHER")}
    for m, n, _ in saved:
        setattr(m, n, refuse)
    for name, table in tables.items():
        getattr(dispatch, name).update(dict.fromkeys(table, refuse))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        for name, table in tables.items():
            getattr(dispatch, name).update(table)


def close_to(got, want, tol, what) -> float:
    """Raise unless got is within tol of want, relative to want's largest
    magnitude (at least 1); return that relative error."""
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    err = float((got.double() - want.double()).abs().max()) / scale
    if got.shape != want.shape or not err <= tol:
        raise AssertionError(f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}, relative "
                             f"error {err:.3g} over {tol:g}")
    return err


def replaced(itp, vals):
    """itp with its table (or coefficients) replaced by `vals`."""
    import torch.utils._pytree as pytree

    leaves, spec = pytree.tree_flatten(itp)
    return pytree.tree_unflatten(leaves[:-1] + [vals], spec)


def interpolator_case(kind, method, cuda, smi, data) -> dict:
    """TorchInterpolator of `method` on the `kind` 20^3 f32 bench grid:
    the call bitwise the ops call (its kernel launched once); vmap over
    NCH tables bitwise the stack op and row for row the single-table call,
    one launch of the stack kernel, no gather tree forward; vmap over
    N_QSETS query sets one launch, bitwise; grad into the table and the
    queries and jvp, the kernel forward launched once, within f32 1e-5 of
    the gather tree's derivatives on the same CUDA tensors; each timed on
    the host clock beside the op it reduces to. pchip (no kernel) is held
    to its ops call and the gather tree alone."""
    import torch.utils._pytree as pytree

    from interpn_tpu_torch import convert, ops
    from interpn_tpu_torch.functional import TorchInterpolator
    from interpn_tpu_torch.ops import dispatch, pchip

    x32, tables, axes, obs, qsets = (data[k] for k in ("x32", "tables", "axes", "obs", "qsets"))
    dims = (20,) * 3
    k = SPLINE.get(method)
    regular = kind == "regular"
    starts, steps = np.zeros(3, np.float32), np.full(3, x32[1] - x32[0], np.float32)
    label = f"TorchInterpolator {kind} {method} 20^3 f32"

    def build(table):
        if regular:
            st, sp = convert.obs_from_numpy((starts, steps), device=cuda, dtype=F32)
            return TorchInterpolator.regular(dims, st, sp, torch.from_numpy(table).to(cuda),
                                             method=method)
        return TorchInterpolator.rectilinear(convert.obs_from_numpy(axes, device=cuda,
                                                                    dtype=F32),
                                             torch.from_numpy(table).to(cuda), method=method)

    itp = build(tables[0])
    counter = f"bspline_k{k}" if k else (None if method == "pchip" else f"{kind}_{method}")
    one = {counter: 1} if counter else {}
    got = counted(lambda: itp(obs), one, f"{label} call")
    if got.shape != (N_MAIN,) or got.dtype != F32 or not got.isfinite().all():
        raise AssertionError(f"{label}: {got.shape} {got.dtype}, not finite")
    # the ops call on tensors made apart from the interpolator
    lin = (True,) if method == "cubic" else ()
    if k:
        spline_axes = ([starts[i].astype(np.float64) + steps[i].astype(np.float64)
                        * np.arange(20) for i in range(3)] if regular
                       else [a.astype(np.float64) for a in axes])
        knots, coeffs = ops.prep_bspline(spline_axes, tables[0].astype(np.float64), k)
        kt, ct = convert.bspline_from_numpy(knots, coeffs, device=cuda, dtype=F32)

        def op(ob, kt=kt, ct=ct):
            return ops.bspline_eval(kt, ct, ob, k)
        op_name = "ops.bspline_eval"
    elif regular:
        g = convert.regular_grid_from_numpy(dims, starts, steps, tables[0], device=cuda,
                                            dtype=F32)
        fn = getattr(pchip if method == "pchip" else ops, f"{method}_regular")

        def op(ob, g=g, fn=fn):
            return fn(*g, ob, *lin)
        op_name = f"ops.{method}_regular"
    else:
        g = convert.rectilinear_grid_from_numpy(axes, tables[0], device=cuda, dtype=F32)
        fn = getattr(pchip if method == "pchip" else ops, f"{method}_rectilinear")

        def op(ob, g=g, fn=fn):
            return fn(*g, ob, *lin)
        op_name = f"ops.{method}_rectilinear"
    bitwise(got, op(obs), f"{label}: the call vs {op_name}")
    row = {"path": label, "entry": op_name, "launches": one,
           "call_ms": host_ms(lambda: itp(obs)), "op_ms": host_ms(lambda: op(obs))}
    notes = [f"the call bitwise {op_name}" + (f", {counter} launched once" if counter
                                              else ", no kernel (a gather tree)")]

    if counter:
        # vmap over NCH tables: the stack kernel once, no gather tree forward
        itps = [itp] + [build(t) for t in tables[1:]]
        stack = torch.stack([i.vals for i in itps])
        batched = replaced(itp, stack)

        def vmapped():
            return torch.func.vmap(lambda i, o: i(o), in_dims=(itp.batch_axes(), None))(
                batched, obs)
        with gather_forward_refused():
            out = counted(vmapped, {f"{counter}_stack": 1}, f"{label} vmap over {NCH} tables")
        leaves = pytree.tree_flatten(itp)[0][:-1]
        if k:
            stack_op = lambda: ops.bspline_eval_stack(leaves, stack, obs, k)  # noqa: E731
        elif regular:
            stack_op = lambda: getattr(ops, f"{method}_regular_stack")(  # noqa: E731
                dims, *leaves, stack, obs, *lin)
        else:
            stack_op = lambda: getattr(ops, f"{method}_rectilinear_stack")(  # noqa: E731
                tuple(leaves), stack, obs, *lin)
        bitwise(out, stack_op(), f"{label}: vmap vs the stack op")
        for c, i in enumerate(itps):
            bitwise(out[c], i(obs), f"{label}: vmap row {c} vs its single-table call")
        # vmap over N_QSETS query sets: one launch of the single-table kernel
        qout = counted(lambda: torch.func.vmap(lambda o: itp(o))(qsets), one,
                       f"{label} vmap over {N_QSETS} query sets")
        for b in range(N_QSETS):
            bitwise(qout[b], itp(tuple(q[b] for q in qsets)), f"{label}: query set {b}")
        notes.append(f"vmap over {NCH} tables bitwise the stack op and each row its "
                     f"single-table call, {counter}_stack launched once, no gather tree "
                     f"forward; vmap over {N_QSETS} query sets of {N_MAIN // N_QSETS} "
                     f"bitwise, {counter} launched once")
        row.update(vmap_ms=host_ms(vmapped), stack_ms=host_ms(stack_op),
                   vmap_queries_ms=host_ms(lambda: torch.func.vmap(lambda o: itp(o))(qsets)))

    # grad into the table and the queries, jvp; against the gather tree
    params = tuple(itp.grid_arrays)
    if method == "pchip":
        head = (dims, *params) if regular else (params,)

        def tree(v, *ob):
            return getattr(pchip, f"pchip_{kind}")(*head, v, ob)
    else:
        route = (dispatch.kernel_route("bspline", k, 3) if k else
                 dispatch.kernel_route(kind, method, dims if regular else 3, *lin))

        def tree(v, *ob):
            return route.gather(*params, v, *ob)

    def loss(v, *ob):
        return replaced(itp, v)(ob).sum()

    argnums = tuple(range(4))
    grads = counted(lambda: torch.func.grad(loss, argnums=argnums)(itp.vals, *obs), one,
                    f"{label} grad")
    want = torch.func.grad(lambda v, *ob: tree(v, *ob).sum(), argnums=argnums)(itp.vals, *obs)
    errs = [close_to(a, b, 1e-5, f"{label}: grad {n}")
            for a, b, n in zip(grads, want, ("table", "x0", "x1", "x2"))]
    gen = torch.Generator(device=cuda).manual_seed(77)
    tangents = tuple(torch.randn(t.shape, generator=gen, device=cuda, dtype=F32)
                     for t in (itp.vals, *obs))
    primal, tangent = counted(
        lambda: torch.func.jvp(lambda v, *ob: replaced(itp, v)(ob), (itp.vals, *obs),
                               tangents), one, f"{label} jvp")
    bitwise(primal, got, f"{label}: jvp's primal vs the call")
    errs.append(close_to(tangent, torch.func.jvp(tree, (itp.vals, *obs), tangents)[1], 1e-5,
                         f"{label}: jvp tangent"))

    def autograd_op():
        v = itp.vals.detach().requires_grad_()
        ob = tuple(o.detach().requires_grad_() for o in obs)
        return torch.autograd.grad(replaced(itp, v)(ob).sum(), (v, *ob))

    row.update(grad_ms=host_ms(lambda: torch.func.grad(loss, argnums=argnums)(itp.vals, *obs)),
               autograd_ms=host_ms(autograd_op),
               jvp_ms=host_ms(lambda: torch.func.jvp(lambda v, *ob: replaced(itp, v)(ob),
                                                     (itp.vals, *obs), tangents)),
               grad_rel_err=max(errs))
    notes.append(f"grad into the table and the 3 query axes and jvp into both"
                 f"{f', {counter} launched once each' if counter else ''}, within "
                 f"{max(errs):.3g} of the gather tree's derivatives (bar 1e-5 of the "
                 "largest magnitude)")
    times = ", ".join(f"{key.removesuffix('_ms')} {v:.4f}" for key, v in row.items()
                      if key.endswith("_ms"))
    log(f"phase 7 {label} x {N_MAIN} queries from CUDA tensors: {'; '.join(notes)} [{smi}]: "
        f"{times} ms/call, host clock")
    return row


def forced_engine_case(cuda, smi) -> dict:
    """Under INTERPN_TPU_F64=df64, TorchInterpolator regular cubic 20^3
    f64: the call takes K8 once; vmap over N_F64_TABLES tables K8 once per
    table (a stack takes no engine), each row bitwise its single call; grad
    into the table K8 once, within 1e-12 of the gather tree's: the route
    decision (the table's split, cached by its data pointer) ran on plain
    tensors."""
    from interpn_tpu_torch import convert
    from interpn_tpu_torch.functional import TorchInterpolator
    from interpn_tpu_torch.ops import dispatch

    x, vals = bench_grid(20, 3)
    dims = (20,) * 3
    st, sp = convert.obs_from_numpy((np.zeros(3), np.full(3, x[1] - x[0])), device=cuda,
                                    dtype=F64)
    tables = torch.stack([torch.from_numpy(vals.ravel() + c) for c in range(N_F64_TABLES)]
                         ).to(cuda)
    rng = np.random.default_rng(9)
    obs = tuple(torch.from_numpy(rng.uniform(LO, HI, N_MAIN)).to(cuda) for _ in range(3))
    label = "TorchInterpolator regular cubic 20^3 f64 under INTERPN_TPU_F64=df64"
    with f64_engine("df64"):
        itp = TorchInterpolator.regular(dims, st, sp, tables[0], method="cubic")
        got = counted(lambda: itp(obs), {"df64": 1}, f"{label} call")
        out = counted(lambda: torch.func.vmap(lambda i, o: i(o), in_dims=(
            itp.batch_axes(), None))(replaced(itp, tables), obs), {"df64": N_F64_TABLES},
            f"{label} vmap over {N_F64_TABLES} tables")
        for c in range(N_F64_TABLES):
            bitwise(out[c], replaced(itp, tables[c])(obs), f"{label}: vmap row {c}")
        bitwise(out[0], got, f"{label}: vmap row 0 vs the call")
        g = counted(lambda: torch.func.grad(lambda v: replaced(itp, v)(obs).sum())(itp.vals),
                    {"df64": 1}, f"{label} grad")
        route = dispatch.kernel_route("regular", "cubic", dims, True)
        want = torch.func.grad(lambda v: route.gather(st, sp, v, *obs).sum())(itp.vals)
        err = close_to(g, want, 1e-12, f"{label}: grad into the table")
        ms = {"call_ms": host_ms(lambda: itp(obs)),
              "vmap_ms": host_ms(lambda: torch.func.vmap(lambda i, o: i(o), in_dims=(
                  itp.batch_axes(), None))(replaced(itp, tables), obs))}
    log(f"phase 7 {label} x {N_MAIN} queries: the call K8 once; vmap over {N_F64_TABLES} "
        f"tables K8 once a table, each row bitwise its single call; grad into the table K8 "
        f"once, within {err:.3g} of the gather tree's [{smi}]: call {ms['call_ms']:.4f}, "
        f"vmap {ms['vmap_ms']:.4f} ms/call, host clock")
    return {"path": label, "launches": {"df64": 1}, "grad_rel_err": err, **ms}


def compat_phase(cuda, smi) -> list[dict]:
    """compat.RegularGridInterpolator from numpy, f64, on the regular 20^3
    bench grid (bounds_error=False, fill_value=None, 1e6 queries in [-0.5,
    10.5]): linear, nearest, slinear and pchip against scipy's RGI on
    N_SCIPY of them at 1e-12; linear, nearest, slinear and hermite (which
    scipy has not) bitwise raw's rectilinear functions, their kernel
    launched once; cubic and quintic bitwise interpn(method="cubic_spline"
    / "quintic") (scipy's RGI solves the 3-D spline iteratively, no bar);
    a trailing axis of NCH channels (linear, cubic) one stack launch, each
    channel bitwise its single-channel call; dtype=np.float32 linear
    bitwise raw's f32 function; each timed beside raw / interpn()."""
    import scipy.interpolate as si

    import interpn_tpu_torch as itt
    from interpn_tpu_torch import compat, raw

    rows = []
    x, vals = bench_grid(20, 3)
    grids = (x, x, x)
    rng = np.random.default_rng(10)
    xi = rng.uniform(LO, HI, (N_MAIN, 3))
    obs = [np.ascontiguousarray(xi[:, i]) for i in range(3)]
    kw = dict(bounds_error=False, fill_value=None)
    out = np.zeros(N_MAIN)
    rect = {"linear": ("linear", ()), "slinear": ("linear", ()), "nearest": ("nearest", ()),
            "hermite": ("cubic", (False,))}
    for method in ("linear", "nearest", "slinear", "hermite", "pchip", "cubic", "quintic"):
        rgi = compat.RegularGridInterpolator(grids, vals, method=method, **kw)
        label = f"compat {method} regular 20^3 f64"
        if method in rect:
            m, lin = rect[method]
            counter = f"rectilinear_{m}"
            fn = getattr(raw, f"interpn_{m}_rectilinear_f64")

            def entry(fn=fn, lin=lin):
                fn(list(grids), vals.ravel(), *lin, obs, out)
                return out
            what = f"raw.{fn.__name__}"
        else:
            counter = {"cubic": "bspline_k3", "quintic": "bspline_k5"}.get(method)
            name = {"cubic": "cubic_spline"}.get(method, method)

            def entry(name=name):
                return itt.interpn(obs, list(grids), vals, method=name, out=out)
            what = f"interpn(method={name!r})"
        got = counted(lambda: rgi(xi), {counter: 1} if counter else {}, label)
        if got.shape != (N_MAIN,) or got.dtype != np.float64 or not np.isfinite(got).all():
            raise AssertionError(f"{label}: {got.shape} {got.dtype}")
        notes = []
        if method in ("linear", "nearest", "slinear", "pchip"):
            ref = si.RegularGridInterpolator(grids, vals, method=method, **kw)(xi[:N_SCIPY])
            rel = float(np.max(np.abs(got[:N_SCIPY] - ref) / np.maximum(1.0, np.abs(ref))))
            if not rel <= 1e-12:
                raise AssertionError(f"{label}: {rel:.3g} from scipy's RGI")
            notes.append(f"within {rel:.3g} of scipy's RGI on {N_SCIPY} (bar 1e-12)")
        entry()
        if method == "pchip":  # interpn() takes the regular tree, compat the rectilinear one
            rel = float(np.max(np.abs(got - out) / np.maximum(1.0, np.abs(out))))
            if not rel <= 1e-12:
                raise AssertionError(f"{label}: {rel:.3g} from {what}")
            notes.append(f"within {rel:.3g} of {what}")
        else:
            np.testing.assert_array_equal(got, out, err_msg=f"{label} vs {what}")
            notes.append(f"bitwise {what}")
        ms = {"compat_ms": host_ms(lambda: rgi(xi)), "entry_ms": host_ms(entry)}
        log(f"phase 7 {label} x {N_MAIN} queries from numpy: "
            f"{counter + ' launched once, ' if counter else ''}{', '.join(notes)} [{smi}]: "
            f"compat {ms['compat_ms']:.4f}, {what} {ms['entry_ms']:.4f} ms/call, host clock")
        rows.append({"path": label, "entry": what, "kernel": counter, **ms})

    # a trailing axis of NCH channels: one stack launch, each channel its single call
    stacked = np.stack([vals + c for c in range(NCH)], axis=-1)
    for method, counter in (("linear", "rectilinear_linear_stack"), ("cubic", "bspline_k3_stack")):
        rgi = compat.RegularGridInterpolator(grids, stacked, method=method, **kw)
        label = f"compat {method} regular 20^3 f64, {NCH} channels"
        got = counted(lambda: rgi(xi), {counter: 1}, label)
        for c in range(NCH):
            one = compat.RegularGridInterpolator(grids, stacked[..., c], method=method, **kw)
            np.testing.assert_array_equal(got[:, c], one(xi), err_msg=f"{label}: channel {c}")
        vt = np.ascontiguousarray(np.moveaxis(stacked, -1, 0))
        name = {"cubic": "cubic_spline"}.get(method, method)
        ms = {"compat_ms": host_ms(lambda: rgi(xi)),
              "entry_ms": host_ms(lambda: itt.interpn_stack(obs, list(grids), vt,
                                                            method=name))}
        log(f"phase 7 {label} x {N_MAIN} queries from numpy: {counter} launched once, each "
            f"channel bitwise its single-channel call [{smi}]: compat {ms['compat_ms']:.4f}, "
            f"interpn_stack(method={name!r}) {ms['entry_ms']:.4f} ms/call, host clock")
        rows.append({"path": label, "entry": "interpn_stack()", "kernel": counter, **ms})

    # the float32 opt-in
    rgi = compat.RegularGridInterpolator(grids, vals, dtype=np.float32, **kw)
    label = "compat linear regular 20^3, dtype=np.float32"
    got = counted(lambda: rgi(xi), {"rectilinear_linear": 1}, label)
    obs32 = [o.astype(np.float32) for o in obs]
    out32 = np.zeros(N_MAIN, np.float32)
    x32 = x.astype(np.float32)

    def entry32():
        raw.interpn_linear_rectilinear_f32([x32] * 3, vals.ravel().astype(np.float32), obs32,
                                           out32)
        return out32
    entry32()
    if got.dtype != np.float32:
        raise AssertionError(f"{label}: {got.dtype}")
    np.testing.assert_array_equal(got, out32, err_msg=f"{label} vs raw")
    ms = {"compat_ms": host_ms(lambda: rgi(xi)), "entry_ms": host_ms(entry32)}
    log(f"phase 7 {label} x {N_MAIN} queries from numpy: float32 out, rectilinear_linear "
        f"launched once, bitwise raw.interpn_linear_rectilinear_f32 [{smi}]: compat "
        f"{ms['compat_ms']:.4f}, raw {ms['entry_ms']:.4f} ms/call, host clock")
    rows.append({"path": label, "entry": "raw.interpn_linear_rectilinear_f32",
                 "kernel": "rectilinear_linear", **ms})
    return rows


def transforms_phase(cuda, smi) -> None:
    """Phase 7: torch.func through the kernel routes (TorchInterpolator on
    each method and grid kind, one forced f64 path) and compat from numpy;
    the numbers of its timed paths in one log line for PERF.md."""
    t0 = time.perf_counter()
    x, vals = bench_grid(20, 3)
    rng = np.random.default_rng(8)
    data = {
        "x32": x.astype(np.float32),
        "tables": [(vals.ravel() + c).astype(np.float32) for c in range(NCH)],
        "axes": [a.astype(np.float32) for a in bench_rect_axes(20, 3)],
        "obs": tuple(torch.from_numpy(rng.uniform(LO, HI, N_MAIN).astype(np.float32)).to(cuda)
                     for _ in range(3)),
        "qsets": tuple(torch.from_numpy(rng.uniform(LO, HI, (N_QSETS, N_MAIN // N_QSETS))
                                        .astype(np.float32)).to(cuda) for _ in range(3)),
    }
    rows = [interpolator_case(kind, method, cuda, smi, data)
            for kind in ("regular", "rectilinear") for method in TRANSFORM_METHODS]
    rows.append(forced_engine_case(cuda, smi))
    rows += compat_phase(cuda, smi)
    log(f"phase 7 record [{smi}] ({time.perf_counter() - t0:.1f} s): {json.dumps(rows)}")


# --- phase 8: serving artifacts (aot) and obs-axis data parallelism (parallel) --------

SERVE_BUCKETS = (1024, 65536, N_MAIN)
# The fresh process that serves the main path's artifact: it imports only
# interpn_tpu_torch.aot, serves N_MAIN and N_MAIN - 1 queries with the launch
# counts set to 0 just before each call, saves the results, times N_HOST
# synchronised calls of N_MAIN and prints one JSON line.
SERVE_SCRIPT = """
import json, sys, time
import numpy as np
import torch
from interpn_tpu_torch import aot

fused = sys.modules["interpn_tpu_torch.ops.fused"]
art, obs_path, out_path, calls = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
served = aot.load(open(art, "rb").read())
obs = [torch.from_numpy(o).to(served.device) for o in np.load(obs_path)]
launches = {}
for n in (len(obs[0]), len(obs[0]) - 1):
    fused.reset_launches()
    got = served([o[:n] for o in obs])
    torch.cuda.synchronize()
    launches[n] = {c: k for c, k in fused.launches.items() if k}
    np.save(f"{out_path}.{n}.npy", got.cpu().numpy())
served(obs)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(calls):
    served(obs)
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3 / calls
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "interpn_tpu"))
print(json.dumps({"launches": launches, "served_ms": ms, "foreign": foreign}))
"""


def serving_models(cuda):
    """The eight classes at 20^3 f32 on the bench grid and table, as phase 6
    builds them, TensorSplineRegular with pchip (no kernel) and
    TensorSplineRectilinear with cubic_spline (K4): (label, model, counter
    of its kernel or None for pchip)."""
    import interpn_tpu_torch as itt

    x, vals = bench_grid(20, 3)
    x32, table = x.astype(np.float32), vals.ravel().astype(np.float32)
    starts, steps = np.zeros(3, np.float32), np.full(3, x32[1] - x32[0], np.float32)
    axes = [a.astype(np.float32) for a in bench_rect_axes(20, 3)]
    out = []
    for kind in ("Regular", "Rectilinear"):
        args = ([20] * 3, starts, steps, table) if kind == "Regular" else (axes, table)
        for family, method in (("Multilinear", "linear"), ("Multicubic", "cubic"),
                               ("Nearest", "nearest")):
            out.append((f"{family}{kind} 20^3 f32", getattr(itt, f"{family}{kind}").new(*args),
                        f"{kind.lower()}_{method}"))
        method = "pchip" if kind == "Regular" else "cubic_spline"
        out.append((f"TensorSpline{kind} {method} 20^3 f32",
                    getattr(itt, f"TensorSpline{kind}").new(*args, method=method),
                    f"bspline_k{SPLINE[method]}" if method in SPLINE else None))
    return out


def program_targets(blob: bytes) -> list:
    """The call targets of the artifact's first program."""
    import io

    from interpn_tpu_torch import aot

    _, off = aot._read(blob, len(aot._MAGIC))
    program = torch.export.load(io.BytesIO(aot._read(blob, off)[0]))
    return [n.target for n in program.graph.nodes if n.op == "call_function"]


def serve_fresh(label, blob, obs_np, counter, want, engine=None):
    """Serve the artifact `blob` in a fresh process (SERVE_SCRIPT, which
    imports only interpn_tpu_torch.aot) with INTERPN_TPU_F64 unset, at
    N_MAIN and N_MAIN - 1 (padded) queries: each result bitwise `want(n)`
    and `counter` launched once a call. (its JSON record, its seconds)."""
    import tempfile

    env = {k: v for k, v in os.environ.items() if k != "INTERPN_TPU_F64"}
    with tempfile.TemporaryDirectory() as tmp:
        art, obs_path, out = f"{tmp}/main.ittaot", f"{tmp}/obs.npy", f"{tmp}/out"
        with open(art, "wb") as f:
            f.write(blob)
        np.save(obs_path, np.stack(obs_np))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", SERVE_SCRIPT, art, obs_path, out,
                              str(N_HOST)], capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
        process_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"{label}: the serving process failed:\n{run.stderr[-4000:]}")
        record = json.loads(run.stdout.strip().splitlines()[-1])
        results = {n: np.load(f"{out}.{n}.npy") for n in (N_MAIN, N_MAIN - 1)}
    if record["foreign"]:
        raise AssertionError(f"{label}: the serving process imported {record['foreign']}")
    for n, got in results.items():
        with f64_engine(engine):
            expect = want(n)
        bitwise(torch.from_numpy(got).to(expect.device), expect,
                f"{label}: served {n} vs eval_torch")
        if record["launches"][str(n)] != {counter: 1}:
            raise AssertionError(f"{label}: served {n} launched {record['launches'][str(n)]}, "
                                 f"want {counter} once")
    return record, process_s


def served_main_path(cuda, smi, obs_np) -> dict:
    """(a) MultilinearRegular 20^3 f32 exported on cuda:0 with buckets
    SERVE_BUCKETS, its program the regular op's node and a reshape, served
    in a fresh process at N_MAIN and N_MAIN - 1 (padded) queries, each
    bitwise eval_torch with K1 launched once a call."""
    from interpn_tpu_torch import aot
    from interpn_tpu_torch.ops import library

    label, model, counter = serving_models(cuda)[0]
    t0 = time.perf_counter()
    blob = aot.export_eval(model, list(SERVE_BUCKETS), device=cuda)
    export_s = time.perf_counter() - t0
    targets = program_targets(blob)
    if targets.count(library.overload("regular")) != 1 or set(targets) - {
            library.overload("regular"), torch.ops.aten.reshape.default}:
        raise AssertionError(f"{label}: the program's nodes are {targets}, want the regular "
                             "op once and no gather tree")
    obs_t = [torch.from_numpy(o).to(cuda) for o in obs_np]
    record, process_s = serve_fresh(label, blob, obs_np, counter,
                                    lambda n: model.eval_torch([o[:n] for o in obs_t]))
    eval_ms = host_ms(lambda: model.eval_torch(obs_t))
    row = {"path": f"served {label}", "buckets": list(SERVE_BUCKETS), "artifact_bytes": len(blob),
           "export_s": export_s, "process_s": process_s, "launches": record["launches"],
           "served_ms": record["served_ms"], "eval_torch_ms": eval_ms}
    log(f"phase 8 (a) {label} exported on {cuda} with buckets {list(SERVE_BUCKETS)} in "
        f"{export_s:.2f} s ({len(blob)} bytes; each program the regular op once and a "
        f"reshape, no gather tree), served in a fresh process importing only "
        f"interpn_tpu_torch.aot ({process_s:.1f} s in all) at {N_MAIN} and {N_MAIN - 1} "
        f"(padded) queries: each bitwise eval_torch, {counter} launched once a call "
        f"{record['launches']} [{smi}]: served {record['served_ms']:.4f} ms/call (fresh "
        f"process), eval_torch {eval_ms:.4f} ms/call, host clock, mean of {N_HOST} "
        "synchronised calls")
    return row


def served_classes(cuda, smi, obs_t) -> list[dict]:
    """(b) The other classes at 20^3 f32, one bucket of N_MAIN each,
    exported and served in this process bitwise eval_torch, the class's
    kernel (K1-K4) launched once a call; pchip's program is its gather
    tree and launches nothing."""
    from interpn_tpu_torch import aot
    from interpn_tpu_torch.ops import library

    kernel_ops = {library.overload(name) for name in library.NAMES}
    rows = []
    for label, model, counter in serving_models(cuda)[1:]:
        t0 = time.perf_counter()
        blob = aot.export_eval(model, N_MAIN, device=cuda)
        export_s = time.perf_counter() - t0
        targets = program_targets(blob)
        ops_in = [t for t in targets if t in kernel_ops]
        if len(ops_in) != (1 if counter else 0):
            raise AssertionError(f"{label}: kernel nodes {ops_in}")
        served = aot.load(blob)
        got = counted(lambda: served(obs_t), {counter: 1} if counter else {},
                      f"{label} served")
        bitwise(got, model.eval_torch(obs_t), f"{label}: served vs eval_torch")
        row = {"path": f"served {label}", "artifact_bytes": len(blob), "export_s": export_s,
               "nodes": len(targets), "served_ms": host_ms(lambda: served(obs_t)),
               "eval_torch_ms": host_ms(lambda: model.eval_torch(obs_t))}
        what = f"{counter} launched once" if counter else "no kernel (pchip's gather tree)"
        log(f"phase 8 (b) {label} exported on {cuda} (bucket {N_MAIN}, {len(blob)} bytes, "
            f"{len(targets)} nodes, {export_s:.2f} s) and served x {N_MAIN}: bitwise "
            f"eval_torch, {what} [{smi}]: served {row['served_ms']:.4f}, eval_torch "
            f"{row['eval_torch_ms']:.4f} ms/call, host clock")
        rows.append(row)
    return rows


def sharded_case(label, meshes, build, single, counter, smi) -> list[dict]:
    """For each mesh: `build(mesh)` (the evaluator built on the mesh, bound
    to its arguments) called once with the launch counts set to 0: one
    launch of `counter` a shard (none for pchip), each shard on its mesh
    entry's device, the shards joined bitwise `single()`; both timed."""
    want = single()
    rows = []
    for name, mesh in meshes:
        f = build(mesh)
        parts = len(mesh)
        out = counted(f, {counter: parts} if counter else {}, f"{label} on {name}")
        for s, d in zip(out, mesh):
            if s.device != d:
                raise AssertionError(f"{label} on {name}: a shard on {s.device}, not {d}")
        bitwise(out.concat(mesh[0]), want, f"{label} on {name}: shards vs the single op")
        rows.append({"path": f"{label} on {name}", "shards": parts,
                     "launches": {counter: parts} if counter else {},
                     "sharded_ms": host_ms(f), "single_ms": host_ms(single)})
        log(f"phase 8 (c) {label} x {N_MAIN} on {name}: {parts} shard(s) on their devices, "
            f"joined bitwise the single-device op, "
            f"{f'{counter} launched {parts} times (once a shard)' if counter else 'no kernel'}"
            f" [{smi}]: sharded {rows[-1]['sharded_ms']:.4f}, single-device "
            f"{rows[-1]['single_ms']:.4f} ms/call, host clock")
    return rows


def parallel_phase(cuda, smi, obs_np) -> list[dict]:
    """(c) The evaluators of interpn_tpu_torch.parallel on make_mesh() (the
    one card) and on four cuda:0 entries: prepared_evaluator on the main
    path, sharded_evaluator on every method and grid kind, the splines
    through prepared_evaluator, prepared_stack_evaluator on NCH tables (K5,
    K6, K7), each against the single-device op."""
    from functools import partial

    from interpn_tpu_torch import convert, ops, parallel

    meshes = [("make_mesh()", parallel.make_mesh()), ("4 x cuda:0", (cuda,) * 4)]
    x, vals = bench_grid(20, 3)
    x32, table = x.astype(np.float32), vals.ravel().astype(np.float32)
    starts, steps = np.zeros(3, np.float32), np.full(3, x32[1] - x32[0], np.float32)
    axes = [a.astype(np.float32) for a in bench_rect_axes(20, 3)]
    dims = (20,) * 3
    obs_t = tuple(torch.from_numpy(o).to(cuda) for o in obs_np)
    reg = convert.regular_grid_from_numpy(dims, starts, steps, table, device=cuda, dtype=F32)
    rect = convert.rectilinear_grid_from_numpy(axes, table, device=cuda, dtype=F32)
    heads = {"regular": reg[:3], "rectilinear": rect[:1]}  # the ops' arguments before vals
    grids = {"regular": (starts, steps), "rectilinear": axes}

    rows = sharded_case(
        "prepared_evaluator regular linear 20^3 f32", meshes,
        lambda mesh: partial(parallel.prepared_evaluator(mesh, grids["regular"], table,
                                                         dims=dims), obs_t),
        partial(ops.linear_regular, *reg, obs_t), "regular_linear", smi)
    for method in ("linear", "cubic", "nearest", "pchip"):
        lin = (True,) if method == "cubic" else ()
        for kind in ("regular", "rectilinear"):
            regular = kind == "regular"
            rows += sharded_case(
                f"sharded_evaluator {kind} {method} 20^3 f32", meshes,
                lambda mesh, regular=regular, kind=kind, method=method: partial(
                    parallel.sharded_evaluator(mesh, method=method, regular=regular),
                    grids[kind], table, obs_t, dims=dims),
                partial(getattr(ops, f"{method}_{kind}"), *heads[kind], reg[3], obs_t, *lin),
                None if method == "pchip" else f"{kind}_{method}", smi)
    for method, k in SPLINE.items():
        knots, coeffs = ops.prep_bspline(axes, table.astype(np.float64), k)
        kt, ct = convert.bspline_from_numpy(knots, coeffs, device=cuda, dtype=F32)
        rows += sharded_case(
            f"prepared_evaluator rectilinear {method} 20^3 f32", meshes,
            lambda mesh, method=method: partial(parallel.prepared_evaluator(
                mesh, axes, table, method=method, regular=False), obs_t),
            partial(ops.bspline_eval, kt, ct, obs_t, k), f"bspline_k{k}", smi)
    tables = np.stack([table + c for c in range(NCH)])
    stack = torch.from_numpy(tables).to(cuda)
    for method in ("linear", "cubic", "nearest"):
        lin = (True,) if method == "cubic" else ()
        for kind in ("regular", "rectilinear"):
            regular = kind == "regular"
            rows += sharded_case(
                f"prepared_stack_evaluator {kind} {method} {NCH} tables 20^3 f32", meshes,
                lambda mesh, regular=regular, kind=kind, method=method: partial(
                    parallel.prepared_stack_evaluator(mesh, grids[kind], tables,
                                                      dims=dims if regular else None,
                                                      method=method, regular=regular), obs_t),
                partial(getattr(ops, f"{method}_{kind}_stack"), *heads[kind], stack, obs_t,
                        *lin),
                f"{kind}_{method}_stack", smi)
    knots, coeffs = ops.prep_bspline(axes, np.ascontiguousarray(tables.T, dtype=np.float64), 3)
    kt, ct = convert.bspline_from_numpy(knots, np.ascontiguousarray(coeffs.T), device=cuda,
                                        dtype=F32)
    rows += sharded_case(
        f"prepared_stack_evaluator rectilinear cubic_spline {NCH} tables 20^3 f32", meshes,
        lambda mesh: partial(parallel.prepared_stack_evaluator(
            mesh, axes, tables, method="cubic_spline", regular=False), obs_t),
        partial(ops.bspline_eval_stack, kt, ct, obs_t, 3), "bspline_k3_stack", smi)
    return rows


def forced_engine_serving(cuda, smi) -> list[dict]:
    """(d) The forced f64 engines served and sharded: MulticubicRegular
    20^3 f64 under INTERPN_TPU_F64=df64 and again under =i8, its eval_torch
    at N_MAIN queries one K8 / K9 launch; exported on the card under the
    setting (the artifact's engine is it), served in a fresh process with
    the variable unset at N_MAIN and N_MAIN - 1 (padded) queries, each
    bitwise eval_torch under the setting with K8 / K9 launched once a call;
    and parallel.prepared_evaluator under the setting on make_mesh() and
    four cuda:0 entries, one launch a shard, joined bitwise the op."""
    from functools import partial

    import interpn_tpu_torch as itt
    from interpn_tpu_torch import aot, convert, ops, parallel

    x, vals = bench_grid(20, 3)
    dims = (20,) * 3
    table, starts, steps = vals.ravel(), np.zeros(3), np.full(3, x[1] - x[0])
    model = itt.MulticubicRegular.new(list(dims), starts, steps, table)
    rng = np.random.default_rng(29)
    obs_np = [rng.uniform(LO, HI, N_MAIN) for _ in range(3)]
    obs_t = [torch.from_numpy(o).to(cuda) for o in obs_np]
    reg = convert.regular_grid_from_numpy(dims, starts, steps, table, device=cuda, dtype=F64)
    meshes = [("make_mesh()", parallel.make_mesh()), ("4 x cuda:0", (cuda,) * 4)]
    rows = []
    for engine in ("df64", "i8"):
        label = f"MulticubicRegular 20^3 f64 under INTERPN_TPU_F64={engine}"
        with f64_engine(engine):
            counted(lambda: model.eval_torch(obs_t), {engine: 1}, f"{label} eval_torch")
            eval_ms = host_ms(lambda: model.eval_torch(obs_t))
            t0 = time.perf_counter()
            blob = aot.export_eval(model, N_MAIN, device=cuda)
            export_s = time.perf_counter() - t0
        pinned = json.loads(aot._read(blob, len(aot._MAGIC))[0])["engine"]
        if pinned != engine:
            raise AssertionError(f"{label}: the artifact's engine is {pinned}")
        record, process_s = serve_fresh(
            label, blob, obs_np, engine, lambda n: model.eval_torch([o[:n] for o in obs_t]),
            engine)
        rows.append({"path": f"served {label}", "artifact_bytes": len(blob),
                     "export_s": export_s, "process_s": process_s,
                     "launches": record["launches"], "served_ms": record["served_ms"],
                     "eval_torch_ms": eval_ms})
        log(f"phase 8 (d) {label}: eval_torch x {N_MAIN} one {engine} launch; exported on "
            f"{cuda} (bucket {N_MAIN}, {len(blob)} bytes, engine {pinned}, {export_s:.2f} s), "
            f"served in a fresh process with INTERPN_TPU_F64 unset ({process_s:.1f} s in all) "
            f"at {N_MAIN} and {N_MAIN - 1} (padded) queries: each bitwise eval_torch under "
            f"{engine}, {engine} launched once a call {record['launches']} [{smi}]: served "
            f"{record['served_ms']:.4f} ms/call (fresh process), eval_torch {eval_ms:.4f} "
            "ms/call, host clock")
        with f64_engine(engine):
            rows += sharded_case(
                f"prepared_evaluator regular cubic 20^3 f64 under {engine}", meshes,
                lambda mesh: partial(parallel.prepared_evaluator(
                    mesh, (starts, steps), table, dims=dims, method="cubic"), tuple(obs_t)),
                partial(ops.cubic_regular, *reg, tuple(obs_t), True), engine, smi)
    return rows


def serving_phase(cuda, smi) -> None:
    """Phase 8: the serving artifacts (a, b), the parallel evaluators (c)
    and both under the forced f64 engines (d) at the main path's width;
    their numbers in one log line for PERF.md."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    obs_np = [rng.uniform(LO, HI, N_MAIN).astype(np.float32) for _ in range(3)]
    obs_t = [torch.from_numpy(o).to(cuda) for o in obs_np]
    rows = [served_main_path(cuda, smi, obs_np), *served_classes(cuda, smi, obs_t),
            *parallel_phase(cuda, smi, obs_np), *forced_engine_serving(cuda, smi)]
    log(f"phase 8 record [{smi}] ({time.perf_counter() - t0:.1f} s): {json.dumps(rows)}")


# --- phase 9: the CPU engines: native from numpy, factorized on the card -----------------

NATIVE_TOL = {F32: 1e-5, F64: 1e-13}  # rtol = atol, native against plain and kernels
TIE_TOL = {F32: 1e-4, F64: 1e-10}  # a nearest query this close to a cell's midpoint is a tie
CROSSOVER_N = (1, 10, 100, 1_000, 10_000, 1_000_000)
FACTORIZED_N = (20, 64)  # points an axis; 64^3 = 2^18 cells, the JAX package's factorized cap


def host_us(fn, budget_s=0.2, cap=20_000) -> float:
    """Host-clock microseconds a call of fn(), after one more: the mean over
    at least 5 calls and `budget_s` seconds, at most `cap` calls."""
    fn()
    calls, t0 = 0, time.perf_counter()
    while calls < cap and (calls < 5 or time.perf_counter() - t0 < budget_s):
        fn()
        calls += 1
    return (time.perf_counter() - t0) * 1e6 / calls


def nearest_ties(kind, grid, obs, dtype) -> torch.Tensor:
    """Queries within TIE_TOL of a cell's midpoint on some axis (float64,
    on the CPU): where two correct nearest results may pick either node."""
    tie = torch.zeros(len(obs[0]), dtype=torch.bool)
    for k, x in enumerate(obs):
        x = np.asarray(x, np.float64)
        if kind == "regular":
            t = (x - float(grid[1][k])) / float(grid[2][k])
            t = t - np.floor(t)
        else:
            a = np.asarray(grid[0][k], np.float64)
            i = np.clip(np.searchsorted(a, x) - 1, 0, len(a) - 2)
            t = (x - a[i]) / (a[i + 1] - a[i])
        tie |= torch.from_numpy(np.abs(t - 0.5) < TIE_TOL[dtype])
    return tie


def held_to(got, want, dtype, what, ties=None, tol=NATIVE_TOL) -> float:
    """Raise unless `got` is within `tol` (rtol = atol) of `want` (for
    nearest, which passes `ties`, equal but at a tie, where either node is
    right); the largest absolute difference away from ties."""
    g = torch.as_tensor(got).double().cpu()
    w = torch.as_tensor(want).double().cpu()
    if ties is None:
        ok = torch.isclose(g, w, rtol=tol[dtype], atol=tol[dtype])
        ties = torch.zeros_like(ok)
    else:
        ok = (g == w) | ties
    if not bool(ok.all()):
        raise AssertionError(f"{what}: {int((~ok).sum())} of {ok.numel()} results differ "
                             f"(max {float((g - w).abs()[~ok].max()):.3e})")
    diff = (g - w).abs()[~ties]
    return float(diff.max()) if diff.numel() else 0.0


def native_build() -> dict:
    """Build the native engine on the card's host (g++ and its version, the
    seconds); fails without g++ or a build."""
    import shutil

    from interpn_tpu_torch import native

    gxx = shutil.which("g++")
    if gxx is None:
        raise AssertionError("phase 9: no g++ on the card's host, so the native engine "
                             "cannot build")
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"phase 9: the native engine did not build with {version}")
    fast = native.fastcall_available()
    seconds = time.perf_counter() - t0
    log(f"phase 9 native engine built with {version} ({' '.join(native.CXX_FLAGS)}) in "
        f"{seconds:.2f} s ({native.build_seconds}), fastcall extension "
        f"{'built' if fast else 'not built: the ctypes path serves'}, "
        f"{native.library_path().name}")
    return {"gxx": version, "build_s": seconds, "fastcall": fast}


def native_case(kind, dtype):
    """(numpy grid args of the engine, numpy table, numpy obs) of the 20^3
    bench grid of `kind` in `dtype`, N_CHECK queries in [LO, HI]."""
    npd = np.float32 if dtype == F32 else np.float64
    x, vals = bench_grid(20, 3)
    table = vals.ravel().astype(npd)
    if kind == "regular":
        grid = ([20] * 3, np.zeros(3, npd), np.full(3, x[1] - x[0], npd))
    else:
        grid = ([a.astype(npd) for a in bench_rect_axes(20, 3)],)
    rng = np.random.default_rng(31)
    obs = [rng.uniform(LO, HI, N_CHECK).astype(npd) for _ in range(3)]
    return grid, table, obs


def grid_tensors(kind, grid, device) -> tuple:
    """The `ops` arguments ahead of the table for the engine's grid args:
    (dims, starts, steps) or (axes,), as tensors on `device`."""
    if kind == "regular":
        return (tuple(grid[0]), *(torch.from_numpy(g).to(device) for g in grid[1:]))
    return (tuple(torch.from_numpy(a).to(device) for a in grid[0]),)


def native_vs_plain(cuda) -> list[dict]:
    """The six native evaluators and both bounds checks, 3D 20^3, f32 and
    f64: against the port's plain CPU version and the kernel on the card
    at NATIVE_TOL (nearest exact but at ties), threaded bitwise one
    thread."""
    from interpn_tpu_torch import native, ops

    cpu = torch.device("cpu")
    rows = []
    for dtype, kind, method in itertools.product((F32, F64), ("regular", "rectilinear"),
                                                 ("linear", "cubic", "nearest")):
        grid, table, obs = native_case(kind, dtype)
        lin = (True,) if method == "cubic" else ()
        fn = getattr(native, f"{method}_{kind}")
        outs = {}
        for threads in (1, None):
            native.set_threads(threads)
            out = np.full(N_CHECK, np.nan, table.dtype)
            if not fn(*grid, table, *lin, obs, out):
                raise AssertionError(f"native {method} {kind} declined")
            outs[threads] = out
        native.set_threads(None)
        what = f"native {kind} {method} 20^3 {SHORT[dtype]}"
        if not np.array_equal(outs[1], outs[None]):
            raise AssertionError(f"{what}: threaded result not bitwise the one-thread one")
        ties = nearest_ties(kind, grid, obs, dtype) if method == "nearest" else None
        op = getattr(ops, f"{method}_{kind}")
        plain = op(*grid_tensors(kind, grid, cpu), torch.from_numpy(table),
                   tuple(torch.from_numpy(o) for o in obs), *lin)
        kern = counted(lambda: op(*grid_tensors(kind, grid, cuda), torch.from_numpy(table).to(cuda),
                                  tuple(torch.from_numpy(o).to(cuda) for o in obs), *lin),
                       {f"{kind}_{method}": 1}, f"{what} kernel")
        rows.append({"case": what, "vs_plain": held_to(outs[1], plain, dtype, f"{what} vs plain",
                                                       ties),
                     "vs_kernel": held_to(outs[1], kern, dtype, f"{what} vs kernel", ties),
                     "ties": 0 if ties is None else int(ties.sum())})
    for dtype, kind, atol in itertools.product((F32, F64), ("regular", "rectilinear"),
                                               (0.0, 0.5)):
        grid, _, obs = native_case(kind, dtype)
        npd = np.float32 if dtype == F32 else np.float64
        check = getattr(ops, f"check_bounds_{kind}")
        for q in (obs, [np.clip(o, 0.25, 9.75).astype(npd) for o in obs]):
            flags = np.zeros(3, bool)
            if not getattr(native, f"check_bounds_{kind}")(*grid, q, atol, flags, npd):
                raise AssertionError(f"native bounds {kind} declined")
            plain, card = (check(*grid_tensors(kind, grid, d),
                                 tuple(torch.from_numpy(o).to(d) for o in q), atol).cpu()
                           for d in (cpu, cuda))
            if not (np.array_equal(flags, plain.numpy()) and np.array_equal(flags, card.numpy())):
                raise AssertionError(f"native bounds {kind} {SHORT[dtype]} atol {atol}: {flags} "
                                     f"vs plain {plain} vs card {card}")
    log(f"phase 9 native vs plain: the six evaluators at 20^3 f32 and f64 ({N_CHECK} queries "
        f"in [{LO}, {HI}]) within f32 1e-5 / f64 1e-13 of the port's plain CPU version and of "
        "the kernel on the card (one launch each), nearest exact but at ties, threaded bitwise "
        "one thread; both bounds checks (atol 0 and 0.5, queries out and in) equal to both: "
        + json.dumps(rows))
    return rows


def crossover(cuda, smi) -> list[dict]:
    """raw.interpn_linear_regular_f32 from numpy into numpy at 20^3, host
    clock: the native engine (the CPU device; auto threads and one thread)
    against the card's round trip (numpy in, the kernel, numpy out), each
    result held to the other at the f32 bar."""
    from interpn_tpu_torch import config, native, raw
    from interpn_tpu_torch.ops import fused

    x, vals = bench_grid(20, 3)
    grid = ([20] * 3, np.zeros(3, np.float32), np.full(3, x[1] - x[0], np.float32))
    table = vals.ravel().astype(np.float32)
    rng = np.random.default_rng(37)
    rows = []
    for n in CROSSOVER_N:
        obs = [rng.uniform(LO, HI, n).astype(np.float32) for _ in range(3)]
        out = np.zeros(n, np.float32)

        def call():
            raw.interpn_linear_regular_f32(*grid, table, obs, out)

        with config.device("cpu"):
            native.set_threads(1)
            one_us = host_us(call)
            native.set_threads(None)
            auto_us = host_us(call)
            on_cpu = out.copy()
        fused.reset_launches()
        call()
        if fused.launches["regular_linear"] != 1:
            raise AssertionError(f"crossover n={n}: the card's round trip launched "
                                 f"{grid_launches()}")
        held_to(out, on_cpu, F32, f"crossover n={n}: card vs native")
        card_us = host_us(call)
        rows.append({"n": n, "native_auto_us": auto_us, "native_one_thread_us": one_us,
                     "card_round_trip_us": card_us})
    won = [r["n"] for r in rows if r["card_round_trip_us"] < r["native_auto_us"]]
    cross = won[0] if won else None
    log(f"phase 9 crossover [{smi}]: raw.interpn_linear_regular_f32 20^3 from numpy into "
        "numpy, host clock, us a call (native auto threads / one thread / the card's round "
        "trip): " + "; ".join(f"{r['n']}: {r['native_auto_us']:.2f} / "
                               f"{r['native_one_thread_us']:.2f} / "
                               f"{r['card_round_trip_us']:.2f}" for r in rows)
        + (f"; the card is faster from {cross} queries" if cross else "; native wins at every n"))
    return rows


def factorized_timing(cuda, smi) -> list[dict]:
    """Under INTERPN_TPU_IMPL=factorized: regular and rectilinear linear,
    cubic and nearest at 20^3 and 64^3 f32 with N_MAIN queries on the card,
    timed by CUDA events (`cuda_time`) beside the kernel route in the same
    call; both against the gather tree at GATHER_TOL's f32 bar, a
    contraction's bar against the tree (1e-4: at 64^3 a query 0.5 outside
    the grid is ~3 cells out, its weights ~3 an axis, so partial sums of
    ~200 cancel to results of ~8 and a different association moves them by
    up to ~1e-4), nearest exact but at ties; the factorized calls launch no
    kernel and keep IEEE float32."""
    from interpn_tpu_torch import config, ops
    from interpn_tpu_torch.ops import cubic, linear, nearest
    from interpn_tpu_torch.utils.profiling import cuda_time

    config.require_ieee_fp32()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(41)
    trees = {"linear": linear, "cubic": cubic, "nearest": nearest}
    rows = []
    for n in FACTORIZED_N:
        x, vals = bench_grid(n, 3)
        dims = (n,) * 3
        v = torch.from_numpy(vals.ravel().astype(np.float32)).to(cuda)
        heads = {"regular": (dims, torch.zeros(3, device=cuda),
                             torch.full((3,), float(x[1] - x[0]), device=cuda)),
                 "rectilinear": (tuple(torch.from_numpy(a.astype(np.float32)).to(cuda)
                                       for a in bench_rect_axes(n, 3)),)}
        batches = [tuple(torch.rand(N_MAIN, device=cuda, generator=gen) * (HI - LO) + LO
                         for _ in range(3)) for _ in range(N_SLICE_BATCHES)]
        for kind, method in itertools.product(("regular", "rectilinear"),
                                              ("linear", "cubic", "nearest")):
            lin = (True,) if method == "cubic" else ()
            head = heads[kind]

            def f(b):
                return getattr(ops, f"{method}_{kind}")(*head, v, b, *lin)

            what = f"{kind} {method} {n}^3 f32"
            plain = getattr(trees[method], f"{method}_{kind}")(*head, v, batches[0], *lin)
            ties = None
            if method == "nearest":
                grid = ((None, np.zeros(3), np.full(3, x[1] - x[0])) if kind == "regular"
                        else ([a.cpu().numpy() for a in head[0]],))
                ties = nearest_ties(kind, grid, [b.cpu().numpy() for b in batches[0]], F32)
            with env_set("INTERPN_TPU_IMPL", "factorized"):
                got = counted(lambda: f(batches[0]), {}, f"factorized {what}")
                err = held_to(got, plain, F32, f"factorized {what} vs gather tree", ties,
                              GATHER_TOL)
                t_fz = cuda_time(f, batches)
            kern = counted(lambda: f(batches[0]), {f"{kind}_{method}": 1}, f"kernel {what}")
            kerr = held_to(kern, plain, F32, f"kernel {what} vs gather tree", ties, GATHER_TOL)
            t_k = cuda_time(f, batches)
            rows.append({"case": what, "factorized_ms": t_fz.device_ms,
                         "factorized_ahead": t_fz.ahead, "kernel_ms": t_k.device_ms,
                         "kernel_ahead": t_k.ahead, "factorized_err": err, "kernel_err": kerr})
            log(f"phase 9 factorized {what} x {N_MAIN} [{smi}]: factorized "
                f"{t_fz.device_ms:.4f} ms (ahead {t_fz.ahead}), kernel {t_k.device_ms:.4f} ms "
                f"(ahead {t_k.ahead}), CUDA events; max abs err vs the gather tree "
                f"{err:.3e} / {kerr:.3e}")
        del batches
        torch.cuda.empty_cache()
    return rows


def cpu_engines_phase(cuda, smi) -> None:
    """Phase 9: the native engine built on the card's host and held to the
    plain version and the kernels, the numpy crossover, and the factorized
    products on the card beside the kernels; one record line for PERF.md."""
    t0 = time.perf_counter()
    record = {"build": native_build(), "native": native_vs_plain(cuda),
              "crossover": crossover(cuda, smi), "factorized": factorized_timing(cuda, smi)}
    log(f"phase 9 record [{smi}] ({time.perf_counter() - t0:.1f} s): {json.dumps(record)}")


def kernels_record(driven, timed) -> list[dict]:
    """One entry per kernel, from its headline path (its first in PATHS),
    a grid kernel's also with `layouts`: for each of its paths, the layout
    that path's kernel read and the launches of that layout's kernel
    beside it; then one entry per other route that a grid kernel's paths
    read, from the first path on that route (each path is driven with the
    counts set to 0 just before it, so its launches are its route's)."""
    kernels = []
    for counter in dict.fromkeys(p.counter for p in PATHS):
        paths = [q for q in PATHS if q.counter == counter]
        p = paths[0]
        layout = {"layouts": {q.label: {"route": q.route, "layout_launches": driven[q][2]}
                              for q in paths}} if p.route else {}
        kernels.append({**kernel_entry(p, f"fused_{counter}", driven, timed), **layout})
    for counter in dict.fromkeys(p.counter for p in PATHS):
        paths = [q for q in PATHS if q.counter == counter and q.route]
        for route in dict.fromkeys(q.route for q in paths[1:]):
            if route != paths[0].route:
                p = next(q for q in paths if q.route == route)
                kernels.append(kernel_entry(p, f"fused_{counter} ({route} route)", driven,
                                            timed))
    return kernels


def kernel_entry(p: Path, name: str, driven, timed) -> dict:
    """A kernels-record entry for path p: its launches and error from the
    phase-4 drive, its times and bound from phase 5."""
    launches, err, *_ = driven[p]
    source = p.engine or f"{p.kind}{'_stack' if p.stacked else ''}"
    return {
        "name": name,
        "route": "cuda",
        "source": f"interpn_tpu_torch/csrc/fused_{source}.cu",
        "replaces": replaces(p),
        "config": p.label,
        "launches": launches,
        "max_abs_err": err,
        **timed[p],
    }


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
    regular_routes_phase(cuda)
    rectilinear_routes_phase(cuda)
    rectilinear_table_routes_phase(cuda)
    rectilinear_stack_routes_phase(cuda)
    bspline_table_routes_phase(cuda)
    stack_routes_phase(cuda)
    engine_vs_plain_phase(cuda)
    nodes_phase(cuda)

    rng = np.random.default_rng(2)
    driven, timed = {}, {}
    for p in PATHS:
        with f64_engine(p.engine):  # unset for the native paths
            driven[p] = drive_path(p, cuda, rng)

    gen = torch.Generator(device=cuda)
    gen.manual_seed(1234)
    for p in PATHS:
        with f64_engine(p.engine):
            timed[p] = timing_phase(p, cuda, gen, smi)
    layouts = [layout_phase(name, cuda, smi, driven) for name in LAYOUT_PATHS]
    flag = flag_phase(cuda, smi, driven)
    slice_phase(cuda, smi)
    transforms_phase(cuda, smi)
    serving_phase(cuda, smi)
    cpu_engines_phase(cuda, smi)

    # the last three lines, unprefixed: the card, the kernels, the result
    print(smi)
    print(json.dumps({"kernels": [*kernels_record(driven, timed), *layouts, flag]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
