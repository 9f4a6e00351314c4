#!/usr/bin/env python3
"""Times the port's grid kernels, K1 (regular, one table) and K5 (a
stack), K2/K3 (rectilinear) and K6 (a stack), and the B-spline kernels K4
and K7, against an earlier checkout's on one CUDA card, in turns.

    PYTHONPATH=. python3 scripts/torch_regular_ab.py --parent DIR

DIR is the root of an earlier checkout of the repository (unpacked with
`git archive` into a gitignored directory). Its `interpn_tpu_torch`, whose
imports are relative, is imported beside this checkout's under another
name, and each builds the sources its cases launch (SOURCES) with its own
`_build.py`, both checkouts' at once.

Each case of CASES is a table on a [0, 10] grid (random values from a
seed) and 1e6 queries (`--queries`) uniform in [-0.5, 10.5]: every K1 and
K5 path of `chip_smoke.py`, the routes' crossings, stacks at 4, 5 and 8D,
cubic stacks of 1-4 groups (the C entry counts a stack's groups; a copy
built with another `kGroupBytes`, csrc/regular.cuh, splits it otherwise,
and is timed as the earlier checkout), and cubic stacks of larger tables
through their cubic packs. On each:

1. the kernels: each checkout's public evaluator
   (`ops.fused.eval_regular[_stack]`; this checkout's on the route that
   `ops.fused.regular_route` picks) and this checkout's entry on each other
   route listed, every result bitwise equal to the earlier checkout's,
   timed by CUDA events behind a head start
   (`interpn_tpu_torch/utils/profiling.py::cuda_time`) over 20 distinct
   batches, in the order earlier, picked, the others, and back, with the
   layout kernel (interleave, pack, cubic pack) inside the timed call; on
   the 3D linear and nearest cases also `F.grid_sample` on in-grid queries
   beside both kernels; the registers, spills and blocks an SM of every
   route timed (`ops.fused.regular_info`) and of the earlier checkout's;
   on a route with a layout kernel, that kernel alone, the earlier
   checkout's where it has it, and the PyTorch call that makes the same
   copy, in turns;
2. back to back: the two public evaluators in turns (earlier, this, this,
   earlier), each over five passes (`--passes`) of the 20 batches after
   three warm-up calls: CUDA events around each pass (the time a caller
   that loops sees, host included) and the host clock around queueing it
   (the host's own time a call); on a single table also each checkout's `raw` entry
   from CUDA tensors into a preallocated `out`, in turns, on the host clock
   over one pass of the batches ending in a synchronize.

Each case of RECT_CASES (`chip_smoke.py`'s jittered axes on [0, 10], a
random table or stack) times both checkouts' `eval_rectilinear[_stack]`
and this checkout's entry on each other route listed (`fused.
rectilinear_route` picks this one's) so, parts 1 and 2 without the layout
kernels and `raw`: this checkout's result bitwise equal to its plain
version on the card and on every route, and the earlier checkout's
bitwise equal to it for linear and nearest, within rtol = atol 1e-4 (f32)
or 1e-13 (f64) for cubic, whose plain version changed from the gather tree
to a weight contraction (a cubic case beyond that bar is timed all the
same and printed with both checkouts' largest errors against the float64
plain version on the same inputs, and the script then exits non-zero);
registers, local bytes and blocks an SM of each
route timed (`fused.regular_info(..., family="rectilinear")`) and the
earlier checkout's (the same, or its ptxas log); the linear and nearest
stacks (K6 on K5's routes) likewise against direct. Each case of
BSPLINE_CASES (`chip_smoke.py`'s spline paths, one table on each of K4's
routes, and K7 stacks around the group cap) times both checkouts'
`eval_bspline[_stack]` and this checkout's entry on each other route
listed so, bitwise equal, with the registers, shared and local bytes and
blocks an SM of each route timed.
`--paths REGEX` keeps the cases whose label it finds, and the build only
their sources; `--unchecked` compares no rectilinear or B-spline result of
the earlier checkout (a copy whose kernel skips part of the work, timed to
see what the rest costs); `--registers` times nothing: it builds the six
grid sources in both checkouts and compares, kernel by kernel, the
registers, stack frame and spill stores that ptxas reports. One line per
case, then the card's name and power limit and one JSON object of every
time; exits non-zero without a CUDA device.

    PYTHONPATH=. python3 scripts/torch_regular_ab.py --parent DIR --engines

times the f64 engines K8 and K9 (`INTERPN_TPU_F64=df64|i8`) instead, on
the ten engine paths of `chip_smoke.py` and regular cubic 20^4 f64 under
each engine (its tables and grids, 20 batches
of 1e6 queries uniform in [-0.5, 10.5]), each checkout building only its
two engine sources. On each path, in turns (earlier, this, this, earlier):
the kernel alone (the earlier checkout's wrapper on weights built
beforehand; this checkout's one launch from the queries, which is its
whole call less host), the whole call (each checkout's
`ops.df64.eval_*` / `ops.i8.eval_*`: weights, kernel, recombination) by
CUDA events over 4 batches, this checkout's whole call beside its native
kernel's on the same float64 table (K1, K2, K4: `fused.eval_*`, in turns
native, engine, engine, native), the op a user calls back to back (median of
ten passes, host included), and the `raw` entry (the op for a spline) from
CUDA tensors on the host clock; this checkout's result bitwise equal to the
earlier one's; the registers, local bytes and blocks an SM of this
checkout's instantiation (`ops.fused.engine_info`) and the registers and
stack frame of the earlier one's (its ptxas log). An earlier checkout whose
kernels build the weights too (it has `ops.fused.i8_route`), such as a copy
of this one with a variant of a kernel, is timed by its whole call on both
sides. `--paths REGEX` keeps the paths whose label it finds.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from interpn_tpu_torch import _build
from interpn_tpu_torch.ops import fused
from interpn_tpu_torch.utils.profiling import cuda_time

SOURCES = ("fused_regular", "fused_regular_stack", "fused_rectilinear",
           "fused_rectilinear_stack", "fused_bspline", "fused_bspline_stack")
ENGINE_SOURCES = ("fused_df64", "fused_i8")
N, BATCHES, LO, HI = 1_000_000, 20, -0.5, 10.5
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (method, points an axis, ndims, dtype, tables of a stack or None, the
# routes timed beside the one `regular_route` picks)
CASES = [
    ("linear", 20, 3, "f32", None, ("staged", "quads", "direct")),
    ("linear", 20, 3, "f64", None, ("staged", "quads", "direct")),
    ("linear", 30, 3, "f32", None, ("staged", "quads", "direct")),
    ("linear", 12, 4, "f64", None, ("quads", "direct")),
    ("linear", 100, 3, "f32", None, ("quads", "direct")),
    ("linear", 100, 3, "f64", None, ("quads", "direct")),
    ("cubic", 20, 3, "f32", None, ("staged", "tap_lanes", "direct")),
    ("cubic", 20, 3, "f64", None, ("staged", "tap_lanes", "direct")),
    ("cubic", 30, 3, "f32", None, ("staged", "tap_lanes", "direct")),
    ("cubic", 30, 3, "f64", None, ("tap_lanes", "direct")),
    ("cubic", 20, 4, "f32", None, ("tap_lanes", "direct")),
    ("cubic", 12, 5, "f64", None, ("tap_lanes", "direct")),
    # the route's crossings: f32 staged and beyond, f64 within and beyond
    # L1_BYTES, at 2-5D
    ("cubic", 200, 2, "f32", None, ("taps", "direct")),
    ("cubic", 150, 2, "f64", None, ("taps", "direct")),
    ("cubic", 1000, 2, "f64", None, ("taps", "direct")),
    ("cubic", 25, 3, "f64", None, ("tap_lanes", "direct")),
    ("cubic", 35, 3, "f32", None, ("tap_lanes", "direct")),
    ("cubic", 35, 3, "f64", None, ("tap_lanes", "direct")),
    ("cubic", 100, 3, "f32", None, ("tap_lanes", "direct")),
    ("cubic", 100, 3, "f64", None, ("tap_lanes", "direct")),
    ("cubic", 12, 4, "f32", None, ("staged", "tap_lanes", "direct")),
    ("cubic", 10, 4, "f64", None, ("staged", "tap_lanes", "direct")),
    ("cubic", 12, 4, "f64", None, ("tap_lanes", "direct")),
    ("cubic", 20, 4, "f64", None, ("tap_lanes", "direct")),
    ("cubic", 6, 5, "f64", None, ("staged", "tap_lanes", "direct")),
    ("cubic", 12, 5, "f32", None, ("tap_lanes", "direct")),
    ("nearest", 20, 3, "f32", None, ()),
    ("nearest", 20, 3, "f64", None, ()),
    ("linear", 20, 3, "f32", 8, ("interleaved", "direct")),
    ("nearest", 20, 3, "f32", 8, ("interleaved", "direct")),
    # K5 cubic stacks: staged groups against direct
    ("cubic", 20, 3, "f32", 8, ("direct",)),
    ("cubic", 20, 3, "f32", 3, ("direct",)),
    ("cubic", 20, 3, "f32", 9, ("direct",)),
    ("cubic", 20, 3, "f64", 4, ("direct",)),
    ("cubic", 40, 3, "f32", 8, ("tap_lanes", "direct")),
    ("cubic", 12, 4, "f32", 8, ("direct",)),
    # K5 cubic stacks of tables above GROUP_BYTES: each table through its
    # cubic pack against direct; 31^3 and 170^2 f64 within L1_BYTES, alone
    # and stacked, 240^2 f32 at 2D
    ("cubic", 20, 4, "f64", 8, ("tap_lanes", "direct")),
    ("cubic", 20, 4, "f32", 8, ("tap_lanes", "direct")),
    ("cubic", 12, 5, "f64", 8, ("tap_lanes", "direct")),
    ("cubic", 31, 3, "f64", 8, ("tap_lanes", "direct")),
    ("cubic", 31, 3, "f64", 1, ("tap_lanes", "direct")),
    ("cubic", 31, 3, "f64", 2, ("tap_lanes", "direct")),
    ("cubic", 170, 2, "f64", 1, ("taps", "direct")),
    ("cubic", 170, 2, "f64", 8, ("taps", "direct")),
    ("cubic", 240, 2, "f32", 8, ("taps", "direct")),
    ("linear", 20, 3, "f32", 1, ("staged", "interleaved", "direct")),
    ("linear", 20, 3, "f32", 3, ("staged", "interleaved", "direct")),
    ("linear", 20, 3, "f64", 4, ("interleaved", "direct")),
    ("linear", 20, 3, "f64", 8, ("interleaved", "direct")),
    *((method, n, nd, dt, nch, ("interleaved", "direct"))
      for method in ("linear", "nearest") for n, nd in ((12, 4), (8, 5), (4, 8))
      for dt, nch in (("f32", 8), ("f64", 4))),
]
# K2, K3 and K6 as CASES: (method, points an axis, ndims, dtype, tables of a
# stack or None, the other routes timed)
RECT_CASES = [
    ("cubic", 20, 3, "f32", None, ("direct",)),
    ("cubic", 20, 3, "f64", None, ("direct",)),
    ("cubic", 100, 3, "f32", None, ("direct",)),
    ("cubic", 12, 4, "f32", None, ("taps", "direct")),
    ("cubic", 20, 3, "f32", 8, ("interleaved", "direct")),
    ("cubic", 20, 3, "f32", 3, ("staged_tables", "interleaved", "direct")),
    ("cubic", 20, 3, "f64", 4, ("interleaved", "direct")),
    # stacks of tables above STAGE_BYTES each: interleaved against direct
    ("cubic", 40, 3, "f32", 8, ("interleaved", "direct")),
    ("cubic", 40, 3, "f64", 4, ("interleaved", "direct")),
    ("cubic", 100, 3, "f32", 8, ("interleaved", "direct")),
    ("cubic", 100, 3, "f64", 4, ("interleaved", "direct")),
    ("cubic", 12, 4, "f64", 4, ("interleaved", "direct")),
    ("cubic", 20, 4, "f64", 4, ("interleaved", "direct")),
    ("cubic", 8, 5, "f64", 4, ("interleaved", "direct")),
    ("cubic", 14, 4, "f32", 8, ("interleaved", "direct")),
    ("cubic", 20, 4, "f32", 8, ("interleaved", "direct")),
    ("cubic", 12, 5, "f32", 8, ("interleaved", "direct")),
    # f64 tables on either side of L1_BYTES
    ("cubic", 30, 3, "f64", 4, ("interleaved", "direct")),
    ("cubic", 9, 5, "f64", 4, ("interleaved", "direct")),
    ("cubic", 6, 6, "f64", 4, ("interleaved", "direct")),
    # one linear or nearest table (K2 linear, K3): the route picked against
    # every other, on the jittered axes, a long axis (1000^2), a table above
    # STAGE_BYTES (100^3) and geometric axes (ratio 1.3 a cell)
    ("linear", 20, 3, "f32", None, ("guided", "direct")),
    ("linear", 20, 3, "f64", None, ("staged", "guided", "direct")),
    ("nearest", 20, 3, "f32", None, ("guided", "direct")),
    ("nearest", 20, 3, "f64", None, ("guided", "direct")),
    ("linear", 100, 3, "f32", None, ("guided", "direct")),
    ("linear", 1000, 2, "f32", None, ("guided", "direct")),
    ("nearest", 1000, 2, "f32", None, ("guided", "direct")),
    ("linear", 20, 3, "f32", None, ("staged", "guided", "direct"), "geometric"),
    ("nearest", 20, 3, "f32", None, ("guided", "direct"), "geometric"),
    # linear and nearest stacks: K5's routes against direct
    ("linear", 20, 3, "f32", 8, ("direct",)),
    ("nearest", 20, 3, "f32", 8, ("direct",)),
    ("linear", 20, 3, "f32", 3, ("interleaved", "direct")),
    ("nearest", 20, 3, "f32", 3, ("interleaved",)),
    ("linear", 20, 3, "f64", 4, ("direct",)),
    ("nearest", 20, 3, "f64", 4, ("direct",)),
    ("linear", 12, 4, "f32", 8, ("direct",)),
    ("linear", 8, 5, "f32", 8, ("direct",)),
    ("linear", 40, 3, "f32", 16, ("direct",)),
]
# K4 and K7: (spline degree, points an axis, ndims, dtype, tables of a stack
# or None, the other routes timed), `chip_smoke.py`'s spline paths and K7
# stacks around the group cap
BSPLINE_CASES = [
    (3, 20, 3, "f32", None, ("direct",)), (3, 20, 3, "f64", None, ("direct",)),
    (3, 100, 2, "f64", None, ("direct",)), (5, 20, 3, "f32", None, ("direct",)),
    (5, 20, 3, "f64", None, ("direct",)), (3, 35, 3, "f32", None, ("direct",)),
    (3, 20, 3, "f32", 8, ("interleaved", "direct")),
    (3, 20, 3, "f32", 3, ("direct",)),
    (3, 20, 3, "f32", 9, ("interleaved", "direct")),
    (3, 20, 3, "f64", 4, ("interleaved", "direct")),
    # tables above GROUP_BYTES: interleaved against direct
    (3, 40, 3, "f32", 8, ("direct",)),
    (3, 40, 3, "f64", 4, ("direct",)),
]
# cubic against an earlier checkout whose plain version was the gather tree:
# the JAX package's bars of a weight contraction against it
GATHER_TOL = {torch.float32: 1e-4, torch.float64: 1e-13}
# whether the earlier checkout's rectilinear results are held against this
# one's (not with --unchecked: a copy whose kernel skips part of the work)
COMPARE_EARLIER = True
# passes of the batches in each turn of the back-to-back timing (--passes)
PASSES = 5


def label(case, family="regular") -> str:
    method, n, nd, dt, nch = case[:5]
    stack = f"stack of {nch} " if nch else ""
    if family == "regular":
        k = 5 if nch else 1
    else:
        k = 6 if nch else (3 if method == "nearest" else 2)
    axes = f" {case[6]}" if len(case) > 6 else ""
    return f"K{k} {method} {stack}{n}^{nd} {dt}{axes}"


def rect_axes(case):
    """A RECT_CASES case's axes: `chip_smoke.py`'s jittered ones on [0, 10],
    or (a 7th entry "geometric") its geometric ones (`rect_axes`) over the
    same span."""
    import chip_smoke as cs

    n, nd = case[1], case[2]
    if len(case) > 6 and case[6] == "geometric":
        return [cs.rect_axes("geometric", n, None)] * nd
    return cs.bench_rect_axes(n, nd)


def bspline_label(case) -> str:
    k, n, nd, dt, nch, _ = case
    what = {3: "cubic_spline", 5: "quintic"}[k]
    return f"K{7 if nch else 4} {what} {f'stack of {nch} ' if nch else ''}{n}^{nd} {dt}"


def source_of(family, case) -> str:
    return f"fused_{family}{'_stack' if case[4] else ''}"


def grid(case, cuda):
    """starts, steps and the table (a stack: (nch, prod(dims))) of a case."""
    method, n, nd, dt, nch, _ = case
    rng = np.random.default_rng(n * 10 + nd)
    size = n**nd
    table = rng.standard_normal((nch, size) if nch else size)
    dtype = DTYPES[dt]
    return (torch.zeros(nd, dtype=dtype, device=cuda),
            torch.full((nd,), 10.0 / (n - 1), dtype=dtype, device=cuda),
            torch.as_tensor(table, dtype=dtype, device=cuda))


def batches(case, cuda, lo=LO, hi=HI, seed=7):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    nd, dtype = case[2], DTYPES[case[3]]
    return [tuple(torch.rand(N, generator=gen, device=cuda, dtype=dtype) * (hi - lo) + lo
                  for _ in range(nd)) for _ in range(BATCHES)]


def public(fused_module, case, st, sp, vals):
    """A checkout's public evaluator on the case's table."""
    method, n, nd, _, nch, _ = case
    f = fused_module.eval_regular_stack if nch else fused_module.eval_regular
    return lambda ob: f((n,) * nd, st, sp, vals, ob, method)


def back_to_back(fn, main):
    """Per call, over PASSES passes of the batches: the events' time of
    each pass (host included) and the host's time to queue it."""
    for b in main[:3]:
        fn(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    loop, issue = [], []
    for _ in range(PASSES):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for b in main:
            fn(b)
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        loop.append(start.elapsed_time(end) / len(main))
        issue.append((t1 - t0) * 1e3 / len(main))
    return loop, issue


def this_kernel(case, st, sp, vals, route):
    """This checkout's entry on `route`, with the buffer of the route's
    layout (which the entry lays out before the kernel reads it) allocated
    inside the call."""
    method, n, nd, _, nch, _ = case
    dims = (n,) * nd
    source = "fused_regular_stack" if nch else "fused_regular"
    head = (fused.METHODS.index(method), 1, int(vals.dtype == torch.float64))
    size = fused._layout_size(dims, route, vals)

    def call(ob):
        work = None if size is None else torch.empty(size, dtype=vals.dtype, device=vals.device)
        return fused._launch(source, f"regular_{method}{'_stack' if nch else ''}", head, dims,
                             vals, ob, ob[0].shape[0], bool(nch), st.data_ptr(), sp.data_ptr(),
                             None if work is None else work.data_ptr(), route=route)
    return call


def raw_times(case, st, sp, vals, main) -> dict:
    """Each checkout's `raw.interpn_<method>_regular_<dtype>` from CUDA
    tensors into a preallocated out: ms a call on the host clock over one
    pass of the batches after two warm-up calls, synchronized, in turns."""
    method, n, nd, dt, _, _ = case
    name = f"interpn_{method}_regular_{dt}"
    lin = (True,) if method == "cubic" else ()
    out = torch.empty(N, dtype=vals.dtype, device=vals.device)
    dims = np.array([n] * nd)
    fns = {side: getattr(importlib.import_module(module), name)
           for side, module in (("earlier", "earlier_port.raw"), ("this", "interpn_tpu_torch.raw"))}
    ms = {}
    for side in ("earlier", "this", "this", "earlier"):
        for b in main[:2]:
            fns[side](dims, st, sp, vals, *lin, list(b), out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in main:
            fns[side](dims, st, sp, vals, *lin, list(b), out)
        torch.cuda.synchronize()
        ms.setdefault(side, []).append((time.perf_counter() - t0) * 1e3 / len(main))
    return ms


def layout_fns(case, route, earlier, vals) -> dict:
    """On a route with a layout kernel: that kernel alone (this checkout's,
    and the earlier's where it has one) and the PyTorch call that makes the
    same copy, each a function of the table."""
    dims = (case[1],) * case[2]
    if route in fused.TAP_ROUTES and case[4]:
        return {"cubic_stack_pack": lambda v: fused.cubic_stack_pack(dims, v),
                "torch": lambda v: v.reshape(-1, *dims).unfold(1, 4, 1).contiguous()}
    if route in fused.TAP_ROUTES:
        return {"cubic_pack": lambda v: fused.cubic_pack(dims, v),
                "torch": lambda v: v.reshape(dims).unfold(0, 4, 1).contiguous()}
    if route == "interleaved":
        return {"earlier": earlier.interleave, "interleave": fused.interleave,
                "torch": lambda v: v.t().contiguous()}
    return {}


def earlier_rect_info(earlier, case) -> dict:
    """Registers (and, where the earlier checkout reports them, local bytes
    and blocks an SM) of the earlier rectilinear instantiation for the case:
    the earlier checkout's own route for it where it has that function
    (a copy with a variant), else direct."""
    method, n, nd, dt, nch = case[:5]
    route = "direct"
    if hasattr(earlier, "guide_bytes"):
        route = earlier.rectilinear_route((n,) * nd, DTYPES[dt], method, nch)
    try:
        return earlier.regular_info(method, DTYPES[dt], nd, route, bool(nch), "rectilinear")
    except TypeError:  # a checkout before the rectilinear routes: its ptxas log
        build = importlib.import_module("earlier_port._build")
        log = build.library_path(source_of("rectilinear", case)).with_suffix(".log").read_text()
        t = "d" if dt == "f64" else "f"
        m = re.search(rf"rectilinear_kernelI{t}Li{nd}ELi"
                      rf"{fused.METHODS.index(method)}ELb{int(bool(nch))}E\S*' for \S+\n[^\n]*\n"
                      r"\s+(\d+) bytes stack frame[^\n]*\n[^\n]*Used (\d+) registers", log)
        return {"registers": int(m.group(2)), "stack_bytes": int(m.group(1))} if m else {}


def rect_times(case, earlier, cuda) -> dict:
    """Parts 1 and 2 of a RECT_CASES case (see the module's docstring)."""
    import chip_smoke as cs

    method, n, nd, dt, nch, others = case[:6]
    dtype = DTYPES[dt]
    rng = np.random.default_rng(n * 10 + nd)
    axes = tuple(torch.as_tensor(a, dtype=dtype, device=cuda) for a in rect_axes(case))
    vals = torch.as_tensor(rng.standard_normal((nch, n**nd) if nch else n**nd), dtype=dtype,
                           device=cuda)
    dims = (n,) * nd
    picked = fused.rectilinear_route(dims, dtype, method, nch)

    def public(m):
        f = m.eval_rectilinear_stack if nch else m.eval_rectilinear
        return lambda ob: f(axes, vals, ob, method)

    def on_route(route):
        cols = (fused._VOIDP * nd)(*(g.data_ptr() for g in axes))
        return lambda ob: fused._relaid_launch("rectilinear", route, fused.RECT_LAYOUTS, dims,
                                               vals, ob, method, True, ob[0].shape[0],
                                               bool(nch), cols)

    fns = {"earlier": public(earlier), picked: public(fused)}
    fns.update({r: on_route(r) for r in others if r != picked})
    main = batches((method, n, nd, dt, nch, ()), cuda)
    what = label(case, "rectilinear")
    plain = fused.plain_rectilinear_stack if nch else fused.plain_rectilinear
    want = fns[picked](main[0])
    cs.bitwise(want, plain(axes, vals, main[0], method), f"{what}: {picked} vs plain")
    for r in fns:
        if r not in ("earlier", picked):
            cs.bitwise(fns[r](main[0]), want, f"{what}: {r} vs {picked}")
    got = fns["earlier"](main[0])
    entry = {"case": what, "route": picked, "kernel_ms": {}, "loop_ms": {}, "issue_ms": {}}
    if not COMPARE_EARLIER:
        pass
    elif method == "cubic":
        try:
            torch.testing.assert_close(got, want, rtol=GATHER_TOL[dtype],
                                       atol=GATHER_TOL[dtype], equal_nan=True)
        except AssertionError as e:
            entry["mismatch"] = beyond_the_bar(e, got, want, plain, axes, vals, main[0], method)
    else:
        cs.bitwise(got, want, f"{what}: earlier vs this")
    for name in [*fns, *reversed(fns)]:
        entry["kernel_ms"].setdefault(name, []).append(cuda_time(fns[name], main).device_ms)
    for side in ("earlier", "this", "this", "earlier"):
        loop, issue = back_to_back(fns["earlier" if side == "earlier" else picked], main)
        entry["loop_ms"].setdefault(side, []).extend(loop)
        entry["issue_ms"].setdefault(side, []).extend(issue)
    entry["info"] = {r: fused.regular_info(method, dtype, nd, r, bool(nch), "rectilinear")
                     for r in fns if r != "earlier"}
    entry["info"]["earlier"] = earlier_rect_info(earlier, case)
    return entry


def beyond_the_bar(error, got, want, plain, axes, vals, obs, method) -> dict:
    """Where the earlier checkout's cubic result and this one's differ
    beyond GATHER_TOL: the failed comparison, and each one's largest error
    against the plain version in float64 on the same inputs (the float64
    weight contraction, within 1e-13 of the exact value of those inputs)."""
    ref = plain(tuple(a.double() for a in axes), vals.double(),
                tuple(o.double() for o in obs), method)
    far = (got.double() - want.double()).abs().argmax()
    return {"failed": str(error).splitlines()[:4],
            "error_vs_f64": {name: (r.double() - ref).abs().max().item()
                             for name, r in (("earlier", got), ("this", want))},
            "at_worst_difference": {name: (r.double() - ref).flatten()[far].abs().item()
                                    for name, r in (("earlier", got), ("this", want))}}


def bspline_times(case, earlier, cuda) -> dict:
    """Parts 1 and 2 of a BSPLINE_CASES case: both checkouts' K4 (K7)
    through `eval_bspline[_stack]` on `chip_smoke.path_grid`'s knots and
    coefficients, bitwise equal."""
    import chip_smoke as cs

    k, n, nd, dt, nch, others = case
    dtype = DTYPES[dt]
    p = cs.Path(f"bspline_k{k}{'_stack' if nch else ''}", dtype, n, nd)
    knots, coeffs = cs.path_grid(p, cuda)
    if nch:  # the path's first nch tables (its 8, then nch - 8 more shifted)
        coeffs = torch.cat([coeffs + 8 * j for j in range(-(-nch // 8))])[:nch].contiguous()
    dims = (n,) * nd
    picked = fused.bspline_route(dims, dtype, k, nch)

    def public(m):
        return lambda ob: (m.eval_bspline_stack if nch else m.eval_bspline)(knots, coeffs, ob, k)

    def on_route(route):
        size = fused._layout_size(dims, route, coeffs)
        cols = (fused._VOIDP * nd)(*(t.data_ptr() for t in knots))
        stack = "_stack" if nch else ""

        def call(ob):
            work = None if size is None else torch.empty(size, dtype=dtype, device=cuda)
            return fused._launch(f"fused_bspline{stack}", f"bspline_k{k}{stack}",
                                 (k, int(dtype == torch.float64)), dims, coeffs, ob,
                                 ob[0].shape[0], bool(nch), cols,
                                 None if work is None else work.data_ptr(), route=route)
        return call

    fns = {"earlier": public(earlier), picked: public(fused)}
    fns.update({r: on_route(r) for r in others if r != picked})
    main = batches(("", n, nd, dt, nch, ()), cuda)
    want = fns[picked](main[0])
    for r in fns:
        if r != "earlier" or COMPARE_EARLIER:
            cs.bitwise(fns[r](main[0]), want, f"{bspline_label(case)}: {r} vs {picked}")
    entry = {"case": bspline_label(case), "route": picked, "kernel_ms": {},
             "loop_ms": {}, "issue_ms": {}}
    for name in [*fns, *reversed(fns)]:
        entry["kernel_ms"].setdefault(name, []).append(cuda_time(fns[name], main).device_ms)
    for side in ("earlier", "this", "this", "earlier"):
        loop, issue = back_to_back(fns["earlier" if side == "earlier" else picked], main)
        entry["loop_ms"].setdefault(side, []).extend(loop)
        entry["issue_ms"].setdefault(side, []).extend(issue)
    entry["info"] = {r: fused.regular_info(k, dtype, nd, r, bool(nch), "bspline")
                     for r in fns if r != "earlier"}
    return entry


def load_earlier(parent: Path):
    """The earlier checkout's `ops.fused`, its package imported as
    `earlier_port`."""
    pkg = parent / "interpn_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "earlier_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["earlier_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("earlier_port.ops.fused")


def case_times(case, earlier, cuda) -> dict:
    """Parts 1 and 2 on one case; `earlier` is the earlier `ops.fused`."""
    import chip_smoke as cs

    method, n, nd, dt, nch, others = case
    st, sp, vals = grid(case, cuda)
    picked = fused.regular_route((n,) * nd, DTYPES[dt], method, nch)
    fns = {"earlier": public(earlier, case, st, sp, vals), picked: public(fused, case, st, sp, vals)}
    fns.update({r: this_kernel(case, st, sp, vals, r) for r in others if r != picked})
    main = batches(case, cuda)
    want = fns["earlier"](main[0])
    for r in fns:
        cs.bitwise(fns[r](main[0]), want, f"{label(case)}: {r} vs earlier")
    ms = {}
    for name in [*fns, *reversed(fns)]:
        ms.setdefault(name, []).append(cuda_time(fns[name], main).device_ms)
    entry = {"case": label(case), "route": picked, "kernel_ms": ms, "loop_ms": {},
             "issue_ms": {}}
    for side in ("earlier", "this", "this", "earlier"):
        loop, issue = back_to_back(fns["earlier" if side == "earlier" else picked], main)
        entry["loop_ms"].setdefault(side, []).extend(loop)
        entry["issue_ms"].setdefault(side, []).extend(issue)
    entry["info"] = {r: fused.regular_info(method, DTYPES[dt], nd, r, bool(nch))
                     for r in fns if r != "earlier"}
    entry["info"]["earlier"] = earlier.regular_info(method, DTYPES[dt], nd, "direct", bool(nch))
    layout = layout_fns(case, picked, earlier, vals)
    if layout:
        entry["layout_ms"] = {}
        for name in [*layout, *reversed(layout)]:
            entry["layout_ms"].setdefault(name, []).append(
                cuda_time(layout[name], [vals] * BATCHES).device_ms)
    if not nch:
        entry["raw_ms"] = raw_times(case, st, sp, vals, main)
    del main
    if nd == 3 and method in ("linear", "nearest"):
        inside = batches(case, cuda, 0.0, 10.0, seed=8)
        prepare, call = cs.grid_sample_call(vals, n, "bilinear" if method == "linear" else
                                            "nearest", nch or 1)
        prepared = [prepare(b) for b in inside]
        grid_ms = {}
        for name in ("grid_sample", "earlier", picked, picked, "earlier", "grid_sample"):
            fn, arg = (call, prepared) if name == "grid_sample" else (fns[name], inside)
            grid_ms.setdefault(name, []).append(cuda_time(fn, arg).device_ms)
        entry["in_grid_ms"] = grid_ms
    return entry


def engine_paths(only=None):
    """`chip_smoke.py`'s engine paths and regular cubic 20^4 f64 under each
    engine (the shape that the JAX package's auto mode sends to its int8
    engine, as 12^5: `bench.py`'s tpu_cubic_f64_4d@1M), whose label `only`
    finds."""
    import chip_smoke as cs

    extra = [cs.Path("regular_cubic", cs.F64, 20, 4, engine) for engine in ("df64", "i8")]
    return [p for p in [*cs.PATHS, *extra]
            if p.engine and (only is None or re.search(only, p.label))]


def native_fn(p, grid):
    """This checkout's native kernel on the path's f64 table (K1, K2, K4),
    its whole call, fn(obs)."""
    dims = (p.n,) * p.ndims
    if p.kind == "bspline":
        return lambda ob: fused.eval_bspline(grid[0], grid[1], ob, p.k)
    if p.kind == "regular":
        return lambda ob: fused.eval_regular(dims, *grid, ob, p.method)
    return lambda ob: fused.eval_rectilinear(*grid, ob, p.method)


def engine_fns(port, p, grid):
    """A checkout's whole engine call (`ops.df64.eval_*` / `ops.i8.eval_*`)
    on `chip_smoke.path_grid`'s tensors, fn(obs)."""
    ops = importlib.import_module(f"{port}.ops")
    module = ops.df64 if p.engine == "df64" else ops.i8
    dims = (p.n,) * p.ndims
    if p.kind == "bspline":
        return lambda ob: module.eval_bspline(grid[0], grid[1], ob, p.k)
    if p.kind == "regular":
        return lambda ob: module.eval_regular(dims, *grid, ob, p.method)
    return lambda ob: module.eval_rectilinear(*grid, ob, p.method)


def earlier_kernel(p, grid):
    """The earlier checkout's kernel alone: its wrapper (`contract`) and a
    function of a batch that builds the wrapper's arguments beforehand; for
    a checkout whose kernels build the weights, its whole call."""
    ops = importlib.import_module("earlier_port.ops")
    if hasattr(ops.fused, "i8_route"):
        return engine_fns("earlier_port", p, grid), lambda ob: ob
    df64, i8 = ops.df64, ops.i8
    dims = (p.n,) * p.ndims
    fp = df64.FOOTPRINT[p.k if p.kind == "bspline" else p.method]

    def args(ob):
        if p.kind == "bspline":
            w, table = df64.spline_weights_f64(grid[0], ob, p.k), grid[1]
        elif p.kind == "regular":
            w, table = df64.weights_f64(dims, grid[0], grid[1], None, ob, p.method), grid[2]
        else:
            w, table = df64.weights_f64(dims, None, None, grid[0], ob, p.method), grid[1]
        prep = df64.table_split(table)[:2] if p.engine == "df64" else i8.prepare(dims, table)[:4]
        return (dims, fp, *w[:3], *prep)

    contract = df64.contract if p.engine == "df64" else i8.contract
    return (lambda a: contract(*a)), args


def earlier_info(p) -> dict:
    """Registers and stack frame of the earlier checkout's instantiation
    for the path, from its ptxas log."""
    build = importlib.import_module("earlier_port._build")
    source = f"fused_{p.engine}"
    log = build.library_path(source).with_suffix(".log").read_text()
    fp = {"linear": 2, "cubic": 4}.get(p.method, p.k + 1 if p.kind == "bspline" else 0)
    g = ""
    if p.engine == "i8":
        g = f"Li{importlib.import_module('earlier_port.ops.i8')._choose_group((p.n,) * p.ndims)}E"
    m = re.search(rf"{p.engine}_kernelILi{p.ndims}ELi{fp}E{g}\S*' for \S+\n[^\n]*\n\s+(\d+) "
                  r"bytes stack frame[^\n]*\n[^\n]*Used (\d+) registers", log)
    return {"registers": int(m.group(2)), "stack_bytes": int(m.group(1))} if m else {}


def engine_times(p, cuda) -> dict:
    """The --engines measurements of one engine path."""
    import chip_smoke as cs

    grid = cs.path_grid(p, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(p.n * 10 + p.ndims)
    main = [tuple(torch.rand(N, generator=gen, device=cuda, dtype=torch.float64) * (HI - LO) + LO
                  for _ in range(p.ndims)) for _ in range(BATCHES)]
    whole = {"earlier": engine_fns("earlier_port", p, grid),
             "this": engine_fns("interpn_tpu_torch", p, grid)}
    kern_e, args = earlier_kernel(p, grid)
    cs.bitwise(whole["this"](main[0]), whole["earlier"](main[0]), f"{p.label}: this vs earlier")
    entry = {"case": p.label, "route": "this", "kernel_ms": {}, "whole_ms": {}, "ahead": {},
             "native_ms": {}, "loop_ms": {}, "issue_ms": {}, "raw_ms": {}}
    prebuilt = [args(b) for b in main]
    for side in ("earlier", "this", "this", "earlier"):
        t = (cuda_time(kern_e, prebuilt) if side == "earlier"
             else cuda_time(whole["this"], main))
        entry["kernel_ms"].setdefault(side, []).append(t.device_ms)
    del prebuilt
    for side in ("earlier", "this", "this", "earlier"):
        t = cuda_time(whole[side], main[:4])
        entry["whole_ms"].setdefault(side, []).append(t.device_ms)
        entry["ahead"].setdefault(side, []).append(t.ahead)
    native = native_fn(p, grid)
    for side in ("native", "this", "this", "native"):
        t = cuda_time(native if side == "native" else whole["this"], main[:4])
        entry["native_ms"].setdefault(side, []).append(t.device_ms)
    ports = {"earlier": "earlier_port", "this": "interpn_tpu_torch"}
    with cs.f64_engine(p.engine):
        ops_fn = {side: cs_op(port, p, grid) for side, port in ports.items()}
        raw_fn = {side: cs_raw(port, p, grid) for side, port in ports.items()}
        for side in ("earlier", "this", "this", "earlier"):
            loop, issue = back_to_back(ops_fn[side], main)
            entry["loop_ms"].setdefault(side, []).extend(loop)
            entry["issue_ms"].setdefault(side, []).extend(issue)
        for side in ("earlier", "this", "this", "earlier"):
            for b in main[:2]:
                raw_fn[side](b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in main:
                raw_fn[side](b)
            torch.cuda.synchronize()
            entry["raw_ms"].setdefault(side, []).append((time.perf_counter() - t0) * 1e3 / BATCHES)
    fp = 2 if p.method == "linear" else (p.k + 1 if p.kind == "bspline" else 4)
    g = importlib.import_module("interpn_tpu_torch.ops.i8")._choose_group((p.n,) * p.ndims)
    entry["info"] = {"this": fused.engine_info(p.engine, fp, p.ndims, g),
                     "earlier": earlier_info(p)}
    return entry


def cs_op(port, p, grid):
    """A checkout's op under INTERPN_TPU_F64 (`ops.<method>_<kind>`,
    `ops.bspline_eval`), fn(obs)."""
    ops = importlib.import_module(f"{port}.ops")
    dims = (p.n,) * p.ndims
    if p.kind == "bspline":
        return lambda ob: ops.bspline_eval(*grid, ob, p.k)
    fn = getattr(ops, f"{p.method}_{p.kind}")
    lin = (True,) if p.method == "cubic" else ()
    if p.kind == "regular":
        return lambda ob: fn(dims, *grid, ob, *lin)
    return lambda ob: fn(*grid, ob, *lin)


def cs_raw(port, p, grid):
    """A checkout's `raw` entry from CUDA tensors into a preallocated out
    (the op for a spline), fn(obs)."""
    if p.kind == "bspline":
        return cs_op(port, p, grid)
    raw = importlib.import_module(f"{port}.raw")
    fn = getattr(raw, f"interpn_{p.method}_{p.kind}_f64")
    out = torch.empty(N, dtype=torch.float64, device=grid[-1].device)
    lin = (True,) if p.method == "cubic" else ()
    head = ((np.array([p.n] * p.ndims), *grid[:2], grid[2]) if p.kind == "regular"
            else (list(grid[0]), grid[1]))
    return lambda ob: fn(*head, *lin, list(ob), out)


def print_engine(entry, smi) -> None:
    best = {k: min(v) for k, v in entry["kernel_ms"].items()}
    whole = {k: min(v) for k, v in entry["whole_ms"].items()}
    native = {k: min(v) for k, v in entry["native_ms"].items()}
    info = "; ".join(f"{k} " + "/".join(str(v) for v in i.values())
                     for k, i in entry["info"].items())
    print(f"{entry['case']} [{smi}]: kernel ms, best of two: earlier {best['earlier']:.4f} "
          f"(on prebuilt weights), this {best['this']:.4f} (one launch from the queries); "
          f"whole call by events over 4 batches, best of two: earlier {whole['earlier']:.4f}, "
          f"this {whole['this']:.4f} (head start held: {entry['ahead']}), "
          f"{whole['earlier'] / whole['this']:.1f}x; against the native kernel (K1, K2, K4 "
          f"in float64), whole call by events over 4 batches, best of two: native "
          f"{native['native']:.4f}, this engine {native['this']:.4f}; "
          f"the op back to back, median of {2 * PASSES} "
          "passes: " + ", ".join(f"{k} {statistics.median(v):.4f}"
                                 for k, v in entry["loop_ms"].items())
          + "; host ms/call: " + ", ".join(f"{k} {statistics.median(v):.4f}"
                                           for k, v in entry["issue_ms"].items())
          + "; raw from CUDA tensors, best of two: " + ", ".join(
              f"{k} {min(v):.4f}" for k, v in entry["raw_ms"].items())
          + f"; this registers/shared bytes/local bytes/blocks an SM, earlier registers/"
          f"stack bytes: {info}", flush=True)


def ptxas_table(build, source) -> dict:
    """Kernel symbol -> (registers, stack frame bytes, spill store bytes)
    from the ptxas log of a checkout's build (`build`, its `_build`) of
    `source`."""
    log = build.library_path(source).with_suffix(".log").read_text()
    found = re.findall(r"Compiling entry function '(\S+)' for \S+\n[^\n]*\n\s+(\d+) bytes stack "
                       r"frame, (\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", log)
    return {name: (int(regs), int(stack), int(spill)) for name, stack, spill, regs in found}


def compare_registers(earlier_build, smi) -> None:
    """--registers: every kernel that both checkouts build, its ptxas
    numbers side by side; the ones that differ printed, and those that one
    checkout builds alone (a kernel whose parameters changed among them)
    with their numbers."""
    for source in SOURCES:
        this, other = ptxas_table(_build, source), ptxas_table(earlier_build, source)
        both = sorted(this.keys() & other.keys())
        differ = [f"{name} {other[name]} -> {this[name]}" for name in both
                  if this[name] != other[name]]
        print(f"{source} [{smi}]: {len(both)} kernels in both checkouts, {len(differ)} with "
              f"other registers / stack frame / spill stores; {len(this.keys() - other.keys())} "
              f"only in this one, {len(other.keys() - this.keys())} only in the earlier one"
              + "".join(f"\n  {d}" for d in differ)
              + "".join(f"\n  only in this one: {name} {this[name]}"
                        for name in sorted(this.keys() - other.keys()))
              + "".join(f"\n  only in the earlier one: {name} {other[name]}"
                        for name in sorted(other.keys() - this.keys())), flush=True)


def main() -> None:
    global COMPARE_EARLIER, N, PASSES
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="root of the earlier checkout")
    parser.add_argument("--engines", action="store_true",
                        help="time the f64 engines K8 and K9 instead")
    parser.add_argument("--paths", help="the cases (engine paths) whose label this regular "
                        "expression finds only")
    parser.add_argument("--unchecked", action="store_true",
                        help="time the earlier checkout's rectilinear kernels without holding "
                        "their results against this one's (a copy whose kernel skips work)")
    parser.add_argument("--queries", type=int, default=N,
                        help=f"queries a batch (default {N})")
    parser.add_argument("--passes", type=int, default=PASSES,
                        help=f"passes of the batches a turn back to back (default {PASSES})")
    parser.add_argument("--registers", action="store_true",
                        help="compare the ptxas numbers of every kernel both checkouts build "
                        "and time nothing")
    args = parser.parse_args()
    COMPARE_EARLIER = not args.unchecked
    PASSES = args.passes
    N = args.queries
    if not torch.cuda.is_available():
        sys.exit("torch_regular_ab: torch.cuda.is_available() is False; needs a CUDA device")
    cuda = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    earlier = load_earlier(args.parent.resolve())
    cases = [(case_times, c, label(c), source_of("regular", c)) for c in CASES]
    cases += [(rect_times, c, label(c, "rectilinear"), source_of("rectilinear", c))
              for c in RECT_CASES]
    cases += [(bspline_times, c, bspline_label(c), source_of("bspline", c))
              for c in BSPLINE_CASES]
    cases = [c for c in cases if args.paths is None or re.search(args.paths, c[2])]
    sources = ENGINE_SOURCES if args.engines else sorted({c[3] for c in cases})
    if args.registers:
        sources = SOURCES
    with ThreadPoolExecutor(2) as pool:
        for built in [pool.submit(b.build_all, sources) for b in (_build, earlier._build)]:
            built.result()
    if args.registers:
        compare_registers(earlier._build, smi)
        return
    if args.engines:
        paths = engine_paths(args.paths)
        # the native kernels this checkout times beside its engines
        _build.build_all(sorted({f"fused_{p.kind}" for p in paths}))
        record = []
        for p in paths:
            record.append(engine_times(p, cuda))
            print_engine(record[-1], smi)
        print(smi)
        print(json.dumps({"card": smi, "engines": record}))
        return
    record = []
    for times, case, _, _ in cases:
        entry = times(case, earlier, cuda)
        record.append(entry)
        best = {k: min(v) for k, v in entry["kernel_ms"].items()}
        kern = "; ".join(f"{k} {v:.4f}" for k, v in best.items())
        loop = ", ".join(f"{k} {statistics.median(v):.4f}" for k, v in entry["loop_ms"].items())
        issue = ", ".join(f"{k} {statistics.median(v):.4f}"
                          for k, v in entry["issue_ms"].items())
        extra = ""
        if "info" in entry:
            extra += "; registers/static shared bytes/local bytes/blocks an SM: " + ", ".join(
                f"{k} " + "/".join(f"{v}" for v in i.values()) for k, i in entry["info"].items())
        if "raw_ms" in entry:
            extra += "; raw entry ms/call, best of two: " + ", ".join(
                f"{k} {min(v):.4f}" for k, v in entry["raw_ms"].items())
        if "layout_ms" in entry:
            extra += "; layout kernel alone, best of two: " + ", ".join(
                f"{k} {min(v):.4f}" for k, v in entry["layout_ms"].items())
        if "mismatch" in entry:
            extra += (f"; EARLIER DIFFERS BEYOND rtol = atol {GATHER_TOL[DTYPES[case[3]]]}: "
                      f"{json.dumps(entry['mismatch'])}")
        if "in_grid_ms" in entry:
            extra += "; in the grid: " + ", ".join(
                f"{k} {min(v):.4f}" for k, v in entry["in_grid_ms"].items())
        print(f"{entry['case']} ({entry['route']}) [{smi}]: kernel ms, best of two: {kern}; "
              f"{best['earlier'] / best[entry['route']]:.2f}x; back to back ms/call, median "
              f"of {2 * PASSES} passes: {loop}; host ms/call: {issue}{extra}", flush=True)
    print(smi)
    print(json.dumps({"card": smi, "cases": record}))
    if any("mismatch" in entry for entry in record):
        sys.exit("torch_regular_ab: the earlier checkout's results differ beyond the bar")


if __name__ == "__main__":
    main()
