"""One run of one cell of the port's benchmark.

A cell is an entry of `workloads` in BENCHMARK.json. Everything it needs is
found by name under this folder, so a later cell or metric is added as files
alone:

* `configs/<config>.json`: the grid, its dtype and method, and the table's
  recipe;
* `grids/<grid>.py`: the configuration's grid kind, `METHODS`, `make`, the
  grid's host arrays from the seed, and `reference_args`, those arrays as the
  reference takes them;
* `reference/<grid>.py`: the plain reference of the grid kind, `evaluate`;
* `mixes/<traffic>.json`: the entry, the queries a step, the tables, the
  query distribution, the ring of distinct batches and the answers sampled
  for the check;
* `cells/<workload>.json`: the cell's limits, and any of the mix's values
  that this cell sets otherwise (`"mix"`);
* `entries/<entry>.py`: `build(problem)`, the port call that one step
  makes, and `OUT`, whether the call writes a preallocated `out`;
* `metrics/<metric>.py`: `read(run)`, the reader of each metric of
  BENCHMARK.json, which returns a number or None where it finds nothing to
  read.

A run makes the tables and the ring of query batches on the device from
`--seed`, builds the entry, warms it up on the ring, then runs a closed
loop for `--seconds`: each step is one call on the next batch of the ring,
then `torch.cuda.synchronize()`. A reservoir drawn from the seed keeps the
answers of a few steps; once the window has closed and the program's state
is freed, the configuration's reference recomputes them in float64 and the
largest gap decides `correct`. With `--trace 1` the window runs under
torch.profiler (it feeds `device.busy_s` and `breakdown` only: on the H100
the profiler was seen to drop kernels) and a head-start pass of the cell's
call times one step on the device after the window (`timing.py`).
"""

from __future__ import annotations

import argparse
import ast
import bisect
import gc
import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PORT = "interpn_tpu_torch"
# top-level module names that no run may load, compared whole: the port's
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "interpn_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the control: the reference computed in the nearest precision below the
# configuration's, (dtype, the reference's rounding of the contraction's
# factors): TF32 products for float32 (the program runs no TF32), float32
# for float64
CONTROLS = {"float32": (torch.float32, "tf32"), "float64": (torch.float32, None)}
MARK = "portbench.window"
TIMING_PASSES = 3
TIMING_CALLS = 8  # calls a head-start pass, cycling the ring
BREAKDOWN_ENTRIES = 10


# --- modules -----------------------------------------------------------------------


def top_level_hits(modules, names=FORBIDDEN) -> list[str]:
    """The modules among `modules` whose top-level name is one of `names`."""
    return sorted(m for m in modules if m.split(".")[0] in names)


def reference_imports(folder: Path) -> list[str]:
    """The modules that the files under `folder` import by name."""
    names = []
    for path in sorted(folder.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.append(node.module)
    return names


def guarded(folder: Path, what: str, load: Callable[[], ModuleType]) -> ModuleType:
    """`load()`, refused where the files under `folder` import, or loading
    pulls in, the program or the JAX package."""
    refused = (*FORBIDDEN, PORT)
    named = top_level_hits(reference_imports(folder), refused)
    if named:
        raise RuntimeError(f"{what} imports {', '.join(named)}")
    before = set(sys.modules)
    module = load()
    pulled = top_level_hits(set(sys.modules) - before, refused)
    if pulled:
        raise RuntimeError(f"{what} pulled in {', '.join(pulled)}")
    return module


def load_reference(folder: Path, module: str) -> ModuleType:
    """The reference `module`, refused where the files under `folder` import,
    or importing it pulls in, the program or the JAX package."""
    return guarded(folder, "the reference", lambda: importlib.import_module(module))


def import_port(root: Path) -> ModuleType:
    """The program under test from the checkout at `root`, never from
    elsewhere on the path."""
    sys.path.insert(0, str(root))
    port = importlib.import_module(PORT)
    where = Path(port.__file__).resolve()
    if root.resolve() not in where.parents:
        raise ImportError(f"{PORT} came from {where}, not from the checkout {root}")
    importlib.import_module(f"{PORT}.ops.fused")
    return port


def load_module(path: Path, tag: str) -> ModuleType:
    """The Python file at `path` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_reference(cell: Cell) -> ModuleType:
    """The reference of the cell's grid kind, `reference/<grid>.py`."""
    return load_reference(cell.bench_dir / "reference",
                          f"portbench.reference.{cell.config['grid']}")


# --- the cell ----------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    grid: ModuleType  # grids/<config's grid>.py
    mix: dict  # the mix's values, with the cell file's in their place
    limits: dict
    entry: ModuleType
    end_to_end: list[dict]  # BENCHMARK.json's metrics that this cell reports
    per_layer: list[dict]
    bench_dir: Path


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(bench_file: Path, bench_dir: Path, name: str) -> Cell:
    """The cell `name` of `bench_file`, from the files under `bench_dir`."""
    bench = json.loads(bench_file.read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    config = json.loads((bench_dir / "configs" / f"{work['config']}.json").read_text())
    # the grid kind makes inputs that the reference takes: as guarded as it
    kind = config["grid"]
    grid = guarded(bench_dir / "grids", f"the grid kind {kind}",
                   lambda: load_module(bench_dir / "grids" / f"{kind}.py", f"grid_{kind}"))
    mix = json.loads((bench_dir / "mixes" / f"{work['traffic']}.json").read_text())
    own = json.loads((bench_dir / "cells" / f"{name}.json").read_text())
    mix = {**mix, **own.get("mix", {})}
    entry = load_module(bench_dir / "entries" / f"{mix['entry']}.py", f"entry_{mix['entry']}")
    return Cell(name, int(work["chips"]), config, grid, mix, own["limits"], entry,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], bench_dir)


# --- inputs from the seed ----------------------------------------------------------


@dataclass
class Problem:
    """What both sides get: the grid as the configuration's dtype holds it
    (`arrays`, by its kind's `make`), the (T, prod(dims)) tables and the ring
    of (N, n) query batches."""

    method: str
    dtype: str
    dims: tuple
    linearize: bool
    grid: ModuleType  # grids/<config's grid>.py
    arrays: dict  # the grid kind's host arrays
    tables: torch.Tensor
    ring: list

    @property
    def starts(self) -> np.ndarray:
        return self.arrays["starts"]

    @property
    def steps(self) -> np.ndarray:
        return self.arrays["steps"]

    @property
    def queries(self) -> int:
        return int(self.ring[0].shape[1])

    @property
    def ntables(self) -> int:
        return int(self.tables.shape[0])

    def obs(self, r: int) -> tuple:
        """Ring batch r as the port takes queries: one 1-D tensor an axis."""
        return tuple(self.ring[r].unbind(0))

    def out(self) -> torch.Tensor:
        """An empty answer: (n,) for one table, (T, n) for a stack."""
        shape = (self.queries,) if self.ntables == 1 else (self.ntables, self.queries)
        return torch.empty(shape, dtype=self.tables.dtype, device=self.tables.device)


def make_problem(cell: Cell, seed: int, device: torch.device) -> Problem:
    """The grid, tables and query batches of `cell` from `seed`: the grid by
    its kind, the tables and queries on `device` by one generator there, in
    the configuration's dtype."""
    cfg, mix = cell.config, cell.mix
    if cfg["method"] not in cell.grid.METHODS:
        raise ValueError(f"no generator for a {cfg['grid']} {cfg['method']} configuration")
    dt = DTYPES[cfg["dtype"]]
    np_dt = np.dtype(cfg["dtype"])
    dims = tuple(int(d) for d in cfg["dims"])
    arrays = cell.grid.make(cfg, seed, np_dt)
    starts64 = np.asarray(cfg["starts"], dtype=np.float64)
    stops64 = np.asarray(cfg["stops"], dtype=np.float64)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    table = cfg["table"]
    if table["kind"] != "uniform":
        raise ValueError(f"no table recipe {table['kind']!r}")
    tables = torch.rand((int(mix["tables"]), int(np.prod(dims))), generator=gen,
                        dtype=dt, device=device)
    tables.mul_(table["high"] - table["low"]).add_(table["low"])
    dist = mix["queries"]
    if dist["kind"] != "uniform":
        raise ValueError(f"no query distribution {dist['kind']!r}")
    span = stops64 - starts64
    lo = torch.tensor(starts64 - dist["margin"] * span, dtype=dt, device=device)[:, None]
    width = torch.tensor((1 + 2 * dist["margin"]) * span, dtype=dt, device=device)[:, None]
    ring = []
    for _ in range(int(mix["ring"])):
        x = torch.rand((len(dims), int(mix["queries_per_step"])), generator=gen, dtype=dt,
                       device=device)
        ring.append(x.mul_(width).add_(lo))
    return Problem(cfg["method"], cfg["dtype"], dims,
                   bool(cfg.get("linearize_extrapolation", True)),
                   cell.grid, arrays, tables, ring)


# --- the closed loop ---------------------------------------------------------------


@dataclass
class Window:
    steps: int
    failed: int
    errors: list
    starts: list  # perf_counter_ns at each call
    returns: list  # ... at its return
    ends: list  # ... after its synchronise
    kept: list  # (step, ring index, answer) of the sampled steps

    @property
    def seconds(self) -> float:
        return (self.ends[-1] - self.starts[0]) / 1e9

    def step_seconds(self) -> np.ndarray:
        return (np.asarray(self.ends) - np.asarray(self.starts)) / 1e9

    def call_seconds(self) -> np.ndarray:
        return (np.asarray(self.returns) - np.asarray(self.starts)) / 1e9


def run_window(call: Callable, problem: Problem, seconds: float, sample: int, seed: int,
               outs, sync: Callable) -> Window:
    """Steps of `call` on the ring until `seconds` have passed. Step i is
    kept by a reservoir of `sample` drawn from `seed` (decided before the
    call, so that a kept step writes its own `out`: outs[j], or outs[sample]
    when not kept)."""
    rng = random.Random(f"{seed}:reservoir")
    obs = [problem.obs(r) for r in range(len(problem.ring))]
    kept, starts, returns, ends, errors = [None] * sample, [], [], [], []
    failed = 0
    clock = time.perf_counter_ns
    limit = int(seconds * 1e9)
    first = clock()
    i = 0
    while True:
        j = i if i < sample else rng.randrange(i + 1)
        keep = j < sample
        out = None if outs is None else outs[j if keep else sample]
        r = i % len(obs)
        t0 = clock()
        try:
            y = call(obs[r], out)
        except Exception as exc:  # a failed step is counted, and the run goes on
            y = None
            failed += 1
            if len(errors) < 3:
                errors.append(repr(exc))
        t1 = clock()
        sync()
        t2 = clock()
        starts.append(t0)
        returns.append(t1)
        ends.append(t2)
        if keep and y is not None:
            kept[j] = (i, r, y)
        i += 1
        if t2 - first >= limit:
            break
    return Window(i, failed, errors, starts, returns, ends, [k for k in kept if k is not None])


# --- the trace ---------------------------------------------------------------------


def _ns(event, what: str) -> int:
    get = getattr(event, f"{what}_ns", None)
    return int(get()) if get is not None else int(getattr(event, f"{what}_us")() * 1000)


def read_trace(events, mark_ns: int, win: Window) -> tuple[dict, dict]:
    """(busy seconds and window seconds, breakdown) of the profiled window:
    the union of the device events inside it, the device events' seconds by
    name, and the idle gaps between them by what the host was doing (from
    the run's own host spans, put on the profiler's clock by the MARK span
    that opened the window)."""
    from torch.autograd import DeviceType

    mark = next(e for e in events if e.name() == MARK)
    offset = _ns(mark, "start") - mark_ns
    lo, hi = win.starts[0] + offset, win.ends[-1] + offset
    # device work only: the profiler also puts the MARK span on the device's timeline
    spans = sorted((_ns(e, "start"), _ns(e, "start") + _ns(e, "duration"), e.name())
                   for e in events if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation() and e.name() != MARK)
    by_name: dict[str, float] = {}
    busy = 0
    gaps = []
    edge = lo
    for a, b, name in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        if a > edge:
            gaps.append((edge, a))
        busy += max(0, b - max(a, edge))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    idle: dict[str, float] = {}
    for a, b in gaps:
        host = (a + b) // 2 - offset
        k = bisect.bisect_right(win.starts, host) - 1
        if k >= 0 and host < win.returns[k]:
            label = "host in the call"
        elif k >= 0 and host < win.ends[k]:
            label = "host in synchronize"
        else:
            label = "host between steps"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    breakdown = {
        "device_ops": [[f"profiler: {name[:180]}", s] for name, s in top],
        "idle_gaps": [[label, s] for label, s in sorted(idle.items(), key=lambda kv: -kv[1])],
    }
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9}, breakdown


# --- the check ---------------------------------------------------------------------


def reference_values(ref: ModuleType, problem: Problem, r: int, dtype,
                     rounding: str | None = None) -> torch.Tensor:
    """(T, n) values of ring batch r by the reference, on inputs cast to
    `dtype` and computed in it, the contraction's factors rounded by the
    reference's function `rounding` where named."""
    grid = problem.grid.reference_args(problem.arrays, dtype, problem.tables.device)
    return ref.evaluate(problem.method, problem.dims, *grid, problem.tables.to(dtype),
                        problem.ring[r].to(dtype), problem.linearize,
                        operand=None if rounding is None else getattr(ref, rounding))


def gap_reading(ref: ModuleType, problem: Problem, answers) -> tuple[float, int]:
    """(the largest gap between an answer and the float64 reference over
    the reference's largest magnitude, values compared) for `answers`, a
    list of (ring index, answer). A NaN, an answer of another size or no
    answer at all reads inf."""
    worst, scale, compared = 0.0, 0.0, 0
    for r, y in answers:
        want = reference_values(ref, problem, r, torch.float64)
        if y.numel() != want.numel():
            return float("inf"), compared
        gap = (y.reshape(want.shape).to(torch.float64) - want).abs()
        gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
        worst = max(worst, float(gap.max()))
        scale = max(scale, float(want.abs().max()))
        compared += y.numel()
        del want, gap
    if not compared:
        return float("inf"), 0
    return worst / scale, compared


def control_reading(ref: ModuleType, problem: Problem) -> float:
    """The number compared when the reference, computed in the nearest
    precision below the configuration's (CONTROLS), stands in the program's
    place on every ring batch."""
    low, rounding = CONTROLS[problem.dtype]
    answers = [(r, reference_values(ref, problem, r, low, rounding))
               for r in range(len(problem.ring))]
    return gap_reading(ref, problem, answers)[0]


def checks(cell: Cell, ref: ModuleType, problem: Problem, win: Window) -> tuple[dict, int]:
    """(each number compared with its limit, values compared). A run is
    correct where every number is within its limit."""
    err, compared = gap_reading(ref, problem, [(r, y) for _, r, y in win.kept])
    return {"max_err": {"value": err, "limit": cell.limits["max_err"]},
            "failed_steps": {"value": win.failed, "limit": 0}}, compared


# --- what the metric readers see ---------------------------------------------------


@dataclass
class Run:
    """What a metric reader reads: the cell, its inputs, the set-up time,
    the window, the port's launch counters over the window, and (traced
    runs on a card) the head-start device time of one step."""

    cell: Cell
    problem: Problem
    setup_s: float
    window: Window
    launches: dict
    device_step: object = None  # timing.Timing of the median pass that held, or None


def read_metrics(run: Run, metrics: list[dict]) -> dict:
    """Each metric's reading, by its reader in metrics/<name>.py; a reader
    that returns None leaves its metric out."""
    found = {}
    for m in metrics:
        reader = load_module(run.cell.bench_dir / "metrics" / f"{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(run)
        if value is not None:
            found[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return found


def device_step_time(call, problem: Problem, out) -> tuple[object, list]:
    """The median over TIMING_PASSES head-start passes whose head start
    held, and every pass."""
    from portbench import timing

    rings = [problem.obs(i % len(problem.ring)) for i in range(TIMING_CALLS)]
    passes = [timing.head_start_time(lambda obs: call(obs, out), rings)
              for _ in range(TIMING_PASSES)]
    held = sorted((p for p in passes if p.ahead), key=lambda p: p.seconds)
    return (held[len(held) // 2] if held else None), passes


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout else None


# --- one run -----------------------------------------------------------------------


def run_cell(cell: Cell, port: ModuleType, ref: ModuleType, seed: int, seconds: float,
             trace: bool, device: torch.device, t0: float,
             marks: list | None = None) -> tuple[dict, list[str]]:
    """One run of `cell`: (the result line's object, the check lines).
    `marks` holds (phase, perf_counter at its end) of the set-up so far."""
    marks = list(marks or [])
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fused = sys.modules[f"{port.__name__}.ops.fused"]
    torch.zeros(1, device=device)
    sync()
    marks.append(("context", time.perf_counter()))
    problem = make_problem(cell, seed, device)
    sync()
    marks.append(("inputs", time.perf_counter()))
    call = cell.entry.build(problem)
    marks.append(("entry", time.perf_counter()))
    sample = int(cell.mix["sample_steps"])
    outs = [problem.out() for _ in range(sample + 1)] if cell.entry.OUT else None
    # warm-up: every ring batch, and as many answers alive at once as the
    # window keeps, so that the allocator holds their blocks already (the
    # first call loads, or builds, the kernels' library)
    held = [call(problem.obs(i % len(problem.ring)), None if outs is None else outs[i])
            for i in range(sample + 1)]
    sync()
    del held
    marks.append(("warm-up", time.perf_counter()))
    # the set-up's objects out of the collector's way: a full collection in
    # the window then walks only what the window made
    gc.collect()
    gc.freeze()
    before = dict(fused.launches)
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        profiler = profile(activities=acts)
        profiler.__enter__()
        marker = record_function(MARK)
        marker.__enter__()
    mark_ns = time.perf_counter_ns()
    setup_s = time.perf_counter() - t0
    try:
        win = run_window(call, problem, seconds, sample, seed, outs, sync)
    finally:
        if trace:
            marker.__exit__(None, None, None)
            profiler.__exit__(None, None, None)
    launches = {k: v - before.get(k, 0) for k, v in fused.launches.items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cell, problem, setup_s, win, launches)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    info = [f"info steps {win.steps} window_s {win.seconds!r} setup_s {setup_s!r}",
            "info step ms p5 {:.4f} median {:.4f} p95 {:.4f} max {:.4f}, call ms median {:.4f}"
            .format(*(np.percentile(win.step_seconds(), [5, 50, 95, 100]) * 1e3),
                    float(np.median(win.call_seconds())) * 1e3),
            "info set-up phases, s: " + " ".join(
                f"{name} {end - start:.3f}" for (name, end), start in
                zip(marks, [t0] + [end for _, end in marks]))]
    if trace:
        trace_dev, breakdown = (read_trace(profiler.profiler.kineto_results.events(), mark_ns,
                                           win) if cuda else ({"busy_s": 0.0,
                                                               "window_s": win.seconds}, None))
        profiler = None
        dev.update(trace_dev)
        if cuda:
            run.device_step, passes = device_step_time(call, problem,
                                                       None if outs is None else outs[sample])
            info.append("info head-start passes " + " ".join(
                f"{p.seconds!r}s/ahead={p.ahead}" for p in passes))
            # the window's own trace beside the events' reading, as a cross-check
            info.append("info busy share of the window: profiler {!r}%, events x steps {}".format(
                100.0 * trace_dev["busy_s"] / trace_dev["window_s"],
                "none" if run.device_step is None else
                repr(100.0 * win.steps * run.device_step.seconds / win.seconds) + "%"))
        metrics = read_metrics(run, cell.per_layer)
    else:
        breakdown = None
        metrics = read_metrics(run, cell.end_to_end)
    smi = power_limit() if cuda else None
    if smi:
        dev["card"] = smi
        info.append(f"info card {smi}")
    # the program's state goes before the reference runs
    call = outs = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found, compared = checks(cell, ref, problem, win)
    info.append(f"info values compared {compared} in {time.perf_counter() - t_check:.3f} s")
    correct = bool(win.kept) and all(v["value"] <= v["limit"] for v in found.values())
    if win.errors:
        info.append("info failed calls: " + " | ".join(win.errors))
    result = {"correct": correct, "attempted": win.steps, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = found  # last: each number compared beside its limit
    lines = info + [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in found.items()]
    return result, lines


def main(argv, t0: float) -> int:
    parser = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(ROOT / "BENCHMARK.json", BENCH_DIR, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    marks = [("imports", time.perf_counter())]
    ref = cell_reference(cell)
    try:
        port = import_port(ROOT)
    except ImportError as exc:
        print(f"portbench: cannot import the program: {exc}", file=sys.stderr)
        return 4
    marks.append(("program import", time.perf_counter()))
    result, lines = run_cell(cell, port, ref, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), t0, marks)
    found = top_level_hits(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
