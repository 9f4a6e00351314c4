"""The harness on the CPU at a size a test run holds: every cell of
BENCHMARK.json end to end, its inputs as the harness made them before grid
kinds were files, a cell and a metric added as files alone (on the regular
and the rectilinear grid), the result line's keys, the checks on imported
modules, the faults that the check must catch, and the control that it must
fail."""

import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 977  # above 32 signed bits: seeds are any whole number
CPU = torch.device("cpu")


def _copy(tmp_path: Path, queries: int = 3000) -> Path:
    """A copy of BENCHMARK.json and portbench/ whose cells take `queries` a step."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (tmp_path / "portbench" / "cells").glob("*.json"):
        own = json.loads(f.read_text())
        own.setdefault("mix", {})["queries_per_step"] = queries
        f.write_text(json.dumps(own))
    return tmp_path


def _run(root: Path, name: str, trace: bool, *, seed=SEED, seconds=0.2, wrap=None):
    cell = harness.load_cell(root / "BENCHMARK.json", root / "portbench", name)
    if wrap is not None:
        cell.entry = wrap(cell.entry)
    port = harness.import_port(ROOT)
    return harness.run_cell(cell, port, harness.cell_reference(cell), seed, seconds, trace, CPU,
                            time.perf_counter())


@pytest.fixture
def bench(tmp_path):
    return _copy(tmp_path)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_its_line_has_the_keys(bench, name, trace):
    result, lines = _run(bench, name, trace)
    assert result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"busy_s", "window_s"} <= set(result["device"]) if trace else True
    cell = harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", name)
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # on the CPU no head-start device time exists, so the device readers give nothing
    assert set(result["metrics"]) == wanted - {"k1_roofline", "k5_roofline", "device.idle_pct"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["checks"]) == {"max_err", "failed_steps"}
    # the numbers compared close the standard error, each beside its limit
    assert lines[-2].startswith("check max_err ") and " limit " in lines[-2]
    assert lines[-1] == "check failed_steps 0 limit 0"


def test_each_cell_reports_what_its_per_layer_metrics_move():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in CELLS:
        ends = {m["name"] for m in spec["end_to_end"] if harness._reports(m, name)}
        layers = [m for m in spec["per_layer"] if harness._reports(m, name)]
        assert "setup_s" in ends and len(ends) >= 2 and layers, name
        for m in layers:
            assert m["moves"] in ends, (name, m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


# tiny configurations added as files alone: (grid kind, method) -> the cell's name
TINY = {("regular", "linear"): "tiny3d_f64_linear.tiny",
        ("rectilinear", "cubic"): "tiny3d_f64_rect_cubic.tiny",
        ("rectilinear", "linear"): "tiny3d_f64_rect_linear.tiny"}
RECT_TINY = [TINY["rectilinear", "cubic"], TINY["rectilinear", "linear"]]
TINY_GRIDS = {
    "regular": {"dims": [4, 5, 6], "starts": [0.0, -1.0, 2.0], "stops": [3.0, 1.0, 5.0]},
    "rectilinear": {"dims": [5, 6, 4], "starts": [0.0, -1.0, 2.0], "stops": [3.0, 1.0, 5.0],
                    "axes": {"kind": "jittered", "jitter": 0.4},
                    "linearize_extrapolation": True},
}


def _add_tiny(bench: Path, name: str) -> None:
    """The tiny cell `name`, its configuration and mix, as files and entries
    of the copy at `bench`."""
    grid, method = next(k for k, v in TINY.items() if v == name)
    config = name.split(".")[0]
    folder = bench / "portbench"
    (folder / "configs" / f"{config}.json").write_text(json.dumps({
        "source": "a test", "grid": grid, "method": method, **TINY_GRIDS[grid],
        "dtype": "float64", "table": {"kind": "uniform", "low": -2.0, "high": 2.0},
        "reduced": []}))
    (folder / "mixes" / "tiny.json").write_text(json.dumps({
        "entry": "eval_torch", "queries_per_step": 500, "tables": 1,
        "queries": {"kind": "uniform", "margin": 0.2}, "ring": 3, "loop": "closed",
        "sample_steps": 2}))
    (folder / "cells" / f"{name}.json").write_text(json.dumps({"limits": {"max_err": 1e-12}}))
    spec = json.loads((bench / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config, "traffic": "tiny", "chips": 1,
                              "why": "a test"})
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("grid,method", list(TINY))
def test_a_cell_and_a_metric_are_added_as_files_alone(bench, grid, method):
    name = TINY[grid, method]
    before = _digest(bench / "portbench")
    _add_tiny(bench, name)
    (bench / "portbench" / "metrics" / "test.steps.py").write_text(
        "def read(run):\n    return run.window.steps\n")
    spec = json.loads((bench / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "test.steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "entry",
                              "moves": "values_per_s", "workloads": [name]})
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(bench / "portbench")
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed
    cell = harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", name)
    harness.import_port(ROOT)
    from portbench.entries import _classes

    model = _classes.model(harness.make_problem(cell, SEED, CPU))
    assert type(model).__name__.lower() == f"multi{method}{grid}"  # e.g. MulticubicRectilinear
    result, _ = _run(bench, name, True)
    assert result["correct"] is True
    assert result["metrics"]["test.steps"]["value"] == result["attempted"]
    # a cell that the new metric does not list does not report it
    other, _ = _run(bench, CELLS[0], True)
    assert "test.steps" not in other["metrics"]


def _broken(fault):
    """The cell's entry with its timed path broken where the answer is made."""

    class Entry:
        def __init__(self, entry):
            self.OUT = entry.OUT
            self.entry = entry

        def build(self, problem):
            call = self.entry.build(problem)
            last = {}

            def step(obs, out):
                y = call(obs, out)
                flat = y.view(-1)
                prev = last.get("y")
                last["y"] = y.clone()
                if fault == "stale" and prev is not None:
                    y.copy_(prev)  # the previous step's answer: the other batch
                elif fault == "alter":
                    flat[flat.numel() // 3] += 1e-2
                elif fault == "half":
                    flat[flat.numel() // 2:] = 0  # half of the batch left unanswered
                return y

            return step

    return Entry


@pytest.mark.parametrize("name", CELLS + RECT_TINY)
@pytest.mark.parametrize("fault", ["alter", "half", "stale"])
def test_a_broken_timed_path_is_not_correct(bench, name, fault):
    if name not in CELLS:
        _add_tiny(bench, name)
    result, lines = _run(bench, name, False, wrap=_broken(fault))
    assert result["correct"] is False
    assert result["checks"]["max_err"]["value"] > result["checks"]["max_err"]["limit"]


def test_a_call_that_fails_in_the_window_is_not_correct(bench):
    class Raising:
        def __init__(self, entry):
            self.OUT = entry.OUT
            self.entry = entry

        def build(self, problem):
            call = self.entry.build(problem)
            calls = []

            def step(obs, out):
                calls.append(1)
                if len(calls) > 4 and len(calls) % 2:  # past the warm-up, every other call
                    raise AssertionError("Unrepresentable coordinate value")
                return call(obs, out)

            return step

    result, lines = _run(bench, CELLS[0], False, wrap=Raising)
    assert result["correct"] is False
    assert 0 < result["failed"] < result["attempted"]
    assert result["checks"]["failed_steps"]["value"] == result["failed"]


@pytest.mark.parametrize("name", CELLS + RECT_TINY)
def test_the_control_fails_where_the_program_passes(bench, name):
    if name not in CELLS:
        _add_tiny(bench, name)
    cell = harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", name)
    ref = harness.cell_reference(cell)
    harness.import_port(ROOT)
    for seed in (11, 12, 13):
        problem = harness.make_problem(cell, seed, CPU)
        call = cell.entry.build(problem)
        answers = [(r, call(problem.obs(r), problem.out() if cell.entry.OUT else None))
                   for r in range(len(problem.ring))]
        program, compared = harness.gap_reading(ref, problem, answers)
        assert compared == len(problem.ring) * problem.queries * problem.ntables
        assert program <= cell.limits["max_err"]
        assert harness.control_reading(ref, problem) > 10 * cell.limits["max_err"]


# SHA-256 of make_problem's tables and ring batches of each cell at 3000
# queries a step, as the harness of commit c0800b3 made them, before grid
# kinds were files
PARENT_INPUTS = {
    ("reg3d20_f32_linear.bulk", SEED):
        "d2222c7333749467858eefeb7122a1300e4125e6e4c29e11db90a90b5b81459c",
    ("reg3d20_f32_linear.bulk", 20261018):
        "5e2e14792f20138edb6aac672ee7adb8c1898d0fb0905348aa80d2e52ec5e77b",
    ("reg4d20_f64_cubic.bulk", SEED):
        "f3e6b6af3312cf8c3de701394e9659c31e06295beeccb19a8b19e3b25617c77c",
    ("reg4d20_f64_cubic.bulk", 20261018):
        "cb3515d82d40cb2d4a3db43d5642dbdf9123e3fd60e037b052f31d9a5f8c5abe",
    ("reg3d20_f32_linear.checked", SEED):
        "d2222c7333749467858eefeb7122a1300e4125e6e4c29e11db90a90b5b81459c",
    ("reg3d20_f32_linear.checked", 20261018):
        "5e2e14792f20138edb6aac672ee7adb8c1898d0fb0905348aa80d2e52ec5e77b",
    ("reg4d20_f64_cubic.stack8", SEED):
        "4464c5491b270f077594041caae6daaf890c800f71c116eb150f20df476142c9",
    ("reg4d20_f64_cubic.stack8", 20261018):
        "f1b79b1829522eccc53869efc77d7c8655fd630181aaaf213e441251b3ead174",
}


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _parent_reference_values(problem, cfg, r, dtype, operand):
    """Ring batch r's values by `reference/regular.py` with the grid passed
    as the harness of commit c0800b3 passed it."""
    from portbench.reference import regular

    starts64 = np.asarray(cfg["starts"], dtype=np.float64)
    stops64 = np.asarray(cfg["stops"], dtype=np.float64)
    steps64 = (stops64 - starts64) / (np.asarray(problem.dims, dtype=np.float64) - 1)
    np_dt = np.dtype(cfg["dtype"])
    starts, steps = (torch.tensor(x.astype(np_dt).astype(np.float64)).to(dtype)
                     for x in (starts64, steps64))
    return regular.evaluate(problem.method, problem.dims, starts, steps,
                            problem.tables.to(dtype), problem.ring[r].to(dtype),
                            problem.linearize, operand=operand)


@pytest.mark.parametrize("name,seed", list(PARENT_INPUTS))
def test_the_inputs_and_reference_values_do_not_move(bench, name, seed):
    cell = harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", name)
    problem = harness.make_problem(cell, seed, CPU)
    assert _sha([problem.tables, *problem.ring]) == PARENT_INPUTS[name, seed]
    ref = harness.cell_reference(cell)
    dtype, rounding = harness.CONTROLS[cell.config["dtype"]]
    for dt, rnd in ((torch.float64, None), (dtype, rounding)):  # the reference, the control
        got = harness.reference_values(ref, problem, 1, dt, rnd)
        want = _parent_reference_values(problem, cell.config, 1, dt,
                                        None if rnd is None else getattr(ref, rnd))
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_inputs_come_from_the_seed(bench):
    cell = harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", CELLS[0])
    a, b, c = (harness.make_problem(cell, s, CPU) for s in (SEED, SEED, SEED + 1))
    assert torch.equal(a.tables, b.tables) and torch.equal(a.ring[1], b.ring[1])
    assert not torch.equal(a.ring[0], c.ring[0])


def test_top_level_names_are_compared_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "interpn_tpu",
            "interpn_tpu.ops", "interpn_tpu_torch", "interpn_tpu_torch.ops", "jaxtyping",
            "flaxen", "numpy"]
    assert harness.top_level_hits(mods) == ["flax.linen", "interpn_tpu", "interpn_tpu.ops",
                                            "jax", "jax.numpy", "jaxlib.xla_client"]


def test_the_reference_imports_nothing_of_the_program():
    names = harness.reference_imports(ROOT / "portbench" / "reference")
    assert names and not harness.top_level_hits(names, (*harness.FORBIDDEN, harness.PORT))


@pytest.mark.parametrize("line", ["import interpn_tpu_torch.ops", "from jax import numpy",
                                  "from interpn_tpu.ops import cubic"])
def test_a_reference_that_imports_the_program_is_refused(tmp_path, line):
    (tmp_path / "bad.py").write_text(f"import torch\n{line}\n")
    with pytest.raises(RuntimeError, match="the reference imports"):
        harness.load_reference(tmp_path, "portbench.reference.regular")


@pytest.mark.parametrize("line", ["import interpn_tpu_torch.ops", "from jax import numpy",
                                  "from interpn_tpu.ops import cubic"])
def test_a_grid_kind_that_imports_the_program_is_refused(bench, line):
    (bench / "portbench" / "grids" / "bad.py").write_text(f"import numpy\n{line}\n")
    with pytest.raises(RuntimeError, match="the grid kind regular imports"):
        harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", CELLS[0])


def test_a_grid_kind_that_pulls_in_the_program_is_refused(bench):
    # a fresh process, since this one may hold the program already
    grid = bench / "portbench" / "grids" / "regular.py"
    grid.write_text(grid.read_text() + '\nimport importlib\nimportlib.import_module("%s")\n'
                    % harness.PORT)
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness; "
            "harness.load_cell(harness.Path(%r), harness.Path(%r), %r)"
            % (str(ROOT), str(bench / "BENCHMARK.json"), str(bench / "portbench"), CELLS[0]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert f"the grid kind regular pulled in {harness.PORT}" in proc.stderr


def test_the_program_comes_from_the_checkout(tmp_path):
    with pytest.raises(ImportError, match="not from the checkout"):
        harness.import_port(tmp_path)


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                           "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
