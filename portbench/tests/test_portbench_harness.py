"""The harness on the CPU at a size a test run holds: every cell of
BENCHMARK.json end to end, a cell and a metric added as files alone, the
result line's keys, the checks on imported modules, the faults that the check
must catch, and the control that it must fail."""

import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
    return harness.run_cell(cell, port, harness.load_reference(), seed, seconds, trace, CPU,
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


def test_a_cell_and_a_metric_are_added_as_files_alone(bench):
    before = _digest(bench / "portbench")
    folder = bench / "portbench"
    (folder / "configs" / "tiny3d_f64_linear.json").write_text(json.dumps({
        "source": "a test", "grid": "regular", "method": "linear", "dims": [4, 5, 6],
        "starts": [0.0, -1.0, 2.0], "stops": [3.0, 1.0, 5.0], "dtype": "float64",
        "table": {"kind": "uniform", "low": -2.0, "high": 2.0}, "reduced": []}))
    (folder / "mixes" / "tiny.json").write_text(json.dumps({
        "entry": "eval_torch", "queries_per_step": 500, "tables": 1,
        "queries": {"kind": "uniform", "margin": 0.2}, "ring": 3, "loop": "closed",
        "sample_steps": 2}))
    (folder / "cells" / "tiny3d_f64_linear.tiny.json").write_text(
        json.dumps({"limits": {"max_err": 1e-12}}))
    (folder / "metrics" / "test.steps.py").write_text(
        "def read(run):\n    return run.window.steps\n")
    spec = json.loads((bench / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny3d_f64_linear.tiny", "config": "tiny3d_f64_linear",
                              "traffic": "tiny", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "test.steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "entry",
                              "moves": "values_per_s", "workloads": ["tiny3d_f64_linear.tiny"]})
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(folder)
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed
    result, _ = _run(bench, "tiny3d_f64_linear.tiny", True)
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


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["alter", "half", "stale"])
def test_a_broken_timed_path_is_not_correct(bench, name, fault):
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


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(bench, name):
    cell = harness.load_cell(bench / "BENCHMARK.json", bench / "portbench", name)
    ref = harness.load_reference()
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
