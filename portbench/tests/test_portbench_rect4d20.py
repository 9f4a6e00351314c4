"""The rectilinear 4D cubic float64 cell, `rect4d20_f64_cubic.bulk`, as
BENCHMARK.json names it: the cell from the real files, what every cell
reports beside it (the existing cells as before it came), its run on the CPU
at a size a test holds, and the reader of K2's roofline share."""

import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELL = "rect4d20_f64_cubic.bulk"
SEED = 2**31 + 1013
CPU = torch.device("cpu")

# what each cell reported before the new cell came (commit 01e6240):
# (end-to-end metrics, per-layer metrics)
HOST = {"dispatch.host_ms", "entry.predispatch_ms", "entry.syncs_per_step",
        "wrappers.launches_per_step", "wrappers.route_ms"}
BEFORE = {
    "reg3d20_f32_linear.bulk": ({"setup_s", "step_ms_p95", "values_per_s"},
                                HOST | {"device.idle_pct", "entry.host_ms", "k1_roofline"}),
    "reg4d20_f64_cubic.bulk": ({"setup_s", "step_ms_p95", "values_per_s"},
                               HOST | {"device.idle_pct", "entry.host_ms", "k1_roofline"}),
    "reg3d20_f32_linear.checked": ({"setup_s", "step_ms_p95", "values_per_s"},
                                   HOST | {"entry.flag_device_ms", "entry.host_ms"}),
    "reg4d20_f64_cubic.stack8": ({"setup_s", "values_per_s"},
                                 HOST | {"device.idle_pct", "k5_roofline",
                                         "stack.step_ms_p95"}),
}
# every metric the benchmark had then; metrics added later are left out of
# the comparison, so an addition made as files and entries alone keeps it
KNOWN = (set().union(*(ends for ends, _ in BEFORE.values())),
         set().union(*(layers for _, layers in BEFORE.values())))
NEW = ({"setup_s", "step_ms_p95", "values_per_s"},
       HOST | {"device.idle_pct", "entry.host_ms", "k2_roofline"})
# the metrics this cell's entries appended it to
APPENDED = ("step_ms_p95", "entry.host_ms", "wrappers.launches_per_step", "device.idle_pct",
            "entry.predispatch_ms", "dispatch.host_ms", "wrappers.route_ms",
            "entry.syncs_per_step")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reported(spec, name, known):
    """The end-to-end and per-layer metrics that `name` reports, of those in
    `known`."""
    return tuple({m["name"] for m in spec[kind] if harness._reports(m, name)} & names
                 for kind, names in zip(("end_to_end", "per_layer"), known))


def test_the_cell_is_as_named():
    cell = harness.load_cell(ROOT / "BENCHMARK.json", ROOT / "portbench", CELL)
    cfg = cell.config
    assert cell.chips == 1
    assert (cfg["grid"], cfg["axes"], cfg["method"], cfg["dtype"]) == (
        "rectilinear", {"kind": "jittered", "jitter": 0.4}, "cubic", "float64")
    assert cfg["linearize_extrapolation"] is True and cfg["reduced"] == []
    assert (cfg["dims"], cfg["starts"], cfg["stops"]) == ([20] * 4, [0.0] * 4, [10.0] * 4)
    assert cfg["table"] == {"kind": "uniform", "low": 0.0, "high": 1.0}
    assert set(cfg["assumed"]) >= {"axes", "values", "entry", "queries"}
    mix = cell.mix
    assert (mix["entry"], mix["queries_per_step"], mix["tables"], mix["ring"],
            mix["sample_steps"]) == ("eval_torch", 10_000_000, 1, 2, 3)
    assert mix["queries"] == {"kind": "uniform", "margin": 0.05}
    assert cell.limits == {"max_err": 1e-9}
    assert Path(cell.grid.__file__).stem == "rectilinear"
    assert Path(harness.cell_reference(cell).__file__).stem == "rectilinear"
    spec = _spec()
    config = next(c for c in spec["configs"] if c["name"] == "rect4d20_f64_cubic")
    assert config["file"] == "portbench/configs/rect4d20_f64_cubic.json"
    assert config["reduced"] == [] and config["source"] == cfg["source"]


def test_the_new_entries_are_as_named():
    spec = _spec()
    work = dict(next(w for w in spec["workloads"] if w["name"] == CELL))
    assert len(work.pop("why")) <= 200
    assert work == {"name": CELL, "config": "rect4d20_f64_cubic", "traffic": "bulk", "chips": 1}
    k2 = next(m for m in spec["per_layer"] if m["name"] == "k2_roofline")
    assert k2 == {"name": "k2_roofline", "unit": "%", "better": "higher",
                  "source": "device_trace", "layer": "kernels", "moves": "values_per_s",
                  "workloads": [CELL]}
    for name in APPENDED:
        m = next(m for m in spec["end_to_end"] + spec["per_layer"] if m["name"] == name)
        assert CELL in m["workloads"], name


@pytest.mark.parametrize("name", list(BEFORE))
def test_each_existing_cell_reports_what_it_reported_before(name):
    assert _reported(_spec(), name, KNOWN) == BEFORE[name]


def test_the_new_cell_reports_its_metrics():
    known = (KNOWN[0], KNOWN[1] | {"k2_roofline"})
    assert _reported(_spec(), CELL, known) == NEW


def _run(tmp_path, trace):
    """The cell at 3000 queries a step, from a copy of the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    own = tmp_path / "portbench" / "cells" / f"{CELL}.json"
    cell_file = json.loads(own.read_text())
    cell_file["mix"]["queries_per_step"] = 3000
    own.write_text(json.dumps(cell_file))
    cell = harness.load_cell(tmp_path / "BENCHMARK.json", tmp_path / "portbench", CELL)
    port = harness.import_port(ROOT)
    return cell, harness.run_cell(cell, port, harness.cell_reference(cell), SEED, 0.2, trace,
                                  CPU, time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu_with_its_metrics(tmp_path, trace):
    cell, (result, _) = _run(tmp_path, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["max_err"]["value"] <= 1e-12
    metrics = cell.per_layer if trace else cell.end_to_end
    wanted = {m["name"] for m in metrics}
    got = set(result["metrics"])
    # a CPU run has no head-start device time: only readers of the device
    # trace may give nothing, and K2's share does
    assert got <= wanted
    assert wanted - got <= {m["name"] for m in metrics if m["source"] == "device_trace"}
    assert "k2_roofline" not in got
    if trace:
        # the CPU runs the plain versions: no kernel launch, no sync in the call
        assert result["metrics"]["entry.syncs_per_step"]["value"] == 0


# --- the reader of K2's share ------------------------------------------------------


def _reader():
    return harness.load_module(ROOT / "portbench" / "metrics" / "k2_roofline.py",
                               "metric_k2_roofline")


def _stub(launches, seconds=6.8e-3):
    problem = SimpleNamespace(dims=(20, 20, 20, 20), method="cubic", dtype="float64",
                              ntables=1, queries=10_000_000)
    return SimpleNamespace(problem=problem, launches=launches,
                           device_step=None if seconds is None else
                           SimpleNamespace(seconds=seconds))


@pytest.mark.parametrize("launches", [
    {}, {"regular_cubic": 5, "regular_cubic_pack": 5}, {"rectilinear_cubic": 0},
    {"rectilinear_nearest": 3}, {"rectilinear_cubic_stack": 4}])
def test_k2_roofline_reads_nothing_without_a_k2_launch(launches):
    assert _reader().read(_stub(launches)) is None


def test_k2_roofline_reads_nothing_without_a_device_time():
    assert _reader().read(_stub({"rectilinear_cubic": 5}, seconds=None)) is None


@pytest.mark.parametrize("kernel", ["rectilinear_cubic", "rectilinear_linear"])
def test_k2_roofline_gives_the_hand_computed_share(kernel):
    # bytes: 1e7 queries x (4 coordinates + 1 result), the 20^4 table and a
    # start and step an axis, 8 bytes each, at 3.35 TB/s; the operations'
    # bound is lower: 1e7 x (4 x 18 + 2 x 340) at 67 TFLOP/s
    least_bytes = 8 * (10_000_000 * 5 + 20**4 + 8) / 3.35e12
    assert least_bytes > 10_000_000 * (4 * 18 + 2 * 340) / 67e12
    got = _reader().read(_stub({kernel: 7, "rectilinear_cubic_pack": 7}))
    assert got == pytest.approx(100 * least_bytes / 6.8e-3, rel=1e-12)
