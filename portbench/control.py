"""Readings that the limits of `correct` are set from; not run by a
benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed, in one process, at the cell's own sizes: the program's
reading (the cell's call on every batch of the ring, the number that a run
compares) and the control's (the reference computed in the nearest precision
below the configuration's, `harness.CONTROLS`, in the program's place). One
JSON line a seed, then one with the largest program reading and the
smallest control reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def readings(cell, ref, seed: int, device) -> dict:
    """The program's and the control's reading for one seed."""
    problem = harness.make_problem(cell, seed, device)
    call = cell.entry.build(problem)
    answers = []
    for r in range(len(problem.ring)):
        out = problem.out() if cell.entry.OUT else None
        answers.append((r, call(problem.obs(r), out)))
    call = None
    program, compared = harness.gap_reading(ref, problem, answers)
    answers = None
    return {"seed": seed, "program": program, "values": compared,
            "control": harness.control_reading(ref, problem)}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args(argv)
    cell = harness.load_cell(harness.ROOT / "BENCHMARK.json", harness.BENCH_DIR, args.workload)
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    ref = harness.cell_reference(cell)
    harness.import_port(harness.ROOT)
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(cell, ref, seed, device))
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, **rows[-1]}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": max(r["program"] for r in rows),
                      "control_min": min(r["control"] for r in rows),
                      "limit": cell.limits["max_err"],
                      "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
