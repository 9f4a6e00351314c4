"""One run of one cell of the port's benchmark; see README.md.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The set-up time counts from here: the interpreter's own start is not in it.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
