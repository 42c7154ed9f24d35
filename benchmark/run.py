"""Run one cell of the benchmark on the card(s) of this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON line; the readings behind it go to standard error.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
