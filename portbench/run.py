"""Run one cell of the port's benchmark once, as ``BENCHMARK.json``'s
command: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout, on a machine
with the cards the cell asks for.  See ``portbench/harness/bench.py``."""
import time

T_START = time.time()   # set-up is timed from here, before any import

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from portbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T_START))
