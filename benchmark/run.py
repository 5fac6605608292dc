"""The benchmark's command: one run of one cell (see benchmark/harness.py).

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.harness import entry
    sys.exit(entry(T_START))
