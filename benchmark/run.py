"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in BENCHMARK.json at the root of the checkout;
its configuration (`benchmark/configs/<config>.json`), traffic mix
(`benchmark/traffic/<traffic>.json`), driver (`benchmark/drivers/<driver>.py`,
named by the traffic file) and per-layer metric readers
(`benchmark/metrics/<metric>.py`) are found by name. Nothing here is
specific to one cell.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import common  # noqa: E402

if __name__ == "__main__":
    common.prepare_environment(ROOT)
    sys.exit(common.main(ROOT, sys.argv[1:], T_START))
