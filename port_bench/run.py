"""Run one benchmark cell once and print its result as the last line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
See port_bench/README.md.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from port_bench import core

    core.environment()
    sys.exit(core.main(sys.argv[1:], T_START))
