#!/usr/bin/env python3
"""Benchmark of hybrid_rendering_torch: runs one cell of BENCHMARK.json
once and prints its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import os
import sys
import time

T0 = time.perf_counter()  # set-up is timed from here

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "reference"), os.path.dirname(HERE)]

from hrbench import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T0))
