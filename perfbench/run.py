#!/usr/bin/env python3
"""Run one cell of the benchmark of mapdn_torch once, from the root of a
checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA devices as the cell asks for; exits 2 without them.
BENCHMARK.json names the cells; perfbench/harness.py describes the result
line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from perfbench import harness
    sys.exit(harness.main(parse_args(), T_START))
