#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 11 12 ... \\
        [--controls 3] [--faults unchanged half_batch solver] [--seconds S]

In one process, for each seed: the program's set-up, what the check
follows before the window, and a window of ``--seconds`` (at least one
episode or day; an evaluation cell's default is BENCHMARK.json's
``run_seconds``, so that as many days are compared as in a run), then the
check's numbers for the program; for the first ``--controls`` seeds also
for the control (the reference in float32 with TF32 matmuls, in the
program's place).  Then each fault planted in the program (a runner's
``fault``: perfbench/algs/ and perfbench/kinds/), on the first
``--controls`` seeds.  An evaluation cell's readings carry each day's
numbers too (``per_day``).

One JSON line a reading: {"seed", "side", "numbers"[, "per_day"]}.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import spec, traffic  # noqa: E402


def readings(cell, seed, device, fault_name=None, control=False, seconds=0.0):
    """[(side, numbers, per_day or None)] of one seed."""
    runner = traffic.make(cell, seed, device)
    runner.setup()
    planted = runner.fault(fault_name) if fault_name else contextlib.nullcontext()
    with planted:
        runner.first_steps(np.random.default_rng(seed))
        runner.window(seconds)
    runner.keep()
    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = lambda: np.random.default_rng([seed, 1])
    sides = [(fault_name or "program", False)] + ([("control", True)] if control else [])
    out = []
    for side, ctrl in sides:
        if runner.kind == "eval":
            per_day = runner.check(device, rng(), control=ctrl, per_day=True)
            out.append((side, {k: max(v) for k, v in per_day.items()}, per_day))
        else:
            out.append((side, runner.check(device, rng(), control=ctrl), None))
    return out


def main(argv=None, cell=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    cell = cell or spec.cell(args.workload)
    seconds = args.seconds
    if seconds is None:
        seconds = spec.benchmark()["run_seconds"] if cell["traffic"]["kind"] == "eval" else 0.0
    device = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []

    def emit(seed, side, nums, per_day):
        lines.append({"seed": seed, "side": side, "numbers": nums})
        if per_day is not None:
            lines[-1]["per_day"] = per_day
        print(json.dumps(lines[-1]), flush=True)

    for i, seed in enumerate(args.seeds):
        for reading in readings(cell, seed, device, control=i < args.controls, seconds=seconds):
            emit(seed, *reading)
    for name in args.faults:
        for seed in args.seeds[:args.controls]:
            for reading in readings(cell, seed, device, fault_name=name, seconds=seconds):
                emit(seed, *reading)
    return lines


if __name__ == "__main__":
    main()
