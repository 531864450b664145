"""One run of one cell: set-up, the measured window (or, with ``--trace 1``,
the traced stretches), the check against the reference, the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers and limits are the last lines of standard error.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from perfbench import check, imports, spec, traffic

PEAKS = os.path.join(spec.HERE, "peaks.json")


class NoDevice(SystemExit):
    pass


def device_for(cell, device):
    """The run's device: the GPU, with as many cards as the cell asks for;
    ``device`` given (the CPU tests) skips the look for a chip."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        raise NoDevice(f"perfbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
                       f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda", 0)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def run(workload, seed, seconds, trace, t_start=None, device=None, cell=None):
    """Run one cell once; returns the result dict (``checks`` last) and the
    check rows.  ``cell`` in place of BENCHMARK.json's (the CPU tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(workload) if cell is None else cell
    device = device_for(cell, device)
    bad_refs = imports.reference_imports()
    if bad_refs:
        raise SystemExit(f"perfbench: the reference imports what it may not: {bad_refs}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(PEAKS) as fh:
        peaks = json.load(fh)

    runner = traffic.make(cell, seed, device)
    runner.setup()
    copy_s = runner.first_steps(np.random.default_rng(seed))
    runner.sync()
    setup_s = time.perf_counter() - t_start - copy_s

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if trace:
        layer = runner.trace(seconds, peaks)
        for m in cell["per_layer"]:
            value = spec.reader(m["name"], cell.get("root", spec.ROOT))(layer)
            if value is not None:
                result["metrics"][m["name"]] = _metric(value, m["unit"])
        prof = layer["profile"]
        result["attempted"] = layer.get("attempted", 1)
    else:
        out = runner.window(seconds)
        for name, value in out["metrics"].items():
            if name in units:
                result["metrics"][name] = _metric(value, units[name])
        result["metrics"]["setup_s"] = _metric(setup_s, units["setup_s"])
        result["attempted"], result["failed"] = out["attempted"], out["failed"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if trace:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    result["device"] = dev
    if trace:
        result["breakdown"] = prof["breakdown"]

    # what the check reads of the window goes to the host, and the
    # program's state is freed, before the reference runs
    runner.keep()
    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check_rng = np.random.default_rng([seed, 1])
    t_check = time.perf_counter()
    numbers = runner.check(device, check_rng)
    print(f"perfbench: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct, rows = check.judge(numbers, cell["check"]["limits"])
    result["correct"] = bool(correct and result["failed"] == 0)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def main(args, t_start):
    try:
        result, rows = run(args.workload, args.seed, args.seconds, args.trace, t_start)
    except NoDevice as exc:
        print(exc, file=sys.stderr)
        return 2
    found = imports.loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded forbidden modules: {found}", file=sys.stderr)
        return 1
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0
