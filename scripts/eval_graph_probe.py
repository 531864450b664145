"""Probes of the tester's eval graphs (mapdn_torch/learn/eval_graph.py) on a
benchmark eval cell, one JSON line a cell, each starting "probe ".

    python scripts/eval_graph_probe.py window <cell>:<seed>:<seconds> ...
    python scripts/eval_graph_probe.py parts <cell>:<seed> ...

Each imports the tree of the working directory, so that one copy of this
script reads a parent commit's checkout too (``window`` alone there: a
parent without the graphs gives null graph readings).

* ``window``: one run of the cell through perfbench's harness
  (``--trace 0``): its result, the tester's ``step_counts()`` after the
  set-up (its warm-up day) and over the window, and the graphs' pool.
* ``parts``: where a graphed step's time goes, after the set-up: each
  half's graph replayed back to back (host us and device ms a replay, CUDA
  events), the engagement test, handing out the step's outputs (a clone
  and its views), and whole days as ``PGTester.run`` steps them, graphed
  and eager (a pass-through wrapper on ``get_actions`` keeps every step
  uncaptured): ms a step.

Run on the card, e.g. ``python scripts/eval_graph_probe.py window
case33_mappo.eval1:1234567891:10``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from perfbench import harness, spec, traffic  # noqa: E402

MIB = 2 ** 20


def _emit(out):
    print("probe " + json.dumps(out), flush=True)


def _counts(tester):
    counts = getattr(tester, "step_counts", None)
    return counts and counts()


def _pool_mib(tester):
    graphs = getattr(tester, "_graphs", None)
    if not graphs:
        return None
    pools = {tuple(g.pool) for g in graphs.values() if g.pool is not None}
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) in pools) / MIB


def window(args):
    seen = {}
    make = traffic.make

    def make_seen(cell, seed, device):
        runner = make(cell, seed, device)
        timed = runner.window

        def window_seen(seconds):
            seen["setup"] = _counts(runner.tester)
            out = timed(seconds)
            seen["window"] = _counts(runner.tester)
            seen["pool_mib"] = _pool_mib(runner.tester)
            return out
        runner.window = window_seen
        return runner
    traffic.make = make_seen

    for arg in args:
        cell, seed, seconds = arg.split(":")
        seen.clear()
        result, _ = harness.run(cell, int(seed), float(seconds), 0, time.perf_counter())
        after, before = seen.get("window"), seen.get("setup")
        delta = after and {k: {w: after[k][w] - before[k][w] for w in after[k]} for k in after}
        _emit({"cell": cell, "seed": int(seed), "correct": result["correct"],
               "metrics": result["metrics"], "setup_counts": before,
               "window_counts": delta, "graph_pool_mib": seen.get("pool_mib")})
        torch.cuda.empty_cache()


def _timed(fn, n):
    """(host us, device ms) a call of ``fn``, ``n`` calls back to back."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / n, e0.elapsed_time(e1) / n


def parts(args):
    for arg in args:
        name, seed = arg.split(":")
        runner = traffic.make(spec.cell(name), int(seed), torch.device("cuda"))
        runner.setup()
        tester = runner.tester
        graph = tester._graphs[1]
        out = {"cell": name}
        for kind in ("act", "step"):
            out[kind + "_replay_host_us"], out[kind + "_replay_device_ms"] = _timed(
                graph.graphs[kind].replay, 200)
        t0 = time.perf_counter()
        for _ in range(200):
            tester._eager_reason()
        out["engagement_test_us"] = 1e6 * (time.perf_counter() - t0) / 200
        out["issue_host_us"], _ = _timed(graph.flat.issue, 200)
        for side in ("graphed", "eager"):
            if side == "eager":
                tester.model.get_actions = (lambda fn: (lambda *a, **kw: fn(*a, **kw)))(
                    tester.model.get_actions)
            steps, t0 = 0, time.perf_counter()
            for _ in range(3):
                day = runner._draw_day()
                steps += len(runner._run_day(day)["bus_voltage"]) - 1
            torch.cuda.synchronize()
            out[side + "_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / steps
        out["counts"] = tester.step_counts()
        _emit(out)
        runner.release()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    {"window": window, "parts": parts}[sys.argv[1]](sys.argv[2:])
