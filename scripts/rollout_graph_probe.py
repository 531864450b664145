"""Probes of the trainer's rollout and update CUDA graphs
(mapdn_torch/learn/rollout_graph.py, update_graph.py) on a benchmark
cell's trainer, one JSON line a cell, each starting "probe ".

    python scripts/rollout_graph_probe.py window <cell>:<seed>:<seconds> ...
    python scripts/rollout_graph_probe.py parts <cell>:<seed> ...
    python scripts/rollout_graph_probe.py profile <cell>:<seed>:<episodes> ...

Each imports the tree of the working directory, so that one copy of this
script reads a parent commit's checkout too (``window`` alone there: a
parent without the graphs gives null graph readings).

* ``window``: one run of the cell through perfbench's harness
  (``--trace 0``): its result, the trainer's rollout tallies, the update
  tallies over the window (``update_counts``, null before the update
  graphs), the memory
  allocated before the graphs' buffers, before each warm-up and after each
  capture, and over the window the peak allocated (the benchmark's
  ``train_peak_mem_gib``), the peak reserved, the reserved at its end and
  the bytes of the rollout graphs' and the update graphs' private pools
  (the segments of the caching allocator that carry each one's id).
* ``parts``: where a graphed step's time goes after one chunk: the step
  graph's replays back to back (host us and device ms a replay, CUDA
  events), replay plus the flag's read, the engagement test, a whole chunk
  through ``RolloutGraph.step``, and the update phase on that chunk's ring
  as the trainer runs it and eagerly (a pass-through wrapper on
  ``_update_step``): host ms, and stream ms between two events; and each
  update graph's replays back to back (device ms a replay).
* ``profile``: ``episodes`` chunks under ``torch.profiler``, graphed and
  then eager (a pass-through wrapper on ``get_actions`` keeps every step
  eager), with none of the benchmark's wrappers: busy share, device ms a
  step, kernel and graph launches a step, wall ms a chunk.

Run on the card, e.g. ``python scripts/rollout_graph_probe.py window
case33_mappo.train512:1234567891:10``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from mapdn_torch.learn.trainer import PGTrainer  # noqa: E402
from perfbench import harness, spec, tracing, traffic  # noqa: E402

try:
    from mapdn_torch.learn import rollout_graph
except ImportError:   # a tree from before the graphs
    rollout_graph = None

MIB = 2 ** 20


def _emit(out):
    print("probe " + json.dumps(out), flush=True)


def _allocated_mib():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / MIB


def _pool_mib(pool):
    """MiB of the caching allocator's segments in the private pool ``pool``."""
    if pool is None:
        return None
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(pool)) / MIB


def window(args):
    seen, marks = [], []
    run_episode = PGTrainer.run_episode

    def seen_episode(self):
        if not seen or seen[-1] is not self:
            seen.append(self)
        return run_episode(self)
    PGTrainer.run_episode = seen_episode

    if rollout_graph is not None:
        cls = rollout_graph.RolloutGraph
        init, run = cls.__init__, cls._run

        def marked_init(self, trainer, carry):
            marks.append(("before graph buffers", _allocated_mib()))
            init(self, trainer, carry)

        def marked_run(self, kind, region):
            new = kind not in self.graphs
            if new:
                marks.append((f"before {kind} warm-up", _allocated_mib()))
            run(self, kind, region)
            if new:
                marks.append((f"after {kind} capture", _allocated_mib()))
        cls.__init__, cls._run = marked_init, marked_run

    peaks, updates = {}, {}
    make = traffic.make

    def make_with_peaks(cell, seed, device):
        runner = make(cell, seed, device)
        timed = runner.window   # the trainer is made later, in setup()

        def window_with_peaks(seconds):
            tr = runner.trainer
            counts = getattr(tr, "update_counts", None)
            before = counts and counts()
            out = timed(seconds)
            graph, ugraph = tr._graph, getattr(tr, "_update_graph", None)
            peaks.update(
                peak_allocated_mib=torch.cuda.max_memory_allocated() / MIB,
                peak_reserved_mib=torch.cuda.max_memory_reserved() / MIB,
                reserved_mib=torch.cuda.memory_reserved() / MIB,
                graph_pool_mib=_pool_mib(None if graph is None else graph.pool),
                update_pool_mib=_pool_mib(None if ugraph is None else ugraph.pool))
            if counts:
                after = counts()
                updates.update({k: {w: after[k][w] - before[k][w] for w in after[k]}
                                for k in after})
            return out
        runner.window = window_with_peaks
        return runner
    traffic.make = make_with_peaks

    for arg in args:
        cell, seed, seconds = arg.split(":")
        seen.clear()
        marks.clear()
        peaks.clear()
        updates.clear()
        result, _ = harness.run(cell, int(seed), float(seconds), 0, time.perf_counter())
        counts = getattr(seen[-1], "rollout_counts", None) if seen else None
        _emit({"cell": cell, "seed": int(seed), "correct": result["correct"],
               "metrics": result["metrics"], "counts": counts and counts(),
               "window_update_counts": dict(updates) or None,
               "allocated_mib": marks, "window_memory": dict(peaks)})
        seen.clear()
        torch.cuda.empty_cache()


def _runner(name, seed):
    runner = traffic.make(spec.cell(name), int(seed), torch.device("cuda"))
    runner.setup()
    return runner


def parts(args):
    for arg in args:
        name, seed = arg.split(":")
        runner = _runner(name, seed)
        tr = runner.trainer
        tr.run_episode()
        g = tr._graph
        step, carry, n = g.graphs["step"], tr.carry, tr._chunk_len
        out = {"cell": name}
        # each loop below replays the step graph at most a chunk's steps from
        # a zeroed step index, inside the chunk's rows and stats columns
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        g.t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        for _ in range(n):
            step.replay()
        e1.record()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["replay_host_us"] = 1e6 * t_host / n
        out["replay_device_ms"] = e0.elapsed_time(e1) / n
        g.t.zero_()
        t0 = time.perf_counter()
        for _ in range(n):
            step.replay()
            bool(g.flag)
        out["replay_and_read_ms"] = 1e3 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in range(n):
            tr._step_eager_reason(carry)
        out["engagement_test_us"] = 1e6 * (time.perf_counter() - t0) / n
        c = tr.carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.begin_chunk(c)
        for _ in range(n):
            c = g.step(c)
        c, _ = g.end_chunk(c)
        torch.cuda.synchronize()
        out["graphed_step_ms"] = 1e3 * (time.perf_counter() - t0) / n
        for side in ("update", "update_eager"):
            if side == "update_eager":
                tr._update_step = (lambda fn: (lambda *a: fn(*a)))(tr._update_step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            tr._update_phase(c.algo, c.replay, c.generator)
            e1.record()
            torch.cuda.synchronize()
            out[side + "_ms"] = 1e3 * (time.perf_counter() - t0)
            out[side + "_stream_ms"] = e0.elapsed_time(e1)
        del tr._update_step
        out["update_counts"] = tr.update_counts()
        # each update graph's replays back to back (as many as its epochs,
        # from a zeroed epoch index): the device ms of one update step
        ug = getattr(tr, "_update_graph", None)
        for (which, _), graph in (ug.graphs.items() if ug is not None else ()):
            n = getattr(tr.cfg, which + "_update_epochs")
            ug.epoch.zero_()
            e0.record()
            for _ in range(n):
                graph.replay()
            e1.record()
            torch.cuda.synchronize()
            out[f"{which}_replay_device_ms"] = e0.elapsed_time(e1) / n
        _emit(out)
        del runner, tr, g, step, carry, c
        torch.cuda.empty_cache()


def _graph_launches(prof):
    return sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.name() in ("cudaGraphLaunch", "cudaGraphLaunch_v10000"))


def _profile(tr, episodes):
    c0 = tr.rollout_counts()
    with tracing.profiled(torch.cuda.synchronize) as held:
        t0 = time.perf_counter()
        for _ in range(episodes):
            tr.run_episode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c1 = tr.rollout_counts()
    s = tracing.summarize(held.prof, kernels=("nr_small", "nr_large"))
    chunks = episodes * tr._chunks_per_episode
    steps = chunks * tr._chunk_len
    return {"busy_share": s["busy_s"] / s["window_s"], "busy_s": s["busy_s"],
            "window_s": s["window_s"], "device_ms_per_step": 1e3 * s["busy_s"] / steps,
            "kernel_launches_per_step": s["launches"] / steps,
            "graph_launches_per_step": _graph_launches(held.prof) / steps,
            "wall_ms_per_chunk": 1e3 * wall / chunks,
            "replays": {k: c1["replays"][k] - c0["replays"][k] for k in c1["replays"]},
            "eager": {k: c1["eager"][k] - c0["eager"][k] for k in c1["eager"]
                      if c1["eager"][k] != c0["eager"][k]},
            "top_ops": s["breakdown"]["device_ops"][:5]}


def profile(args):
    for arg in args:
        name, seed, episodes = arg.split(":")
        runner = _runner(name, seed)
        tr = runner.trainer
        tr.run_episode()
        tr.run_episode()
        torch.cuda.synchronize()
        out = {"cell": name, "graphed": _profile(tr, int(episodes))}
        tr.model.get_actions = (lambda fn: (lambda *a, **k: fn(*a, **k)))(tr.model.get_actions)
        out["eager"] = _profile(tr, int(episodes))
        _emit(out)
        del runner, tr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    {"window": window, "parts": parts, "profile": profile}[sys.argv[1]](sys.argv[2:])
