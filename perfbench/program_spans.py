"""The program's own spans and counters (``mapdn_torch.utils.profiling``)
over one more stretch of a ``--trace 1`` run: one ``run_episode``
(training) or one drawn day (evaluation) inside
``profiling.tracing(Tracer(device))``, with no profiler running and none of
the benchmark's spans, labels or solve logs installed.  Only the wrappers
the check needs stay: the window's chunk snapshot (training), the step
times and rewards of ``_play`` (evaluation).

The stretch runs once a run, when the first reader of its numbers asks
for them (``of(rec)``), so after every stretch of ``Runner.trace`` and after
the readers listed before its own in BENCHMARK.json have read the record:
it moves none of their readings.  Its readers find the runner the record
came from in the frame of the harness that called them, which holds both
(``layer`` and ``runner`` of ``harness.run``).  A program without the
tracer, or a record read outside a run, gives None.

To tell the tracer's cost, the summary also gives the stretch's rate beside
an uninstrumented one of the same run: ``Runner.trace``'s first stretch
(training), or one more day played just before the traced one
(evaluation).
"""
from __future__ import annotations

import json
import sys
import time


def of(rec):
    """The traced stretch's summary for the record ``rec`` (run at the
    first call and kept in ``rec["program"]``), or None."""
    if "program" not in rec:
        rec["program"] = _run(rec, _runner_of(rec))
    return rec["program"]


def span(rec, name):
    """{"calls", "host_s", "host_self_s", "stream_s", "stream_self_s"} of
    span ``name`` in the traced stretch (calls 0 where it never opened), or
    None without a summary."""
    out = of(rec)
    if out is None:
        return None
    return out["spans"].get(name, {"calls": 0, "host_s": 0.0, "host_self_s": 0.0,
                                   "stream_s": None, "stream_self_s": None})


def counter(rec, name):
    out = of(rec)
    return None if out is None else out["counters"].get(name)


def _runner_of(rec):
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("layer") is rec and "runner" in local:
            return local["runner"]
        frame = frame.f_back
    return None


def _day(runner):
    """(steps, seconds) of one more drawn day of an evaluation runner."""
    runner.sync()
    t0 = time.perf_counter()
    times, _ = runner._play()
    runner.sync()
    return len(times), time.perf_counter() - t0


def _run(rec, runner):
    try:
        from mapdn_torch.utils import profiling
    except ImportError:
        return None
    if runner is None or not hasattr(profiling, "Tracer"):
        return None
    tracer = profiling.Tracer(runner.device)
    if rec.get("kind") == "train":
        tr = runner.trainer
        s = rec["stretch"]
        untraced = tr.n_envs * tr._chunk_len * s["chunks"] / s["seconds"]
        with profiling.tracing(tracer):
            n, _, seconds = runner._episodes(0)
        steps = tr.n_envs * runner.steps_per_episode * n
    elif rec.get("kind") == "eval":
        steps, seconds = _day(runner)
        untraced = steps / seconds
        with profiling.tracing(tracer):
            steps, seconds = _day(runner)
    else:
        return None
    out = tracer.summary()
    out.update(seconds=seconds, env_steps=steps, rate=steps / seconds, untraced_rate=untraced)
    print(f"perfbench: the program's spans: {steps} env steps in {seconds:.4f} s traced, "
          f"{out['rate']:.1f} a second against {untraced:.1f} uninstrumented",
          file=sys.stderr)
    print("perfbench: the program's spans: " + json.dumps(out), file=sys.stderr)
    return out
