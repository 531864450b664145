"""The benchmark's own spans and counters around calls into the program's
layers, and the reduction of a ``torch.profiler`` trace.

Three kinds of instrument, each installed on an object's attribute for a
stretch of a traced run and removed after it:

* :class:`SyncSpans`: host-clock spans closed by ``synchronize`` on both
  sides, so each holds the device work of its call (the split of the
  program's own profiler script, copied here);
* :class:`SolveLog`: keeps each power-flow solve's per-lane iteration
  counts (references only, no synchronize);
* :class:`Labels`: ``record_function`` ranges that name what the host was
  doing while the profiler runs.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

WINDOW_LABEL = "perfbench.window"
# the host ranges :func:`label` opens (the names the traffic generators use)
LABELS = {WINDOW_LABEL, "update", "value_fill", "rollout.env_step", "rollout.pf_solve",
          "rollout.policy", "eval.policy", "eval.env_step", "eval.pf_solve"}


@contextlib.contextmanager
def installed(wrappers):
    """Set ``obj.attr = make(original)`` for each (obj, attr, make), and put
    the originals back on exit."""
    saved = []
    try:
        for obj, attr, make in wrappers:
            original = getattr(obj, attr)
            saved.append((obj, attr, original, attr in vars(obj)))
            setattr(obj, attr, make(original))
        yield
    finally:
        for obj, attr, original, own in reversed(saved):
            if own:
                setattr(obj, attr, original)
            else:
                delattr(obj, attr)


class SyncSpans:
    """Seconds and calls of each named span."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)

    def wrap(self, name):
        def make(fn):
            def run(*args, **kwargs):
                self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
                return out
            return run
        return make


class SolveLog:
    """Each solve's lane count and per-lane iteration counts."""

    def __init__(self):
        self.n_iter = []

    def wrap(self, fn):
        def run(*args, **kwargs):
            res = fn(*args, **kwargs)
            self.n_iter.append(res.n_iter)
            return res
        return run

    def counts(self):
        """[per-lane iteration counts of each solve] on the host."""
        return [x.cpu().numpy() for x in self.n_iter]


def label(name):
    if name not in LABELS:
        raise ValueError(f"unknown label {name!r}")

    def make(fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    return make


def _on_device(ev):
    return "cuda" in str(ev.device_type()).lower()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, kernels=()):
    """Reduce a profile whose stretch ran inside ``record_function(WINDOW_LABEL)``:
    the window's seconds, the seconds some device activity (kernel, memcpy,
    memset) ran, the kernel launches, each kernel name's seconds and count
    (for names containing one of ``kernels``), the ten device operations
    that took most time, and the ten host labels under which the device sat
    idle longest (a gap is charged to the innermost label open at its
    middle; ``host`` where none is)."""
    window, labels, dev = None, [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if name in LABELS:
            # a host range of ours (its mirror on the device timeline is no work)
            if not _on_device(ev):
                if name == WINDOW_LABEL:
                    window = (start, end)
                else:
                    labels.append((start, end, name))
        elif _on_device(ev):
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            dev.append((start, end, name, kind))
    if window is None:
        raise RuntimeError("the profile holds no window label")
    w0, w1 = window
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _, _ in dev])
    by_name = collections.defaultdict(float)
    matched = {k: [0.0, 0] for k in kernels}
    launches = 0
    for s, e, name, kind in dev:
        by_name[name] += (e - s) * 1e-9
        if kind == "kernel":
            launches += 1
            for k in kernels:
                if k in name:
                    matched[k][0] += (e - s) * 1e-9
                    matched[k][1] += 1
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    labels.sort()
    starts = [lb[0] for lb in labels]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host"
        # labels nest a few deep: the innermost one open at ``mid`` is among
        # the last few that started before it
        i = bisect.bisect_right(starts, mid)
        for lb in reversed(labels[max(0, i - 64):i]):
            if lb[1] > mid:
                name = lb[2]
                break
        gaps[name] += (b - a) * 1e-9
    top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "launches": launches,
            "kernels": {k: {"seconds": v[0], "count": v[1]} for k, v in matched.items()},
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}


@contextlib.contextmanager
def profiled(sync):
    """A CPU and CUDA profile of the body, inside the window label; yields
    a holder whose ``prof`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    holder = type("Profiled", (), {})()
    with profile(activities=acts) as prof:
        sync()
        with torch.profiler.record_function(WINDOW_LABEL):
            yield holder
            sync()
    holder.prof = prof
