"""Profiling hooks: the program's spans and counters, ``torch.profiler``
device traces and phase timers (port of mapdn_tpu/utils/profiling.py).

The trainer, the losses, the env, the lane helpers, the replay and the
tester mark each layer boundary with ``span(name)`` (the names are
``SPANS``) and count at the same boundaries with ``count(name, value)``
(``COUNTERS``).  Both do nothing beyond one check unless a :class:`Tracer`
is active::

    tracer = Tracer()
    with tracing(tracer):
        trainer.run_episode()
    tracer.summary()   # {"spans": {name: {...}}, "counters": {name: n}}

An active tracer keeps each span's name, its parent (the span open around
it) and its host interval; on CUDA also a timing-enabled event at its
start and end on the current stream.  Nothing synchronizes and nothing is
read from the device until ``Tracer.summary()``.  While the
``torch.profiler`` runs (``device_trace``), each span also opens a
``record_function`` range of its name, so the trace names the program's
spans around the kernels they launched.

``device_trace`` records the CPU and, where the card is in use, the CUDA
activity of a block into a Chrome trace; ``PhaseTimer`` accumulates
wall-clock phases on a tracer of its own, waiting for the device of
``block_on`` before it stops the clock.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

# every span the program opens, and its parent
SPANS = (
    "train.chunk",          # PGTrainer._train_chunk
    "train.rollout_step",   # PGTrainer._rollout_step; in train.chunk
    "train.policy",         # the rollout's get_actions; in train.rollout_step
    "train.ring_write",     # an uncaptured step's ring row; in train.chunk
    "train.value_fill",     # the ring's (or episode's) rollout values; in train.chunk
    "train.update",         # PGTrainer._update_phase; in train.chunk or alone
    "update.sample",        # an epoch's batch; in train.update
    "update.loss",          # model.get_loss; in train.update
    "update.backward",      # the gradients; in train.update
    "update.optimizer",     # global_norm and the optimizer step; in train.update
    "update.target",        # a loss's bootstrap: the next-state policy and the
                            # (target) critic; in update.loss
    "update.critic",        # MAAC's attention critic in a loss; in update.loss
                            # or update.target
    "update.attend",        # its attention: projections, logits, masked softmax,
                            # weighted sum, regulariser; in update.critic
    "policy.fused_fwd",     # the fused policy's forward kernel (nets/policy_gru.py);
                            # in update.loss
    "policy.fused_bwd",     # its backward kernel and the blocks' sum; in
                            # update.backward
    "train.target_update",  # PGTrainer._soft_update; outside train.chunk
    "replay.gather",        # the index gather of a sampled window of a ring
                            # longer than the window; in update.sample
    "env.step",             # VoltageControlEnv.step; in a rollout or eval step
    "env.reset",            # every reset attempt; in its caller's span
    "pf.solve",             # the power-flow solve; in env.step or env.reset
    "host.sync",            # a blocking read of the device; in its caller's span
    "eval.step",            # one step of PGTester.run, run_days or batch_run
    "eval.act",             # PGTester._act; in eval.step
)
# every counter: lanes x solves, the solves' Newton iterations summed over
# their lanes, the lanes each env step terminated, the trainer's rollout
# steps and update steps that ran uncaptured (all of them while a tracer is
# active: a step replayed as a CUDA graph calls no Python, so it opens no
# span), the soft target updates, the tester's steps that ran uncaptured,
# the attention logits MAAC's critic computed (samples x heads x agents^2)
COUNTERS = ("pf.lane_solves", "pf.nr_iters", "env.terminated_lanes", "train.eager_steps",
            "train.eager_updates", "train.target_updates", "eval.eager_steps",
            "update.attend_logits",
            # the rows of each differentiated policy call (MARLModel.policy),
            # through the fused kernels of nets/policy_gru.py or not
            "policy.fused_rows", "policy.plain_rows")

_ACTIVE = None
_NO_SPAN = contextlib.nullcontext()


def active():
    """The active :class:`Tracer`, or None."""
    return _ACTIVE


def span(name):
    """A context that records the block as span ``name`` on the active
    tracer; with none active, one shared no-op context."""
    if _ACTIVE is None:
        return _NO_SPAN
    return _Span(_ACTIVE, name)


def count(name, value):
    """Add ``value`` (a number, or a tensor whose sum is taken and added on
    its device) to counter ``name`` of the active tracer; with none active,
    nothing is computed."""
    if _ACTIVE is not None:
        _ACTIVE.count(name, value)


@contextlib.contextmanager
def tracing(tracer):
    """Make ``tracer`` the active tracer for the block (the one active
    before it comes back after)."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = saved


class _Span:
    __slots__ = ("tracer", "rec", "range")

    def __init__(self, tracer, name):
        self.tracer = tracer
        # [name, parent, host start, host end (ns), start event, end event]
        self.rec = [name, -1, 0, 0, None, None]

    def __enter__(self):
        tr, rec = self.tracer, self.rec
        if tr._open:
            rec[1] = tr._open[-1]
        tr._open.append(len(tr._spans))
        tr._spans.append(rec)
        rec[2] = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(rec[0])
            self.range.__enter__()
        else:
            self.range = None
        rec[4] = tr._event()
        return self

    def __exit__(self, *exc):
        tr, rec = self.tracer, self.rec
        rec[5] = tr._event()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec[3] = time.perf_counter_ns()
        tr._open.pop()
        return False


def _union_s(intervals, lo, hi):
    """Seconds of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class Tracer:
    """The spans and counters of the blocks it was active in.  On a CUDA
    ``device`` (by default the current one where CUDA is available) each
    span also records an event at its start and end on the device's
    current stream; on the CPU no event is made."""

    def __init__(self, device=None):
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if torch.cuda.is_available() else torch.device("cpu"))
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._spans = []
        self._open = []
        self._counters = {}

    def _event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def span(self, name):
        """A context that records the block as span ``name``."""
        return _Span(self, name)

    def records(self):
        """Each closed span as (name, index of its parent in this list or
        -1, host start, host end), in the order the spans opened; host
        times in ``time.perf_counter_ns`` nanoseconds."""
        closed = [i for i, r in enumerate(self._spans) if r[3]]
        at = {i: k for k, i in enumerate(closed)}
        return [(r[0], at.get(r[1], -1), r[2], r[3])
                for r in (self._spans[i] for i in closed)]

    def count(self, name, value):
        if isinstance(value, torch.Tensor):
            value = value.sum()
        prev = self._counters.get(name)
        self._counters[name] = value if prev is None else prev + value

    def summary(self):
        """{"spans": {name: {"calls", "host_s", "host_self_s", "stream_s",
        "stream_self_s"}}, "counters": {name: number}} of the closed spans.
        A span's self time is its interval less the union of its children's;
        its stream interval runs from its start event to its end event
        (``None`` on the CPU).  Waits once for the device, then reads every
        event and counter."""
        recs, closed = self._spans, [r[3] != 0 for r in self._spans]
        clocks = {"host": [(r[2] * 1e-9, r[3] * 1e-9) for r in recs]}
        if self._cuda and any(closed):
            torch.cuda.synchronize(self.device)
            base = recs[closed.index(True)][4]
            at = lambda ev: base.elapsed_time(ev) * 1e-3
            clocks["stream"] = [(at(r[4]), at(r[5])) if c else None
                                for r, c in zip(recs, closed)]
        kids = collections.defaultdict(list)
        for i, r in enumerate(recs):
            if closed[i] and r[1] >= 0:
                kids[r[1]].append(i)
        out = {}
        for i, r in enumerate(recs):
            if not closed[i]:
                continue
            s = out.setdefault(r[0], {"calls": 0, "host_s": 0.0, "host_self_s": 0.0,
                                      "stream_s": None, "stream_self_s": None})
            s["calls"] += 1
            for clock, iv in clocks.items():
                a, b = iv[i]
                s[clock + "_s"] = (s[clock + "_s"] or 0.0) + (b - a)
                s[clock + "_self_s"] = ((s[clock + "_self_s"] or 0.0) + (b - a)
                                        - _union_s([iv[k] for k in kids[i]], a, b))
        counters = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                    for k, v in self._counters.items()}
        return {"spans": out, "counters": counters}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is present) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Under an active :class:`Tracer` the trace also names the program's
    spans.  Yields the profiler, whose ``key_averages()`` sums the trace by
    op and kernel; its ``trace_path`` attribute names the file."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def _synchronize(tree):
    """Wait for the devices of every tensor in ``tree`` (a tensor, or a
    list, tuple or dict of them) to finish their queued work."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class PhaseTimer:
    """Accumulating wall-clock timers: ``with timer.phase('rollout'): ...``,
    each phase a span of the timer's own host-clock :class:`Tracer`."""

    def __init__(self):
        self.tracer = Tracer(device="cpu")

    @contextlib.contextmanager
    def phase(self, name, block_on=None):
        """Time the block; with ``block_on`` (tensors), the clock stops
        after their devices have finished, as ``jax.block_until_ready``."""
        with self.tracer.span(name):
            try:
                yield
            finally:
                if block_on is not None:
                    _synchronize(block_on)

    def summary(self):
        spans = self.tracer.summary()["spans"]
        return {k: {"total_s": round(v["host_s"], 4),
                    "mean_ms": round(1e3 * v["host_s"] / max(v["calls"], 1), 3),
                    "count": v["calls"]}
                for k, v in sorted(spans.items())}


def enable_nan_debugging():
    """Dev-mode numerical tripwire: ``torch.autograd.set_detect_anomaly``.
    It raises where a backward op yields NaN and names the forward op that
    made it.  Unlike the JAX package's ``jax_debug_nans``/``jax_debug_infs``
    it does not trap a NaN or an infinity made by a forward op outside a
    backward pass (an env step, a power-flow solve)."""
    torch.autograd.set_detect_anomaly(True)
