"""Profiling hooks: ``torch.profiler`` device traces and phase timers
(port of mapdn_tpu/utils/profiling.py).

``device_trace`` records the CPU and, where the card is in use, the CUDA
activity of a block into a Chrome trace; ``PhaseTimer`` accumulates
wall-clock phases, waiting for the device of ``block_on`` before it stops
the clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is present) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums the trace by op and
    kernel; its ``trace_path`` attribute names the file."""
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
    """Accumulating wall-clock timers: ``with timer.phase('rollout'): ...``."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name, block_on=None):
        """Time the block; with ``block_on`` (tensors), the clock stops
        after their devices have finished, as ``jax.block_until_ready``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}


def enable_nan_debugging():
    """Dev-mode numerical tripwire: ``torch.autograd.set_detect_anomaly``.
    It raises where a backward op yields NaN and names the forward op that
    made it.  Unlike the JAX package's ``jax_debug_nans``/``jax_debug_infs``
    it does not trap a NaN or an infinity made by a forward op outside a
    backward pass (an env step, a power-flow solve)."""
    torch.autograd.set_detect_anomaly(True)
