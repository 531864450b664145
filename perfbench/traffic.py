"""The one general generator: it reads a cell's traffic file and hands it to
the runner of the file's ``kind`` (``perfbench/kinds/<kind>.py``, found by
name), which drives the program's own entry points with it.  A new kind
of traffic is a new file there; a new mix of a kind is a data file alone.

A runner ``Runner(cell, seed, device)`` has ``kind`` and ``sync``, and:

* ``setup()``: builds the program from the configuration's flags and the
  mix, draws its weights from the seed on the device, warms up;
* ``first_steps(rng)``: what the check follows before the window (none
  for some kinds); returns the seconds spent copying it, which set-up
  does not count;
* ``window(seconds)``: {"metrics", "attempted", "failed", "seconds"};
* ``trace(seconds, peaks)``: the record the per-layer
  readers read, with ``profile`` (perfbench/tracing.py ``summarize``);
* ``keep()``: after the peak memory was read, copies what the check reads
  of the window to the host;
* ``release()``: drops the program's state;
* ``check(device, rng, control=False)``: {number: reading} against the
  plain reference (``control``: the reference in the control's precision
  in the program's place);
* ``fault(name)``: a context in which the timed path is broken by
  ``name`` (perfbench/control.py).
"""
from __future__ import annotations

import collections
import contextlib

import torch

from perfbench import counting, spec, tracing

GIB = 2 ** 30


def make(cell, seed, device):
    return spec.kind(cell["traffic"]["kind"], cell.get("root", spec.ROOT)).Runner(
        cell, seed, device)


def alg_of(cell):
    """The algorithm module the configuration's ``--alg`` flag names."""
    flags = cell["config"]["flags"]
    return spec.alg(flags[flags.index("--alg") + 1], cell.get("root", spec.ROOT))


def sync_of(device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def flags(config, extra, device):
    out = list(config["flags"]) + ["--days", str(config["data"]["days"]),
                                   "--seed", str(config["data"]["seed"])] + extra
    if device.type == "cpu":
        out += ["--platform", "cpu"]
    return out


def check_config(cfg, config, overrides):
    """The program's merged configuration must be the one the configuration
    file states (with the mix's overrides): the reference reads the file."""
    want = dict(config["alg"], **config["model"])
    want.update(overrides)
    bad = {k: (getattr(cfg, k), v) for k, v in want.items()
           if hasattr(cfg, k) and getattr(cfg, k) != v}
    if bad:
        raise ValueError(f"the program's configuration differs from the file: {bad}")


def roofline(n_iters, kernels, grid_counts, peaks, kernel):
    """{kernel: {bound_s, kernel_s, calls, bound_by}} of the profiled solves."""
    n_bus, nnz_y, inner = grid_counts
    if not n_iters or kernels.get(kernel, {}).get("count", 0) == 0:
        return {}
    bound, by = 0.0, collections.Counter()
    for it in n_iters:
        s, what = counting.roofline_seconds(counting.nr_flops(it, n_bus, nnz_y, inner),
                                            counting.nr_bytes(len(it), n_bus, nnz_y), peaks)
        bound += s
        by[what] += 1
    return {kernel: {"bound_s": bound, "kernel_s": kernels[kernel]["seconds"],
                     "calls": len(n_iters), "launches": kernels[kernel]["count"],
                     "bound_by": max(by, key=by.get)}}


@contextlib.contextmanager
def solver_fault(env):
    """The power flow stops at a 1e-4 mismatch instead of 1e-7: an answer
    altered where it is produced."""
    from mapdn_torch.pf.fused_nr import make_solver
    loose = make_solver(env.grid, tol=1e-4)
    with tracing.installed([(env, "_solver", lambda fn: loose)]):
        yield
