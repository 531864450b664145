#!/usr/bin/env python
"""Where the time of one training chunk of the PyTorch port goes, on the GPU.

    python3 profile_torch.py [--out build/profile_chunk.txt]

Builds the trainer of chip_smoke.py (the bench.py configuration: MAPPO on
case33, 8192 lanes), runs one warm-up chunk, and then:

1. ``split``: one chunk timed on the host clock, span by span (each span
   closed by a ``torch.cuda.synchronize()``): the 60 rollout steps and,
   inside them, the policy forward, the env step and the power-flow solves;
   the ring value fill; the update phase.  The synchronizes themselves cost
   time, so this chunk runs slower than an untimed one.
2. ``profile``: one more chunk under ``torch.profiler``: the device's busy
   time (the sum of its kernels' times, one stream) against the chunk's
   wall time, and the kernels that take the most device time.  The full
   table goes to ``--out``.

Needs a GPU; fails without one.
"""
import argparse
import collections
import json
import os
import time

import torch

from chip_smoke import bench_trainer


def _timed(spans, name, fn):
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spans[name] += time.perf_counter() - t0
        return out
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "profile_chunk.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    trainer = bench_trainer()
    trainer.carry, _ = trainer._train_chunk(trainer.carry)
    torch.cuda.synchronize()

    # 1. host-clock split of one chunk
    spans = collections.defaultdict(float)
    env, model = trainer.env, trainer.model
    saved = (trainer._rollout_step, trainer._fill_ring_values,
             trainer._update_phase, env._solver, env.batched_auto_reset_step,
             model.get_actions)
    trainer._rollout_step = _timed(spans, "rollout", trainer._rollout_step)
    trainer._fill_ring_values = _timed(spans, "value_fill", trainer._fill_ring_values)
    trainer._update_phase = _timed(spans, "update", trainer._update_phase)
    env._solver = _timed(spans, "rollout.pf_solve", env._solver)
    env.batched_auto_reset_step = _timed(spans, "rollout.env_step",
                                         env.batched_auto_reset_step)
    model.get_actions = _timed(spans, "rollout.policy", model.get_actions)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.carry, _ = trainer._train_chunk(trainer.carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (trainer._rollout_step, trainer._fill_ring_values, trainer._update_phase,
     env._solver, env.batched_auto_reset_step, model.get_actions) = saved
    print("[split] " + json.dumps({"chunk_ms": wall * 1e3,
                                   **{k + "_ms": v * 1e3 for k, v in sorted(spans.items())}}),
          flush=True)

    # 2. device busy share and top kernels of one untimed chunk
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.carry, _ = trainer._train_chunk(trainer.carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print("[profile] " + json.dumps({
        "chunk_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "kernel_launches": sum(v[1] for v in by_name.values()),
        "top": [{"name": k[:80], "ms": v[0], "count": v[1],
                 "share_of_busy": v[0] / busy_ms} for k, v in top]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(prof.key_averages().table(row_limit=40))


if __name__ == "__main__":
    main()
