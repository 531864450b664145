#!/usr/bin/env python
"""Where the time of one training chunk of the PyTorch port goes, on the GPU.

    python3 profile_torch.py [--case case33|case322] [--alg mappo]
                             [--out build/profile_chunk.txt]

Builds a trainer: for case33 MAPPO (the default) bench_torch.py's, the
bench.py configuration, 8192 lanes in 60-step chunks; for another
``--alg`` at case33 the trainer ``mapdn_torch.train`` builds from the flags
of train_case33.sh at 512 lanes (``python3 profile_torch.py --alg maddpg``:
an off-policy chunk of 60 steps, 10 value and 1 policy epoch); for case322
the one it builds from the flags of train_case322.sh at 4096 lanes, whose
MAPPO chunk is the whole 240-step episode.  It runs one warm-up chunk, and
then:

1. ``split``: one chunk timed on the host clock, span by span (each span
   closed by a ``torch.cuda.synchronize()``): the rollout steps and,
   inside them, the policy forward, the env step and the power-flow solves;
   the ring value fill (PPO family); the update phase.  The synchronizes themselves cost
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

from bench_torch import bench_trainer
from chip_smoke import case322_flags, case33_flags


def _timed(spans, name, fn, gate=lambda: True):
    """``fn`` with its time added to ``spans[name]`` while ``gate()``."""
    def run(*args, **kwargs):
        if not gate():
            return fn(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spans[name] += time.perf_counter() - t0
        return out
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("case33", "case322"), default="case33")
    ap.add_argument("--alg", default="mappo")
    ap.add_argument("--out", default=os.path.join("build", "profile_chunk.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.case == "case33" and args.alg == "mappo":
        trainer = bench_trainer()
    else:
        from mapdn_torch import train
        flags = case33_flags if args.case == "case33" else case322_flags
        _, _, trainer = train.build_trainer(train.parse_args(flags(args.alg)))
    trainer.carry, _ = trainer._train_chunk(trainer.carry)
    torch.cuda.synchronize()

    # 1. host-clock split of one chunk
    spans = collections.defaultdict(float)
    env, model = trainer.env, trainer.model
    saved = (trainer._rollout_step, trainer._fill_ring_values,
             trainer._update_phase, env._solver, env.batched_auto_reset_step,
             model.get_actions)
    # the DDPG family's losses call get_actions too: the policy span counts
    # the rollout's calls only
    in_rollout = [False]

    def rollout_step(*args, **kwargs):
        in_rollout[0] = True
        try:
            return saved[0](*args, **kwargs)
        finally:
            in_rollout[0] = False

    trainer._rollout_step = _timed(spans, "rollout", rollout_step)
    trainer._fill_ring_values = _timed(spans, "value_fill", trainer._fill_ring_values)
    trainer._update_phase = _timed(spans, "update", trainer._update_phase)
    env._solver = _timed(spans, "rollout.pf_solve", env._solver)
    env.batched_auto_reset_step = _timed(spans, "rollout.env_step",
                                         env.batched_auto_reset_step)
    model.get_actions = _timed(spans, "rollout.policy", model.get_actions,
                               lambda: in_rollout[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.carry, _ = trainer._train_chunk(trainer.carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (trainer._rollout_step, trainer._fill_ring_values, trainer._update_phase,
     env._solver, env.batched_auto_reset_step, model.get_actions) = saved
    print("[split] " + json.dumps({"case": args.case, "alg": args.alg,
                                   "n_envs": trainer.n_envs, "chunk_ms": wall * 1e3,
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
        "case": args.case, "alg": args.alg, "chunk_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "kernel_launches": sum(v[1] for v in by_name.values()),
        "top": [{"name": k[:80], "ms": v[0], "count": v[1],
                 "share_of_busy": v[0] / busy_ms} for k, v in top]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(prof.key_averages().table(row_limit=40))


if __name__ == "__main__":
    main()
