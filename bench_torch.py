#!/usr/bin/env python
"""Benchmark of the PyTorch port: aggregate training env-steps/s on one GPU.

    python3 bench_torch.py [--platform cpu] [--n-envs N] [--episodes K]

The configuration of bench.py: 8192 vectorized case33 environments
(distributed mode, l1 barrier, 40 synthetic days, float32), each env step
one batched Newton-Raphson AC power flow through the hand-written CUDA
kernel ``csrc/nr_small.cu``, feeding MAPPO with bench.py's cadence (60-step
chunks, 10 value epochs and 1 policy epoch on 32-step windows of 1024
lanes, bf16 ring), seed 0.  One warm-up episode, then ``--episodes`` (8)
timed episodes of 240 steps, each closed by ``torch.cuda.synchronize()``;
the median gives ``value``.

The baseline is bench.py's: the pinned case33 float64 numpy NR oracle of
BASELINE_ORACLE.json (single env, the pandapower-class proxy of the
reference, which steps one env per process), else the oracle measured here.

Prints ONE JSON line with bench.py's keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``baseline``, ``baseline_kind``, ``n_envs``,
``train_reward``) and ``episode_s`` (every timed episode, sorted),
``spread`` (slowest over fastest), ``kernel_launches_per_episode`` (the
small kernel's launches in the timed episodes, per episode; 0 on the CPU,
where its plain version runs) and ``card`` (``nvidia-smi``'s name and power
limit, null on the CPU).  ``--terminations`` adds
``terminations_per_episode``: the timed episodes' terminated lanes by
cause, and the steps that paid a reset solve.  Runs on the GPU;
``--platform cpu`` (with a small ``--n-envs``) only exercises the script.
"""
import argparse
import json
import os
import subprocess
import time

import numpy as np

N_ENVS = 8192
EPISODES = 8


def pinned_baseline(case):
    """The pinned per-case oracle baseline from BASELINE_ORACLE.json
    (one protocol, so the baseline does not drift between runs), or None
    if the file is absent."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_ORACLE.json")
    try:
        with open(path) as f:
            return float(json.load(f)["cases"][case])
    except (OSError, KeyError, ValueError):
        return None


def measure_baseline_oracle(grid, load_p, load_q, repeats=25, trials=5):
    """float64 numpy NR solves/s (the reference's compute-class proxy),
    best of ``trials`` so that transient host load does not set it."""
    from mapdn_torch.pf.reference import nr_solve_ref

    n = grid.n_bus
    p = np.zeros(n)
    q = np.zeros(n)
    np.add.at(p, grid.load_bus.cpu().numpy(), -np.asarray(load_p, np.float64))
    np.add.at(q, grid.load_bus.cpu().numpy(), -np.asarray(load_q, np.float64))
    g = grid.g_mat.cpu().double().numpy()
    b = grid.b_mat.cpu().double().numpy()
    nr_solve_ref(g, b, p, q)  # warm caches
    best = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        for i in range(repeats):
            nr_solve_ref(g, b, p * (0.8 + 0.4 * i / repeats), q)
        best = max(best, repeats / (time.perf_counter() - t0))
    return best


def bench_trainer(n_envs=N_ENVS, device=None):
    """The bench.py configuration: MAPPO on case33 (distributed mode, l1
    barrier, 40 synthetic days), GRU policy and central critic, 60-step
    chunks with 10 value epochs and 1 policy epoch on 32-step windows of
    1024 lanes, bf16 ring; ``device`` None is the GPU."""
    import torch

    from mapdn_torch.algos import MAPPO
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.utils.config import load_config

    env = make_env("case33", EnvConfig(episode_limit=240), days=40,
                   dtype=torch.float32, device=device)
    info = env.get_env_info()
    cfg, _ = load_config("mappo")
    cfg = cfg.replace(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], n_envs=n_envs,
        behaviour_update_freq=60, batch_size=32, value_update_epochs=10,
        policy_update_epochs=1, update_lanes=1024, replay_bf16=True)
    return PGTrainer(cfg, MAPPO(cfg, device=device), env).setup(seed=0)


def count_terminations(env):
    """Wrap ``env.batched_auto_reset_step`` to tally, on the device, the
    lanes that terminate on each step by cause (a failed reset attempt on
    the previous step, a diverged solve, the episode's end) and the steps on
    which any lane terminated, each of which costs one reset solve; returns
    the tallies' dict, read after the run."""
    import torch

    tally = {k: torch.zeros((), dtype=torch.int64, device=env.device)
             for k in ("failed_reset", "diverged", "episode_end", "reset_steps")}
    step = env.batched_auto_reset_step

    def counted(states, *args, **kw):
        out = step(states, *args, **kw)
        failed = states.terminated
        diverged = (out.info["destroy"] > 0) & ~failed
        tally["failed_reset"] += failed.sum()
        tally["diverged"] += diverged.sum()
        tally["episode_end"] += (out.terminated & ~failed & ~diverged).sum()
        tally["reset_steps"] += out.terminated.any()
        return out

    env.batched_auto_reset_step = counted
    return tally


def card():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    import torch

    from mapdn_torch.pf.fused_nr import nr_solve_small
    from mapdn_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="torch device (default: the GPU; 'cpu' for a tiny check)")
    ap.add_argument("--n-envs", type=int, default=N_ENVS)
    ap.add_argument("--episodes", type=int, default=EPISODES)
    ap.add_argument("--terminations", action="store_true",
                    help="also count the timed episodes' terminated lanes by cause "
                         "(adds a few small launches a step)")
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)
    gpu = device.type == "cuda"
    sync = torch.cuda.synchronize if gpu else (lambda: None)
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    trainer = bench_trainer(args.n_envs, device)
    trainer.run_episode()           # warm-up episode (bench.py's compile)
    sync()
    steps_per_ep = trainer._chunk_len * trainer._chunks_per_episode
    tally = count_terminations(trainer.env) if args.terminations else None
    times = []
    nr_solve_small.launches = 0
    for _ in range(args.episodes):
        t0 = time.perf_counter()
        stats = trainer.run_episode()
        sync()
        times.append(time.perf_counter() - t0)
    launches = nr_solve_small.launches
    times.sort()
    env_sps = steps_per_ep * args.n_envs / times[len(times) // 2]

    base_sps = pinned_baseline("case33")
    baseline_kind = ("float64 numpy NR oracle solves/s, single env "
                     "(pandapower-class proxy; reference trains 1 env)")
    if base_sps is None:
        from mapdn_torch.grid import make_case
        grid, load_p, load_q, _ = make_case("case33", device="cpu")
        base_sps = measure_baseline_oracle(grid, load_p, load_q)
    else:
        baseline_kind += "; pinned in BASELINE_ORACLE.json"

    out = {
        "metric": f"train env-steps/s/GPU ({args.n_envs} case33 envs, batched NR "
                  "power flow, MAPPO learner; median episode)",
        "value": env_sps,
        "unit": "env-steps/s",
        "vs_baseline": env_sps / base_sps,
        "baseline": base_sps,
        "baseline_kind": baseline_kind,
        "n_envs": args.n_envs,
        "train_reward": stats.get("mean_train_reward", float("nan")),
        "episode_s": times,
        "spread": times[-1] / times[0],
        "kernel_launches_per_episode": launches / args.episodes,
        "card": card() if gpu else None,
    }
    if tally is not None:
        out["terminations_per_episode"] = {
            k: int(v) / args.episodes for k, v in tally.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
