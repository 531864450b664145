"""Interaction examples (PyTorch port of the repository's code_examples.py;
reference code_examples.py:1-66):

1. the drop-in object interface with random actions (the reference's demo);
2. the batched way: every lane of one env object stepped together, one
   power-flow solve a step for all of them.

    python -m mapdn_torch.code_examples [--platform cpu] [--n-envs N]

Runs on the GPU unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse

import torch

from mapdn_torch.envs import EnvConfig, VoltageControlWrapper, make_env

STEPS = 24


def oo_example(device=None):
    """Reference-style single-env loop (reference code_examples.py:40-66);
    returns the return and the steps taken."""
    env = VoltageControlWrapper("case33", EnvConfig(episode_limit=STEPS), days=8,
                                device=device)
    info = env.get_env_info()
    print("env info:", info)

    env.reset()
    total = 0.0
    for t in range(info["episode_limit"]):
        actions = env.get_action()           # uniform random in env range
        reward, terminated, step_info = env.step(actions)
        total += reward
        if terminated:
            break
    print(f"random policy return over {t + 1} steps: {total:.3f}")
    print("last-step metrics:",
          {k: round(v, 4) for k, v in list(step_info.items())[:4]})
    return total, t + 1


def vectorized_example(n_envs=512, device=None, seed=0):
    """``n_envs`` lanes reset together, then 24 steps of uniform actions with
    the auto-reset; returns the (24, n_envs) rewards."""
    env = make_env("case33", EnvConfig(episode_limit=STEPS), days=8, device=device)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state, _, _ = env.reset(n_envs, gen)
    rewards = []
    for _ in range(STEPS):
        u = torch.rand((n_envs, env.grid.n_sgen), generator=gen, dtype=env.dtype,
                       device=env.device)
        a = u * (env.action_high - env.action_low) + env.action_low
        out = env.batched_auto_reset_step(state, a, gen)
        state = out.state
        rewards.append(out.reward)
    rewards = torch.stack(rewards)
    print(f"{n_envs} envs x {STEPS} steps: mean reward {float(rewards.mean()):.4f}")
    return rewards


def main(argv=None):
    parser = argparse.ArgumentParser(description="The port's interaction examples.")
    parser.add_argument("--platform", choices=["cpu"], default=None,
                        help="run on the CPU (default: the GPU)")
    parser.add_argument("--n-envs", type=int, default=512)
    args = parser.parse_args(argv)
    oo_example(args.platform)
    vectorized_example(args.n_envs, args.platform)


if __name__ == "__main__":
    main()
