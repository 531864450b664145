"""Summarize the port's learning curves beside a random-action baseline.

    python -m mapdn_torch.scripts.learning_report [--art DIR] [--platform cpu]

The counterpart of scripts/learning_report.py.  Writes
``artifacts/learning_torch/summary.json`` (read by
tests/test_torch_learning.py): for every run under ``--art``
(``<run>/metrics.jsonl``, written by ``mapdn_torch.scripts.train_zoo``)
the eval curve's milestones (``curve_summary``, line for line the JAX
script's) and its ``metrics_path``, and a uniform-random-action baseline on
the same env build (the role of the reference's RandomAgent) with the
trainer's per-episode mean-of-means weighting: ``random_baseline`` over
256 episodes and ``random_baseline_sem``, the standard error of each mean
over those episodes; ``random_baseline_case322`` and
``random_baseline_case69`` (each with its ``_sem``) where a run of that
case is there; and ``droop_baseline`` and ``opf_baseline``
(``engineering_baselines``: the droop and OPF dispatch of
``mapdn_torch.traditional`` over 256 sampled case33 dataset rows).  The
baselines run on the GPU unless ``--platform cpu`` is given.

Where the bf16-ring A/B runs are there (``train_zoo``'s ``mappo_bf16``
and ``maddpg_bf16`` under ``--art/bf16_ab/``), it also writes
``bf16_ab/summary.json`` (``bf16_ab_summary``) with the fields of the JAX
package's artifacts/bf16_ab/summary.json.

Run names: ``<alg>`` is case33 distributed, ``<alg>_decentralised`` case33
decentralised, ``<alg>_case322`` case322 and ``<alg>_case69`` case69
distributed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from mapdn_torch.scripts.train_zoo import ART, ROOT


CASE_SUFFIXES = ("case322", "case69")   # a run named <alg>_<case> runs on <case>


def random_episodes(case="case33", n_episodes=256, max_steps=240, seed=7,
                    draws=None, device=None):
    """Per-episode stats of uniform-random actions in [action_low,
    action_high], the episodes run side by side with no auto-reset: for
    each stat the mean over the episode's live steps, as float64 arrays of
    (n_episodes,).  Draws come from a generator seeded ``seed``; ``draws``
    replaces them: ``reset`` (``env.reset``'s first-attempt ``t0``,
    ``noise``, ``a0``), ``actions`` (max_steps, n_episodes, n_sgen) and
    ``noise`` (one ``env.step`` noise tuple a step).  The env is the JAX
    script's: 40 synthetic days of seed 7, float32."""
    from mapdn_torch.envs import EnvConfig, make_env

    env = make_env(case, EnvConfig(episode_limit=240), days=40, seed=7,
                   dtype=torch.float32, device=device)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state, _, _ = env.reset(n_episodes, gen, draws=draws and draws["reset"])
    alive = torch.ones(n_episodes, dtype=env.dtype, device=env.device)
    n_alive = torch.zeros_like(alive)
    sums = {}
    for t in range(max_steps):
        if draws:
            a, noise = torch.as_tensor(draws["actions"][t]), draws["noise"][t]
        else:
            a = torch.rand((n_episodes, env.grid.n_sgen), generator=gen,
                           dtype=env.dtype, device=env.device)
            a, noise = a * (env.action_high - env.action_low) + env.action_low, None
        out = env.step(state, a, gen, noise=noise)
        stats = dict(out.info, reward=out.reward)
        for k, v in stats.items():
            sums[k] = sums.get(k, 0.0) + v * alive
        n_alive = n_alive + alive
        alive = alive * (1.0 - out.terminated.to(alive.dtype))
        state = out.state
    ep_len = torch.clamp(n_alive, min=1.0)
    return {"mean_test_" + k: (v / ep_len).double().cpu().numpy() for k, v in sums.items()}


def _means(episodes):
    return {k: float(np.mean(v)) for k, v in episodes.items()}


def random_baseline(case="case33", n_episodes=256, max_steps=240, seed=7,
                    draws=None, device=None):
    """The mean over episodes of each stat of ``random_episodes`` (the JAX
    script's ``random_baseline``)."""
    return _means(random_episodes(case, n_episodes, max_steps, seed, draws, device))


def baseline_points(case="case33", n_samples=256, seed=7, device=None,
                    dtype=torch.float32):
    """(env, load_p, load_q, pv_p): the JAX script's env build (40 synthetic
    days of seed 7) and ``n_samples`` of its dataset rows, drawn by
    ``np.random.default_rng(seed)`` as the JAX script draws them."""
    from mapdn_torch.envs import EnvConfig, make_env

    env = make_env(case, EnvConfig(episode_limit=240), days=40, seed=7,
                   dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.integers(0, env.ts.n_steps, size=n_samples),
                           device=env.device)
    return env, env.ts.load_p[rows], env.ts.load_q[rows], env.ts.pv[rows]


def engineering_baselines(case="case33", n_samples=256, seed=7, device=None,
                          dtype=torch.float32):
    """Droop and OPF dispatch metrics over ``n_samples`` dataset rows
    (quasi-static operating points, no noise; ``baseline_points``), all rows
    in one batch: the JAX script's ``engineering_baselines``.  Lanes whose
    final solve did not converge are dropped; ``n_samples`` is the count
    kept."""
    from mapdn_torch.traditional import droop_solve, opf_solve

    env, load_p, load_q, pv_p = baseline_points(case, n_samples, seed, device, dtype)
    out = {}
    for name, solver in (("droop_baseline", droop_solve),
                         ("opf_baseline", opf_solve)):
        q, res, _ = solver(env, load_p, load_q, pv_p)
        reward, info = env._calc_reward(res.vm, res.pl_mw, q)
        info["reward"] = reward
        ok = res.converged.cpu().numpy()
        out[name] = {"mean_test_" + k: float(np.mean(v.double().cpu().numpy()[ok]))
                     for k, v in info.items()}
        out[name]["n_samples"] = int(ok.sum())
    return out


def curve_summary(path):
    recs = [json.loads(l) for l in open(path)]
    evals = [r for r in recs if "mean_test_reward" in r]
    if not evals:
        return None

    def pick(r):
        return {"episode": r["step"],
                "mean_test_reward": r["mean_test_reward"],
                "mean_test_totally_controllable_ratio":
                    r.get("mean_test_totally_controllable_ratio")}

    best = max(evals, key=lambda r: r["mean_test_reward"])
    tail = evals[-3:]
    return {
        "n_episodes": recs[-1]["step"],
        "n_evals": len(evals),
        "first": pick(evals[0]),
        "best": pick(best),
        "final": pick(evals[-1]),
        "late_mean_test_reward": sum(
            r["mean_test_reward"] for r in tail) / len(tail),
        "late_mean_test_totally_controllable_ratio": sum(
            r.get("mean_test_totally_controllable_ratio", 0.0)
            for r in tail) / len(tail),
    }


BF16_AB_ALGS = ("mappo", "maddpg")


def late_eval_reward(path, n=5):
    """The mean eval reward of a curve's last ``n`` evals."""
    with open(path) as fh:
        evals = [r["mean_test_reward"] for r in map(json.loads, fh) if "mean_test_reward" in r]
    return float(np.mean(evals[-n:]))


def bf16_ab_summary(art=ART):
    """The bf16-ring A/B of the curves under ``art``: each algorithm's
    late-5 eval-reward mean with the float32 ring (``<art>/<alg>``) and
    the bf16 one (``<art>/bf16_ab/<alg>_bf16``), and ``delta_<alg>``,
    bf16 less float32; None when a curve is missing."""
    paths = {}
    for alg in BF16_AB_ALGS:
        paths[f"{alg}_f32"] = os.path.join(art, alg, "metrics.jsonl")
        paths[f"{alg}_bf16"] = os.path.join(art, "bf16_ab", f"{alg}_bf16", "metrics.jsonl")
    if not all(map(os.path.exists, paths.values())):
        return None
    runs = {name: late_eval_reward(path) for name, path in paths.items()}
    return {"metric": ("bf16-ring learning parity (late-5 eval-reward mean, case33, "
                       "400 eps, 512 lanes, seed 7)"),
            "runs": runs,
            **{f"delta_{alg}": runs[f"{alg}_bf16"] - runs[f"{alg}_f32"]
               for alg in BF16_AB_ALGS}}


def main(argv=None):
    from mapdn_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description="Summarize the port's learning curves.")
    ap.add_argument("--art", default=ART, help="the runs' directory (train_zoo's --out)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)

    runs = {}
    cases_needed = {"case33"}
    for path in sorted(glob.glob(os.path.join(args.art, "*", "metrics.jsonl"))):
        name = os.path.basename(os.path.dirname(path))
        s = curve_summary(path)
        if s:
            s["metrics_path"] = os.path.relpath(path, ROOT)
            runs[name] = s
            for case in CASE_SUFFIXES:
                if name.endswith("_" + case):
                    cases_needed.add(case)

    out = {}
    for case in sorted(cases_needed):
        key = "random_baseline" if case == "case33" else "random_baseline_" + case
        print(f"computing {key}...", flush=True)
        lanes = random_episodes(case, device=device)
        out[key] = _means(lanes)
        out[key + "_sem"] = {k: float(np.std(v, ddof=1) / np.sqrt(len(v)))
                             for k, v in lanes.items()}
    print("computing droop/opf baselines...", flush=True)
    out.update(engineering_baselines("case33", device=device))
    out.update(runs)

    dest = os.path.join(args.art, "summary.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f"\nwrote {dest}")
    ab = bf16_ab_summary(args.art)
    if ab is not None:
        ab_dest = os.path.join(args.art, "bf16_ab", "summary.json")
        with open(ab_dest, "w") as f:
            json.dump(ab, f, indent=1)
        print(json.dumps(ab, indent=1))
        print(f"wrote {ab_dest}")
    return out


if __name__ == "__main__":
    main()
