"""Train the algorithm zoo with the port and keep the learning curves.

    python -m mapdn_torch.scripts.train_zoo               # every run not done
    python -m mapdn_torch.scripts.train_zoo maddpg coma   # just these runs
    python -m mapdn_torch.scripts.train_zoo --force       # rerun from scratch
    python -m mapdn_torch.scripts.train_zoo --jobs 4      # 4 runs at once

The counterpart of scripts/train_zoo.py: the ten algorithms on
case33_3min_final (distributed mode), one decentralised run, one
case322 run and two case69 runs (maddpg, mappo), each 400 episodes of 512
lanes, seed 7, l1 barrier, 40 synthetic days.  Each run is
``mapdn_torch.train.main`` on its flags, so it has the CLI's eval cadence,
checkpoints and ``--resume``.  The CLI's
``model_save/`` and ``tensorboard/`` go under ``--work`` (``build/zoo``);
each run's ``metrics.jsonl`` and ``log.txt`` are copied to
``--out/<run>/`` (``artifacts/learning_torch``).

A run whose curve has eval records and reaches the episode count is done
and skipped; a run cut short resumes from its newest checkpoint (the CLI
saves every 40 episodes), with the killed run's records after that
checkpoint dropped.  ``--force`` deletes a run's curve and checkpoints
first.  With ``--jobs N`` each run is a child process of this module, up to
N at a time on the one card, its output in ``--work/<run>.log``.
``--episodes``, ``--n-envs``, ``--max-steps`` and ``--platform`` are
passed to the CLI (a short check, or the CPU).
Afterwards: ``python -m mapdn_torch.scripts.learning_report``.

Six case33 runs (coma, iac, ippo, maac, mappo, facmaddpg) start from the
JAX package's seed-7 initial weights, ``jax_init/<alg>.npz`` under
``artifacts/learning_torch`` (written on the CPU by
``python tests/test_torch_first_eval.py jax_init``), loaded before the
first episode (``mapdn_torch.train.main(initial_weights=...)``; each
run's ``log.txt`` names the file); the others from the port's own seed-7
draw.  ``mappo_bf16`` and ``maddpg_bf16`` are the bf16-ring A/B: each
trains with ``replay_bf16`` set in its config, from the same initial
weights as ``mappo`` and ``maddpg``, its curve under ``--out/bf16_ab/``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import NamedTuple, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART = os.path.join(ROOT, "artifacts", "learning_torch")
WORK = os.path.join(ROOT, "build", "zoo")

ALGS = ["iddpg", "maddpg", "matd3", "ippo", "mappo", "iac", "coma",
        "sqddpg", "maac", "facmaddpg"]


class Run(NamedTuple):
    alg: str
    scenario: str
    mode: str
    init: Optional[str] = None   # initial weights, a file under ART; None: the seed's draw
    config: tuple = ()           # algorithm config overrides, (key, value) pairs
    group: str = ""              # the curve's subdirectory of --out


# case33 runs that start from the JAX package's seed-7 initial weights
JAX_INIT = ("coma", "iac", "ippo", "maac", "mappo", "facmaddpg")
RUNS = {a: Run(a, "case33_3min_final", "distributed",
               init=f"jax_init/{a}.npz" if a in JAX_INIT else None) for a in ALGS}
RUNS["maddpg_decentralised"] = Run("maddpg", "case33_3min_final", "decentralised")
RUNS["mappo_case322"] = Run("mappo", "case322_3min_final", "distributed")
# case69, the published 69-bus feeder (scripts/train_zoo.py:42-43)
RUNS["maddpg_case69"] = Run("maddpg", "case69", "distributed")
RUNS["mappo_case69"] = Run("mappo", "case69", "distributed")
# the bf16 replay ring against the float32 one (artifacts/bf16_ab)
RUNS.update({f"{a}_bf16": RUNS[a]._replace(config=(("replay_bf16", True),), group="bf16_ab")
             for a in ("mappo", "maddpg")})

EPISODES = 400
N_ENVS = 512
SEED = 7


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train the zoo with mapdn_torch.")
    ap.add_argument("runs", nargs="*", help=f"runs (default: all of {sorted(RUNS)})")
    ap.add_argument("--force", action="store_true", help="rerun done runs from scratch")
    ap.add_argument("--jobs", type=int, default=1, help="runs at once, each a process")
    ap.add_argument("--out", default=ART, help="where each run's curve is kept")
    ap.add_argument("--work", default=WORK, help="the CLI's --save-path root")
    ap.add_argument("--episodes", type=int, default=EPISODES)
    ap.add_argument("--n-envs", type=int, default=N_ENVS)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)
    unknown = [r for r in args.runs if r not in RUNS]
    if unknown:
        ap.error(f"unknown runs {unknown}; known: {sorted(RUNS)}")
    args.out, args.work = os.path.abspath(args.out), os.path.abspath(args.work)
    return args


def _forwarded(args):
    """The flags passed on unchanged, to the CLI and to a child run."""
    flags = ["--n-envs", str(args.n_envs), "--episodes", str(args.episodes)]
    if args.max_steps:
        flags += ["--max-steps", str(args.max_steps)]
    if args.platform:
        flags += ["--platform", args.platform]
    return flags


def cli_flags(name, args):
    """The training CLI's flags for run ``name``."""
    run = RUNS[name]
    return ["--alg", run.alg, "--scenario", run.scenario, "--mode", run.mode,
            "--voltage-barrier-type", "l1", "--seed", str(SEED), "--days", "40",
            "--save-path", os.path.join(args.work, name)] + _forwarded(args)


def out_dir(name, args):
    """Where run ``name``'s curve is kept."""
    return os.path.join(args.out, RUNS[name].group, name)


def is_done(path, episodes):
    """A curve with eval records whose last record is episode ``episodes``
    or later."""
    if not os.path.exists(path):
        return False
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return (any("mean_test_reward" in r for r in recs)
            and recs[-1]["step"] >= episodes)


def has_checkpoint(name, args):
    return bool(glob.glob(os.path.join(
        args.work, name, "model_save", "*", "checkpoint", "ckpt_*")))


def run_one(name, args):
    """Train (or resume) one run through the CLI, in this process, and copy
    its curve to ``out_dir``; returns the run's record."""
    from mapdn_torch import train

    run = RUNS[name]
    resume = has_checkpoint(name, args)
    if not resume:      # no checkpoint: a curve left beside it is stale
        shutil.rmtree(os.path.join(args.work, name), ignore_errors=True)
    t0 = time.time()
    summary = train.main(cli_flags(name, args) + (["--resume"] if resume else []),
                         config=dict(run.config),
                         initial_weights=run.init and os.path.join(ART, run.init))
    wall = time.time() - t0
    dest = out_dir(name, args)
    os.makedirs(dest, exist_ok=True)
    for f in ("metrics.jsonl", "log.txt"):
        shutil.copyfile(os.path.join(summary["tb_dir"], f), os.path.join(dest, f))
    evals = [s for s in summary["stats"] if "mean_test_reward" in s]
    episode_s = sorted(summary["episode_s"])
    return {"run": name, "start_episode": summary["start_episode"],
            "episodes": summary["episodes"], "wall_s": wall,
            "episode_s_median": episode_s[len(episode_s) // 2] if episode_s else None,
            "eval_s_mean": (sum(summary["eval_s"]) / len(summary["eval_s"])
                            if summary["eval_s"] else None),
            "final_eval": {k: evals[-1][k] for k in (
                "mean_test_reward", "mean_test_totally_controllable_ratio")}
            if evals else None, "out": dest}


def _child_argv(name, args):
    return [sys.executable, "-m", "mapdn_torch.scripts.train_zoo", name,
            "--out", args.out, "--work", args.work] + _forwarded(args)


def _run_children(names, args):
    """Each run a child process, ``--jobs`` at a time; returns the failed
    runs.  A child's output goes to ``--work/<run>.log``; its record (its
    last JSON line) is printed when it ends.  Children still running when
    this process is interrupted or terminated are terminated too."""
    os.makedirs(args.work, exist_ok=True)
    pending, running, failed = list(names), {}, []
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    try:
        _supervise(pending, running, failed, args)
    finally:
        for proc, _ in running.values():
            proc.terminate()
        for proc, _ in running.values():
            proc.wait()
        signal.signal(signal.SIGTERM, previous)
    return failed


def _supervise(pending, running, failed, args):
    while pending or running:
        while pending and len(running) < args.jobs:
            name = pending.pop(0)
            log = open(os.path.join(args.work, f"{name}.log"), "w")
            running[name] = (subprocess.Popen(_child_argv(name, args), stdout=log,
                                              stderr=subprocess.STDOUT, cwd=ROOT), log)
            print(f"[{name}] started ({len(running)} running)", flush=True)
        time.sleep(1.0)
        for name, (proc, log) in list(running.items()):
            if proc.poll() is None:
                continue
            log.close()
            del running[name]
            with open(log.name) as fh:
                lines = fh.read().splitlines() or [""]
            record = next((ln for ln in reversed(lines) if ln.startswith("{")), lines[-1])
            print(record if proc.returncode == 0 else
                  f"[{name}] FAILED (exit {proc.returncode}): {lines[-1]}", flush=True)
            if proc.returncode != 0:
                failed.append(name)


def main(argv=None):
    args = parse_args(argv)
    wanted = args.runs or list(RUNS)
    todo = []
    for name in wanted:
        if args.force:
            shutil.rmtree(os.path.join(args.work, name), ignore_errors=True)
            shutil.rmtree(out_dir(name, args), ignore_errors=True)
        elif is_done(os.path.join(out_dir(name, args), "metrics.jsonl"), args.episodes):
            print(f"[{name}] already present, skipping", flush=True)
            continue
        todo.append(name)
    if args.jobs > 1:
        failed = _run_children(todo, args)
    else:
        failed = []
        for name in todo:
            run = RUNS[name]
            print(f"[{name}] training {run.alg} on {run.scenario} ({run.mode})...", flush=True)
            try:
                print(json.dumps(run_one(name, args)), flush=True)
            except Exception as e:  # keep sweeping; report at the end
                print(f"[{name}] FAILED: {e!r}", flush=True)
                failed.append(name)
    if failed:
        print(f"FAILED runs: {failed}", flush=True)
        sys.exit(1)
    print("zoo complete", flush=True)


if __name__ == "__main__":
    main()
