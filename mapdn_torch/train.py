"""Training CLI of the PyTorch port, flag-compatible with the repository's
train.py (itself the reference's train.py):

    python -m mapdn_torch.train --alg mappo --mode distributed \\
        --scenario case322_3min_final --voltage-barrier-type bowl \\
        --n-envs 4096 --save-path ./out

The same 3-layer config merge, per-scenario action ranges, directory layout
(``model_save/<log_name>`` with ``model.pt`` and ``checkpoint/``,
``tensorboard/<log_name>`` with ``metrics.jsonl`` and ``log.txt``),
per-episode stat logging, eval and save cadences, final save and
full-state ``--resume``.  The run is on the GPU; ``--platform cpu`` runs it
on the CPU.

``--distributed --coordinator host:port --num-processes N --process-id i``
runs rank i of N (one process each, started by the caller) over
``torch.distributed``: NCCL with one card a rank on the GPU, gloo on the
CPU; the env lanes are split over the ranks
(:class:`mapdn_torch.parallel.ShardedPGTrainer`).  Rank 0 alone writes
``tensorboard/`` and ``model_save/``; a run of several processes saves
``model.pt`` and no resume checkpoint (train.py does the same).

``main(argv)`` can be called in-process; it returns a summary of the run.
Called so, it also takes, as train.py's flags do not, ``config`` (algorithm
config overrides, e.g. ``{"replay_bf16": True}``) and ``initial_weights``
(an ``.npz`` of flax parameter trees, :func:`mapdn_torch.convert.state_from_npz`,
loaded before the first episode of a run that does not resume; its path is
written to ``log.txt``).
"""
from __future__ import annotations

import argparse
import os
import time


def build_env_cfg(env_dict):
    from mapdn_torch.envs import EnvConfig
    return EnvConfig(
        mode=env_dict["mode"],
        voltage_barrier_type=env_dict["voltage_barrier_type"],
        voltage_weight=env_dict.get("voltage_weight", 1.0),
        q_weight=env_dict.get("q_weight", 0.1),
        line_weight=env_dict.get("line_weight"),
        v_upper=env_dict.get("v_upper", 1.05),
        v_lower=env_dict.get("v_lower", 0.95),
        episode_limit=env_dict.get("episode_limit", 240),
        history=env_dict.get("history", 1),
        action_scale=env_dict["action_scale"],
        action_bias=env_dict["action_bias"],
        reset_action=env_dict.get("reset_action", True),
        state_space=tuple(env_dict.get(
            "state_space", ("pv", "demand", "reactive", "vm_pu", "va_degree"))),
    )


def log_name_of(args):
    """The run's directory name under ``model_save/`` and ``tensorboard/``
    (train.py's and test.py's)."""
    return "-".join(filter(None, [
        args.env, args.scenario, args.mode, args.alg,
        args.voltage_barrier_type, args.alias]))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a MARL agent (PyTorch port).")
    parser.add_argument("--save-path", type=str, default="./")
    parser.add_argument("--alg", type=str, default="maddpg")
    parser.add_argument("--env", type=str, default="var_voltage_control")
    parser.add_argument("--alias", type=str, default="")
    parser.add_argument("--mode", type=str, default="distributed",
                        choices=["distributed", "decentralised"])
    parser.add_argument("--scenario", type=str, default="case33_3min_final")
    parser.add_argument("--voltage-barrier-type", type=str, default="l1")
    parser.add_argument("--n-envs", type=int, default=None,
                        help="vectorized env lanes (default from config)")
    parser.add_argument("--episodes", type=int, default=None,
                        help="override train_episodes_num")
    parser.add_argument("--data-path", type=str, default=None,
                        help="real MAPDN csv dataset directory")
    parser.add_argument("--days", type=int, default=40,
                        help="synthetic dataset length in days")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--distributed", action="store_true",
                        help="one rank of a torch.distributed run: pass "
                             "--coordinator/--num-processes/--process-id")
    parser.add_argument("--coordinator", type=str, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--platform", type=str, default=None,
                        help="torch device to run on (default: the GPU; "
                             "'cpu' runs on the CPU)")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="override episode length (smoke tests)")
    parser.add_argument("--resume", action="store_true",
                        help="restore the newest checkpoint generation under "
                             "the run's model dir and continue training")
    return parser.parse_args(argv)


def _save(model_dir, ckpt_dir, trainer):
    """model.pt always; the full resume checkpoint only where this process
    holds every lane (a run of several processes has each rank's lanes
    apart; train.py:46-61 skips it alike)."""
    from mapdn_torch.utils.checkpoint import save_checkpoint, save_model
    save_model(os.path.join(model_dir, "model.pt"), trainer.carry.algo)
    if getattr(trainer, "world_size", 1) == 1:
        save_checkpoint(ckpt_dir, trainer.carry, trainer.steps, trainer.episodes)
    else:
        print("multi-process run: skipping the full resume checkpoint "
              "(each rank holds its own lanes; model.pt saved)")


def _timed(device, fn):
    """(result, seconds) of ``fn()``, the device's queue drained first and
    after."""
    import torch
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def init_distributed(args):
    """Join the run's process group for ``--distributed`` (NCCL on the GPU,
    one card a rank; gloo with ``--platform cpu``) and return this rank's
    device; None without ``--distributed``.  Missing rendezvous flags, more
    NCCL ranks than cards, or a failed rendezvous raise."""
    from mapdn_torch.parallel import init_process_group, rank_device
    from mapdn_torch.utils.device import resolve_device

    if not args.distributed:
        if args.coordinator or args.num_processes or args.process_id is not None:
            raise ValueError("--coordinator/--num-processes/--process-id need --distributed")
        return None
    if not args.coordinator or args.num_processes is None or args.process_id is None:
        raise ValueError("--distributed needs --coordinator host:port, --num-processes N "
                         "and --process-id i (one process a rank, started by the caller)")
    device = resolve_device(args.platform)
    backend = "gloo" if device.type == "cpu" else "nccl"
    init_process_group(args.coordinator, args.num_processes, args.process_id, backend)
    device = rank_device(backend, args.process_id)
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(device)
    return device


def build_trainer(args, device=None, config=None):
    """(cfg, env_dict, trainer) of parsed flags: the 3-layer config (with
    the algorithm config overrides ``config`` on top), the env and a set-up
    trainer of ``--alg`` on the flags' device (``device`` where given);
    under ``--distributed`` a sharded trainer over the process group."""
    from mapdn_torch.algos import make_model
    from mapdn_torch.envs import make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.parallel import ShardedPGTrainer
    from mapdn_torch.utils.config import load_config
    from mapdn_torch.utils.device import resolve_device

    device = device if device is not None else resolve_device(args.platform)
    overrides = {"seed": args.seed}
    if args.n_envs:
        overrides["n_envs"] = args.n_envs
    if args.episodes:
        overrides["train_episodes_num"] = args.episodes
    overrides.update(config or {})
    cfg, env_dict = load_config(
        args.alg, env=args.env, scenario=args.scenario, mode=args.mode,
        voltage_barrier_type=args.voltage_barrier_type, overrides=overrides)
    env = make_env(args.scenario, build_env_cfg(env_dict),
                   data_path=args.data_path or env_dict.get("data_path"),
                   days=args.days, seed=args.seed, device=device)
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"],
                      max_steps=min(cfg.max_steps, info["episode_limit"]))
    if args.max_steps:
        cfg = cfg.replace(max_steps=args.max_steps)
    cls = ShardedPGTrainer if args.distributed else PGTrainer
    trainer = cls(cfg, make_model(args.alg, cfg, device=device), env).setup(seed=args.seed)
    return cfg, env_dict, trainer


def main(argv=None, *, config=None, initial_weights=None):
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns a dict
    with the per-episode stats and the seconds each phase took.
    ``config`` and ``initial_weights``: see the module docstring."""
    args = parse_args(argv)
    device = init_distributed(args)
    try:
        return _run(args, device, config, initial_weights)
    finally:
        if args.distributed:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, device, config=None, initial_weights=None):
    """The run of :func:`main` on parsed flags."""
    import torch

    from mapdn_torch.convert import state_from_npz
    from mapdn_torch.utils.checkpoint import restore_checkpoint
    from mapdn_torch.utils.logging import MetricsLogger

    cfg, env_dict, trainer = build_trainer(args, device, config)
    device = trainer.device
    world = getattr(trainer, "world_size", 1)
    is_main = getattr(trainer, "rank", 0) == 0
    if args.resume and world > 1:
        raise ValueError("--resume: a run of several processes writes no resume checkpoint")

    log_name = log_name_of(args)
    save_path = args.save_path.rstrip("/") + "/"
    model_dir = os.path.join(save_path, "model_save", log_name)
    tb_dir = os.path.join(save_path, "tensorboard", log_name)
    logger = None
    if is_main:
        os.makedirs(model_dir, exist_ok=True)
        logger = MetricsLogger(tb_dir)
        logger.log_config(cfg, env_dict, initial_weights=initial_weights
                          and os.path.relpath(initial_weights))
    print(f"{cfg}\n")
    print(f"device: {device} n_envs={cfg.n_envs} ranks={world}")

    ckpt_dir = os.path.join(model_dir, "checkpoint")
    summary = {"episode_s": [], "eval_s": [], "save_s": [], "restore_s": None,
               "stats": [], "start_episode": 0}
    if args.resume:
        # full-state resume: parameters, targets, optimizer, replay, env
        # state and the generator all live in the carry, so the restored run
        # continues the exact stat stream of the interrupted one
        (carry, steps, episodes), summary["restore_s"] = _timed(
            device, lambda: restore_checkpoint(ckpt_dir, trainer.carry))
        trainer.carry, trainer.steps, trainer.episodes = carry, steps, episodes
        summary["start_episode"] = episodes
        logger.drop_after(episodes)
        print(f"resumed from {ckpt_dir} at episode {episodes} ({steps} env steps)")
    elif initial_weights:
        # optimizer states, targets (copies) and the generator as a fresh run
        # makes them, around the given parameters
        trainer.carry.algo = state_from_npz(trainer.model, initial_weights)
        print(f"initial weights from {initial_weights}")

    t0 = time.time()
    steps0 = trainer.steps
    for i in range(summary["start_episode"], cfg.train_episodes_num):
        stat, dt = _timed(device, trainer.run_episode)
        summary["episode_s"].append(dt)
        if i % cfg.eval_freq == cfg.eval_freq - 1 or i == 0:
            ev, dt = _timed(device, trainer.evaluate)
            stat.update(ev)
            summary["eval_s"].append(dt)
        summary["stats"].append(stat)
        if not is_main:
            continue
        logger.log(stat, trainer.episodes)
        if i % cfg.save_model_freq == cfg.save_model_freq - 1:
            env_sps = ((trainer.steps - steps0) * cfg.n_envs) / (time.time() - t0)
            print(f"\nEpisode: {trainer.episodes}  ({env_sps:,.0f} env-steps/s aggregate)")
            for k, v in sorted(stat.items()):
                print(f"{k}: {v:2.4f}")
            summary["save_s"].append(_timed(device, lambda: _save(model_dir, ckpt_dir, trainer))[1])
            print("The model is saved!\n")
    if is_main and cfg.train_episodes_num % cfg.save_model_freq != 0:
        # final save: a run shorter than (or not divisible by) the save
        # cadence still leaves a loadable model.pt and a resumable checkpoint
        summary["save_s"].append(_timed(device, lambda: _save(model_dir, ckpt_dir, trainer))[1])
    with torch.no_grad():
        norm = sum(float(p.abs().sum()) for p in trainer.carry.algo.policy.parameters())
    # every rank prints this (the ranks' parameters must agree)
    print(f"final_policy_param_l1: {norm:.10e}", flush=True)
    if logger is not None:
        logger.close()
    summary.update(final_policy_param_l1=norm, episodes=trainer.episodes,
                   n_envs=cfg.n_envs, max_steps=cfg.max_steps,
                   model_dir=model_dir, tb_dir=tb_dir, world_size=world)
    return summary


if __name__ == "__main__":
    main()
