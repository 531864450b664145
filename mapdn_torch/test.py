"""Evaluation CLI of the PyTorch port, flag-compatible with the
repository's test.py (itself the reference's test.py):

    python -m mapdn_torch.test --alg maddpg --mode distributed \\
        --scenario case33_3min_final --test-mode single --test-day 10

One-day test episodes (``episode_limit`` and ``max_steps`` 480), the
port's own ``<save-path>/model_save/<log_name>/model.pt`` (as
``python -m mapdn_torch.train`` writes it), then one of three modes, each
pickling test.py's record under test.py's file name in the working
directory:

* ``single``: the telemetry of one day (``test_record_<log_name>_day<d>``);
  with ``--render``, then PNG frames of the day (at most 48) and a GIF in
  ``render_<log_name>_day<d>/`` (matplotlib, and Pillow for the GIF);
* ``day_sweep``: per-day means over ``--sweep-days`` days from
  ``--test-day`` (``..._days<first>-<last>``);
* ``batch``: each metric's mean and 2 std over ``--test-episodes`` random
  episodes (``..._batch``).

The run is on the GPU; ``--platform cpu`` runs it on the CPU.  ``main(argv)``
can be called in-process; it returns a summary of the run (with
``--render``, the frames' paths under ``frames``).
"""
from __future__ import annotations

import argparse
import os
import pickle
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a trained agent (PyTorch port).")
    parser.add_argument("--save-path", type=str, default="./")
    parser.add_argument("--alg", type=str, default="maddpg")
    parser.add_argument("--env", type=str, default="var_voltage_control")
    parser.add_argument("--alias", type=str, default="")
    parser.add_argument("--mode", type=str, default="distributed",
                        choices=["distributed", "decentralised"])
    parser.add_argument("--scenario", type=str, default="case33_3min_final")
    parser.add_argument("--voltage-barrier-type", type=str, default="l1")
    parser.add_argument("--test-mode", type=str, default="single",
                        choices=["single", "batch", "day_sweep"])
    parser.add_argument("--test-day", type=int, default=10)
    parser.add_argument("--sweep-days", type=int, default=28,
                        help="day_sweep: days [test-day, test-day + sweep-days)")
    parser.add_argument("--test-episodes", type=int, default=10)
    parser.add_argument("--data-path", type=str, default=None,
                        help="real MAPDN csv dataset directory")
    parser.add_argument("--days", type=int, default=40,
                        help="synthetic dataset length in days")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--render", action="store_true",
                        help="write PNG frames of the single-day replay")
    parser.add_argument("--platform", type=str, default=None,
                        help="torch device to run on (default: the GPU; "
                             "'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def build_tester(args):
    """(tester, log_name, loaded) of parsed flags: the one-day config, the
    env and the model on the flags' device, with the weights of the run's
    ``model.pt`` where it exists (``loaded``)."""
    import torch

    from mapdn_torch.algos import make_model
    from mapdn_torch.envs import make_env
    from mapdn_torch.learn.tester import PGTester
    from mapdn_torch.train import build_env_cfg, log_name_of
    from mapdn_torch.utils.checkpoint import load_model
    from mapdn_torch.utils.config import load_config
    from mapdn_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    cfg, env_dict = load_config(
        args.alg, env=args.env, scenario=args.scenario, mode=args.mode,
        voltage_barrier_type=args.voltage_barrier_type)
    # one-day test episodes (reference test.py:51-56)
    env_dict["episode_limit"] = 480
    cfg = cfg.replace(max_steps=480)
    env = make_env(args.scenario, build_env_cfg(env_dict),
                   data_path=args.data_path or env_dict.get("data_path"),
                   days=args.days, seed=args.seed, device=device)
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"])

    log_name = log_name_of(args)
    load_path = os.path.join(args.save_path, "model_save", log_name, "model.pt")
    model = make_model(args.alg, cfg, device=device)
    algo_state = model.init_state(torch.Generator().manual_seed(0))
    loaded = os.path.exists(load_path)
    if loaded:
        algo_state = load_model(load_path, algo_state)
        print(f"loaded checkpoint: {load_path}")
    else:
        print(f"WARNING: no checkpoint at {load_path}; evaluating an "
              "untrained (randomly initialized) policy")
    return PGTester(cfg, model, env, algo_state), log_name, loaded


def main(argv=None):
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns a dict
    with the output file, the record and the seconds the mode took."""
    import torch

    args = parse_args(argv)
    tester, log_name, loaded = build_tester(args)
    device = tester.env.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    if args.test_mode == "day_sweep":
        days = list(range(args.test_day, args.test_day + args.sweep_days))
        record = tester.run_days(days, 23, 2)
        out = f"test_record_{log_name}_days{days[0]}-{days[-1]}.pickle"
    elif args.test_mode == "single":
        record = tester.run(args.test_day, 23, 2)
        out = f"test_record_{log_name}_day{args.test_day}.pickle"
    else:
        record = tester.batch_run(args.test_episodes)
        out = f"test_record_{log_name}_{args.test_mode}.pickle"
    sync()
    seconds = time.perf_counter() - t0
    with open(out, "wb") as f:
        pickle.dump(record, f, pickle.HIGHEST_PROTOCOL)
    frames = None
    if args.test_mode == "day_sweep":
        rw = record["reward"]
        worst = days[min(range(len(rw)), key=lambda i: rw[i])]
        print(f"wrote {out}: {len(days)} days, mean reward "
              f"{sum(rw) / len(rw):.4f}, worst day {worst}")
    elif args.test_mode == "single":
        print(f"wrote {out} ({len(record['bus_voltage'])} steps)")
        if args.render:
            from mapdn_torch.envs.rendering import render_record
            frames = render_record(tester.env, record,
                                   f"render_{log_name}_day{args.test_day}")
            print(f"wrote {len(frames)} frames to {os.path.dirname(frames[0])}")
    else:
        print("Test Results:")
        for k, (m, s2) in sorted(record.items()):
            print(f"{k}: mean: {m:2.4f}, \t2std: {s2:2.4f}")
        print(f"wrote {out}")
    return {"out": out, "record": record, "seconds": seconds, "loaded": loaded,
            "device": str(device), "frames": frames}


if __name__ == "__main__":
    main()
