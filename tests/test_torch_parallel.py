"""ShardedPGTrainer over 2 gloo processes against the single-process
PGTrainer on the same seed, float64, on the CPU: the counterpart of
tests/test_parallel.py (its five profiles, :81-88) and
tests/test_multiprocess.py (the CLI's --distributed run).

The module starts its own workers (``python tests/test_torch_parallel.py
--worker RANK PORT OUT``): both ranks run every profile and save each
rank's carry and stats; the tests hold rank r's carry to rank r's lanes of
the single-process carry (``shard_carry``), every leaf and stat within
rtol/atol 1e-9, with no explicit draws.  Imports no JAX."""
import dataclasses
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mapdn_torch.algos import make_model  # noqa: E402
from mapdn_torch.envs import EnvConfig, make_env  # noqa: E402
from mapdn_torch.learn.trainer import PGTrainer  # noqa: E402
from mapdn_torch.parallel import ShardedPGTrainer, lane_range, shard_carry  # noqa: E402
from mapdn_torch.utils import lanes  # noqa: E402
from mapdn_torch.utils.config import load_config  # noqa: E402
from mapdn_torch.utils.lanes import LaneShard  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
TOL = 1e-9
# name -> (alg, env/config options, program); the five of tests/test_parallel.py
# (maddpg as a whole episode: its two chunks and the soft target update),
# then three that reach what those do not: a lane of rank 0 alone diverging
# on the first step (its auto-reset draws on rank 0 only, unless the flag
# is global), the update drawing 2 of 8 lanes (a rank may hold none), and
# advantages standardized over the whole batch inside the policy gradient
# (the autograd all-reduce of batchnorm's sums)
PROFILES = {
    "maddpg-episode": ("maddpg", {}, "episode"),
    "mappo": ("mappo", {}, "chunks"),
    "facmaddpg": ("facmaddpg", {}, "chunks"),
    "coma-episodic": ("coma", {"episodic": True}, "chunks"),
    "maddpg-decentralised": ("maddpg", {"mode": "decentralised"}, "chunks"),
    "mappo-rank0-diverges": ("mappo", {"diverge_lane0": True}, "chunks"),
    "maddpg-2-update-lanes": ("maddpg", {"update_lanes": 2}, "chunks"),
    "maddpg-normalized-advantages": ("maddpg", {"normalize_advantages": True}, "chunks"),
}


def build(alg, *, sharded, n_envs=8, mode="distributed", episodic=False,
          update_lanes=None, normalize_advantages=None, **_):
    """tests/test_parallel.py's configuration (case33, episodes of 16
    steps, chunks of 4, batches of 4, 2 value epochs and 1 policy epoch)
    at 8 lanes, float64, set up on seed 0."""
    env = make_env("case33", EnvConfig(episode_limit=16, mode=mode), days=8,
                   dtype=torch.float64, device="cpu")
    info = env.get_env_info()
    cfg, _ = load_config(alg)
    cfg = cfg.replace(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], max_steps=8, behaviour_update_freq=4,
        batch_size=4, value_update_epochs=2, policy_update_epochs=1,
        replay_buffer_size=64, n_envs=n_envs, num_eval_episodes=2, hid_size=32,
        episodic=episodic, update_lanes=update_lanes)
    if normalize_advantages is not None:
        cfg = cfg.replace(normalize_advantages=normalize_advantages)
    model = make_model(alg, cfg, device="cpu", param_dtype=torch.float64)
    return (ShardedPGTrainer if sharded else PGTrainer)(cfg, model, env).setup(seed=0)


def run(trainer, opts, program):
    """Two chunks (or one episode of two), coma's episodic update, and an
    eval; returns (carry, stats as floats)."""
    if opts.get("diverge_lane0") and getattr(trainer, "lo", 0) == 0:
        trainer.carry.env_state.load_p[0] *= 1e4   # unsolvable: lane 0 diverges
    carry = trainer.carry
    if program == "episode":
        carry, stats = trainer._train_episode(carry)
    else:
        carry, first = trainer._train_chunk(carry)
        carry, stats = trainer._train_chunk(carry)
        stats["first_chunk_destroy"] = first["mean_train_destroy"]
    if trainer.cfg.episodic:
        carry, upd = trainer._episodic_update(carry)
        stats = {**stats, **upd}
    trainer.carry = carry
    stats.update(trainer.evaluate())
    return carry, {k: float(v) for k, v in stats.items()}


def carry_tensors(carry):
    """Every tensor of a carry by name, and its host counters."""
    out = {f"env_state.{f.name}": getattr(carry.env_state, f.name)
           for f in dataclasses.fields(carry.env_state)}
    out.update(obs=carry.obs, last_hid=carry.last_hid,
               generator=carry.generator.get_state())
    for name in ("policy", "value", "target_policy", "target_value", "mixer",
                 "target_mixer"):
        module = getattr(carry.algo, name)
        for k, v in (module.state_dict().items() if module is not None else ()):
            out[f"algo.{name}.{k}"] = v
    for name in ("policy_opt", "value_opt", "mixer_opt"):
        for i, v in enumerate(getattr(carry.algo, name)):
            out[f"algo.{name}.{i}"] = v
    for f in dataclasses.fields(carry.replay.data):
        out[f"replay.{f.name}"] = getattr(carry.replay.data, f.name)
    return {k: v.detach().clone() for k, v in out.items()}, (
        carry.replay.ptr, carry.replay.size, carry.steps)


def worker(rank, port, out):
    """One rank: every profile, sharded over the gloo group."""
    from mapdn_torch.parallel import init_process_group

    init_process_group(f"localhost:{port}", WORLD, rank, "gloo")
    try:
        results = {}
        for name, (alg, opts, program) in PROFILES.items():
            trainer = build(alg, sharded=True, **opts)
            carry, stats = run(trainer, opts, program)
            results[name] = (*carry_tensors(carry), stats)
        try:
            build("iddpg", sharded=True, n_envs=7)
        except ValueError as exc:
            results["uneven"] = str(exc)
        # a flag that holds on rank 0's lane only, read by each rank
        with LaneShard(torch.tensor([rank]), WORLD).active():
            flag = torch.tensor([rank == 0])
            results["flags"] = (lanes.any_lane(flag), lanes.all_lanes(flag))
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args_for, timeout=600):
    """Start one process a rank and wait for all; as soon as one fails,
    stop the others (a rank left alone waits in a collective until its
    timeout). Returns their outputs."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(WORLD)]
        procs = [subprocess.Popen(args_for(r), cwd=ROOT, stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        deadline = time.monotonic() + timeout
        try:
            while (any(p.poll() is None for p in procs) and time.monotonic() < deadline
                   and not any(p.returncode for p in procs)):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    _spawn(lambda r: [sys.executable, os.path.abspath(__file__), "--worker",
                      str(r), str(port), str(tmp / f"rank{r}.pt")])
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("name", list(PROFILES))
def test_sharded_run_matches_single_process(ranks, name):
    """Each rank's carry is its lanes of the single-process carry (the
    learner and generator whole), and its stats the single process's, all
    within 1e-9 at float64 (the all-reduce sums the ranks' shares in
    another order); the ranks' learners are bitwise equal."""
    alg, opts, program = PROFILES[name]
    ref_carry, ref_stats = run(build(alg, sharded=False, **opts), opts, program)
    for rank in range(WORLD):
        tensors, counters, stats = ranks[rank][name]
        want, want_counters = carry_tensors(shard_carry(ref_carry, WORLD, rank))
        assert counters == want_counters and set(tensors) == set(want)
        for k in want:
            torch.testing.assert_close(tensors[k], want[k], rtol=TOL, atol=TOL,
                                       msg=f"rank {rank} {k}")
        assert set(stats) == set(ref_stats)
        for k, v in ref_stats.items():
            assert math.isclose(stats[k], v, rel_tol=TOL, abs_tol=TOL), (rank, k, stats[k], v)
    learner = [k for k in ranks[0][name][0] if k.startswith("algo.")]
    for k in learner:
        assert torch.equal(ranks[0][name][0][k], ranks[1][name][0][k]), k
    if opts.get("diverge_lane0"):
        assert ref_stats["first_chunk_destroy"] > 0.0    # lane 0 did diverge
        assert not bool(ranks[1][name][0]["env_state.terminated"].any())


def test_uneven_lanes_rejected(ranks):
    assert "not divisible by world size 2" in ranks[0]["uneven"]
    with pytest.raises(ValueError, match="not divisible"):
        lane_range(12, 8, 0)
    assert lane_range(16, 2, 1) == (8, 16)


def test_host_flags_are_global(ranks):
    """The auto-reset's and the reset retry's flags (``any_lane``,
    ``all_lanes``) read alike on every rank: a lane of rank 0 alone sets
    them."""
    assert [r["flags"] for r in ranks] == [(True, False)] * WORLD


def test_sharded_trainer_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        build("iddpg", sharded=True)


def test_cli_distributed_two_processes(tmp_path):
    """``python -m mapdn_torch.train --distributed`` with 2 gloo processes
    for one episode: each rank's final policy is the single-process run's
    (tests/test_multiprocess.py:47-75), and rank 0 alone writes its logs
    and model.pt, and no resume checkpoint."""
    port = _free_port()
    flags = ["--platform", "cpu", "--alg", "iddpg", "--n-envs", "4", "--episodes", "1",
             "--max-steps", "4", "--days", "2"]
    outs = _spawn(lambda r: [sys.executable, "-m", "mapdn_torch.train", *flags,
                             "--distributed", "--coordinator", f"localhost:{port}",
                             "--num-processes", str(WORLD), "--process-id", str(r),
                             "--save-path", str(tmp_path / f"r{r}")])
    norms = [line for out in outs for line in out.splitlines()
             if line.startswith("final_policy_param_l1")]
    single = subprocess.run([sys.executable, "-m", "mapdn_torch.train", *flags,
                             "--save-path", str(tmp_path / "single")], cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
    assert single.returncode == 0, single.stderr
    want = [line for line in single.stdout.splitlines()
            if line.startswith("final_policy_param_l1")]
    assert norms == want * WORLD, (norms, want)
    log = "var_voltage_control-case33_3min_final-distributed-iddpg-l1"
    assert os.path.isfile(tmp_path / "r0" / "tensorboard" / log / "metrics.jsonl")
    assert os.path.isfile(tmp_path / "r0" / "model_save" / log / "model.pt")
    assert not os.path.exists(tmp_path / "r0" / "model_save" / log / "checkpoint")
    assert not os.path.exists(tmp_path / "r1")


def test_cli_distributed_refusals(tmp_path):
    """Without the rendezvous flags, and with more NCCL ranks than cards
    (none here), the CLI raises before it trains."""
    from mapdn_torch import train
    from mapdn_torch.parallel import init_process_group

    with pytest.raises(ValueError, match="--coordinator"):
        train.main(["--platform", "cpu", "--distributed", "--save-path", str(tmp_path)])
    with pytest.raises(ValueError, match="need --distributed"):
        train.main(["--platform", "cpu", "--process-id", "0", "--save-path", str(tmp_path)])
    with pytest.raises(ValueError, match="one card a rank"):
        init_process_group("localhost:1", 2, 0, "nccl")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    torch.set_num_threads(1)
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
