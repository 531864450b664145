"""mapdn_torch's checkpoints and CLIs on the CPU: the checkpoint round
trip, kill-and-resume, generations and 9-digit names of
tests/test_subsystems.py ported to ``torch.save``,
``mapdn_torch.train.main`` end to end at case33 for every algorithm, and
``mapdn_torch.test.main`` in its three modes on a model that the training
CLI saved; and that the port imports neither JAX nor the JAX package."""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import test as test_cli
from mapdn_torch import train
from mapdn_torch.algos import MAPPO, make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.checkpoint import (
    load_model, restore_checkpoint, save_checkpoint, save_model)
from mapdn_torch.utils.config import load_config

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


def _tiny_trainer(seed=0, alg="mappo"):
    env = make_env("case33", EnvConfig(episode_limit=8), days=8,
                   dtype=torch.float32, device="cpu")
    info = env.get_env_info()
    cfg, _ = load_config(alg)
    cfg = cfg.replace(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], max_steps=8, behaviour_update_freq=4,
        batch_size=4, value_update_epochs=1, policy_update_epochs=1,
        replay_buffer_size=64, n_envs=2, num_eval_episodes=2, hid_size=32)
    model = MAPPO(cfg, device="cpu") if alg == "mappo" else make_model(alg, cfg, device="cpu")
    return env, model, cfg, PGTrainer(cfg, model, env).setup(seed=seed)


def _carry_tensors(carry):
    """Every tensor of a carry, by name, and its host-side counters."""
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
    return out, (carry.replay.ptr, carry.replay.size, carry.steps)


def _assert_carries_equal(a, b):
    ta, ca = _carry_tensors(a)
    tb, cb = _carry_tensors(b)
    assert ca == cb and set(ta) == set(tb)
    for k in ta:
        torch.testing.assert_close(ta[k], tb[k], rtol=0, atol=0, msg=k)


def test_checkpoint_roundtrip(tmp_path):
    env, model, cfg, trainer = _tiny_trainer()
    trainer.run_episode()

    mpath = str(tmp_path / "model.pt")
    save_model(mpath, trainer.carry.algo)
    restored = load_model(mpath, model.init_state(torch.Generator().manual_seed(123)))
    for name in ("policy", "value", "target_policy", "target_value"):
        for a, b in zip(getattr(trainer.carry.algo, name).parameters(),
                        getattr(restored, name).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    cpath = str(tmp_path / "ckpt")
    save_checkpoint(cpath, trainer.carry, trainer.steps, trainer.episodes)
    carry2, steps, episodes = restore_checkpoint(cpath, trainer.carry)
    assert steps == trainer.steps and episodes == trainer.episodes
    _assert_carries_equal(carry2, trainer.carry)
    # the restored state continues training
    trainer.carry = carry2
    stats = trainer.run_episode()
    assert math.isfinite(stats["mean_train_reward"])
    assert "mean_train_policy_loss" in stats


def test_checkpoint_roundtrip_with_mixer(tmp_path):
    """facmaddpg's mixer, mixer target and mixer optimizer state go through
    save_model / load_model and the resumable checkpoint; a mixer-less
    model.pt does not load into it."""
    _, model, _, trainer = _tiny_trainer(alg="facmaddpg")
    trainer.run_episode()
    trainer.run_episode()                   # the second episode updates
    algo = trainer.carry.algo
    assert float(algo.mixer_opt[0].abs().max()) > 0.0

    mpath = str(tmp_path / "model.pt")
    save_model(mpath, algo)
    restored = load_model(mpath, model.init_state(torch.Generator().manual_seed(123)))
    for name in ("mixer", "target_mixer"):
        for a, b in zip(getattr(algo, name).parameters(), getattr(restored, name).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    cpath = str(tmp_path / "ckpt")
    save_checkpoint(cpath, trainer.carry, trainer.steps, trainer.episodes)
    carry2, _, _ = restore_checkpoint(cpath, trainer.carry)
    _assert_carries_equal(carry2, trainer.carry)
    trainer.carry = carry2
    assert math.isfinite(trainer.run_episode()["mean_train_mixer_loss"])

    _, _, _, plain = _tiny_trainer()
    save_model(str(tmp_path / "plain.pt"), plain.carry.algo)
    with pytest.raises(ValueError, match="mixer"):
        load_model(str(tmp_path / "plain.pt"), model.init_state(torch.Generator()))


def test_kill_and_resume_matches_unkilled_run(tmp_path):
    """Train 3 episodes and checkpoint; a fresh trainer (another seed, as a
    new process after a kill) restores and trains 3 more: counters, stats
    and the whole carry match a straight 6-episode run bit for bit."""
    cdir = str(tmp_path / "ckpt")
    env, model, cfg, t_a = _tiny_trainer()
    for _ in range(3):
        t_a.run_episode()
    save_checkpoint(cdir, t_a.carry, t_a.steps, t_a.episodes)
    stats_a = [t_a.run_episode() for _ in range(3)]
    eval_a = t_a.evaluate()

    t_b = PGTrainer(cfg, model, env).setup(seed=99)
    carry, steps, episodes = restore_checkpoint(cdir, t_b.carry)
    t_b.carry, t_b.steps, t_b.episodes = carry, steps, episodes
    assert episodes == 3 and steps == t_a.steps - 3 * cfg.max_steps
    stats_b = [t_b.run_episode() for _ in range(3)]
    eval_b = t_b.evaluate()

    assert t_b.episodes == t_a.episodes and t_b.steps == t_a.steps
    assert stats_a == stats_b and eval_a == eval_b
    _assert_carries_equal(t_a.carry, t_b.carry)


def test_checkpoint_keeps_two_generations(tmp_path):
    """save_checkpoint prunes to the newest `keep` generations and restore
    picks the newest, falling back past a corrupt one."""
    cdir = str(tmp_path / "gens")
    _, _, _, trainer = _tiny_trainer()
    for ep in (1, 2, 3):
        save_checkpoint(cdir, trainer.carry, ep * 8, ep)
    assert sorted(os.listdir(cdir)) == ["ckpt_00000002", "ckpt_00000003"]
    _, steps, episodes = restore_checkpoint(cdir, trainer.carry)
    assert (steps, episodes) == (24, 3)

    with open(os.path.join(cdir, "ckpt_00000003"), "wb") as fh:
        fh.write(b"truncated")
    _, steps, episodes = restore_checkpoint(cdir, trainer.carry)
    assert (steps, episodes) == (16, 2)
    # a temporary file left by a crash mid-write is neither counted nor read
    open(os.path.join(cdir, "ckpt_00000004.tmp.1"), "wb").close()
    _, steps, episodes = restore_checkpoint(cdir, trainer.carry)
    assert (steps, episodes) == (16, 2)
    save_checkpoint(cdir, trainer.carry, 40, 5)
    assert sorted(os.listdir(cdir)) == ["ckpt_00000003", "ckpt_00000005"]


def test_checkpoint_nine_digit_generations(tmp_path):
    """Past 1e8 episodes the zero padding overflows to 9-digit names:
    pruning still counts them and restore ranks them numerically."""
    cdir = str(tmp_path / "gens9")
    _, _, _, trainer = _tiny_trainer()
    for ep in (99_999_998, 99_999_999, 100_000_000):
        save_checkpoint(cdir, trainer.carry, ep * 2, ep)
    assert set(os.listdir(cdir)) == {"ckpt_99999999", "ckpt_100000000"}
    _, steps, episodes = restore_checkpoint(cdir, trainer.carry)
    assert (steps, episodes) == (200_000_000, 100_000_000)


FLAGS = ["--platform", "cpu", "--alg", "mappo", "--scenario", "case33_3min_final",
         "--n-envs", "4", "--max-steps", "10"]
LOG_NAME = "var_voltage_control-case33_3min_final-distributed-mappo-l1"


def _records(save_path):
    with open(os.path.join(save_path, "tensorboard", LOG_NAME, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def test_cli_layout_logs_and_resume(tmp_path):
    """Two episodes, then --resume to a third: the layout of train.py, the
    logs, the final save, and a resumed stat stream equal to an unkilled
    three-episode run's."""
    killed, straight = str(tmp_path / "killed"), str(tmp_path / "straight")
    first = train.main(FLAGS + ["--episodes", "2", "--save-path", killed])
    model_dir = os.path.join(killed, "model_save", LOG_NAME)
    assert first["model_dir"] == os.path.join(killed + "/", "model_save", LOG_NAME)
    assert os.path.isfile(os.path.join(model_dir, "model.pt"))
    assert os.listdir(os.path.join(model_dir, "checkpoint")) == ["ckpt_00000002"]
    with open(os.path.join(killed, "tensorboard", LOG_NAME, "log.txt")) as fh:
        text = fh.read()
    assert "alg_params:" in text and "\tn_envs: 4" in text and "env_params:" in text
    recs = _records(killed)
    assert [r["step"] for r in recs] == [1, 2]
    assert any(k.startswith("mean_test_") for k in recs[0])      # eval at episode 0
    assert not any(k.startswith("mean_test_") for k in recs[1])
    assert all(math.isfinite(v) for r in recs for v in r.values())

    resumed = train.main(FLAGS + ["--episodes", "3", "--resume", "--save-path", killed])
    assert resumed["start_episode"] == 2 and resumed["episodes"] == 3
    unkilled = train.main(FLAGS + ["--episodes", "3", "--save-path", straight])
    drop_time = lambda rs: [{k: v for k, v in r.items() if k != "time"} for r in rs]
    assert drop_time(_records(killed)) == drop_time(_records(straight))
    assert resumed["final_policy_param_l1"] == unkilled["final_policy_param_l1"]


@pytest.mark.parametrize("alg", ["iddpg", "maddpg", "matd3", "ippo", "iac", "coma",
                                 "sqddpg", "random"])
def test_cli_trains_each_ported_algorithm(tmp_path, alg):
    """One tiny episode with the episode-0 eval and the final save."""
    out = train.main(["--platform", "cpu", "--alg", alg, "--n-envs", "4",
                      "--max-steps", "10", "--episodes", "1",
                      "--save-path", str(tmp_path)])
    assert out["episodes"] == 1 and os.path.isfile(os.path.join(out["model_dir"], "model.pt"))
    (stat,) = out["stats"]
    assert "mean_train_reward" in stat and "mean_test_reward" in stat
    assert all(math.isfinite(v) for v in stat.values())


def test_cli_default_algorithm_runs(tmp_path):
    """No --alg: train.py's default, maddpg."""
    out = train.main(["--platform", "cpu", "--n-envs", "4", "--max-steps", "10",
                      "--episodes", "1", "--save-path", str(tmp_path)])
    assert out["episodes"] == 1 and "-maddpg-" in out["model_dir"]


def test_cli_off_policy_resume_matches_unkilled_run(tmp_path):
    """maddpg killed after 2 episodes and resumed to 4, against a straight
    4-episode run: the off-policy ring (40 steps of 4 lanes by the 4th
    episode, the first update) and the generator that draws its window
    come back from the checkpoint, so the stats and the policy are equal
    bit for bit."""
    flags = ["--platform", "cpu", "--alg", "maddpg", "--n-envs", "4", "--max-steps", "10"]
    killed, straight = str(tmp_path / "killed"), str(tmp_path / "straight")
    train.main(flags + ["--episodes", "2", "--save-path", killed])
    resumed = train.main(flags + ["--episodes", "4", "--resume", "--save-path", killed])
    unkilled = train.main(flags + ["--episodes", "4", "--save-path", straight])
    assert resumed["start_episode"] == 2 and resumed["episodes"] == 4
    assert unkilled["stats"][2:] == resumed["stats"]
    assert unkilled["stats"][3]["mean_train_value_loss"] > 0.0       # updated
    assert unkilled["stats"][2]["mean_train_value_loss"] == 0.0      # not yet
    assert resumed["final_policy_param_l1"] == unkilled["final_policy_param_l1"]


@pytest.mark.parametrize("flags,match", [
    (["--alg", "mappo", "--distributed"], "--coordinator host:port"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, flags, match):
    """--distributed is ported (tests/test_torch_parallel.py); without its
    rendezvous flags it raises before it trains."""
    with pytest.raises(ValueError, match=match):
        train.main(["--platform", "cpu", "--save-path", str(tmp_path)] + flags)


@pytest.mark.parametrize("flags", [
    ["--alg", "maac"],
    ["--alg", "facmaddpg"],
    ["--alg", "mappo", "--data-path", "/nonexistent"],
], ids=["maac", "facmaddpg", "data-path-fallback"])
def test_cli_runs_what_it_used_to_refuse(tmp_path, flags):
    """maac and facmaddpg train (facmaddpg's mixer epochs among the
    stats), and a --data-path without CSVs falls back to the synthetic
    dataset as train.py does: two tiny episodes, the second updating."""
    out = train.main(["--platform", "cpu", "--n-envs", "4", "--max-steps", "10",
                      "--episodes", "4", "--save-path", str(tmp_path)] + flags)
    assert out["episodes"] == 4 and os.path.isfile(os.path.join(out["model_dir"], "model.pt"))
    assert all(math.isfinite(v) for stat in out["stats"] for v in stat.values())
    assert out["stats"][3]["mean_train_value_loss"] > 0.0
    if "facmaddpg" in flags:
        assert out["stats"][3]["mean_train_mixer_loss"] > 0.0
        assert out["stats"][0]["mean_train_mixer_loss"] == 0.0        # warm-up


TEST_FLAGS = ["--platform", "cpu", "--alg", "maac", "--scenario", "case33_3min_final",
              "--voltage-barrier-type", "bowl"]


@pytest.fixture(scope="module")
def trained_maac(tmp_path_factory):
    """A maac model.pt as ``python -m mapdn_torch.train`` saves it."""
    save = str(tmp_path_factory.mktemp("trained"))
    train.main(TEST_FLAGS + ["--n-envs", "4", "--max-steps", "10", "--episodes", "1",
                             "--save-path", save])
    return save


@pytest.mark.parametrize("mode,name,keys", [
    ("single", "day10", "telemetry"),
    ("day_sweep", "days10-12", "per_day"),
    ("batch", "batch", "aggregate"),
])
def test_test_cli_evaluates_a_trained_model(trained_maac, tmp_path, monkeypatch,
                                            mode, name, keys):
    """Each --test-mode on the saved weights: test.py's pickle in the
    working directory, under test.py's name, with the JAX PGTester's record
    layout (mapdn_tpu/learn/tester.py; its values are held to JAX's in
    tests/test_torch_tester.py)."""
    from mapdn_tpu.learn.tester import PGTester as JaxPGTester

    monkeypatch.chdir(tmp_path)
    out = test_cli.main(TEST_FLAGS + ["--save-path", trained_maac, "--test-mode", mode,
                                      "--sweep-days", "3", "--test-episodes", "3"])
    assert out["loaded"] and out["device"] == "cpu"
    log_name = "var_voltage_control-case33_3min_final-distributed-maac-bowl"
    path = tmp_path / f"test_record_{log_name}_{name}.pickle"
    assert out["out"] == path.name and os.path.isfile(path)
    with open(path, "rb") as fh:
        record = pickle.load(fh)
    info = {"percentage_of_v_out_of_control", "percentage_of_lower_than_lower_v",
            "percentage_of_higher_than_upper_v", "totally_controllable_ratio",
            "average_voltage_deviation", "average_voltage", "max_voltage_drop_deviation",
            "max_voltage_rise_deviation", "total_line_loss", "q_loss", "destroy"}
    if keys == "telemetry":         # the reset state and 479 steps of one day
        assert set(record) == set(JaxPGTester._SNAP_FIELDS)
        assert all(len(v) == 480 for v in record.values())
        assert record["bus_voltage"][0].shape == (33,)
        assert all(np.isfinite(x).all() for v in record.values() for x in v)
    elif keys == "per_day":
        assert set(record) == info | {"reward", "days"} and record["days"] == [10, 11, 12]
        assert all(len(v) == 3 and all(map(math.isfinite, v))
                   for k, v in record.items() if k != "days")
    else:
        assert set(record) == {"mean_test_" + k for k in info}
        assert all(len(v) == 2 and all(map(math.isfinite, v)) for v in record.values())


def test_test_cli_refuses_render(trained_maac, tmp_path, monkeypatch):
    """Named for the refusal it held before rendering was ported: ``--render``
    in ``single`` mode now writes the day's pickle, then at most 48 PNG
    frames of the day and their GIF under ``render_<log_name>_day<d>/``
    (test.py:99-104), and returns the frames' paths."""
    monkeypatch.chdir(tmp_path)
    out = test_cli.main(TEST_FLAGS + ["--save-path", trained_maac, "--render"])
    log_name = "var_voltage_control-case33_3min_final-distributed-maac-bowl"
    assert out["loaded"] and os.path.isfile(tmp_path / f"test_record_{log_name}_day10.pickle")
    frames = out["frames"]
    assert len(frames) == 48         # 480 states, every 10th
    outdir = tmp_path / f"render_{log_name}_day10"
    assert frames[0] == os.path.join(outdir.name, "step_0000.png")
    assert all(os.path.getsize(tmp_path / f) > 0 for f in frames)
    assert os.path.isfile(outdir / "replay.gif")


def test_cli_runs_on_the_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--alg", "mappo", "--save-path", str(tmp_path)])


def test_port_imports_no_jax():
    """Every module of mapdn_torch, and chip_smoke.py and bench_torch.py,
    import in a process where importing jax or mapdn_tpu
    fails, and so does importing matplotlib, PIL or pandas: the port
    imports those where it uses them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = sys.modules['mapdn_tpu'] = None\n"
        "sys.modules['matplotlib'] = sys.modules['PIL'] = sys.modules['pandas'] = None\n"
        "import mapdn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mapdn_torch.__path__, 'mapdn_torch.')]\n"
        "for name in names + ['chip_smoke', 'bench_torch']:\n"
        "    importlib.import_module(name)\n"
        "assert ({'mapdn_torch.algos.sqddpg', 'mapdn_torch.algos.maac',\n"
        "        'mapdn_torch.algos.facmaddpg', 'mapdn_torch.learn.tester',\n"
        "        'mapdn_torch.train', 'mapdn_torch.test',\n"
        "        'mapdn_torch.scripts.train_zoo', 'mapdn_torch.scripts.learning_report',\n"
        "        'mapdn_torch.envs.wrapper', 'mapdn_torch.code_examples',\n"
        "        'mapdn_torch.parallel', 'mapdn_torch.parallel.mesh',\n"
        "        'mapdn_torch.native', 'mapdn_torch.utils.profiling',\n"
        "        'mapdn_torch.traditional', 'mapdn_torch.traditional.droop',\n"
        "        'mapdn_torch.traditional.opf', 'mapdn_torch.envs.rendering',\n"
        "        'mapdn_torch.grid.converter'}\n"
        "       <= set(names))\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20
