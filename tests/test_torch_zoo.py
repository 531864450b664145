"""The port's zoo and report scripts against the JAX package's, on the CPU:
``mapdn_torch.scripts.learning_report.curve_summary`` equal to
scripts/learning_report.py's on every committed JAX curve;
``random_baseline`` with JAX's draws replayed equal to the JAX function's;
``mapdn_torch.scripts.train_zoo`` writing the artifacts layout, skipping a
finished run and resuming a killed one without duplicate steps; and
``bench_torch.py``'s JSON line and termination tallies."""
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import bench_torch
from mapdn_torch.envs.voltage_control import VoltageControlEnv
from mapdn_torch.scripts import learning_report, train_zoo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CURVES = sorted(glob.glob(os.path.join(ROOT, "artifacts", "learning", "*", "metrics.jsonl")))


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def jax_report():
    """scripts/learning_report.py, which is not a package module."""
    spec = importlib.util.spec_from_file_location(
        "jax_learning_report", os.path.join(ROOT, "scripts", "learning_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", JAX_CURVES,
                         ids=[os.path.basename(os.path.dirname(p)) for p in JAX_CURVES])
def test_curve_summary_equals_jax(jax_report, path):
    assert learning_report.curve_summary(path) == jax_report.curve_summary(path)


def _random_baseline_draws(jenv, n, max_steps, seed):
    """The draws of the JAX ``random_baseline`` in its key order
    (scripts/learning_report.py:51-71): ``split(PRNGKey(seed))`` into the
    env keys and the roll keys; each lane's reset from its env key
    (voltage_control.py:331-333, :285-294); per step the action key and
    the lanes' step keys (voltage_control.py:248-255)."""
    g, f32 = jenv.grid, jnp.float32
    sizes = (g.n_sgen, g.n_load, g.n_load)

    def lane_noise(keys):
        return tuple(np.stack([np.asarray(jax.random.normal(jax.random.split(k, 3)[i],
                                                            (size,), f32)) for k in keys])
                     for i, size in enumerate(sizes))

    k_env, k_roll = jax.random.split(jax.random.PRNGKey(seed))
    t0, attempts = [], []
    for k in jax.random.split(k_env, n):
        _, k1, k2 = jax.random.split(k, 3)
        t0.append(int(jenv._sample_start(k1)))
        attempts.append(k2)
    kn_ka = [jax.random.split(k) for k in attempts]
    reset = {"t0": np.array(t0), "noise": lane_noise([kn for kn, _ in kn_ka]),
             "a0": np.stack([np.asarray(jax.random.uniform(
                 ka, (g.n_sgen,), f32, jenv.action_low, jenv.action_high)) for _, ka in kn_ka])}
    actions, noise = [], []
    for k in jax.random.split(k_roll, max_steps):
        k_act, k_step = jax.random.split(k)
        actions.append(np.asarray(jax.random.uniform(
            k_act, (n, g.n_sgen), f32, jenv.action_low, jenv.action_high)))
        noise.append(lane_noise(jax.random.split(k_step, n)))
    return {"reset": reset, "actions": np.stack(actions), "noise": noise}


def test_random_baseline_matches_jax(jax_report, monkeypatch):
    """4 episodes of 12 steps on case33, float32 on both sides (the JAX
    script builds its env in float32): every stat within 1e-5, but the
    line loss within 2e-5 (each branch's loss is the difference of its two
    end flows, so float32 rounding cancels: the two float32 sums lie 4.6e-6
    and 8.1e-6 from the port's float64 one), with no lane's reset retried
    (a retry draws from the generator, not from the replayed draws)."""
    n, max_steps, seed = 4, 12, 7
    want = jax_report.random_baseline("case33", n_episodes=n, max_steps=max_steps, seed=seed)
    draws = _random_baseline_draws(jax_report._build_env("case33"), n, max_steps, seed)
    attempts = []
    attempt = VoltageControlEnv._attempt_reset

    def counted(self, *args, **kw):
        attempts.append(1)
        return attempt(self, *args, **kw)

    monkeypatch.setattr(VoltageControlEnv, "_attempt_reset", counted)
    got = learning_report.random_baseline("case33", n_episodes=n, max_steps=max_steps,
                                          seed=seed, draws=draws, device="cpu")
    assert len(attempts) == 1
    assert set(got) == set(want)
    for k in want:
        tol = 2e-5 if k == "mean_test_total_line_loss" else 1e-5
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


ZOO_FLAGS = ["--platform", "cpu", "--n-envs", "4", "--max-steps", "10"]


def _steps(path):
    with open(path) as fh:
        return [json.loads(line)["step"] for line in fh]


def test_train_zoo_layout_skip_and_force(tmp_path, capsys):
    """A finished run leaves train_zoo.py's artifacts layout, is skipped on
    the next call and starts from a fresh file under --force."""
    out, work = str(tmp_path / "out"), str(tmp_path / "work")
    flags = ["mappo"] + ZOO_FLAGS + ["--episodes", "2", "--out", out, "--work", work]
    train_zoo.main(flags)
    curve = os.path.join(out, "mappo", "metrics.jsonl")
    assert sorted(os.listdir(os.path.join(out, "mappo"))) == ["log.txt", "metrics.jsonl"]
    assert _steps(curve) == [1, 2]
    with open(os.path.join(out, "mappo", "log.txt")) as fh:
        assert "\tn_envs: 4" in fh.read()
    record = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("{")][-1])
    assert record["run"] == "mappo" and record["episodes"] == 2

    before = os.path.getmtime(curve)
    train_zoo.main(flags)
    assert "[mappo] already present, skipping" in capsys.readouterr().out
    assert os.path.getmtime(curve) == before

    train_zoo.main(flags + ["--force"])
    assert _steps(curve) == [1, 2]
    summary = learning_report.curve_summary(curve)
    assert summary["n_episodes"] == 2 and summary["n_evals"] == 1


def test_train_zoo_resumes_a_killed_run_without_duplicate_steps(tmp_path):
    """A run killed after its checkpoint of episode 2 had logged episodes 3
    and 4: the next call resumes from the checkpoint, drops the killed
    run's records after it and logs 3 and 4 once."""
    out, work = str(tmp_path / "out"), str(tmp_path / "work")
    flags = ["maddpg"] + ZOO_FLAGS + ["--out", out, "--work", work]
    train_zoo.main(flags + ["--episodes", "2"])
    (tb,) = glob.glob(os.path.join(work, "maddpg", "tensorboard", "*", "metrics.jsonl"))
    with open(tb, "a") as fh:               # the killed run's last records
        for step in (3, 4):
            fh.write(json.dumps({"step": step, "killed": True}) + "\n")
        fh.write('{"step": 5, "kil')        # cut mid-line

    train_zoo.main(flags + ["--episodes", "4"])
    curve = os.path.join(out, "maddpg", "metrics.jsonl")
    with open(curve) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert not any("killed" in r for r in recs)
    assert train_zoo.is_done(curve, 4)


def test_train_zoo_runs_side_by_side(tmp_path, capsys):
    """--jobs 2: each run a child process, its output in --work/<run>.log,
    its record printed when it ends."""
    out, work = str(tmp_path / "out"), str(tmp_path / "work")
    train_zoo.main(["mappo", "iddpg", "--jobs", "2"] + ZOO_FLAGS
                   + ["--episodes", "1", "--out", out, "--work", work])
    printed = capsys.readouterr().out
    records = {json.loads(ln)["run"] for ln in printed.splitlines() if ln.startswith("{")}
    assert records == {"mappo", "iddpg"} and "zoo complete" in printed
    for run in ("mappo", "iddpg"):
        assert _steps(os.path.join(out, run, "metrics.jsonl")) == [1]
        assert os.path.isfile(os.path.join(work, f"{run}.log"))


def test_bf16_ab_summary_equals_jax(tmp_path):
    """``learning_report.bf16_ab_summary`` over the JAX package's four A/B
    curves laid out as the port's zoo writes them (``<alg>`` and
    ``bf16_ab/<alg>_bf16``) gives artifacts/bf16_ab/summary.json."""
    jax_ab = os.path.join(ROOT, "artifacts", "bf16_ab")
    for alg in learning_report.BF16_AB_ALGS:
        for run, dest in ((f"{alg}_f32", tmp_path / alg),
                          (f"{alg}_bf16", tmp_path / "bf16_ab" / f"{alg}_bf16")):
            dest.mkdir(parents=True)
            with open(os.path.join(jax_ab, run, "metrics.jsonl")) as src:
                (dest / "metrics.jsonl").write_text(src.read())
    with open(os.path.join(jax_ab, "summary.json")) as fh:
        want = json.load(fh)
    assert learning_report.bf16_ab_summary(str(tmp_path)) == want
    os.remove(tmp_path / "maddpg" / "metrics.jsonl")
    assert learning_report.bf16_ab_summary(str(tmp_path)) is None


def test_zoo_run_table():
    """The runs that start from the JAX package's weights name a committed
    file; the bf16 A/B runs are their float32 runs with ``replay_bf16`` set
    and their curves under ``bf16_ab/``."""
    for name, run in train_zoo.RUNS.items():
        if run.init:
            assert os.path.isfile(os.path.join(train_zoo.ART, run.init)), name
    assert {n for n, r in train_zoo.RUNS.items() if r.init} == (
        set(train_zoo.JAX_INIT) | {"mappo_bf16"})
    for alg in learning_report.BF16_AB_ALGS:
        run = train_zoo.RUNS[f"{alg}_bf16"]
        assert run == train_zoo.RUNS[alg]._replace(config=(("replay_bf16", True),),
                                                   group="bf16_ab")


def test_train_zoo_starts_from_jax_weights_and_bf16(tmp_path, monkeypatch):
    """A run of the table with initial weights starts its first episode from
    the file's parameters, with targets their copies, and names the file in
    its log.txt; a bf16 run logs ``replay_bf16: True`` and writes its curve
    under ``bf16_ab/``."""
    from mapdn_torch.algos import make_model
    from mapdn_torch.convert import state_from_npz
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.utils.config import load_config

    first, run_episode = [], PGTrainer.run_episode

    def recorded(self):
        if not first:
            first.append(self.carry.algo)
        return run_episode(self)

    monkeypatch.setattr(PGTrainer, "run_episode", recorded)
    out, work = str(tmp_path / "out"), str(tmp_path / "work")
    train_zoo.main(["mappo_bf16"] + ZOO_FLAGS + ["--episodes", "1", "--out", out,
                                                 "--work", work])
    with open(os.path.join(out, "bf16_ab", "mappo_bf16", "log.txt")) as fh:
        log = fh.read()
    assert "\treplay_bf16: True" in log
    assert log.rstrip().endswith("initial_weights: artifacts/learning_torch/jax_init/mappo.npz")

    cfg, _ = load_config("mappo", overrides=dict(agent_num=6, obs_size=38, action_dim=1))
    model = make_model("mappo", cfg, device="cpu")
    want = state_from_npz(model, os.path.join(train_zoo.ART, "jax_init", "mappo.npz"))
    (algo,) = first
    # the state the first episode started from: the file's weights, whose
    # targets (copies, not updated within 10 steps) still hold them
    port_draw = model.init_state(torch.Generator().manual_seed(train_zoo.SEED))
    for got, ref in zip(algo.target_policy.parameters(), want.policy.parameters()):
        assert torch.equal(got, ref)
    assert not all(torch.equal(a, b) for a, b in zip(want.policy.parameters(),
                                                     port_draw.policy.parameters()))


def test_bench_torch_prints_bench_line(capsys):
    bench_torch.main(["--platform", "cpu", "--n-envs", "4", "--episodes", "2"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(line)
    assert {"metric", "value", "unit", "vs_baseline", "baseline", "baseline_kind",
            "n_envs", "train_reward", "episode_s", "spread",
            "kernel_launches_per_episode", "card"} <= set(rec)
    assert rec["n_envs"] == 4 and len(rec["episode_s"]) == 2
    assert rec["episode_s"] == sorted(rec["episode_s"])
    assert rec["spread"] == rec["episode_s"][-1] / rec["episode_s"][0] >= 1.0
    assert rec["value"] > 0 and rec["baseline"] == 1097.1
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / rec["baseline"])


def test_bench_torch_measures_the_oracle_without_a_pin():
    """The fallback where BASELINE_ORACLE.json is absent: the float64 numpy
    oracle's solves/s on case33's base load."""
    from mapdn_torch.grid import make_case

    grid, load_p, load_q, _ = make_case("case33", device="cpu")
    assert bench_torch.measure_baseline_oracle(grid, load_p, load_q, repeats=2, trials=1) > 0


def test_bench_torch_counts_terminations():
    """``--terminations``' tallies over 5 steps of 3 case33 lanes with
    3-step episodes (the reset's solve is the first): every lane ends at
    steps 2 and 4, none diverges, and each of those two steps pays one
    reset solve."""
    from mapdn_torch.envs import EnvConfig, make_env

    env = make_env("case33", EnvConfig(episode_limit=3), days=2, seed=0,
                   dtype=torch.float64, device="cpu")
    tally = bench_torch.count_terminations(env)
    gen = torch.Generator().manual_seed(0)
    state, _, _ = env.reset(3, gen)
    actions = torch.zeros((3, env.grid.n_sgen), dtype=torch.float64)
    for _ in range(5):
        state = env.batched_auto_reset_step(state, actions, gen).state
    assert {k: int(v) for k, v in tally.items()} == {
        "failed_reset": 0, "diverged": 0, "episode_end": 6, "reset_steps": 2}
