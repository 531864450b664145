"""The eval path of mapdn_torch against the JAX package's, in float64 at
case33: ``PGTester.run`` (one day's telemetry), ``run_days`` (three days
from one shared reset action) and ``batch_run`` (the flat alive-weighted
mean and 2 std over all steps of all episodes) against JAX ``PGTester`` on
the same ``from_flax`` MAAC weights, with episodes of 8 steps inside 12,
so every lane terminates and its later steps are masked.  The JAX draws
(the reset action of ``manual_reset``'s PRNGKey(0), ``batch_run``'s resets
from PRNGKey(1)) are replayed into the port.

Also the repairs of the port against the JAX package: ``--data-path``
CSVs read as JAX reads them and the synthetic fallback for a path without
them, and the trainer's rollout value of a critic that returns a tuple or
per-sample values, or needs actions."""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.timeseries import TimeSeries, dataset_for_case
from mapdn_torch.learn.tester import PGTester
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.envs.timeseries import dataset_for_case as jax_dataset_for_case
from mapdn_tpu.learn.tester import PGTester as JaxPGTester
from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
from mapdn_tpu.utils.config import load_config as jax_load_config

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


ENV_CFG = dict(episode_limit=8)
MAX_STEPS, DAYS, EPISODES = 12, [1, 2, 3], 3
# float64 on both sides; the records pass through a few hundred Newton
# products and policy forwards
ATOL, RTOL = 1e-9, 1e-8


def _np(x):
    return np.array(x, np.float64)


def _lane_noise(env, keys):
    """The standard normals each lane's env draws from its key
    (voltage_control.py:248-255)."""
    g = env.grid
    noise = [[], [], []]
    for k in keys:
        for i, (kk, size) in enumerate(zip(jax.random.split(k, 3),
                                           (g.n_sgen, g.n_load, g.n_load))):
            noise[i].append(_np(jax.random.normal(kk, (size,), jnp.float64)))
    return tuple(np.stack(z) for z in noise)


def _reset_a0(env, key):
    """The reset action an attempt draws from its key
    (voltage_control.py:285, :290-294)."""
    return _np(jax.random.uniform(jax.random.split(key)[1], (env.grid.n_sgen,), jnp.float64,
                                  env.action_low, env.action_high))


def _batch_draws(env, n):
    """The first reset attempt of each of batch_run's lanes from
    PRNGKey(1) (tester.py:146-149; voltage_control.py:331-333)."""
    k_env, _ = jax.random.split(jax.random.PRNGKey(1))
    t0, attempts = [], []
    for k in jax.random.split(k_env, n):
        _, k1, k2 = jax.random.split(k, 3)
        t0.append(int(env._sample_start(k1)))
        attempts.append(k2)
    return {"reset": {"t0": np.array(t0),
                      "noise": _lane_noise(env, [jax.random.split(k)[0] for k in attempts]),
                      "a0": np.stack([_reset_a0(env, k) for k in attempts])}}


@pytest.fixture(scope="module")
def testers():
    jenv = jax_make_env("case33", JaxEnvConfig(**ENV_CFG), days=8, dtype=jnp.float64)
    info = jenv.get_env_info()
    over = dict(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                action_dim=info["n_actions"], max_steps=MAX_STEPS)
    jcfg, _ = jax_load_config("maac", overrides=over)
    jmodel = jax_make_model("maac", jcfg)
    algo = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                  jax.jit(jmodel.init_state)(jax.random.PRNGKey(3)))
    jtester = JaxPGTester(jcfg, jmodel, jenv, algo)

    tenv = make_env("case33", EnvConfig(**ENV_CFG), days=8, dtype=torch.float64,
                    device="cpu")
    tcfg, _ = load_config("maac", overrides=over)
    tmodel = make_model("maac", tcfg, device="cpu", param_dtype=torch.float64)
    policy, value = convert.from_flax(
        jax.tree_util.tree_map(_np, algo.policy_params),
        jax.tree_util.tree_map(_np, algo.value_params),
        tmodel.make_policy_module(), tmodel.make_value_module())
    ttester = PGTester(tcfg, tmodel, tenv, tmodel.state_from_modules(policy, value))
    return jenv, jtester, ttester


def test_single_day_record_matches_jax(testers):
    """The reset state and one entry per step up to the first terminal
    one (7 steps of an 8-step episode), every telemetry field."""
    jenv, jtester, ttester = testers
    want = jtester.run(2, 23, 2)
    a0 = _reset_a0(jenv, jax.random.PRNGKey(0))
    got = ttester.run(2, 23, 2, a0=a0)
    assert set(got) == set(want) == set(PGTester._SNAP_FIELDS)
    for k, entries in want.items():
        assert len(got[k]) == len(entries) == ENV_CFG["episode_limit"], k
        for t, (g, w) in enumerate(zip(got[k], entries)):
            assert isinstance(g, np.ndarray) and g.shape == np.shape(w), (k, t)
            np.testing.assert_allclose(g, _np(w), rtol=RTOL, atol=ATOL, err_msg=f"{k}[{t}]")


def test_day_sweep_matches_jax(testers):
    """Three days, one lane each, all from the one reset action JAX draws
    from PRNGKey(0) in every vmapped lane."""
    jenv, jtester, ttester = testers
    want = jtester.run_days(DAYS, 23, 2)
    got = ttester.run_days(DAYS, 23, 2, a0=_reset_a0(jenv, jax.random.PRNGKey(0)))
    assert set(got) == set(want) and "reward" in got and got["days"] == DAYS
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_manual_reset_shares_one_reset_action_across_days(testers):
    """Without an explicit ``a0`` every day's lane starts from the same
    draw (seed 0), as JAX's vmapped PRNGKey(0) does: the first day's lane
    of a sweep equals a lone reset of that day."""
    env = testers[2].env
    reset_action = lambda st: st.sgen_q / env.clip_reactive_power(
        torch.ones_like(st.pv_p), st.pv_p)             # sgen_q = cap(pv) * a0
    sweep = reset_action(env.manual_reset(torch.tensor(DAYS), 23, 2)[0])
    lone = reset_action(env.manual_reset(DAYS[0], 23, 2)[0])
    assert tuple(sweep.shape) == (len(DAYS), env.grid.n_sgen)
    for lane in range(len(DAYS)):
        torch.testing.assert_close(sweep[lane], lone[0], rtol=0, atol=1e-12)


def test_batch_run_matches_jax(testers):
    """Three random episodes; the flat mean and 2 std over every alive
    step of every episode (not a mean of per-episode means)."""
    jenv, jtester, ttester = testers
    want = jtester.batch_run(EPISODES)
    draws = _batch_draws(jenv, EPISODES)
    got = ttester.batch_run(EPISODES, draws=draws)
    assert set(got) == set(want) and "mean_test_q_loss" in got
    for k, (m, s2) in want.items():
        np.testing.assert_allclose(got[k], (m, s2), rtol=RTOL, atol=ATOL, err_msg=k)
    # every first reset attempt solved, so the replayed draws were all used
    state, _, _ = ttester.env.reset(EPISODES, draws=draws["reset"])
    assert not bool(state.terminated.any())


def _write_scenario(path, rows=240, seed=0):
    rng = np.random.RandomState(seed)
    for name, cols in (("pv_active.csv", 6), ("load_active.csv", 32),
                       ("load_reactive.csv", 32)):
        with open(os.path.join(path, name), "w") as f:
            f.write("time," + ",".join(f"c{i}" for i in range(cols)) + "\n")
            for r in range(rows):
                vals = rng.uniform(0.0, 2.0, cols)
                f.write(f"2020-01-01 {r}," + ",".join(f"{v:.6f}" for v in vals) + "\n")


def test_data_path_csvs_read_as_jax(tmp_path):
    """A scenario directory's CSVs (timestamp column dropped, PV and demand
    scaled) give the JAX package's TimeSeries, field for field, to 1e-14
    relative (both parse 6-decimal text; the parsers may round a last
    bit apart)."""
    _write_scenario(str(tmp_path))
    args = (np.ones(32), np.ones(32), np.ones(6))
    kw = dict(data_path=str(tmp_path), pv_scale=1.5, demand_scale=0.5)
    want = jax_dataset_for_case("case33", *args, dtype=jnp.float64, **kw)
    got = dataset_for_case("case33", *args, dtype=torch.float64, device="cpu", **kw)
    assert got.n_steps == want.n_steps == 240 and got.time_delta == want.time_delta
    for f in dataclasses.fields(TimeSeries):
        if f.name in ("n_steps", "time_delta"):
            continue
        np.testing.assert_allclose(getattr(got, f.name).numpy(), _np(getattr(want, f.name)),
                                   rtol=1e-14, atol=0, err_msg=f.name)


@pytest.mark.parametrize("where", ["missing", "no_csv"])
def test_data_path_without_csvs_falls_back_to_synthetic(tmp_path, where):
    """A path that is not a directory holding pv_active.csv gives the
    synthetic dataset, as JAX does (timeseries.py:130-135), not an error."""
    path = str(tmp_path / "nonexistent") if where == "missing" else str(tmp_path)
    env = make_env("case33", EnvConfig(), data_path=path, days=8, dtype=torch.float64,
                   device="cpu")
    synthetic = make_env("case33", EnvConfig(), days=8, dtype=torch.float64, device="cpu")
    jenv = jax_make_env("case33", JaxEnvConfig(), data_path=path, days=8, dtype=jnp.float64)
    for got, want in ((env.ts.pv, synthetic.ts.pv), (env.ts.load_p, synthetic.ts.load_p),
                      (env.ts.pv, _np(jenv.ts.pv))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("output", ["tuple", "samples", "needs_act"])
def test_rollout_value_handles_the_critic_output_as_jax(output):
    """The ring's rollout value: the first element of a tuple-valued
    critic, the mean over samples of a (b, s, n) one, and a refusal for a
    critic that needs actions (mapdn_tpu/learn/trainer.py:150-179)."""
    env = make_env("case33", EnvConfig(), days=8, dtype=torch.float64, device="cpu")
    info = env.get_env_info()
    cfg, _ = load_config("mappo", overrides=dict(
        agent_num=info["n_agents"], obs_size=info["obs_shape"], action_dim=1, n_envs=2,
        hid_size=8))
    model = make_model("mappo", cfg, device="cpu", param_dtype=torch.float64)
    trainer = PGTrainer(cfg, model, env)
    rng = np.random.RandomState(4)
    states = rng.randn(3, 2, info["n_agents"], info["obs_shape"])
    raw = {"tuple": (rng.randn(6, info["n_agents"]), rng.randn(info["n_agents"])),
           "samples": rng.randn(6, 5, info["n_agents"]),
           "needs_act": rng.randn(6, info["n_agents"])}[output]
    model.value = lambda module, obs, act: (
        tuple(torch.tensor(x) for x in raw) if output == "tuple" else torch.tensor(raw))
    jstub = types.SimpleNamespace(model=types.SimpleNamespace(
        value=lambda params, obs, act: (tuple(jnp.asarray(x) for x in raw)
                                        if output == "tuple" else jnp.asarray(raw)),
        rollout_value_needs_act=output == "needs_act"))
    jstub._rollout_value = lambda algo, obs, act: JaxPGTrainer._rollout_value(
        jstub, algo, obs, act)
    algo = types.SimpleNamespace(value=None, value_params=None)
    if output == "needs_act":
        model.rollout_value_needs_act = True
        with pytest.raises(AssertionError):
            JaxPGTrainer._rollout_values_all(jstub, algo, jnp.asarray(states))
        with pytest.raises(ValueError, match="needs actions"):
            trainer._rollout_values_all(algo, torch.tensor(states))
        return
    want = JaxPGTrainer._rollout_values_all(jstub, algo, jnp.asarray(states))
    got = trainer._rollout_values_all(algo, torch.tensor(states))
    assert tuple(got.shape) == tuple(want.shape) == (3, 2, info["n_agents"])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-15)
