"""The slice as a whole: one chunk of mapdn_torch's MAPPO PGTrainer against
JAX ``PGTrainer._train_chunk`` in float64, from the same initial carry, and
the greedy eval rollout against JAX ``PGTrainer._eval_rollout``.

case33 and case322 (distributed mode; case322 with the bowl barrier of
train_case322.sh), 4 lanes, chunk 5, batch_size 4 and replay_buffer_size 16 (a ring of
capacity 4 = batch_size refilled by the chunk: the stack-emit path of the
8192-lane configuration), update_lanes 2 (so windows gather lanes), 2 value
epochs and 1 policy epoch.  Every draw is replayed from the JAX key splits
and handed to the port: action noise (trainer.py:200, :211), env step noise
(voltage_control.py:586-587, :248-255) and the epochs' lane indices
(trainer.py:459, :363, :355, :307; replay.py:96, :110).  episode_limit is
longer than the chunk, so no reset fires (resets: tests/test_torch_env.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import MAPPO
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
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


L, CHUNK, LANES, HID = 4, 5, 2, 16
OVERRIDES = dict(n_envs=L, behaviour_update_freq=CHUNK, batch_size=4,
                 replay_buffer_size=16, update_lanes=LANES,
                 value_update_epochs=2, policy_update_epochs=1,
                 replay_bf16=False, hid_size=HID)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _np(x):
    return np.array(x, np.float64)


def _lane_noise(env, keys, dtype=jnp.float64):
    """The standard normals each lane's env draws from its key
    (voltage_control.py:248-255), of the env's ``dtype``."""
    g = env.grid
    noise = [[], [], []]
    for k in keys:
        for i, (kk, size) in enumerate(zip(jax.random.split(k, 3),
                                           (g.n_sgen, g.n_load, g.n_load))):
            noise[i].append(_np(jax.random.normal(kk, (size,), dtype)))
    return tuple(np.stack(z) for z in noise)


def _replay_draws(rng, env, cfg, dtype=jnp.float64):
    """The draws of one JAX _train_chunk, from its carry's rng, at the
    chunk's compute ``dtype``."""
    steps = []
    for _ in range(CHUNK):
        rng, k_act, k_env = jax.random.split(rng, 3)
        action_noise = jax.random.normal(k_act, (L, env.n_agents, 1), dtype)
        k_step = jax.vmap(lambda k: jax.random.split(k, 3))(
            jax.random.split(k_env, L))[:, 0]
        steps.append({"action_noise": _np(action_noise),
                      "env": {"step_noise": _lane_noise(env, k_step, dtype)}})
    rng, k_upd = jax.random.split(rng)
    kv, kp, _ = jax.random.split(k_upd, 3)

    def lanes(key, epochs):
        out = []
        for k in jax.random.split(key, epochs):
            k_samp, _ = jax.random.split(k)
            _, k_lane = jax.random.split(k_samp)
            out.append(np.asarray(jax.random.choice(k_lane, L, (LANES,), replace=False)))
        return np.stack(out)

    return {"steps": steps, "value_lanes": lanes(kv, cfg.value_update_epochs),
            "policy_lanes": lanes(kp, cfg.policy_update_epochs)}


ENV_CFG = {"case33": dict(episode_limit=240),
           "case322": dict(episode_limit=240, voltage_barrier_type="bowl")}


@pytest.fixture(scope="module", params=["case33", "case322"])
def chunk_pair(request):
    case = request.param
    jenv = jax_make_env(case, JaxEnvConfig(**ENV_CFG[case]), days=8,
                        dtype=jnp.float64)
    info = jenv.get_env_info()
    extra = dict(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                 action_dim=info["n_actions"])
    jcfg, _ = jax_load_config("mappo", overrides={**OVERRIDES, **extra})
    jtr = JaxPGTrainer(jcfg, jax_make_model("mappo", jcfg), jenv)
    carry = jax.jit(jtr.init_carry)(jax.random.PRNGKey(0))
    # float64 parameters and optimizer state: the JAX nets keep float32
    # parameters by default, which would round every update to float32
    carry = carry.replace(algo=_f64(carry.algo))
    draws = _replay_draws(carry.rng, jenv, jcfg)
    jout, jstats = jax.jit(jtr._train_chunk)(carry)

    tenv = make_env(case, EnvConfig(**ENV_CFG[case]), days=8,
                    dtype=torch.float64, device="cpu")
    tcfg, _ = load_config("mappo", overrides={**OVERRIDES, **extra})
    tmodel = MAPPO(tcfg, device="cpu", param_dtype=torch.float64)
    ttr = PGTrainer(tcfg, tmodel, tenv)
    policy, value = convert.from_flax(
        jax.tree_util.tree_map(_np, carry.algo.policy_params),
        jax.tree_util.tree_map(_np, carry.algo.value_params),
        tmodel.make_policy_module(), tmodel.make_value_module())
    env_state = EnvState(**{f.name: torch.as_tensor(np.array(getattr(carry.env_state, f.name)))
                            for f in dataclasses.fields(EnvState)})
    tcarry = ttr.carry_from(env_state, torch.tensor(_np(carry.obs)),
                            tmodel.state_from_modules(policy, value),
                            torch.Generator(), torch.tensor(_np(carry.last_hid)))
    tout, tstats = ttr._train_chunk(tcarry, draws)
    assert ttr._stack_emit and tout.replay.capacity == 4
    return tmodel, jout, jstats, tout, tstats


def test_chunk_rollout_matches_jax(chunk_pair):
    _, jout, jstats, tout, tstats = chunk_pair
    assert tout.steps == int(jout.steps) == CHUNK
    np.testing.assert_allclose(tout.obs.numpy(), _np(jout.obs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tout.last_hid.numpy(), _np(jout.last_hid), rtol=0, atol=1e-9)
    for f in dataclasses.fields(EnvState):
        np.testing.assert_allclose(getattr(tout.env_state, f.name).numpy(),
                                   _np(getattr(jout.env_state, f.name)),
                                   rtol=0, atol=1e-9, err_msg=f.name)
    # the ring after the chunk (cleared on-policy: only ptr/size reset)
    assert (tout.replay.ptr, tout.replay.size) == (int(jout.replay.ptr), int(jout.replay.size))
    for name in ("state", "action", "log_prob_a", "reward", "value", "next_value", "done"):
        np.testing.assert_allclose(getattr(tout.replay.data, name).numpy(),
                                   _np(getattr(jout.replay.data, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    for k in ("mean_train_reward", "mean_train_q_loss", "mean_train_total_line_loss"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=0,
                                   atol=1e-9, err_msg=k)


def test_chunk_update_matches_jax(chunk_pair):
    tmodel, jout, jstats, tout, tstats = chunk_pair
    assert set(tstats) == set(jstats)
    for k in ("mean_train_value_loss", "mean_train_policy_loss",
              "mean_train_value_grad_norm", "mean_train_policy_grad_norm",
              "mean_train_entropy"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-8,
                                   atol=1e-9, err_msg=k)
    algo = jout.algo
    pol, val = tmodel.make_policy_module, tmodel.make_value_module
    for module, tree, make, load in (
            (tout.algo.policy, algo.policy_params, pol, convert.load_flax_policy),
            (tout.algo.value, algo.value_params, val, convert.load_flax_critic),
            (tout.algo.target_policy, algo.target_policy_params, pol,
             convert.load_flax_policy),
            (tout.algo.target_value, algo.target_value_params, val,
             convert.load_flax_critic)):
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for (name, got), ref in zip(module.named_parameters(), want.parameters()):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                       rtol=0, atol=1e-8, err_msg=name)
    # optimizer second moments, in the flax tree's layout
    for nu, tree, make, load in (
            (tout.algo.value_opt, algo.value_opt[1][0].nu, tmodel.make_value_module,
             convert.load_flax_critic),
            (tout.algo.policy_opt, algo.policy_opt[1][0].nu, tmodel.make_policy_module,
             convert.load_flax_policy)):
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for got, ref in zip(nu, want.parameters()):
            np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=0, atol=1e-9)


def _eval_draws(key, env, cfg):
    """The draws of one JAX _eval_rollout from its key (trainer.py:534-558):
    each lane's first reset attempt (voltage_control.py:331-333, :290-298)
    and each step's env noise."""
    n_eval = cfg.num_eval_episodes
    k_env, k_roll = jax.random.split(key)
    t0, k_attempt = [], []
    for k in jax.random.split(k_env, n_eval):
        _, k1, k2 = jax.random.split(k, 3)
        t0.append(int(env._sample_start(k1)))
        k_attempt.append(k2)
    kn_ka = [jax.random.split(k) for k in k_attempt]
    reset = {"t0": np.array(t0),
             "noise": _lane_noise(env, [k[0] for k in kn_ka]),
             "a0": np.stack([_np(jax.random.uniform(
                 k[1], (env.grid.n_sgen,), jnp.float64, env.action_low,
                 env.action_high)) for k in kn_ka])}
    steps = []
    for k in jax.random.split(k_roll, cfg.max_steps):
        _, k_env = jax.random.split(k)
        steps.append({"step_noise": _lane_noise(env, jax.random.split(k_env, n_eval))})
    return {"reset": reset, "steps": steps}


@pytest.mark.parametrize("case", ["case33", "case322"])
def test_eval_rollout_matches_jax(case):
    """Greedy eval at float64, given the replayed draws: 3 lanes over 4
    steps of 3-step episodes, so every lane terminates and its later steps
    are masked out of the mean-of-means."""
    env_cfg = dict(ENV_CFG[case], episode_limit=3)
    jenv = jax_make_env(case, JaxEnvConfig(**env_cfg), days=8, dtype=jnp.float64)
    info = jenv.get_env_info()
    over = dict(OVERRIDES, agent_num=info["n_agents"], obs_size=info["obs_shape"],
                action_dim=info["n_actions"], num_eval_episodes=3, max_steps=4)
    jcfg, _ = jax_load_config("mappo", overrides=over)
    jtr = JaxPGTrainer(jcfg, jax_make_model("mappo", jcfg), jenv)
    algo = _f64(jtr.model.init_state(jax.random.PRNGKey(3)))
    key = jax.random.PRNGKey(5)
    jstats = jax.jit(jtr._eval_rollout)(algo, key)

    tenv = make_env(case, EnvConfig(**env_cfg), days=8, dtype=torch.float64, device="cpu")
    tcfg, _ = load_config("mappo", overrides=over)
    tmodel = MAPPO(tcfg, device="cpu", param_dtype=torch.float64)
    policy, value = convert.from_flax(
        jax.tree_util.tree_map(_np, algo.policy_params),
        jax.tree_util.tree_map(_np, algo.value_params),
        tmodel.make_policy_module(), tmodel.make_value_module())
    ttr = PGTrainer(tcfg, tmodel, tenv)
    draws = _eval_draws(key, jenv, jcfg)
    state, _, _ = tenv.reset(3, draws=draws["reset"])
    assert not bool(state.terminated.any())   # every first attempt solved
    tstats = ttr._eval_rollout(tmodel.state_from_modules(policy, value),
                               torch.Generator(), draws)
    assert set(tstats) == set(jstats) and "mean_test_reward" in tstats
    for k, v in jstats.items():
        np.testing.assert_allclose(float(tstats[k]), float(v), rtol=1e-9, atol=1e-10,
                                   err_msg=k)
