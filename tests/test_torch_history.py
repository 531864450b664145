"""``EnvConfig.history > 1`` (frame stacking) in mapdn_torch against the JAX
package, at float64 on the CPU.

With ``history=3`` an agent's observation is its last three base frames,
oldest first; ``obs_hist`` holds the two before the newest, zeros at a
reset (mapdn_tpu/envs/voltage_control.py:319-321, :511-517;
mapdn_torch/envs/voltage_control.py:308-310, :484-490).  Held to the JAX
env on replayed draws: a reset of 4 lanes, then steps of 3-step episodes
through ``batched_auto_reset_step``, so every lane auto-resets at the
second step and its stack restarts from zeros; every state field,
``obs_hist`` included, and the obs within 1e-10 (rtol 1e-9), the
tolerances of tests/test_torch_env.py.  Also the port's mirrors of
tests/test_coverage_paths.py:79 (obs against a hand-rolled stack) and
:105 (an iddpg episode with history=3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.algos import make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from test_torch_env import _assert_out_close, _step_noise, _to_torch_state

torch.set_num_threads(1)

HIST, LANES = 3, 4


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other
    with threadpool_limits(1, user_api="blas"):
        yield


def _reset_draws(jenv, keys):
    """Each lane's first reset attempt as JAX ``reset`` draws it from its
    key (voltage_control.py:331-334, :289-298)."""
    t0, attempts = [], []
    for k in keys:
        _, k1, k2 = jax.random.split(k, 3)
        t0.append(int(jenv._sample_start(k1)))
        attempts.append(k2)
    kn_ka = [jax.random.split(k) for k in attempts]
    return {"t0": np.array(t0),
            "noise": _step_noise(jenv, [kn for kn, _ in kn_ka]),
            "a0": np.stack([np.asarray(jax.random.uniform(
                ka, (jenv.grid.n_sgen,), jnp.float64, jenv.action_low, jenv.action_high))
                for _, ka in kn_ka])}


def _auto_reset_draws(jenv, keys):
    """The draws of JAX ``batched_auto_reset_step`` from its lane keys
    (voltage_control.py:586-587, :282-298)."""
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    k_step, k_reset, k_t = ks[:, 0], ks[:, 1], ks[:, 2]
    kn_ka = jax.vmap(jax.random.split)(k_reset)
    return {"step_noise": _step_noise(jenv, k_step),
            "t0": np.array(jax.vmap(jenv._sample_start)(k_t)),
            "reset_noise": _step_noise(jenv, kn_ka[:, 0]),
            "a0": np.stack([np.asarray(jax.random.uniform(
                k, (jenv.grid.n_sgen,), jnp.float64, jenv.action_low, jenv.action_high))
                for k in kn_ka[:, 1]])}


@pytest.fixture(scope="module")
def envs():
    cfg = dict(episode_limit=3, history=HIST)
    jenv = jax_make_env("case33", JaxEnvConfig(**cfg), days=8, dtype=jnp.float64)
    tenv = make_env("case33", EnvConfig(**cfg), days=8, dtype=torch.float64, device="cpu")
    return jenv, tenv


def _split_frames(env, obs):
    """(L, n, HIST * base) obs as (L, n, HIST, base) frames, oldest first."""
    return obs.reshape(obs.shape[0], env.n_agents, HIST, env.obs_base_size)


def test_history_reset_matches_jax(envs):
    """A reset stacks two zero frames before the first: obs_hist zeros
    pushed once, every field equal to the JAX reset's."""
    jenv, tenv = envs
    assert tenv.obs_size == jenv.obs_size == HIST * tenv.obs_base_size
    keys = jax.random.split(jax.random.PRNGKey(7), LANES)
    jstate, jobs, jgs = jax.jit(jax.vmap(jenv.reset))(keys)
    state, obs, gs = tenv.reset(LANES, draws=_reset_draws(jenv, keys))
    assert not bool(state.terminated.any())     # every first attempt solved
    for name in (f.name for f in dataclasses.fields(EnvState)):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=1e-9, atol=1e-10)
    frames = _split_frames(tenv, obs)
    assert bool((frames[:, :, :2] == 0).all())
    assert torch.equal(frames[:, :, 2], tenv._base_obs(state))
    assert state.obs_hist.shape == (LANES, HIST - 1, tenv.n_agents, tenv.obs_base_size)


def test_history_step_and_auto_reset_match_jax(envs):
    """Three auto-reset steps of 3-step episodes from the JAX reset: the
    second terminates every lane, whose fresh episode restarts its stack
    (obs = two zero frames and the fresh frame); the third pushes on it.
    Every output equal to JAX's ``batched_auto_reset_step``."""
    jenv, tenv = envs
    jstates, jobs, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(7), LANES))
    tstates, prev_obs = _to_torch_state(jstates), torch.as_tensor(np.array(jobs))
    acts = np.random.RandomState(1).uniform(-0.8, 0.8, (3, LANES, tenv.grid.n_sgen))
    jstep = jax.jit(jenv.batched_auto_reset_step)
    for step, key in enumerate(jax.random.split(jax.random.PRNGKey(4), 3)):
        keys = jax.random.split(key, LANES)
        jout = jstep(jstates, jnp.asarray(acts[step]), keys)
        tout = tenv.batched_auto_reset_step(tstates, torch.tensor(acts[step]),
                                            draws=_auto_reset_draws(jenv, keys))
        assert bool(tout.terminated.all()) == (step == 1)
        _assert_out_close(tout, jout)
        frames = _split_frames(tenv, tout.obs)
        if step == 1:       # every lane reset: its stack restarts
            assert bool((frames[:, :, :2] == 0).all())
            assert bool((tout.state.obs_hist[:, 0] == 0).all())
        else:               # the frame before the newest is the last obs's newest
            prev = _split_frames(tenv, prev_obs)
            assert torch.equal(frames[:, :, :2], prev[:, :, 1:])
        assert torch.equal(frames[:, :, 2], tenv._base_obs(tout.state))
        prev_obs = tout.obs
        jstates, tstates = jout.state, tout.state
    assert tstates.step.tolist() == [2] * LANES


def test_history_stacking_matches_hand_rolled():
    """tests/test_coverage_paths.py:79 for the port: history=3 obs equal the
    per-agent concatenation of the last three base frames, oldest first."""
    env = make_env("case33", EnvConfig(episode_limit=8, history=HIST), days=8,
                   dtype=torch.float64, device="cpu")
    base = env.obs_base_size
    gen = torch.Generator().manual_seed(0)
    state, obs0, _ = env.reset(1, gen)
    frames = list(state.obs_hist[0])    # the stack before the next frame: zeros, f0
    zero, f0 = frames
    assert torch.equal(f0, env._base_obs(state)[0]) and not bool(zero.any())
    np.testing.assert_array_equal(
        obs0[0].numpy(), torch.stack([zero, zero, f0], 1).reshape(env.n_agents, -1).numpy())
    acts = torch.zeros((1, env.n_agents, 1), dtype=torch.float64)
    for t in range(3):
        out = env.step(state, env.translate_actions(acts), gen)
        frames.append(env._base_obs(out.state)[0])
        state = out.state
        want = torch.stack(frames[-HIST:], dim=1).reshape(env.n_agents, HIST * base)
        np.testing.assert_array_equal(out.obs[0].numpy(), want.numpy(), err_msg=f"step {t}")


def test_history_training_smoke():
    """tests/test_coverage_paths.py:105 for the port: an iddpg episode on
    history=3 observations gives finite stats."""
    env = make_env("case33", EnvConfig(episode_limit=6, history=HIST), days=4,
                   dtype=torch.float32, device="cpu")
    info = env.get_env_info()
    cfg, _ = load_config("iddpg", overrides=dict(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], max_steps=6, behaviour_update_freq=3,
        batch_size=3, value_update_epochs=1, policy_update_epochs=1,
        target_update_freq=6, n_envs=2, num_eval_episodes=2,
        replay_buffer_size=32, hid_size=16))
    assert cfg.obs_size == HIST * env.obs_base_size
    trainer = PGTrainer(cfg, make_model("iddpg", cfg, device="cpu"), env).setup(seed=0)
    stats = trainer.run_episode()
    assert np.isfinite(float(stats["mean_train_reward"]))
    assert np.isfinite(float(stats["mean_train_value_loss"]))
