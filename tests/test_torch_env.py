"""mapdn_torch environment vs the JAX package's: the committed golden
trajectory, batched steps and auto-resets against ``jax.vmap`` of the JAX
env with the same noise (replayed from the JAX key splits), destroy
semantics and both task modes' shapes."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env

torch.set_num_threads(1)


def _to_torch_state(js):
    return EnvState(**{f.name: torch.as_tensor(np.array(getattr(js, f.name)))
                       for f in dataclasses.fields(EnvState)})


def _step_noise(env, keys):
    """The standard normals JAX's step draws per lane
    (voltage_control.py:248-255)."""
    g = env.grid
    zs = []
    for k in keys:
        k1, k2, k3 = jax.random.split(k, 3)
        zs.append([jax.random.normal(k1, (g.n_sgen,), jnp.float64),
                   jax.random.normal(k2, (g.n_load,), jnp.float64),
                   jax.random.normal(k3, (g.n_load,), jnp.float64)])
    return tuple(np.stack([np.asarray(z[i]) for z in zs]) for i in range(3))


def _assert_out_close(tout, jout, atol=1e-10):
    for f in dataclasses.fields(EnvState):
        np.testing.assert_allclose(getattr(tout.state, f.name).numpy(),
                                   np.asarray(getattr(jout.state, f.name)),
                                   rtol=1e-9, atol=atol, err_msg=f.name)
    for name in ("obs", "global_state", "reward", "terminated"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-9, atol=atol, err_msg=name)
    assert set(tout.info) == set(jout.info)
    for k, v in jout.info.items():
        np.testing.assert_allclose(tout.info[k].numpy(), np.asarray(v),
                                   rtol=1e-9, atol=atol, err_msg=k)


def test_golden_trajectory_replay():
    """The committed 48-step no-noise manual_reset replay (tests/test_env.py)
    through the port's env, one lane, at the same tolerances."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_trajectory.json")
    with open(path) as f:
        gold = json.load(f)
    actions = np.asarray(gold["actions"])
    for dtype, rtol, atol in [(torch.float64, 1e-9, 1e-10),
                              (torch.float32, 2e-3, 2e-4)]:
        env = make_env("case33", EnvConfig(episode_limit=240, reset_action=False),
                       days=8, seed=0, dtype=dtype, device="cpu")
        state, obs, gs = env.manual_reset(gold["day"], gold["hour"], gold["quarter"])
        np.testing.assert_allclose(obs[0].numpy(), gold["obs0"], rtol=rtol, atol=atol)
        np.testing.assert_allclose(gs[0].numpy(), gold["state0"], rtol=rtol, atol=atol)
        wide = 5e-4 if dtype == torch.float32 else atol
        for t in range(gold["n_steps"]):
            out = env.step(state, torch.as_tensor(actions[t][None], dtype=dtype),
                           add_noise=False)
            state = out.state
            assert not bool(out.terminated[0])
            msg = f"dtype={dtype} step={t}"
            np.testing.assert_allclose(float(out.reward[0]), gold["rewards"][t],
                                       rtol=rtol, atol=atol, err_msg=msg)
            np.testing.assert_allclose(out.state.vm[0].numpy(), gold["vm"][t],
                                       rtol=rtol, atol=atol, err_msg=msg)
            np.testing.assert_allclose(out.obs[0].numpy(), gold["obs"][t],
                                       rtol=rtol, atol=wide, err_msg=msg)
            np.testing.assert_allclose(out.global_state[0].numpy(), gold["states"][t],
                                       rtol=rtol, atol=wide, err_msg=msg)
            np.testing.assert_allclose(
                float(out.info["total_line_loss"][0]), gold["info_total_line_loss"][t],
                rtol=rtol, atol=1e-3 if dtype == torch.float32 else atol, err_msg=msg)
            np.testing.assert_allclose(float(out.info["q_loss"][0]),
                                       gold["info_q_loss"][t], rtol=rtol,
                                       atol=atol, err_msg=msg)
            assert (float(out.info["percentage_of_v_out_of_control"][0])
                    == pytest.approx(gold["info_pct_out"][t], abs=1e-6)), msg


@pytest.fixture(scope="module")
def envs():
    cfg = dict(episode_limit=3)
    jenv = jax_make_env("case33", JaxEnvConfig(**cfg), days=8, dtype=jnp.float64)
    tenv = make_env("case33", EnvConfig(**cfg), days=8, dtype=torch.float64,
                    device="cpu")
    jstates, _, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(7), 4))
    return jenv, tenv, jstates


def test_batched_step_matches_jax_vmap(envs):
    jenv, tenv, jstates = envs
    lanes = 4
    acts = np.random.RandomState(0).uniform(-0.8, 0.8, (lanes, 6))
    keys = jax.random.split(jax.random.PRNGKey(8), lanes)
    jout = jax.jit(jax.vmap(jenv.step))(jstates, jnp.asarray(acts), keys)
    tout = tenv.step(_to_torch_state(jstates), torch.tensor(acts),
                     noise=_step_noise(jenv, keys))
    _assert_out_close(tout, jout)


def test_auto_reset_step_matches_jax(envs):
    """Two auto-reset steps with episode_limit=3: the second terminates every
    lane, so the warm-started reset attempt runs (reset draws replayed from
    voltage_control.py:586-587, :282-298)."""
    jenv, tenv, jstates = envs
    lanes = 4
    tstates = _to_torch_state(jstates)
    acts = np.random.RandomState(1).uniform(-0.8, 0.8, (2, lanes, 6))
    jstep = jax.jit(jenv.batched_auto_reset_step)
    for step, key in enumerate(jax.random.split(jax.random.PRNGKey(4), 2)):
        keys = jax.random.split(key, lanes)
        jout = jstep(jstates, jnp.asarray(acts[step]), keys)
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        k_step, k_reset, k_t = ks[:, 0], ks[:, 1], ks[:, 2]
        kn_ka = jax.vmap(jax.random.split)(k_reset)
        draws = {
            "step_noise": _step_noise(jenv, k_step),
            "t0": np.array(jax.vmap(jenv._sample_start)(k_t)),
            "reset_noise": _step_noise(jenv, kn_ka[:, 0]),
            "a0": np.stack([np.asarray(jax.random.uniform(
                k, (6,), jnp.float64, jenv.action_low, jenv.action_high))
                for k in kn_ka[:, 1]]),
        }
        tout = tenv.batched_auto_reset_step(tstates, torch.tensor(acts[step]),
                                            draws=draws)
        assert bool(tout.terminated.all()) == (step == 1)
        _assert_out_close(tout, jout)
        jstates, tstates = jout.state, tout.state
    assert tstates.step.tolist() == [1] * lanes


def test_destroy_semantics():
    """Forced divergence must penalize, roll back and terminate."""
    env = make_env("case33", EnvConfig(episode_limit=240), days=8,
                   dtype=torch.float64, device="cpu")
    state, _, _ = env.reset(2, torch.Generator().manual_seed(11))
    bad = state.replace(load_p=state.load_p * torch.tensor([[1e4], [1.0]], dtype=torch.float64),
                        load_q=state.load_q * torch.tensor([[1e4], [1.0]], dtype=torch.float64))
    out = env.step(bad, torch.zeros(2, 6, dtype=torch.float64),
                   torch.Generator().manual_seed(12))
    assert out.info["destroy"].tolist() == [1.0, 0.0]
    assert out.terminated.tolist() == [True, False]
    assert float(out.reward[0]) < -150.0 and float(out.reward[1]) > -10.0
    # rollback: voltages kept from the pre-action state
    np.testing.assert_array_equal(out.state.vm[0].numpy(), state.vm[0].numpy())
    assert not np.array_equal(out.state.vm[1].numpy(), state.vm[1].numpy())


def test_reset_retry_exhaustion_terminates():
    env = make_env("case33", EnvConfig(episode_limit=8, pf_max_iter=0,
                                       reset_retries=2),
                   days=4, dtype=torch.float64, device="cpu")
    state, obs, gs = env.reset(3, torch.Generator().manual_seed(0))
    assert state.terminated.all()
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(gs).all())


@pytest.mark.parametrize("mode", ["distributed", "decentralised"])
def test_task_mode_shapes_match_jax(mode):
    jenv = jax_make_env("case33", JaxEnvConfig(mode=mode, episode_limit=5),
                        days=4, dtype=jnp.float64)
    tenv = make_env("case33", EnvConfig(mode=mode, episode_limit=5), days=4,
                    dtype=torch.float64, device="cpu")
    assert tenv.get_env_info() == jenv.get_env_info()
    np.testing.assert_array_equal(tenv.avail_actions.numpy(),
                                  np.asarray(jenv.avail_actions))
    state, obs, gs = tenv.reset(2, torch.Generator().manual_seed(0))
    assert obs.shape == (2, jenv.n_agents, jenv.obs_size)
    assert gs.shape == (2, jenv.state_size)
    agent_actions = torch.ones((2, tenv.n_agents, tenv.n_actions), dtype=torch.float64)
    sgen = tenv.translate_actions(agent_actions)
    jsgen = jenv.translate_actions(jnp.ones((tenv.n_agents, tenv.n_actions)))
    np.testing.assert_allclose(sgen[0].numpy(), np.asarray(jsgen))
    out = tenv.step(state, sgen, torch.Generator().manual_seed(1))
    assert out.obs.shape == obs.shape and bool(torch.isfinite(out.reward).all())
