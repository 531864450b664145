"""mapdn_torch's PyMARL wrapper and code examples: the counterpart of
tests/test_wrapper.py (the reference's interaction demo), the wrapper's
trajectory against the JAX package's wrapper at float64 from one
``manual_reset`` under one fixed action sequence (no data noise and no
reset action, so neither side draws), its getters, its refusals, and
``python -m mapdn_torch.code_examples`` on the CPU."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import code_examples
from mapdn_torch.envs import EnvConfig, VoltageControlWrapper
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import VoltageControlWrapper as JaxVoltageControlWrapper

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10     # tests/test_torch_env.py's float64 tolerances
INFO_KEYS = {"percentage_of_v_out_of_control", "totally_controllable_ratio",
             "total_line_loss", "q_loss", "destroy"}


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_random_interaction_loop():
    """tests/test_wrapper.py's loop: reset, random actions, termination at
    the episode limit, the info keys and the avail mask's shape."""
    env = VoltageControlWrapper("case33", EnvConfig(episode_limit=6), days=8,
                                dtype=torch.float64, device="cpu")
    info = env.get_env_info()
    obs, state = env.reset()
    assert len(obs) == info["n_agents"]
    assert obs[0].shape == (info["obs_shape"],)
    assert state.shape == (info["state_shape"],)
    total = 0.0
    for t in range(10):
        actions = env.get_action()
        reward, terminated, step_info = env.step(actions)
        assert isinstance(reward, float) and isinstance(terminated, bool)
        assert all(isinstance(v, float) for v in step_info.values())
        total += reward
        assert set(step_info) >= INFO_KEYS
        if terminated:
            break
    assert terminated and t == 4
    assert np.isfinite(total)
    avail = env.get_avail_actions()
    assert avail.shape == (1, info["n_agents"], info["n_actions"])
    assert env.get_avail_agent_actions(0).shape == (info["n_actions"],)
    assert env.get_total_actions() == info["n_actions"]
    assert env.get_num_of_agents() == info["n_agents"] == env.n_agents
    assert env.get_obs_size() == info["obs_shape"]
    assert env.get_state_size() == info["state_shape"]


def test_get_action_draws_from_the_wrapper_seed():
    """Uniform over [action_low, action_high] for every sgen, from the
    wrapper's own generator: the same seed gives the same actions."""
    a, b, c = (VoltageControlWrapper("case33", days=8, seed=s, device="cpu")
               for s in (3, 3, 4))
    n_sgen = a.env.grid.n_sgen
    draws = np.stack([a.get_action() for _ in range(200)])
    assert draws.shape == (200, n_sgen)
    assert draws.min() >= a.action_space.low and draws.max() <= a.action_space.high
    assert draws.min() < a.action_space.low + 0.1 and draws.max() > a.action_space.high - 0.1
    np.testing.assert_array_equal(draws[0], b.get_action())
    assert not np.array_equal(draws[0], c.get_action())


def test_trajectory_matches_the_jax_wrapper():
    """From ``manual_reset`` with ``reset_action=False`` and
    ``add_noise=False``, one fixed action sequence past the episode limit:
    obs, state, reward, terminated and every info key, per step, and the
    telemetry accessors at the end."""
    cfg = dict(episode_limit=8, reset_action=False)
    jenv = JaxVoltageControlWrapper("case33", JaxEnvConfig(**cfg), days=8,
                                    dtype=jnp.float64)
    tenv = VoltageControlWrapper("case33", EnvConfig(**cfg), days=8,
                                 dtype=torch.float64, device="cpu")
    actions = np.random.RandomState(0).uniform(
        tenv.action_space.low, tenv.action_space.high, (10, tenv.env.grid.n_sgen))
    tobs, tstate = tenv.manual_reset(3, 11, 2)
    jobs, jstate = jenv.manual_reset(3, 11, 2)
    _close(np.stack(tobs), np.stack(jobs), "reset obs")
    _close(tstate, jstate, "reset state")
    ends = []
    for t, a in enumerate(actions):
        tr, tterm, tinfo = tenv.step(a, add_noise=False)
        jr, jterm, jinfo = jenv.step(a, add_noise=False)
        _close(tr, jr, f"reward {t}")
        assert tterm == jterm, t
        ends.append(tterm)
        assert set(tinfo) == set(jinfo) >= INFO_KEYS
        for k, v in jinfo.items():
            _close(tinfo[k], v, f"{k} {t}")
        _close(np.stack(tenv.get_obs()), np.stack(jenv.get_obs()), f"obs {t}")
        _close(tenv.get_obs_agent(2), jenv.get_obs_agent(2), f"obs agent 2 {t}")
        _close(tenv.get_state(), jenv.get_state(), f"state {t}")
    assert ends == [False] * 6 + [True] * 4
    for name in ("_get_res_bus_v", "_get_res_bus_active", "_get_res_bus_reactive",
                 "_get_res_line_loss", "_get_sgen_active", "_get_sgen_reactive"):
        _close(getattr(tenv, name)(), getattr(jenv, name)(), name)
    np.testing.assert_array_equal(tenv.get_avail_actions(), jenv.get_avail_actions())
    assert tenv.get_env_info() == jenv.get_env_info()


def test_render_and_plot_refuse_naming_a13(tmp_path):
    """Named for the refusal it held before rendering was ported: the
    wrapper's ``render`` now returns an RGB frame of its lane, and
    ``res_pf_plot`` writes the PNG and HTML and returns the PNG's path."""
    env = VoltageControlWrapper("case33", days=8, device="cpu")
    env.reset()
    frame = env.render()
    assert frame.dtype == np.uint8 and frame.ndim == 3 and frame.shape[2] == 3
    assert frame.std() > 0
    path = str(tmp_path / "plot_save" / "pf_res_plot")
    assert env.res_pf_plot(path) == path + ".png"
    assert os.path.getsize(path + ".png") > 0 and os.path.isfile(path + ".html")


def test_wrapper_runs_on_the_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VoltageControlWrapper("case33", days=8)


def test_examples_in_process():
    """Both examples on the CPU: the object loop ends at its limit of 24
    steps (the step counter starts at 1), the batched one gives a finite
    (24, lanes) reward table."""
    total, steps = code_examples.oo_example("cpu")
    assert np.isfinite(total) and steps == 23
    rewards = code_examples.vectorized_example(4, "cpu")
    assert rewards.shape == (24, 4) and bool(torch.isfinite(rewards).all())


def test_code_examples_cli_exits_0():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "mapdn_torch.code_examples",
                          "--platform", "cpu", "--n-envs", "4"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "4 envs x 24 steps" in out.stdout
