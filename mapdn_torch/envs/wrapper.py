"""PyMARL-compatible object wrapper around the batched env (PyTorch port of
mapdn_tpu/envs/wrapper.py).

Gives users of the reference's ``MultiAgentEnv`` API (reference
environments/multiagentenv.py:1-67 and the usage pattern of reference
code_examples.py:40-66) one environment behind the familiar interface:

    env = VoltageControlWrapper(case="case33", cfg=EnvConfig(...))
    obs, state = env.reset()
    reward, terminated, info = env.step(actions)

It drives one lane of :class:`VoltageControlEnv`, whose power flow runs on
the device (the GPU unless ``device="cpu"``).  Each step copies its reward,
terminated flag and info to the host in one transfer, so a loop over steps
is bound by the host; for training at scale use the batched env and
``mapdn_torch.learn.trainer``.  Random draws (resets, data noise,
``get_action``) come from the wrapper's own ``torch.Generator``, seeded
``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from mapdn_torch.envs.voltage_control import EnvConfig, VoltageControlEnv, make_env


class ActionSpace:
    """Mirror of the reference's ActionSpace (voltage_control_env.py:18-21)."""

    def __init__(self, low, high):
        self.low = low
        self.high = high


class VoltageControlWrapper:
    def __init__(self, case="case33", cfg: EnvConfig | None = None, *,
                 seed=0, data_path=None, days=40, dtype=torch.float32, device=None):
        self.cfg = cfg or EnvConfig()
        self.env: VoltageControlEnv = make_env(
            case, self.cfg, data_path=data_path, days=days, seed=seed,
            dtype=dtype, device=device)
        self.n_agents = self.env.n_agents
        self.n_actions = self.env.n_actions
        self.episode_limit = self.cfg.episode_limit
        self.action_space = ActionSpace(
            low=self.env.action_low, high=self.env.action_high)
        self._gen = torch.Generator(device=self.env.device).manual_seed(seed)
        self._state = None
        self._obs = None
        self._gs = None

    # --- reference API (multiagentenv.py) ----------------------------------
    def reset(self):
        self._state, self._obs, self._gs = self.env.reset(1, self._gen)
        return self.get_obs(), self.get_state()

    def manual_reset(self, day, hour, interval):
        """Deterministic start, no noise; the reset action (with
        ``reset_action``) is ``VoltageControlEnv.manual_reset``'s."""
        self._state, self._obs, self._gs = self.env.manual_reset(day, hour, interval)
        return self.get_obs(), self.get_state()

    def step(self, actions, add_noise=True):
        """One step from (n_sgen,) actions; returns the reward (float), the
        terminated flag (bool) and the info metrics (floats)."""
        env = self.env
        actions = torch.as_tensor(np.asarray(actions, np.float64).reshape(1, -1),
                                  dtype=env.dtype, device=env.device)
        out = env.step(self._state, actions, self._gen, add_noise=add_noise)
        self._state, self._obs, self._gs = out.state, out.obs, out.global_state
        host = torch.stack([out.reward[0], out.terminated[0].to(out.reward.dtype)]
                           + [v[0] for v in out.info.values()]).tolist()
        return host[0], bool(host[1]), dict(zip(out.info, host[2:]))

    def get_obs(self):
        return list(self._obs[0].cpu().numpy())

    def get_obs_agent(self, agent_id):
        return self._obs[0, agent_id].cpu().numpy()

    def get_obs_size(self):
        return self.env.obs_size

    def get_state(self):
        return self._gs[0].cpu().numpy()

    def get_state_size(self):
        return self.env.state_size

    def get_avail_actions(self):
        # (1, n_agents, n_actions) like reference voltage_control_env.py:345-351
        return self.env.avail_actions.cpu().numpy()[None]

    def get_avail_agent_actions(self, agent_id):
        return self.env.avail_actions[agent_id].cpu().numpy()

    def get_total_actions(self):
        return self.n_actions

    def get_num_of_agents(self):
        return self.n_agents

    def get_action(self):
        """Uniform random action of every sgen over the env's range
        (voltage_control_env.py:334-338)."""
        env = self.env
        u = torch.rand((env.grid.n_sgen,), generator=self._gen, dtype=env.dtype,
                       device=env.device)
        return (u * (env.action_high - env.action_low) + env.action_low).cpu().numpy()

    def get_env_info(self):
        return self.env.get_env_info()

    # --- telemetry accessors used by the tester (reference tester.py:34-55) --
    def _get_res_bus_v(self):
        return self._state.vm[0].cpu().numpy()

    def _get_res_bus_active(self):
        return self._state.p_bus[0].cpu().numpy()

    def _get_res_bus_reactive(self):
        return self._state.q_bus[0].cpu().numpy()

    def _get_res_line_loss(self):
        return self._state.pl_mw[0].cpu().numpy()

    def _get_sgen_active(self):
        return self._state.pv_p[0].cpu().numpy()

    def _get_sgen_reactive(self):
        return self._state.sgen_q[0].cpu().numpy()

    def render(self, mode="rgb_array"):
        """RGB frame of the current grid state
        (reference voltage_control_env.py:654-657)."""
        from mapdn_torch.envs.rendering import render
        return render(self.env, self._state, mode=mode)

    def res_pf_plot(self, path="plot_save/pf_res_plot"):
        """Write PNG + HTML network heatmap
        (reference voltage_control_env.py:659-674)."""
        from mapdn_torch.envs.rendering import pf_res_plot
        return pf_res_plot(self.env, self._state, path)

    def close(self):
        pass
