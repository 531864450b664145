"""MATD3: MADDPG with twin critics and target-action smoothing (PyTorch port
of mapdn_tpu/algos/matd3.py; reference models/matd3.py).

The twin Q is one critic evaluated twice with a trailing 0/1 indicator
feature (reference :64-82); target actions are drawn with exploration
noise, ``draws["target_noise"]`` (b, n, a) where given; the TD target
takes the smaller of the twin target values (:141-142).  Under
``action_enforcebound`` the target action is tanh(mean + std * noise):
``select_action_continuous`` returns before its ``clip_c`` clamp, in the
JAX package as here (mapdn_tpu/learn/sampling.py:117-122).
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.maddpg import MADDPG
from mapdn_torch.learn.sampling import batchnorm, draw_normal, select_action_continuous


class MATD3(MADDPG):
    # MADDPG's rollout and update step, declared capturable there, are not
    # yet checked here (its loss draws the target noise)
    rollout_capturable = False
    update_capturable = False

    def construct_value_net(self):
        self.value_in_dim = (self.obs_dim + self.act_dim) * self.n + 1 + self.id_dim()

    def value(self, module, obs, act):
        """(q1, q2), each (b, n)."""
        inputs = self.joint_input(obs, act)
        zeros = inputs.new_zeros(inputs.shape[:-1] + (1,))
        return (self.apply_critic(module, torch.cat([inputs, zeros], dim=-1)),
                self.apply_critic(module, torch.cat([inputs, 1.0 - zeros], dim=-1)))

    def get_actions(self, module, obs, last_hid, *, status, exploration,
                    avail, clip=False, generator=None, noise=None):
        """As the base's, but the means and log-stds of unavailable slots
        are zeroed before sampling (reference matd3.py:100-102)."""
        means, log_stds, hid = self.policy(module, obs, last_hid)
        avail_mask = (avail != 0).to(means.dtype)
        means = means * avail_mask
        log_stds = log_stds * avail_mask
        actions, log_prob = select_action_continuous(
            self.cfg, means, log_stds, status=status, exploration=exploration,
            clip=clip, generator=generator, noise=noise)
        if log_prob is None:
            log_prob = torch.zeros_like(means)
        return actions, avail_mask * actions, log_prob, (means, log_stds), hid

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        """(reference matd3.py:126-160)."""
        cfg = self.cfg
        b = self.unpack(batch)
        policy_loss, value_loss, dist = None, None, (None, None)
        if policy:
            _, actions_pol, _, dist, _ = self.get_actions(
                state.policy, b.state, b.last_hid, status="train",
                exploration=False, avail=avail)
            advantages, _ = self.value(state.value, b.state, actions_pol)
            if cfg.normalize_advantages:
                advantages = batchnorm(advantages)
            policy_loss = -torch.mean(advantages)
        if value:
            with torch.no_grad():
                shape = b.action.shape
                noise = draw_normal((draws or {}).get("target_noise"), shape,
                                    b.action, generator)
                _, next_actions, _, _, _ = self.get_actions(
                    self.next_policy(state), b.next_state, b.hid, status="train",
                    exploration=True, avail=avail, clip=True, noise=noise)
                nv1, nv2 = self.value(state.target_value, b.next_state, next_actions)
                next_values = torch.minimum(nv1, nv2)
            values1, values2 = self.value(state.value, b.state, b.action)
            returns = b.reward + cfg.gamma * (1.0 - b.done[:, None]) * next_values
            value_loss = 0.5 * (torch.mean((returns - values1) ** 2)
                                + torch.mean((returns - values2) ** 2))
        return policy_loss, value_loss, dist
