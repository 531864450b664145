"""COMA: counterfactual multi-agent policy gradient, continuous variant
(PyTorch port of mapdn_tpu/algos/coma.py; reference models/coma.py).

The critic sees (all obs, own obs [, agent id], all actions) (reference
coma.py:21-37).  The counterfactual baseline of agent i is the mean critic
value over ``sample_size`` joint actions in which agent i's action is
replaced by one drawn from its current policy (reference coma.py:139-151);
the draws are ``draws["sample_noise"]`` (s, b, n, a) where given.
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import MARLModel
from mapdn_torch.learn.sampling import batchnorm, draw_normal, policy_log_density


class COMA(MARLModel):
    on_policy = True

    def construct_value_net(self):
        self.value_in_dim = ((self.n + 1) * self.obs_dim + self.n * self.act_dim
                             + self.id_dim())

    def _critic_obs(self, obs):
        """(b, n, o) -> (b, n, n*o + o [+ n]): the joint and own obs."""
        b, n = obs.shape[0], self.n
        joint = obs.reshape(b, 1, -1).expand(b, n, n * self.obs_dim)
        return self.with_ids(torch.cat([joint, obs], dim=-1))

    def value_joint(self, module, obs, act_joint):
        """obs (b, n, o); act_joint (b, n, n*a) each agent's joint action."""
        return self.apply_critic(module, torch.cat([self._critic_obs(obs), act_joint], dim=-1))

    def value(self, module, obs, act):
        b = obs.shape[0]
        act_joint = act.reshape(b, 1, -1).expand(b, self.n, self.n * self.act_dim)
        return self.value_joint(module, obs, act_joint)

    def baselines(self, module, obs, action, means, log_stds, noise):
        """(b, n) counterfactual baselines from ``noise`` (s, b, n, a)."""
        s, bsz, n, a = noise.shape
        sampled = means + torch.exp(log_stds) * noise                # (s, b, n, a)
        own = self.own_mask(means.dtype)[None, None, :, :, None]
        act_rep = action[None, :, None].expand(s, bsz, n, n, a)
        smp_rep = sampled[:, :, None].expand(s, bsz, n, n, a)
        merged = (act_rep * (1.0 - own) + smp_rep * own).reshape(s * bsz, n, n * a)
        obs_rep = obs[None].expand((s,) + tuple(obs.shape)).reshape(s * bsz, n, -1)
        values = self.value_joint(module, obs_rep, merged).reshape(s, bsz, n)
        return torch.mean(values, dim=0)

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        """(reference coma.py:120-160)."""
        cfg = self.cfg
        b = self.unpack(batch)
        policy_loss, value_loss, dist = None, None, (None, None)
        if policy:
            means, log_stds, _ = self.policy(state.policy, b.state, b.last_hid, need_hid=False)
            log_prob_a = policy_log_density(cfg, b.action, means, log_stds)
            with torch.no_grad():
                shape = (cfg.sample_size,) + tuple(means.shape)
                noise = draw_normal((draws or {}).get("sample_noise"), shape,
                                    means, generator, axis=1)
                advantages = (self.value(state.value, b.state, b.action)
                              - self.baselines(state.value, b.state, b.action,
                                               means, log_stds, noise))
            if cfg.normalize_advantages:
                advantages = batchnorm(advantages)
            restore_mask = (avail != 0).to(means.dtype)
            lp = torch.sum(restore_mask * log_prob_a, dim=-1)
            policy_loss = -torch.mean(advantages * lp)
            dist = (means, log_stds)
        if value:
            with torch.no_grad():
                _, next_actions, _, _, _ = self.get_actions(
                    self.next_policy(state), b.next_state, b.hid, status="train",
                    exploration=False, avail=avail)
                target = state.target_value if cfg.target else state.value
                next_values = self.value(target, b.next_state, next_actions)
            values = self.value(state.value, b.state, b.action)
            returns = b.reward + cfg.gamma * (1.0 - b.done[:, None]) * next_values
            value_loss = torch.mean((returns - values) ** 2)
        return policy_loss, value_loss, dist
