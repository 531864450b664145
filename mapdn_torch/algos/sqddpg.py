"""SQDDPG: Shapley-value credit assignment through sampled grand coalitions
(PyTorch port of mapdn_tpu/algos/sqddpg.py; reference models/sqddpg.py).

Each of ``sample_size`` samples orders the agents at random; agent i's
marginal contribution is the critic value of the joint action restricted
to its predecessors' actions (detached) and its own (live), the other
actions zeroed.  The TD target regresses the sum of the Shapley values
(reference :141-153).  An ordering is given as ``positions`` (b, s, n):
agent j precedes agent i where positions[..., j] < positions[..., i].  The
loss takes three, ``draws["policy_positions"]``, ``["value_positions"]``
and ``["next_positions"]`` (the JAX package's keys k3, k4, k5), each drawn
on the device where not given.
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import MARLModel, mix_detached
from mapdn_torch.learn.sampling import batchnorm
from mapdn_torch.utils import lanes


class SQDDPG(MARLModel):
    def construct_value_net(self):
        self.value_in_dim = (self.obs_dim + self.act_dim) * self.n + self.id_dim()

    def draw_positions(self, batch_size, like, generator):
        """One random ordering of the n agents per (transition, sample), on
        ``like``'s device: (b, s, n)."""
        shape = (batch_size, self.cfg.sample_size, self.n)
        return lanes.draw(lambda s: torch.rand(s, generator=generator, device=like.device),
                          shape).argsort(-1)

    def marginal_contribution(self, module, obs, act, positions):
        """(b, n, o), (b, n, a), (b, s, n) -> (b, s, n) marginal
        contributions."""
        b, s, n = positions.shape
        positions = torch.as_tensor(positions, device=obs.device)
        prec = (positions[..., None, :] < positions[..., :, None]).to(obs.dtype)
        own = self.own_mask(obs.dtype)[None, None]
        act_rep = act[:, None, None].expand(b, s, n, n, self.act_dim)
        act_masked = mix_detached(act_rep, prec[..., None], own[..., None])
        obs_rep = obs.reshape(b, 1, 1, -1).expand(b, s, n, n * self.obs_dim)
        inp = torch.cat([obs_rep, act_masked.reshape(b, s, n, n * self.act_dim)], dim=-1)
        if self.cfg.agent_id:
            inp = torch.cat([inp, self.own_mask(obs.dtype).expand(b, s, n, n)], dim=-1)
        return self.apply_critic(module, inp.reshape(b * s, n, -1)).reshape(b, s, n)

    def value(self, module, obs, act, positions=None, generator=None):
        if positions is None:
            positions = self.draw_positions(obs.shape[0], obs, generator)
        else:
            positions = lanes.given(positions)
        return self.marginal_contribution(module, obs, act, positions)

    def _shapley(self, module, obs, act, draws, name, generator):
        """Mean marginal contribution over the samples, (b, n)."""
        positions = (draws or {}).get(name)
        return torch.mean(self.value(module, obs, act, positions, generator), dim=1)

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        """(reference sqddpg.py:137-160)."""
        cfg = self.cfg
        b = self.unpack(batch)
        policy_loss, value_loss, dist = None, None, (None, None)
        if policy:
            _, actions_pol, _, dist, _ = self.get_actions(
                state.policy, b.state, b.last_hid, status="train",
                exploration=False, avail=avail, need_hid=False)
            advantages = self._shapley(state.value, b.state, actions_pol, draws,
                                       "policy_positions", generator)
            if cfg.normalize_advantages:
                advantages = batchnorm(advantages)
            policy_loss = -torch.mean(advantages)
        if value:
            shapley_sum = self._shapley(state.value, b.state, b.action, draws,
                                        "value_positions", generator).sum(-1, keepdim=True)
            with torch.no_grad():
                _, next_actions, _, _, _ = self.get_actions(
                    self.next_policy(state), b.next_state, b.hid, status="train",
                    exploration=False, avail=avail)
                target = state.target_value if cfg.target else state.value
                next_sum = self._shapley(target, b.next_state, next_actions, draws,
                                         "next_positions", generator).sum(-1, keepdim=True)
            returns = b.reward + cfg.gamma * (1.0 - b.done[:, None]) * next_sum
            value_loss = torch.mean((returns - shapley_sum) ** 2)
        return policy_loss, value_loss, dist
