"""FACMADDPG: factored MADDPG, per-agent critics Q_i(o_i [+ id], a_i) mixed
by a QMIX hypernetwork into q_tot on the global state, with a third (mixer)
optimizer (PyTorch port of mapdn_tpu/algos/facmaddpg.py; reference
models/facmaddpg.py and critics/qmix.py).

The TD target is the team reward plus the target mixer's q_tot of the
target critic's values; the trainer's mixer epochs train the mixer on the
same value loss.  Draws nothing.
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.iddpg import IDDPG
from mapdn_torch.learn.sampling import batchnorm
from mapdn_torch.nets.critics import QMixer


class FACMADDPG(IDDPG):
    uses_mixer = True

    def make_mixer_module(self):
        cfg = self.cfg
        return QMixer(self.n, self.obs_dim * self.n, embed_dim=cfg.mixing_embed_dim or 64,
                      hypernet_layers=cfg.hypernet_layers or 2,
                      hypernet_embed=cfg.hypernet_embed or 64, gated=bool(cfg.gated),
                      skip_connections=bool(cfg.skip_connections),
                      param_dtype=self.param_dtype)

    def q_tot(self, mixer, values, obs):
        """(b, n) agent values on the global state (b, n * o) -> (b, 1)."""
        return mixer(values, obs.reshape(obs.shape[0], self.n * self.obs_dim))

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        """(reference facmaddpg.py:90-119)."""
        cfg = self.cfg
        b = self.unpack(batch)
        policy_loss, value_loss, dist = None, None, (None, None)
        if policy:
            _, actions_pol, _, dist, _ = self.get_actions(
                state.policy, b.state, b.last_hid, status="train",
                exploration=False, avail=avail, need_hid=False)
            advantages = self.value(state.value, b.state, actions_pol)
            if cfg.normalize_advantages:
                advantages = batchnorm(advantages)
            policy_loss = -torch.mean(advantages)
        if value:
            with torch.no_grad():
                _, next_actions, _, _, _ = self.get_actions(
                    self.next_policy(state), b.next_state, b.hid, status="train",
                    exploration=False, avail=avail)
                next_values = self.value(state.target_value, b.next_state, next_actions)
                next_q_tot = self.q_tot(state.target_mixer, next_values, b.next_state)
            q_tot = self.q_tot(state.mixer, self.value(state.value, b.state, b.action),
                               b.state)
            returns = b.reward[:, 0:1] + cfg.gamma * (1.0 - b.done[:, None]) * next_q_tot
            value_loss = torch.mean((returns - q_tot) ** 2)
        return policy_loss, value_loss, dist
