"""MADDPG: centralized critic Q_i(all obs, all actions [+ id]) with the other
agents' actions gradient-detached (PyTorch port of
mapdn_tpu/algos/maddpg.py; reference models/maddpg.py)."""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import MARLModel, mix_detached
from mapdn_torch.learn.losses import ddpg_loss


class MADDPG(MARLModel):
    # the rollout runs the base class's get_actions (the policy, the
    # exploration noise drawn from the generator, the avail mask) and the
    # env's translate_actions, as MAPPO's does: no host read
    rollout_capturable = True

    def construct_value_net(self):
        self.value_in_dim = (self.obs_dim + self.act_dim) * self.n + self.id_dim()

    def joint_input(self, obs, act):
        """(b, n, o), (b, n, a) -> (b, n, n*o [+ n] + n*a): every agent's row
        holds all observations and all actions, its own action live and the
        others detached (reference maddpg.py:40-65)."""
        b, n = obs.shape[0], self.n
        obs_rep = self.with_ids(obs.reshape(b, 1, -1).expand(b, n, n * self.obs_dim))
        own = self.own_mask(act.dtype)[None, :, :, None]
        act_rep = mix_detached(act[:, None].expand(b, n, n, self.act_dim), 1.0 - own, own)
        return torch.cat([obs_rep, act_rep.reshape(b, n, -1)], dim=-1)

    def value(self, module, obs, act):
        return self.apply_critic(module, self.joint_input(obs, act))

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        return ddpg_loss(self, state, batch, avail, policy=policy, value=value)
