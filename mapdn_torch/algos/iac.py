"""IAC: independent actor-critic, per-agent Q(o_i [+ id], a_i) (PyTorch port
of mapdn_tpu/algos/iac.py; reference models/iac.py, continuous branch)."""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import MARLModel
from mapdn_torch.learn.losses import actor_critic_loss


class IAC(MARLModel):
    on_policy = True

    def construct_value_net(self):
        self.value_in_dim = self.obs_dim + self.act_dim + self.id_dim()

    def value(self, module, obs, act):
        return self.apply_critic(module, torch.cat([self.with_ids(obs), act], dim=-1))

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        return actor_critic_loss(self, state, batch, avail, policy=policy, value=value)
