"""IPPO: independent PPO, per-agent V(o_i [+ id]) (PyTorch port of
mapdn_tpu/algos/ippo.py; reference models/ippo.py)."""
from __future__ import annotations

from mapdn_torch.algos.base import MARLModel
from mapdn_torch.learn.losses import ppo_loss


class IPPO(MARLModel):
    on_policy = True
    stores_rollout_value = True
    stores_next_hidden = False  # the PPO loss never reads Transition.hid
    rollout_capturable = True

    def construct_value_net(self):
        self.value_in_dim = self.obs_dim + self.id_dim()

    def value(self, module, obs, act=None):
        return self.apply_critic(module, self.with_ids(obs))

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        return ppo_loss(self, state, batch, avail, policy=policy, value=value)
