"""MAPPO: PPO with a centralized V(all obs) critic (PyTorch port of
mapdn_tpu/algos/mappo.py; reference models/mappo.py)."""
from __future__ import annotations

from mapdn_torch.algos.base import MARLModel
from mapdn_torch.learn.losses import ppo_loss
from mapdn_torch.nets.critics import CentralVCritic


class MAPPO(MARLModel):
    on_policy = True
    stores_rollout_value = True
    stores_next_hidden = False  # the PPO loss never reads Transition.hid

    def construct_value_net(self):
        self.value_in_dim = self.obs_dim * self.n

    def make_value_module(self):
        return CentralVCritic(self.value_in_dim, n_agents=self.n,
                              use_agent_id=self.cfg.agent_id, output_dim=1,
                              **self._net_kw())

    def value(self, module, obs, act=None):
        """(b, n, o) -> (b, n) centralized values."""
        return module(obs.reshape(obs.shape[0], -1))[..., 0]

    def get_loss(self, state, batch, avail, **parts):
        return ppo_loss(self, state, batch, avail, **parts)
