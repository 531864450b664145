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
        # shared: one CentralVCritic over the joint obs; non-shared
        # (mapdn_tpu/algos/mappo.py:27-47): per-agent MLP critics over the
        # joint obs [+ the agent's one-hot]
        self.value_in_dim = self.obs_dim * self.n
        if self.per_agent is not None:
            self.value_in_dim += self.id_dim()

    def make_value_module(self):
        if self.per_agent is not None:
            return super().make_value_module()
        return CentralVCritic(self.value_in_dim, n_agents=self.n,
                              use_agent_id=self.cfg.agent_id, output_dim=1,
                              **self._net_kw())

    def value(self, module, obs, act=None):
        """(b, n, o) -> (b, n) centralized values."""
        b = obs.shape[0]
        if self.per_agent is None:
            return module(obs.reshape(b, -1))[..., 0]
        joint = obs.reshape(b, 1, -1).expand(b, self.n, self.n * self.obs_dim)
        return self.apply_critic(module, self.with_ids(joint))

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        return ppo_loss(self, state, batch, avail, policy=policy, value=value)
