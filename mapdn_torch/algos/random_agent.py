"""Random-action baseline (PyTorch port of mapdn_tpu/algos/random_agent.py;
reference models/random.py): actions tanh(N(0, 1)), losses zero."""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import MARLModel
from mapdn_torch.learn.sampling import draw_normal


class RandomAgent(MARLModel):
    def construct_value_net(self):
        self.value_in_dim = 1

    def value(self, module, obs, act=None):
        return obs.new_zeros(obs.shape[:2])

    def get_actions(self, module, obs, last_hid, *, status, exploration,
                    avail, clip=False, generator=None, noise=None, need_hid=True):
        """Standard normals (``noise`` where given) as the means, whatever
        the status; the GRU state passes through (``need_hid`` or not)."""
        shape = tuple(obs.shape[:2]) + (self.act_dim,)
        means = draw_normal(noise, shape, obs, generator)
        restore_mask = (avail != 0).to(means.dtype)
        actions = torch.tanh(means) if self.cfg.action_enforcebound else means
        return (actions, restore_mask * actions, torch.zeros_like(means),
                (means, torch.zeros_like(means)), last_hid)

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        zero = batch.reward.new_zeros(())
        means = torch.zeros_like(batch.action)
        return zero, zero, (means, means)
