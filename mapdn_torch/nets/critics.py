"""Critic networks (PyTorch port of mapdn_tpu/nets/critics.py): the MLP
critic and the centralized V critic."""
from __future__ import annotations

import torch
from torch import nn

from mapdn_torch.nets.agents import Dense, _Base, _init_kernel_


class MLPCritic(_Base):
    """Generic Q/V head (reference critics/mlp_critic.py:7-37):
    fc1 -> optional LayerNorm -> act -> fc2 -> act -> out."""

    def __init__(self, in_dim, output_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.fc2 = Dense(self.hid_size, self.hid_size, self.param_dtype)
        self.head = Dense(self.hid_size, output_dim, self.param_dtype)

    def forward(self, x):
        return self.head(self.act(self.fc2(self.stem(x))))


class CentralVCritic(_Base):
    """Centralized V(all obs) head with the agent identity folded into the
    first layer as a learned per-agent bias ``agent_id_embed`` (n_agents,
    hid): the wide first-layer matmul runs once per sample instead of once
    per agent on a one-hot-extended copy.  (b, in_dim) -> (b, n_agents, out).

    ``agent_id_embed`` is created in the explicit ``param_dtype`` like every
    other parameter (the JAX package pins it to float32 for the same reason:
    so a float64 run does not silently promote the parameter)."""

    def __init__(self, in_dim, n_agents=1, use_agent_id=True, output_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.n_agents = n_agents
        self.use_agent_id = use_agent_id
        self.fc2 = Dense(self.hid_size, self.hid_size, self.param_dtype)
        self.head = Dense(self.hid_size, output_dim, self.param_dtype)
        self.agent_id_embed = (
            nn.Parameter(torch.zeros(n_agents, self.hid_size, dtype=self.param_dtype))
            if use_agent_id else None)

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        if self.agent_id_embed is not None:
            with torch.no_grad():
                _init_kernel_(self.agent_id_embed, self.init_type,
                              self.init_std, self.hid_activation, generator)
        return self

    def forward(self, joint):
        h = self.fc1(joint)[:, None, :]
        if self.agent_id_embed is not None:
            h = h + self.agent_id_embed.to(joint.dtype)[None]
        else:
            h = h.expand(joint.shape[0], self.n_agents, self.hid_size)
        if self.norm is not None:
            h = self.norm(h)
        h = self.act(h)
        return self.head(self.act(self.fc2(h)))
