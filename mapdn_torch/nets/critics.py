"""Critic networks (PyTorch port of mapdn_tpu/nets/critics.py): the MLP
and GRU critics, the centralized V critic, the QMIX mixer and MAAC's
attention critic.

The last two take flax's ``nn.Dense`` defaults (lecun-normal kernels, zero
biases), as the JAX modules do.  Per-agent layers (``nn.vmap`` in flax) are
:class:`AgentDense`: (n, in, out) kernels applied in one batched product
over the agent axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mapdn_torch.nets.agents import AgentDense, Dense, _Base, _init_kernel_
from mapdn_torch.utils import profiling


class MLPCritic(_Base):
    """Generic Q/V head (reference critics/mlp_critic.py:7-37):
    fc1 -> optional LayerNorm -> act -> fc2 -> act -> out."""

    def __init__(self, in_dim, output_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.fc2 = self._dense(self.hid_size, self.hid_size)
        self.head = self._dense(self.hid_size, output_dim)

    def forward(self, x):
        return self.head(self.act(self.fc2(self.stem(x))))


class RNNCritic(_Base):
    """GRU critic (reference critics/rnn_critic.py:7-36): fc1 -> optional
    LayerNorm -> act -> GRU cell -> out; (x, hidden) -> (value, hidden).
    No algorithm uses it, in the reference, the JAX package or here."""

    def __init__(self, in_dim, output_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.gru = self._gru(self.hid_size, self.hid_size)
        self.head = self._dense(self.hid_size, output_dim)

    def forward(self, x, hidden):
        hidden = self.gru(self.stem(x), hidden)
        return self.head(hidden), hidden


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


class QMixer(nn.Module):
    """Monotonic hypernetwork mixer (reference critics/qmix.py:8-83):
    q_tot = |W_final(s)|^T elu(|W_1(s)|^T q + b_1(s)) [* gate] [+ sum q] + V(s),
    with 1- or 2-layer hypernets (ReLU between) and a 2-layer V(s)."""

    def __init__(self, n_agents, state_dim, embed_dim=64, hypernet_layers=2,
                 hypernet_embed=64, gated=False, skip_connections=False,
                 param_dtype=torch.float32):
        super().__init__()
        if hypernet_layers not in (1, 2):
            raise ValueError(f"hypernet_layers must be 1 or 2, not {hypernet_layers}")
        self.n_agents, self.embed_dim = n_agents, embed_dim
        self.skip_connections = skip_connections

        def hyper(out_dim):
            if hypernet_layers == 1:
                return Dense(state_dim, out_dim, param_dtype)
            return nn.Sequential(Dense(state_dim, hypernet_embed, param_dtype), nn.ReLU(),
                                 Dense(hypernet_embed, out_dim, param_dtype))

        self.hyper_w_1 = hyper(embed_dim * n_agents)
        self.hyper_b_1 = Dense(state_dim, embed_dim, param_dtype)
        self.hyper_w_final = hyper(embed_dim)
        self.V = nn.Sequential(Dense(state_dim, embed_dim, param_dtype), nn.ReLU(),
                               Dense(embed_dim, 1, param_dtype))
        self.gate = (nn.Parameter(torch.full((1,), 0.5, dtype=param_dtype))
                     if gated else None)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Dense):
                    mod.reset_lecun_(generator)
            if self.gate is not None:
                self.gate.fill_(0.5)
        return self

    def forward(self, agent_qs, states):
        """(b, n) agent values, (b, state_dim) global states -> (b, 1)."""
        b = agent_qs.shape[0]
        qs = agent_qs.reshape(b, 1, self.n_agents)
        w1 = torch.abs(self.hyper_w_1(states)).reshape(b, self.n_agents, self.embed_dim)
        b1 = self.hyper_b_1(states).reshape(b, 1, self.embed_dim)
        hidden = F.elu(torch.matmul(qs, w1) + b1)
        w_final = torch.abs(self.hyper_w_final(states)).reshape(b, self.embed_dim, 1)
        v = self.V(states).reshape(b, 1, 1)
        y = torch.matmul(hidden, w_final)
        if self.gate is not None:
            y = y * self.gate.to(y.dtype)
        if self.skip_connections:
            y = y + torch.sum(qs, dim=2, keepdim=True)
        return (y + v).reshape(b, 1)


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def _self_mask(n, device):
    """(n, n) True on the diagonal: each agent's own slot, which its
    attention skips."""
    return torch.eye(n, dtype=torch.bool, device=device)


class AgentHead(nn.Module):
    """Per-agent leaky-ReLU layer then a scalar output (the JAX package's
    ``_LeakyHead`` under ``nn.vmap``): (b, n, in) -> (b, n, 1)."""

    def __init__(self, n, in_features, hidden, param_dtype=torch.float32):
        super().__init__()
        self.fc = AgentDense(n, in_features, hidden, param_dtype)
        self.out = AgentDense(n, hidden, 1, param_dtype)

    def forward(self, x):
        return self.out(_leaky(self.fc(x)))


class AttentionCritic(nn.Module):
    """Multi-head cross-agent attention critic (reference
    critics/maac_critic.py:8-161).

    Per agent an (obs, act) encoder and an obs encoder (leaky ReLU 0.01);
    shared key and selector projections (no bias) and a value projection
    (bias, leaky ReLU); each agent attends over the others (the diagonal
    masked to -1e9); Q = critic([own sa encoding, attended values]) minus
    a state-only bias head.  Returns ((b, n) values, (n,) regulariser
    1e-3 mean_{b,h}(sum_j logits^2 / (n - 1)) over the masked logits).
    The attention, from the projections to the weighted sum and the
    regulariser, is the span ``update.attend``; the counter
    ``update.attend_logits`` adds the b * heads * n * n logits it computes.

    ``norm_in`` is accepted and ignored: the JAX module declares it and
    never reads it."""

    def __init__(self, n_agents, obs_dim, act_dim, hid_size=64, attend_heads=1,
                 norm_in=False, param_dtype=torch.float32):
        super().__init__()
        n, h = n_agents, hid_size
        self.n_agents, self.attend_heads = n, attend_heads
        self.head_dim = h // attend_heads
        proj = self.head_dim * attend_heads
        self.sa_encoders = AgentDense(n, obs_dim + act_dim, h, param_dtype)
        self.s_encoders = AgentDense(n, obs_dim, h, param_dtype)
        self.key_proj = Dense(h, proj, param_dtype, bias=False)
        self.sel_proj = Dense(h, proj, param_dtype, bias=False)
        self.val_proj = Dense(h, proj, param_dtype)
        self.critics = AgentHead(n, h + proj, h, param_dtype)
        self.biases = AgentHead(n, h, h, param_dtype)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Dense, AgentDense)):
                    mod.reset_lecun_(generator)
        return self

    def forward(self, obs, act):
        """obs (b, n, o), act (b, n, a)."""
        b, n, hd, d = obs.shape[0], self.n_agents, self.attend_heads, self.head_dim
        sa_enc = _leaky(self.sa_encoders(torch.cat([obs, act], dim=-1)))
        s_enc = _leaky(self.s_encoders(obs))
        with profiling.span("update.attend"):
            keys = self.key_proj(sa_enc).reshape(b, n, hd, d)
            sels = self.sel_proj(s_enc).reshape(b, n, hd, d)
            vals = _leaky(self.val_proj(sa_enc)).reshape(b, n, hd, d)

            logits = torch.einsum("bihd,bjhd->bhij", sels, keys) / math.sqrt(d)
            own = _self_mask(n, obs.device)
            attn = torch.softmax(logits.masked_fill(own, -1e9), dim=-1)
            other_vals = torch.einsum("bhij,bjhd->bihd", attn, vals).reshape(b, n, hd * d)
            masked = logits.masked_fill(own, 0.0)
            attend_reg = 1e-3 * torch.mean(torch.sum(masked**2, dim=-1) / (n - 1), dim=(0, 1))
        profiling.count("update.attend_logits", b * hd * n * n)

        q = self.critics(torch.cat([sa_enc, other_vals], dim=-1))
        bias = self.biases(s_enc)
        return (q - bias)[..., 0], attend_reg
