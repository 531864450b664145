"""MAPPO's networks in plain PyTorch, as functions of a dict of parameters
(the reference MAPDN's rnn_agent.py and a centralised V critic).

Policy (shared over agents, the agent's one-hot appended to its obs):
fc1 -> LayerNorm -> ReLU -> GRU cell -> linear mean; a fixed std.
The GRU cell: r = s(W_ir x + b_ir + W_hr h), z = s(W_iz x + b_iz + W_hz h),
n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n + z h.
Critic: fc1 over the joint obs, plus a learned per-agent embedding ->
LayerNorm -> ReLU -> fc2 -> ReLU -> linear value, one per agent.
LayerNorm eps is 1e-6.  Parameter names and shapes are the leaves of
:func:`policy_leaves` and :func:`critic_leaves`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def policy_leaves(obs_dim, n_agents, hid, act_dim):
    """(name, shape, kind) of the policy's parameters; ``kind`` says how the
    benchmark draws it."""
    d_in = obs_dim + n_agents
    return [("fc1.weight", (hid, d_in), "dense"), ("fc1.bias", (hid,), "bias"),
            ("norm.weight", (hid,), "scale"), ("norm.bias", (hid,), "bias"),
            ("gru.weight_ih", (3 * hid, hid), "fan_in"),
            ("gru.weight_hh", (3 * hid, hid), "fan_in"),
            ("gru.bias_ih", (3 * hid,), "bias"), ("gru.bias_hn", (hid,), "bias"),
            ("head.weight", (act_dim, hid), "dense"), ("head.bias", (act_dim,), "bias")]


def critic_leaves(obs_dim, n_agents, hid):
    return [("fc1.weight", (hid, obs_dim * n_agents), "dense"), ("fc1.bias", (hid,), "bias"),
            ("norm.weight", (hid,), "scale"), ("norm.bias", (hid,), "bias"),
            ("fc2.weight", (hid, hid), "dense"), ("fc2.bias", (hid,), "bias"),
            ("head.weight", (1, hid), "dense"), ("head.bias", (1,), "bias"),
            ("agent_id_embed", (n_agents, hid), "dense")]


def _norm(x, p, prefix):
    w = p[prefix + ".weight"]
    return F.layer_norm(x, w.shape, w, p[prefix + ".bias"], LN_EPS)


def policy(p, obs, hid):
    """(B, n, o) obs and (B, n, h) hidden (None: zeros) -> means (B, n, act)
    and the new hidden."""
    b, n, _ = obs.shape
    ids = torch.eye(n, dtype=obs.dtype, device=obs.device).expand(b, n, n)
    x = torch.relu(_norm(F.linear(torch.cat([obs, ids], -1), p["fc1.weight"], p["fc1.bias"]),
                         p, "norm"))
    if hid is None:
        hid = torch.zeros(b, n, p["gru.weight_hh"].shape[1], dtype=obs.dtype, device=obs.device)
    gi = F.linear(x, p["gru.weight_ih"], p["gru.bias_ih"])
    gh = F.linear(hid, p["gru.weight_hh"])
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    cand = torch.tanh(i_n + r * (h_n + p["gru.bias_hn"]))
    new = (1.0 - z) * cand + z * hid
    return F.linear(new, p["head.weight"], p["head.bias"]), new


def critic(p, obs):
    """(B, n, o) obs -> (B, n) values."""
    b = obs.shape[0]
    h = F.linear(obs.reshape(b, -1), p["fc1.weight"], p["fc1.bias"])[:, None, :]
    h = torch.relu(_norm(h + p["agent_id_embed"][None], p, "norm"))
    h = torch.relu(F.linear(h, p["fc2.weight"], p["fc2.bias"]))
    return F.linear(h, p["head.weight"], p["head.bias"])[..., 0]
