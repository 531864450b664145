"""MAAC's update in plain PyTorch (Iqbal & Sha, "Actor-Attention-Critic for
Multi-Agent Reinforcement Learning", ICML 2019; MAPDN's models/maac.py,
critics/maac_critic.py and agents/rnn_agent_gaussian.py), with RMSprop
after clipping the global gradient norm and the soft target update of the
DDPG reference (perfbench/reference/ddpg.py, perfbench/reference/ppo.py).

Policy: the GRU policy of perfbench/reference/nets.py (means and the new
hidden state) with a log-std head on the new hidden state,
    log_std = lo + (hi - lo) (tanh(W h + b) + 1) / 2,
lo, hi = LOG_STD_MIN, LOG_STD_MAX.  An exploring action from a standard
normal eps (the caller's: the program's own draw) is y = tanh(x),
x = mean + exp(log_std) eps, with log-prob
    log N(x; mean, exp(log_std)) - log(1 - y^2 + 1e-6), summed over the action.

Critic, for agent i of n, on obs o and actions a:
    e_i = lrelu(A_i [o_i, a_i] + a_i0),  s_i = lrelu(S_i o_i + s_i0)
    k_j = K e_j,  q_i = Q s_i,  v_j = lrelu(V e_j + v0)   (shared, no bias on K, Q;
                                                        heads of d = hid / heads)
    alpha_ij = softmax over j != i of q_i . k_j / sqrt(d)   (per head)
    x_i = sum_{j != i} alpha_ij v_j
    Q_i = f_i([e_i, x_i]) - g_i(s_i)
f_i and g_i per-agent layers lrelu(W h + b) then a scalar; lrelu's slope
0.01.  The regulariser of sample b, agent i: 1e-3 mean over heads of
sum_{j != i} (q_i . k_j / sqrt(d))^2 / (n - 1).

One value step, on a window of rows whose rewards are standardised per
agent over the window (``reward_normalisation``):
    y~ = policy's exploring action on (obs, last hidden), noise eps1; log pi
    a' = target policy's exploring action on (next obs, hidden), noise eps2
    t  = r + gamma (1 - done) Q_target(next obs, a') - soft log pi / reward_scale
    L  = mean (t - Q(obs, action))^2                   (t with no gradient)
one policy step:
    L  = mean(log pi / reward_scale - Q(obs, y~) + reg(obs, action))
         - entr mean(0.5 + 0.5 log 2 pi + log_std)
the regulariser taken with no gradient; after the update steps of a chunk
that crossed a ``target_update_freq`` boundary, the soft update of both
networks.

Where this departs from MAPDN's models/maac.py, it keeps what the port
keeps on purpose: the regulariser is computed from the stored actions with
no gradient and enters only the policy loss, so it trains neither network
(its value still counts in the policy loss); ``norm_in`` is ignored (no
batch norm of the critic's inputs); the policy is always Gaussian with a
learned log-std; the entropy bonus is the trainer's ``entr`` on the
Gaussian's entropy; each agent's layers are batched over the agent axis.
The losses are means over every (row, agent) entry; the per-entry terms
let a caller sum them over blocks of rows.  Only the soft target
(``soft``) with unnormalised advantages is followed.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import ddpg, nets, ppo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROW_BLOCK = 8192
NOISE = ("policy_noise", "next_noise")
LOG2PI = math.log(2.0 * math.pi)


def policy_leaves(obs_dim, n_agents, hid, act_dim):
    """The GRU policy's leaves and its log-std head's."""
    return nets.policy_leaves(obs_dim, n_agents, hid, act_dim) + [
        ("log_std_head.weight", (act_dim, hid), "dense"),
        ("log_std_head.bias", (act_dim,), "bias")]


def critic_leaves(obs_dim, n_agents, hid, act_dim):
    """(name, shape, kind) of the attention critic's parameters: per-agent
    kernels (n, in, out) and biases (n, out), shared ones (out, in)."""
    n = n_agents

    def agent(name, fan_in, out):
        return [(name + ".weight", (n, fan_in, out), "dense"), (name + ".bias", (n, out), "bias")]
    return (agent("sa_encoders", obs_dim + act_dim, hid) + agent("s_encoders", obs_dim, hid)
            + [("key_proj.weight", (hid, hid), "dense"), ("sel_proj.weight", (hid, hid), "dense"),
               ("val_proj.weight", (hid, hid), "dense"), ("val_proj.bias", (hid,), "bias")]
            + agent("critics.fc", 2 * hid, hid) + agent("critics.out", hid, 1)
            + agent("biases.fc", hid, hid) + agent("biases.out", hid, 1))


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _per_agent(p, name, x):
    """(B, n, in) through agent i's kernel and bias for each i."""
    return torch.einsum("bni,nio->bno", x, p[name + ".weight"]) + p[name + ".bias"]


def critic(p, obs, act, heads):
    """(B, n, o) obs and (B, n, a) actions -> (B, n) Q values and the
    (B, n) regulariser terms."""
    b, n, _ = obs.shape
    e = _lrelu(_per_agent(p, "sa_encoders", torch.cat([obs, act], -1)))
    s = _lrelu(_per_agent(p, "s_encoders", obs))
    width = p["key_proj.weight"].shape[0]
    if width % heads:
        raise ValueError(f"{width} projection features do not split into {heads} heads")
    d = width // heads
    keys = F.linear(e, p["key_proj.weight"]).reshape(b, n, heads, d)
    sels = F.linear(s, p["sel_proj.weight"]).reshape(b, n, heads, d)
    vals = _lrelu(F.linear(e, p["val_proj.weight"], p["val_proj.bias"])).reshape(b, n, heads, d)
    scores = torch.einsum("bihd,bjhd->bhij", sels, keys) / math.sqrt(d)
    others = ~torch.eye(n, dtype=torch.bool, device=obs.device)
    weights = torch.softmax(scores.masked_fill(~others, -math.inf), dim=-1)
    attended = torch.einsum("bhij,bjhd->bihd", weights, vals).reshape(b, n, width)
    q = _per_agent(p, "critics.out", _lrelu(_per_agent(p, "critics.fc",
                                                          torch.cat([e, attended], -1))))
    base = _per_agent(p, "biases.out", _lrelu(_per_agent(p, "biases.fc", s)))
    reg = 1e-3 * ((scores * others) ** 2).sum(-1).mean(1) / (n - 1)
    return (q - base)[..., 0], reg


def gaussian(p, obs, hid, alg):
    """(B, n, o) obs and (B, n, h) hidden -> means, log-stds, new hidden."""
    means, new = nets.policy(p, obs, hid)
    lo, hi = alg["LOG_STD_MIN"], alg["LOG_STD_MAX"]
    log_std = lo + 0.5 * (hi - lo) * (torch.tanh(F.linear(new, p["log_std_head.weight"],
                                                          p["log_std_head.bias"])) + 1.0)
    return means, log_std, new


def explore(means, log_std, noise):
    """The tanh-squashed exploring action from standard normals ``noise``
    and its log-prob summed over the action: (B, n, a), (B, n)."""
    x = means + torch.exp(log_std) * noise
    y = torch.tanh(x)
    lp = -0.5 * ((x - means) ** 2 / torch.exp(2.0 * log_std) + 2.0 * log_std + LOG2PI)
    return y, (lp - torch.log(1.0 - y * y + 1e-6)).sum(-1)


def log_prob(action, means, log_std):
    """Log density of stored tanh-squashed actions under (means, log_std)."""
    y = torch.clamp(action.to(means.dtype), -1.0 + 1e-6, 1.0 - 1e-6)
    x = torch.atanh(y)
    lp = -0.5 * ((x - means) ** 2 / torch.exp(2.0 * log_std) + 2.0 * log_std + LOG2PI)
    return (lp - torch.log(1.0 - y * y + 1e-6)).sum(-1)


def prepared(batch, alg, dtype, device):
    """A (T, L, ...) window as (T L, ...) rows, rewards standardised, with
    the loss noise it holds ((T L, n, a) rows, as the program drew it; a
    policy step's holds no ``next_noise``)."""
    flat = ddpg.prepared(batch, alg, dtype, device)
    flat.update({k: batch[k].to(device, dtype) for k in NOISE if k in batch})
    return flat


def value_terms(p, targets, policy, b, alg):
    """Per-entry squared soft TD errors of (rows, n) entries."""
    with torch.no_grad():
        means, log_std, _ = gaussian(policy, b["state"], b["last_hid"], alg)
        _, logp = explore(means, log_std, b["policy_noise"])
        nm, nls, _ = gaussian(targets["policy"], b["next_state"], b["hid"], alg)
        next_act, _ = explore(nm, nls, b["next_noise"])
        next_q, _ = critic(targets["value"], b["next_state"], next_act, alg["attend_heads"])
        ret = (b["reward"] + alg["gamma"] * (1.0 - b["done"])[:, None] * next_q
               - logp / alg["reward_scale"])
    q, _ = critic(p, b["state"], b["action"], alg["attend_heads"])
    return (ret - q) ** 2


def policy_terms(p, value, b, alg):
    """Per-entry soft policy loss with the regulariser and the entropy bonus."""
    means, log_std, _ = gaussian(p, b["state"], b["last_hid"], alg)
    act, logp = explore(means, log_std, b["policy_noise"])
    q, _ = critic(value, b["state"], act, alg["attend_heads"])
    with torch.no_grad():
        _, reg = critic(value, b["state"], b["action"], alg["attend_heads"])
    ent = (0.5 + 0.5 * LOG2PI + log_std).mean(-1)
    return logp / alg["reward_scale"] - q + reg - alg["entr"] * ent


def loss_grads(which, params, targets, b, alg):
    """(loss, {leaf: grad}) of one update step of ``which``, summed over
    blocks of rows."""
    if alg["normalize_advantages"] or not alg["soft"]:
        raise NotImplementedError("only the soft target with unnormalised advantages splits "
                                  "into blocks of rows")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params[which].items()}
    rows, n = b["reward"].shape
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss = 0.0
    for i in range(0, rows, ROW_BLOCK):
        blk = {k: v[i:i + ROW_BLOCK] for k, v in b.items()}
        if which == "value":
            terms = value_terms(leaves, targets, params["policy"], blk, alg)
        else:
            terms = policy_terms(leaves, params["value"], blk, alg)
        part = terms.sum() / (rows * n)
        for k, g in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
            grads[k] += g
        loss += float(part.detach())
    return loss, grads


def follow(weights, chunks, batches, alg, dtype, device, nu0=None, targets0=None):
    """The reference's own trajectory through the update steps of
    ``chunks`` ([{"updates": [{"which", "batch"}], "soft_update": bool}])
    on ``batches`` (each with its loss noise), from ``weights``, the
    targets ``targets0`` (the weights where None) and the optimizer state
    ``nu0`` (zeros where None): each chunk's starting parameters, the
    critic's Q on the first batch, each optimizer's first loss, the mean
    loss of each over the last chunk, the first clipped gradients' norms,
    and the parameters after (``target_policy``, ``target_value`` the
    targets)."""
    dev = lambda w: {k: v.to(device, dtype).clone() for k, v in w.items()}
    p = {net: dev(w) for net, w in weights.items()}
    targets = {net: dev(w) for net, w in (targets0 or weights).items()}
    nu = {net: (dev(nu0[net]) if nu0 else {k: torch.zeros_like(v) for k, v in p[net].items()})
          for net in p}
    lr = {"value": alg["value_lrate"], "policy": alg["policy_lrate"]}
    out = {"starts": [], "losses": {}, "first_grads": {}, "fill": None, "mean_losses": {}}
    for chunk in chunks:
        out["starts"].append({net: {k: v.to("cpu", copy=True) for k, v in w.items()}
                              for net, w in p.items()})
        last = {}
        for u in chunk["updates"]:
            b = prepared(batches[u["batch"]], alg, dtype, device)
            if out["fill"] is None:
                with torch.no_grad():
                    out["fill"] = torch.cat([
                        critic(p["value"], b["state"][i:i + ROW_BLOCK],
                               b["action"][i:i + ROW_BLOCK], alg["attend_heads"])[0]
                        for i in range(0, len(b["state"]), ROW_BLOCK)]).cpu()
            which = u["which"]
            loss, grads = loss_grads(which, p, targets, b, alg)
            out["losses"].setdefault(which, loss)
            last.setdefault(which, []).append(loss)
            clipped = ppo.rmsprop_step(p[which], grads, nu[which], lr[which],
                                       alg["grad_clip_eps"])
            out["first_grads"].setdefault(which, {k: float(v.norm())
                                                  for k, v in clipped.items()})
            del b
        if chunk.get("soft_update"):
            ddpg.soft_update(targets, p, alg["target_lr"])
        out["mean_losses"] = {w: float(np.mean(v)) for w, v in last.items()}
    out["after"] = {net: {k: v.cpu() for k, v in w.items()} for net, w in p.items()}
    out["after"].update({"target_" + net: {k: v.cpu() for k, v in w.items()}
                         for net, w in targets.items()})
    return out
