"""MADDPG's update in plain PyTorch: the centralised critic Q_i(all obs,
agent i's one-hot, all actions), the DDPG losses, RMSprop after clipping
the global gradient norm, and the soft target update (MAPDN's
models/maddpg.py, learning_algorithms/ddpg.py and the trainer's update
cadence).

The critic is one MLP shared by the agents: agent i's row holds every
agent's obs, then i's one-hot, then every agent's action;
fc1 -> LayerNorm -> ReLU -> fc2 -> ReLU -> linear Q.  In the policy loss
only agent i's own action in its row carries a gradient to the policy.

One value step, on a window of rows whose rewards are standardised per
agent over the window (``reward_normalisation``):
    a' = mean of the behaviour policy on (next obs, its stored hidden state)
    y  = r + gamma (1 - done) Q_target(next obs, a')    (no gradient)
    L  = mean (y - Q(obs, action))^2
one policy step:
    L  = -mean Q(obs, mean of the policy on (obs, last hidden)) - entr H
with H the fixed-std Gaussian's entropy, a constant.  After the update
steps of a chunk that crossed a ``target_update_freq`` boundary,
target <- (1 - target_lr) target + target_lr online, for both networks.

Where this departs from the reference MAPDN, it keeps what the port keeps
on purpose: the policy's actions in both losses are its pre-tanh means
(the reference takes them from select_action in "train" status without
exploration, which returns the means), the bootstrap's next actions come
from the behaviour policy (``double_q``), and each agent's row of the
critic carries its one-hot.  The losses are means over every (row,
agent) entry; the per-entry terms let a caller sum them over blocks of
rows.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import nets, ppo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROW_BLOCK = 16384
FIELDS = ("state", "next_state", "last_hid", "hid", "action", "reward", "done")


def critic_leaves(obs_dim, n_agents, hid, act_dim):
    """(name, shape, kind) of the critic's parameters."""
    d_in = (obs_dim + act_dim) * n_agents + n_agents
    return [("fc1.weight", (hid, d_in), "dense"), ("fc1.bias", (hid,), "bias"),
            ("norm.weight", (hid,), "scale"), ("norm.bias", (hid,), "bias"),
            ("fc2.weight", (hid, hid), "dense"), ("fc2.bias", (hid,), "bias"),
            ("head.weight", (1, hid), "dense"), ("head.bias", (1,), "bias")]


def joint(obs, act, own_live=False):
    """(B, n, o) obs and (B, n, a) actions -> (B, n, n o + n + n a) critic
    rows; with ``own_live`` agent i's row passes a gradient only to agent
    i's action."""
    b, n, _ = obs.shape
    eye = torch.eye(n, dtype=obs.dtype, device=obs.device)
    acts = act[:, None].expand(b, n, n, act.shape[-1])
    if own_live:
        own = eye[None, :, :, None]
        acts = acts.detach() * (1.0 - own) + acts * own
    return torch.cat([obs.reshape(b, 1, -1).expand(b, n, -1), eye.expand(b, n, n),
                      acts.reshape(b, n, -1)], -1)


def critic(p, x):
    """(B, n, d) rows -> (B, n) Q values."""
    w = p["norm.weight"]
    h = F.layer_norm(F.linear(x, p["fc1.weight"], p["fc1.bias"]), w.shape, w,
                     p["norm.bias"], nets.LN_EPS)
    h = torch.relu(F.linear(torch.relu(h), p["fc2.weight"], p["fc2.bias"]))
    return F.linear(h, p["head.weight"], p["head.bias"])[..., 0]


def q_values(p, obs, act):
    return critic(p, joint(obs, act))


def prepared(batch, alg, dtype, device):
    """A (T, L, ...) window as (T L, ...) rows, rewards standardised."""
    b = {k: batch[k].to(device, dtype) for k in FIELDS}
    t, l = b["reward"].shape[:2]
    flat = {k: v.reshape((t * l,) + tuple(v.shape[2:])) for k, v in b.items()}
    if alg["reward_normalisation"]:
        flat["reward"] = ppo.batchnorm(flat["reward"])
    return flat


def value_terms(p, target, policy, b, alg):
    """Per-entry squared TD errors of (rows, n) entries."""
    with torch.no_grad():
        next_act, _ = nets.policy(policy, b["next_state"], b["hid"])
        next_q = q_values(target, b["next_state"], next_act)
        ret = b["reward"] + alg["gamma"] * (1.0 - b["done"])[:, None] * next_q
    return (ret - q_values(p, b["state"], b["action"])) ** 2


def policy_terms(p, value, b):
    """Per-entry -Q at the policy's own means."""
    means, _ = nets.policy(p, b["state"], b["last_hid"])
    return -critic(value, joint(b["state"], means, own_live=True))


def loss_grads(which, params, targets, b, alg):
    """(loss, {leaf: grad}) of one update step of ``which``, summed over
    blocks of rows."""
    if alg["normalize_advantages"]:
        raise NotImplementedError("a standardised Q in the policy loss does not split into "
                                  "blocks of rows")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params[which].items()}
    rows, n = b["reward"].shape
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss = 0.0
    for i in range(0, rows, ROW_BLOCK):
        blk = {k: v[i:i + ROW_BLOCK] for k, v in b.items()}
        if which == "value":
            terms = value_terms(leaves, targets["value"], params["policy"], blk, alg)
        else:
            terms = policy_terms(leaves, params["value"], blk)
        part = terms.sum() / (rows * n)
        for k, g in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
            grads[k] += g
        loss += float(part.detach())
    if which == "policy":
        loss -= alg["entr"] * ppo.entropy(alg)
    return loss, grads


def soft_update(targets, params, tau):
    with torch.no_grad():
        for net, t in targets.items():
            for k in t:
                t[k].copy_((1.0 - tau) * t[k] + tau * params[net][k])


def follow(weights, chunks, batches, alg, dtype, device, nu0=None, targets0=None):
    """The reference's own trajectory through the update steps of
    ``chunks`` ([{"updates": [{"which", "batch"}], "soft_update": bool}])
    on ``batches``, from ``weights``, the targets ``targets0`` (the
    weights where None) and the optimizer state ``nu0`` (zeros where
    None): each chunk's starting parameters, the critic's Q on the first
    batch, each optimizer's first loss, the mean loss of each over the
    last chunk, the first clipped gradients' norms, and the parameters
    after (``target_policy``, ``target_value`` the targets)."""
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
        held, last = (None, None), {}
        for u in chunk["updates"]:
            if held[0] != u["batch"]:
                held = (u["batch"], prepared(batches[u["batch"]], alg, dtype, device))
            b = held[1]
            if out["fill"] is None:
                with torch.no_grad():
                    out["fill"] = torch.cat([
                        q_values(p["value"], b["state"][i:i + ROW_BLOCK],
                                 b["action"][i:i + ROW_BLOCK])
                        for i in range(0, len(b["state"]), ROW_BLOCK)]).cpu()
            which = u["which"]
            loss, grads = loss_grads(which, p, targets, b, alg)
            out["losses"].setdefault(which, loss)
            last.setdefault(which, []).append(loss)
            clipped = ppo.rmsprop_step(p[which], grads, nu[which], lr[which],
                                       alg["grad_clip_eps"])
            out["first_grads"].setdefault(which, {k: float(v.norm())
                                                  for k, v in clipped.items()})
        del held
        if chunk.get("soft_update"):
            soft_update(targets, p, alg["target_lr"])
        out["mean_losses"] = {w: float(np.mean(v)) for w, v in last.items()}
    out["after"] = {net: {k: v.cpu() for k, v in w.items()} for net, w in p.items()}
    out["after"].update({"target_" + net: {k: v.cpu() for k, v in w.items()}
                         for net, w in targets.items()})
    return out
