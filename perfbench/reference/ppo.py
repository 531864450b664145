"""MAPPO's update in plain PyTorch: PPO's clipped surrogate with GAE over a
contiguous window, the clipped value loss against GAE returns, and RMSprop
after clipping the global gradient norm (MAPDN's ppo.py, mappo.py and the
RMSprop of its trainer; eps inside the root, decay 0.99).

The losses are means over every (sample, agent) entry of the window; the
per-entry terms below let a caller sum them over blocks of samples.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import nets

ROW_BLOCK = 16384


def batchnorm(x, eps=1e-5):
    """Standardise over the rows, population std, eps added to the std."""
    return (x - x.mean(0, keepdim=True)) / (x.std(0, keepdim=True, correction=0) + eps)


def gae(rewards, next_values, values, mask, gamma, lam):
    last = torch.zeros_like(rewards[0])
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * mask[t] - values[t]
        last = delta + gamma * lam * last * mask[t]
        out.append(last)
    return torch.stack(out[::-1])


def log_density(actions, means, log_std):
    """Log density of tanh-squashed Gaussian actions."""
    y = torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6)
    x = torch.atanh(y)
    var = math.exp(2.0 * log_std)
    lp = -0.5 * ((x - means) ** 2 / var + 2.0 * log_std + math.log(2.0 * math.pi))
    return lp - torch.log(1.0 - y * y + 1e-6)


def advantages(batch, alg):
    """(T, L, n) GAE advantages of a window whose rewards are normalised
    per agent over the window."""
    t, l, n = batch["reward"].shape
    rewards = batchnorm(batch["reward"].reshape(t * l, n)).reshape(t, l, n)
    mask = (1.0 - batch["done"])[..., None].expand(t, l, n)
    return gae(rewards, batch["next_value"], batch["value"], mask,
               alg["gamma"], alg["lambda_"])


def value_terms(p, obs, adv, old, alg):
    """Per-entry clipped value loss of (rows, n, o) obs against GAE returns."""
    values = nets.critic(p, obs)
    returns = adv + old
    clipped = old + torch.clamp(values - old, -alg["eps_clip"], alg["eps_clip"])
    return alg["value_loss_coef"] * torch.maximum((values - returns) ** 2,
                                                  (clipped - returns) ** 2)


def policy_terms(p, obs, hid, action, old_log_prob, adv_norm, alg):
    """Per-entry negative clipped surrogate (the fixed-std entropy term is
    a constant: :func:`entropy`)."""
    means, _ = nets.policy(p, obs, hid)
    lp = log_density(action, means, math.log(alg["fixed_policy_std"])).sum(-1)
    ratio = torch.exp(lp - old_log_prob.sum(-1))
    clip = torch.clamp(ratio, 1.0 - alg["eps_clip"], 1.0 + alg["eps_clip"])
    return -torch.minimum(ratio * adv_norm, clip * adv_norm)


def entropy(alg):
    return 0.5 + 0.5 * math.log(2.0 * math.pi) + math.log(alg["fixed_policy_std"])


def rmsprop_step(params, grads, nu, lr, max_norm, decay=0.99, eps=1e-5):
    """Clip the global norm to ``max_norm``, then RMSprop, in place; returns
    the clipped gradients."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = 1.0 if float(norm) < max_norm else max_norm / norm
    clipped = {}
    with torch.no_grad():
        for k, g in grads.items():
            g = g * scale
            nu[k].mul_(decay).add_((1.0 - decay) * g * g)
            params[k].add_(-lr * g / torch.sqrt(nu[k] + eps))
            clipped[k] = g
    return clipped


def prepared(batch, alg, dtype, device):
    b = {k: v.to(device, dtype) for k, v in batch.items()}
    t, l, n = b["reward"].shape
    adv = advantages(b, alg).reshape(t * l, n)
    flat = lambda x: x.reshape((t * l,) + tuple(x.shape[2:]))
    return {"obs": flat(b["state"]), "hid": flat(b["last_hid"]), "action": flat(b["action"]),
            "old_lp": flat(b["log_prob_a"]), "old_v": flat(b["value"]), "adv": adv,
            "adv_norm": batchnorm(adv)}


def loss_grads(which, params, b, alg):
    """(loss, {leaf: grad}) of one update step, summed over blocks of rows."""
    leaves_ = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    rows, n = b["old_v"].shape
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = 0.0
    for i in range(0, rows, ROW_BLOCK):
        sl = slice(i, i + ROW_BLOCK)
        if which == "value":
            terms = value_terms(leaves_, b["obs"][sl], b["adv"][sl], b["old_v"][sl], alg)
        else:
            terms = policy_terms(leaves_, b["obs"][sl], b["hid"][sl], b["action"][sl],
                                     b["old_lp"][sl], b["adv_norm"][sl], alg)
        part = terms.sum() / (rows * n)
        for k, g in zip(leaves_, torch.autograd.grad(part, list(leaves_.values()))):
            grads[k] += g
        loss += float(part.detach())
    if which == "policy":
        loss -= alg["entr"] * entropy(alg)
    return loss, grads


def follow(weights, chunks, batches, alg, dtype, device, nu0=None):
    """The reference's own trajectory through the update steps of
    ``chunks`` ([{"updates": [{"which", "batch"}]}]) on ``batches``, from
    ``weights`` and the optimizer state ``nu0`` (zeros where None): each
    chunk's starting parameters, the first chunk's ring values, each
    optimizer's first loss, the mean loss of each over the last chunk, the
    first clipped gradients' norms, the parameters after."""
    p = {net: {k: v.to(device, dtype).clone() for k, v in w.items()} for net, w in weights.items()}
    nu = {net: ({k: v.to(device, dtype).clone() for k, v in nu0[net].items()} if nu0 else
                {k: torch.zeros_like(v) for k, v in p[net].items()}) for net in p}
    lr = {"value": alg["value_lrate"], "policy": alg["policy_lrate"]}
    out = {"starts": [], "losses": {}, "first_grads": {}, "fill": None, "mean_losses": {}}
    for chunk in chunks:
        out["starts"].append({net: {k: v.to("cpu", copy=True) for k, v in p[net].items()}
                              for net in p})
        held = (None, None)
        last = {}
        for u in chunk["updates"]:
            if held[0] != u["batch"]:
                held = (u["batch"], prepared(batches[u["batch"]], alg, dtype, device))
            b = held[1]
            if out["fill"] is None:
                with torch.no_grad():
                    out["fill"] = torch.cat([nets.critic(p["value"], b["obs"][i:i + ROW_BLOCK])
                                             for i in range(0, len(b["obs"]), ROW_BLOCK)]).cpu()
            which = u["which"]
            loss, grads = loss_grads(which, p[which], b, alg)
            out["losses"].setdefault(which, loss)
            last.setdefault(which, []).append(loss)
            clipped = rmsprop_step(p[which], grads, nu[which], lr[which], alg["grad_clip_eps"])
            out["first_grads"].setdefault(which, {k: float(v.norm()) for k, v in clipped.items()})
        out["mean_losses"] = {w: float(np.mean(v)) for w, v in last.items()}
        del held
    out["after"] = {net: {k: v.cpu() for k, v in w.items()} for net, w in p.items()}
    return out
