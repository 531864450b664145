"""Losses: DDPG, actor-critic, PPO with GAE (PyTorch port of
mapdn_tpu/learn/losses.py).

Each returns (policy_loss, value_loss, (means, log_stds)) and honours
``policy=`` / ``value=``: a part not asked for is None and only what the
other part needs is evaluated.  Bootstrap targets are computed under
``torch.no_grad()``: they are stop-gradient in the JAX package, so the
values are the same and no graph is kept.

The DDPG family's policy and next actions are
``select_action_continuous(status="train", exploration=False)``, which
returns the raw means, not ``tanh(means)`` (mapdn_tpu/learn/sampling.py:
105-130); the JAX package does the same and the port keeps it.
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import flatten_batch
from mapdn_torch.learn.sampling import batchnorm, policy_log_density
from mapdn_torch.utils import profiling


def gae_advantages(rewards, next_values, values, mask, gamma, lambda_):
    """Generalized advantage estimation over the leading time axis:
    adv[t] = delta[t] + gamma lambda mask[t] adv[t+1] with
    delta[t] = r[t] + gamma mask[t] V[t+1] - V[t] (reference ppo.py:46-54)."""
    last = torch.zeros_like(rewards[0])
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        m = mask[t]
        delta = rewards[t] + gamma * next_values[t] * m - values[t]
        last = delta + gamma * lambda_ * last * m
        out.append(last)
    return torch.stack(out[::-1])


def _bootstrap(model, state, b, avail, value_module):
    """V(s', a') of the next policy's actions, no graph (the callers'
    targets are stop-gradient)."""
    with torch.no_grad(), profiling.span("update.target"):
        _, next_actions, _, _, _ = model.get_actions(
            model.next_policy(state), b.next_state, b.hid, status="train",
            exploration=False, avail=avail)
        return model.value(value_module, b.next_state, next_actions)


def ddpg_loss(model, state, batch, avail, *, policy=True, value=True):
    """TD(0) critic against the target critic and the deterministic policy
    gradient through the behaviour critic (reference
    learning_algorithms/ddpg.py:15-39); draws nothing."""
    cfg = model.cfg
    b = model.unpack(batch)
    policy_loss, value_loss, dist = None, None, (None, None)
    if policy:
        _, actions_pol, _, dist, _ = model.get_actions(
            state.policy, b.state, b.last_hid, status="train",
            exploration=False, avail=avail, need_hid=False)
        advantages = model.value(state.value, b.state, actions_pol)
        if cfg.normalize_advantages:
            advantages = batchnorm(advantages)
        policy_loss = -torch.mean(advantages)
    if value:
        next_values = _bootstrap(model, state, b, avail, state.target_value)
        values = model.value(state.value, b.state, b.action)
        returns = b.reward + cfg.gamma * (1.0 - b.done[:, None]) * next_values
        value_loss = torch.mean((returns - values) ** 2)
    return policy_loss, value_loss, dist


def actor_critic_loss(model, state, batch, avail, *, policy=True, value=True):
    """TD critic and the detached Q times the log-prob as the policy
    gradient (reference learning_algorithms/actor_critic.py:16-56).  The
    bootstrap is the behaviour critic's, not the target's (reference :37)."""
    cfg = model.cfg
    b = model.unpack(batch)
    policy_loss, value_loss, dist = None, None, (None, None)
    if policy:
        means, log_stds, _ = model.policy(state.policy, b.state, b.last_hid,
                                          need_hid=False)
        restore_mask = (avail != 0).to(means.dtype)
        log_prob_a = torch.sum(
            restore_mask * policy_log_density(cfg, b.action, means, log_stds), dim=-1)
        with torch.no_grad():
            advantages = model.value(state.value, b.state, b.action)
        if cfg.normalize_advantages:
            advantages = batchnorm(advantages)
        policy_loss = -torch.mean(advantages * log_prob_a)
        dist = (means, log_stds)
    if value:
        next_values = _bootstrap(model, state, b, avail, state.value)
        values = model.value(state.value, b.state, b.action)
        returns = b.reward + cfg.gamma * (1.0 - b.done[:, None]) * next_values
        value_loss = torch.mean((returns - values) ** 2)
    return policy_loss, value_loss, dist


def ppo_loss(model, state, batch, avail, *, policy=True, value=True):
    """Clipped-surrogate PPO with GAE over the contiguous window (reference
    learning_algorithms/ppo.py:16-71, with true behaviour log-probs in the
    ratio); draws nothing."""
    cfg = model.cfg
    restore_dtype = batch.state.dtype

    rewards = batch.reward
    if cfg.reward_normalisation:
        rewards = batchnorm(flatten_batch(rewards)).reshape(rewards.shape)
    old_values = batch.value
    done = batch.done[..., None]
    last_step = batch.last_step[..., None]
    mask = torch.where(last_step > 0, 1.0 - done, torch.ones_like(done))
    advantages = gae_advantages(rewards, batch.next_value, old_values, mask,
                                cfg.gamma, cfg.lambda_)

    b = model.unpack(batch)
    advantages = flatten_batch(advantages)
    rewards_f = flatten_batch(rewards)
    old_values_f = flatten_batch(old_values)

    policy_loss, value_loss, dist = None, None, (None, None)
    if policy:
        means, log_stds, _ = model.policy(state.policy, b.state, b.last_hid,
                                          need_hid=False)
        restore_mask = (avail != 0).to(restore_dtype)
        log_prob_a = torch.sum(
            restore_mask * policy_log_density(cfg, b.action, means, log_stds), dim=-1)
        old_log_prob_a = torch.sum(restore_mask * b.log_prob_a, dim=-1)
        ratios = torch.exp(log_prob_a - old_log_prob_a.detach())
        adv = batchnorm(advantages) if cfg.normalize_advantages else advantages
        adv = adv.detach()
        surr1 = ratios * adv
        surr2 = torch.clamp(ratios, 1.0 - cfg.eps_clip, 1.0 + cfg.eps_clip) * adv
        policy_loss = -torch.mean(torch.minimum(surr1, surr2))
        dist = (means, log_stds)
    if value:
        values = model.value(state.value, b.state, None)
        if cfg.ppo_value_target == "gae":
            # standard PPO: targets fixed within the update
            returns = (advantages + old_values_f).detach()
        else:
            next_values = model.value(state.value, b.next_state, None)
            returns = rewards_f + cfg.gamma * (1.0 - b.done[:, None]) * next_values.detach()
        values_clipped = old_values_f + torch.clamp(
            values - old_values_f, -cfg.eps_clip, cfg.eps_clip)
        vl1 = (values - returns) ** 2
        vl2 = (values_clipped - returns) ** 2
        value_loss = cfg.value_loss_coef * torch.mean(torch.maximum(vl1, vl2))
    return policy_loss, value_loss, dist
