"""Action selection, densities and small tensor utilities (PyTorch port of
mapdn_tpu/learn/sampling.py).

Every function that draws takes its noise as an optional explicit tensor
(``noise``, ``u``, ``draws``) and otherwise draws from a
``torch.Generator`` on the input's device.  The discrete-action helpers
(``categorical_entropy``, ``gumbel_softmax_sample``,
``multinomials_log_density``, ``select_action_discrete``) serve custom
discrete envs: no algorithm of the port trains with discrete actions, as in
the JAX package (``continuous: False`` is refused in algos/base.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mapdn_torch.utils import lanes

LOG2PI = math.log(2.0 * math.pi)


def normal_log_density(x, mean, log_std):
    """Diagonal-Gaussian log density (reference util.py:44-46)."""
    var = torch.exp(2.0 * log_std)
    return -0.5 * ((x - mean) ** 2 / var + 2.0 * log_std + LOG2PI)


def normal_entropy(mean, log_std):
    """Mean entropy of a diagonal Gaussian (reference util.py:37-38)."""
    return torch.mean(0.5 + 0.5 * LOG2PI + log_std)


def categorical_entropy(logits):
    """Mean entropy of a categorical over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


def _uniform(u, like, generator):
    """``u`` on ``like``'s device and dtype, or uniforms in [0, 1) of its
    shape drawn from ``generator``."""
    if u is not None:
        return torch.as_tensor(u, device=like.device).to(like.dtype)
    return torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def gumbel_softmax_sample(logits, temperature=0.1, eps=1e-20, *, generator=None, u=None):
    """Reparameterized Gumbel-softmax draw (reference util.py:9-35) from the
    uniforms ``u`` (the shape of ``logits``), drawn from ``generator`` when
    None."""
    u = _uniform(u, logits, generator)
    g = -torch.log(-torch.log(u + eps) + eps)
    return torch.softmax((logits + g) / temperature, dim=-1)


def _categorical(index, logits, generator):
    """The drawn class of each row of ``logits``: ``index`` when given, else
    the Gumbel-max draw argmax(logits + Gumbel) from ``generator`` (the
    law of ``jax.random.categorical``)."""
    if index is not None:
        return torch.as_tensor(index, device=logits.device).long()
    tiny = torch.finfo(logits.dtype).tiny
    u = _uniform(None, logits, generator).clamp_min(tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def multinomials_log_density(actions, logits):
    """Categorical log density sum_i a_i log p_i (reference util.py:47-50),
    with the last axis kept; valid for hard one-hots and for relaxed
    Gumbel-softmax samples."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(actions * logp, dim=-1, keepdim=True)


def select_action_discrete(cfg, logits, *, status="train", exploration=True,
                           generator=None, draws=None):
    """Discrete-action selection (reference util.py:87-121).

    test: the greedy one-hot ``p == max(p)`` (every tied class is 1);
    train with exploration and ``cfg.epsilon_softmax``: a one-hot draw from
    (1 - eps) * softmax + eps / n with the log of that probability; with
    ``cfg.gumbel_softmax``: the differentiable Gumbel-softmax rsample at
    T=0.1 with exploration, a detached sample at T=1.0 without; otherwise
    a plain categorical one-hot.  Returns (actions, log_prob | None),
    log_prob of shape (..., 1).  ``draws`` replaces the generator's draw:
    the uniforms (the shape of ``logits``) of the Gumbel branches, the
    drawn class indices (its shape without the last axis) of the
    categorical ones."""
    n = logits.shape[-1]
    if status == "test":
        p = torch.softmax(logits, dim=-1)
        return (p == p.amax(dim=-1, keepdim=True)).to(logits.dtype), None
    if exploration and cfg.epsilon_softmax:
        eps = cfg.softmax_eps
        probs = (1.0 - eps) * torch.softmax(logits, dim=-1) + eps / n
        idx = _categorical(draws, torch.log(probs), generator)
        actions = F.one_hot(idx, n).to(logits.dtype)
        return actions, torch.sum(actions * torch.log(probs), dim=-1, keepdim=True)
    if cfg.gumbel_softmax:
        if exploration:     # differentiable rsample (reference :97-101)
            actions = gumbel_softmax_sample(logits, 0.1, generator=generator, u=draws)
        else:               # detached T=1.0 sample (reference :109-113)
            actions = gumbel_softmax_sample(logits, 1.0, generator=generator,
                                            u=draws).detach()
        return actions, multinomials_log_density(actions, logits)
    actions = F.one_hot(_categorical(draws, logits, generator), n).to(logits.dtype)
    return actions, multinomials_log_density(actions, logits)


def policy_log_density(cfg, actions, means, log_stds):
    """Log density of a stored action under the current policy; with
    ``action_enforcebound`` the tanh squash is inverted:
    log N(atanh(y); mean, std) - log(1 - y^2)."""
    if cfg.action_enforcebound:
        y = torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6)
        x = torch.atanh(y)
        return normal_log_density(x, means, log_stds) - torch.log(1.0 - y * y + 1e-6)
    return normal_log_density(actions, means, log_stds)


def draw_normal(given, shape, like, generator, axis=0):
    """``given`` (an explicit draw) on ``like``'s device and dtype, or when
    it is None standard normals of ``shape`` drawn there from
    ``generator``; ``axis`` is the draw's lane or batch-row axis (drawn,
    or given, whole under a :class:`mapdn_torch.utils.lanes.LaneShard`)."""
    if given is not None:
        return torch.as_tensor(lanes.given(given, axis), device=like.device).to(like.dtype)
    return lanes.draw(lambda s: torch.randn(s, generator=generator, dtype=like.dtype,
                                            device=like.device), shape, axis)


def select_action_continuous(cfg, means, log_stds, *, status="train",
                             exploration=True, clip=False, generator=None,
                             noise=None):
    """Continuous-action selection (reference util.py:52-87).

    Returns (actions, log_prob | None).  Exploration draws standard normals
    from ``generator`` unless ``noise`` (same shape as ``means``) is given.
    With ``action_enforcebound``: x ~ N(mean, std), a = tanh(x) with the
    tanh log-prob correction; otherwise zero-mean noise is added (clamped to
    +-clip_c with ``clip``).
    """
    if status == "train" and exploration:
        std = torch.exp(log_stds)
        noise = draw_normal(noise, means.shape, means, generator)
        if cfg.action_enforcebound:
            x = means + std * noise
            y = torch.tanh(x)
            log_prob = normal_log_density(x, means, log_stds)
            log_prob = log_prob - torch.log(1.0 - y**2 + 1e-6)
            return y, log_prob
        noise = std * noise
        log_prob = normal_log_density(noise, torch.zeros_like(means), log_stds)
        if clip:
            noise = torch.clamp(noise, -cfg.clip_c, cfg.clip_c)
        return means + noise, log_prob
    if status == "test" and cfg.action_enforcebound:
        return torch.tanh(means), None
    return means, None


def batchnorm(x, dim=0, eps=1e-5):
    """Batch standardization with the population std (reference
    util.py:155-159); under a lane shard the statistics are the whole
    batch's (``dim`` 0, the batch rows)."""
    shard = lanes.current()
    if shard is None:
        mean = torch.mean(x, dim=dim, keepdim=True)
        std = torch.std(x, dim=dim, keepdim=True, correction=0)
    else:
        if dim != 0:
            raise ValueError("a sharded batchnorm normalizes over the batch rows (dim 0)")
        mean = lanes.row_sum(x)[None] / shard.n_global
        std = torch.sqrt(lanes.row_sum((x - mean) ** 2)[None] / shard.n_global)
    return (x - mean) / (std + eps)


def global_norm(tensors):
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def translate_action(cfg, actions):
    """clamp to [-1,1] then affine to [bias-scale, bias+scale]
    (reference util.py:123-132)."""
    a = torch.clamp(actions, -1.0, 1.0)
    low = cfg.action_bias - cfg.action_scale
    high = cfg.action_bias + cfg.action_scale
    return 0.5 * (a + 1.0) * (high - low) + low
