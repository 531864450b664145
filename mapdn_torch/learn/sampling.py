"""Action selection, densities and small tensor utilities (PyTorch port of
mapdn_tpu/learn/sampling.py, continuous-action paths)."""
from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def normal_log_density(x, mean, log_std):
    """Diagonal-Gaussian log density (reference util.py:44-46)."""
    var = torch.exp(2.0 * log_std)
    return -0.5 * ((x - mean) ** 2 / var + 2.0 * log_std + LOG2PI)


def normal_entropy(mean, log_std):
    """Mean entropy of a diagonal Gaussian (reference util.py:37-38)."""
    return torch.mean(0.5 + 0.5 * LOG2PI + log_std)


def policy_log_density(cfg, actions, means, log_stds):
    """Log density of a stored action under the current policy; with
    ``action_enforcebound`` the tanh squash is inverted:
    log N(atanh(y); mean, std) - log(1 - y^2)."""
    if cfg.action_enforcebound:
        y = torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6)
        x = torch.atanh(y)
        return normal_log_density(x, means, log_stds) - torch.log(1.0 - y * y + 1e-6)
    return normal_log_density(actions, means, log_stds)


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
        if noise is None:
            noise = torch.randn(means.shape, generator=generator,
                                dtype=means.dtype, device=means.device)
        noise = torch.as_tensor(noise, device=means.device).to(means.dtype)
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
    util.py:155-159)."""
    mean = torch.mean(x, dim=dim, keepdim=True)
    std = torch.std(x, dim=dim, keepdim=True, correction=0)
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
