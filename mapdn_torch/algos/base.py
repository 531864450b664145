"""Shared MARL model base (PyTorch port of mapdn_tpu/algos/base.py).

* shared-parameter policy with an agent-id one-hot appended to the obs
  (reference model.py:101-139);
* soft target updates target <- (1 - tau) target + tau behaviour
  (reference model.py:27-37, tau = target_lr);
* per-head RMSprop(decay 0.99, eps 1e-5) after global-norm clipping, written
  out by hand to match optax: ``rsqrt(nu + eps)`` (eps inside the root, where
  ``torch.optim.RMSprop`` adds it outside) and no ``+1e-6`` in the clip
  (where ``clip_grad_norm_`` adds one);
* the Transition record (reference model.py:18).

Only the shared-parameter path and deterministic (fixed-std) policies are
ported.  Learnable state lives in :class:`AlgoState` (modules + optimizer
states); the model holds static configuration.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import List

import torch

from mapdn_torch.learn.sampling import batchnorm, select_action_continuous
from mapdn_torch.nets.agents import MLPAgent, RNNAgent
from mapdn_torch.utils.device import resolve_device


@dataclasses.dataclass
class Transition:
    """One (vectorized) transition; every field has a leading lane dim."""
    state: torch.Tensor        # (L, n, obs)
    action: torch.Tensor       # (L, n, act) policy output pre-translate
    log_prob_a: torch.Tensor   # (L, n, act)
    value: torch.Tensor        # (L, n)
    next_value: torch.Tensor   # (L, n)
    reward: torch.Tensor       # (L, n) team reward repeated per agent
    next_state: torch.Tensor   # (L, n, obs)
    done: torch.Tensor         # (L,)
    last_step: torch.Tensor    # (L,)
    last_hid: torch.Tensor     # (L, n, hid)
    hid: torch.Tensor          # (L, n, hid) or (L, n, 0)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn, *others):
        """Apply ``fn`` field-wise (to this and the same fields of others)."""
        return Transition(**{f.name: fn(getattr(self, f.name),
                                         *(getattr(o, f.name) for o in others))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class AlgoState:
    """Learnable state of one algorithm: behaviour and target modules and
    the optimizer states (one second-moment tensor per parameter)."""
    policy: torch.nn.Module
    value: torch.nn.Module
    target_policy: torch.nn.Module
    target_value: torch.nn.Module
    policy_opt: List[torch.Tensor]
    value_opt: List[torch.Tensor]


@torch.no_grad()
def soft_update(target, source, tau):
    """target <- (1 - tau) target + tau source, in place."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_((1.0 - tau) * t + tau * s)


def flatten_batch(x):
    """(T, L, ...) -> (T*L, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


class ClippedRMSprop:
    """``optax.chain(clip_by_global_norm(max_norm), rmsprop(lr, decay, eps))``
    on a list of parameters, in place:

        g  <- g if |g| < max_norm else g / |g| * max_norm   (|.| global norm)
        nu <- (1 - decay) g^2 + decay nu
        p  <- p + (-lr) rsqrt(nu + eps) g
    """

    def __init__(self, lr, max_norm, decay=0.99, eps=1e-5):
        self.lr, self.max_norm, self.decay, self.eps = lr, max_norm, decay, eps

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, nu):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < self.max_norm
        for p, g, n in zip(params, grads, nu):
            g = torch.where(trigger, g, (g / g_norm.to(g.dtype)) * self.max_norm)
            n.copy_((1 - self.decay) * g**2 + self.decay * n)
            p.copy_(p + torch.rsqrt(n + self.eps) * g * (-self.lr))


class MARLModel:
    """Base class; subclasses define the critic and the loss."""

    on_policy = False
    stores_rollout_value = False
    stores_next_hidden = True

    def __init__(self, cfg, device=None, param_dtype=torch.float32):
        if not cfg.continuous:
            raise NotImplementedError("only continuous actions are ported")
        if not cfg.shared_params:
            raise NotImplementedError("shared_params: False is not ported yet")
        if cfg.gaussian_policy:
            raise NotImplementedError("Gaussian policies are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.n = cfg.agent_num
        self.obs_dim = cfg.obs_size
        self.act_dim = cfg.action_dim
        self.hid_dim = cfg.hid_size
        self.construct_value_net()
        self.policy_tx = ClippedRMSprop(cfg.policy_lrate, cfg.grad_clip_eps)
        self.value_tx = ClippedRMSprop(cfg.value_lrate, cfg.grad_clip_eps)

    # ------------------------------------------------------------- modules
    def _net_kw(self):
        cfg = self.cfg
        return dict(hid_size=cfg.hid_size, layernorm=cfg.layernorm,
                    hid_activation=cfg.hid_activation, init_type=cfg.init_type,
                    init_std=cfg.init_std, param_dtype=self.param_dtype)

    def make_policy_module(self):
        cls = {"mlp": MLPAgent, "rnn": RNNAgent}.get(self.cfg.agent_type)
        if cls is None:
            raise ValueError(f"unknown agent_type {self.cfg.agent_type}")
        in_dim = self.obs_dim + (self.n if self.cfg.agent_id else 0)
        return cls(in_dim, action_dim=self.act_dim, **self._net_kw())

    def construct_value_net(self):
        """Subclasses set self.value_in_dim and define make_value_module."""
        raise NotImplementedError

    def make_value_module(self):
        raise NotImplementedError

    # ---------------------------------------------------------------- init
    def init_state(self, generator=None) -> AlgoState:
        """Fresh parameters drawn on the CPU from ``generator`` (so a seed
        gives the same weights on any device), then moved to the device."""
        policy = self.make_policy_module().reset_parameters(generator)
        value = self.make_value_module().reset_parameters(generator)
        return self.state_from_modules(policy, value)

    def state_from_modules(self, policy, value) -> AlgoState:
        """AlgoState around given behaviour modules: targets are copies,
        optimizer states zero."""
        policy = policy.to(self.device)
        value = value.to(self.device)
        return AlgoState(
            policy=policy, value=value,
            target_policy=copy.deepcopy(policy).requires_grad_(False),
            target_value=copy.deepcopy(value).requires_grad_(False),
            policy_opt=self.policy_tx.init(list(policy.parameters())),
            value_opt=self.value_tx.init(list(value.parameters())))

    def init_hidden(self, batch_size, dtype=torch.float32):
        """(b, n, hid) zero GRU state."""
        return torch.zeros((batch_size, self.n, self.hid_dim), dtype=dtype,
                           device=self.device)

    # --------------------------------------------------------------- policy
    def agent_ids(self, batch_size, dtype=torch.float32):
        eye = torch.eye(self.n, dtype=dtype, device=self.device)
        return eye.expand(batch_size, self.n, self.n)

    def policy(self, module, obs, last_hid):
        """(b, n, o) -> means, log_stds, hid (b, n, .) (reference
        model.py:101-139), fixed std exp(log fixed_policy_std)."""
        b = obs.shape[0]
        if self.cfg.agent_id:
            obs = torch.cat([obs, self.agent_ids(b, obs.dtype)], dim=-1)
        flat = obs.reshape(b * self.n, -1)
        hid_flat = last_hid.reshape(b * self.n, self.hid_dim)
        means, _, hid = module(flat, hid_flat)
        means = means.reshape(b, self.n, -1)
        hid = (hid_flat if hid is None else hid).reshape(b, self.n, -1)
        log_stds = torch.full_like(
            means, math.log(self.cfg.fixed_policy_std))
        return means, log_stds, hid

    def get_actions(self, module, obs, last_hid, *, status, exploration,
                    avail, clip=False, generator=None, noise=None):
        """Sample/evaluate actions; ``avail`` (n, n_actions) mask."""
        means, log_stds, hid = self.policy(module, obs, last_hid)
        actions, log_prob = select_action_continuous(
            self.cfg, means, log_stds, status=status, exploration=exploration,
            clip=clip, generator=generator, noise=noise)
        restore = (avail != 0).to(actions.dtype) * actions
        if log_prob is None:
            log_prob = torch.zeros_like(means)
        return actions, restore, log_prob, (means, log_stds), hid

    # ---------------------------------------------------------------- value
    def value(self, module, obs, act=None):
        raise NotImplementedError

    # ---------------------------------------------------------------- batch
    def unpack(self, batch: Transition) -> Transition:
        """Flatten (T, L, ...) -> (b, ...) with reward normalization
        (reference model.py:304-319)."""
        flat = batch.map(flatten_batch)
        reward = flat.reward
        if self.cfg.reward_normalisation:
            reward = batchnorm(reward)
        return flat.replace(reward=reward)

    def get_loss(self, state: AlgoState, batch: Transition, avail, **parts):
        """(policy_loss, value_loss, (means, log_stds))."""
        raise NotImplementedError
