"""MAAC: soft actor-critic style MARL with a cross-agent attention critic
(PyTorch port of mapdn_tpu/algos/maac.py; reference models/maac.py).

The Gaussian policy is forced (reference maac.py:20-38); the critic is
:class:`AttentionCritic`; the TD target carries the entropy term
``soft * log_prob / reward_scale`` (reference maac.py:109-117); the
attention regulariser is added to the policy loss (reference maac.py:118).
The loss draws exploring actions twice: from the policy,
``draws["policy_noise"]``, and from the target policy,
``draws["next_noise"]``, each (b, n, a) where given (the JAX package's
keys k1 and k2).  It declares both (``loss_noise``), so that the update
steps draw them before the loss and the step replays as a CUDA graph;
the rollout runs the base class's ``get_actions``, whose Gaussian head
reads no host value.
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.base import MARLModel
from mapdn_torch.learn.sampling import batchnorm, draw_normal
from mapdn_torch.nets.critics import AttentionCritic
from mapdn_torch.utils import profiling


class MAAC(MARLModel):
    rollout_capturable = True
    update_capturable = True

    def __init__(self, cfg, device=None, param_dtype=torch.float32):
        if not cfg.shared_params:
            raise NotImplementedError(
                "MAAC's attention critic already realizes per-agent "
                "encoders/heads internally (AttentionCritic nn.vmap axes); "
                "a non-shared variant would duplicate the shared attention "
                "projections and is not part of the reference benchmark")
        if not cfg.gaussian_policy:
            cfg = cfg.replace(gaussian_policy=True)
        super().__init__(cfg, device=device, param_dtype=param_dtype)

    def construct_value_net(self):
        pass

    def make_value_module(self):
        cfg = self.cfg
        return AttentionCritic(self.n, self.obs_dim, self.act_dim, hid_size=cfg.hid_size,
                               attend_heads=cfg.attend_heads or 1,
                               norm_in=bool(cfg.norm_in), param_dtype=self.param_dtype)

    def value(self, module, obs, act):
        """(q (b, n), attend_reg (n,))."""
        with profiling.span("update.critic"):
            return module(obs, act)

    def loss_noise(self, which):
        """The policy's exploring actions in both losses, then the target
        policy's in the value loss (:meth:`get_loss`'s order)."""
        return {"value": ("policy_noise", "next_noise"),
                "policy": ("policy_noise",)}.get(which, ())

    def next_values(self, state, b, avail, noise):
        """The bootstrap's Q: the target critic on the next obs and the
        target policy's exploring actions there (reference maac.py:109-113)."""
        with torch.no_grad(), profiling.span("update.target"):
            _, next_actions, _, _, _ = self.get_actions(
                state.target_policy, b.next_state, b.hid, status="train",
                exploration=True, avail=avail, noise=noise)
            return self.value(state.target_value, b.next_state, next_actions)[0]

    def get_loss(self, state, batch, avail, *, policy=True, value=True,
                 generator=None, draws=None):
        """(reference maac.py:96-124)."""
        cfg = self.cfg
        draws = draws or {}
        b = self.unpack(batch)
        shape = tuple(b.action.shape)
        restore_mask = (avail != 0).to(b.state.dtype)
        noise = draw_normal(draws.get("policy_noise"), shape, b.state, generator)
        with torch.set_grad_enabled(policy and torch.is_grad_enabled()):
            _, actions_pol, log_prob_a, dist, _ = self.get_actions(
                state.policy, b.state, b.last_hid, status="train", exploration=True,
                avail=avail, noise=noise)
        log_prob_a = torch.sum(restore_mask * log_prob_a, dim=-1)       # (b, n)

        policy_loss, value_loss = None, None
        if policy:
            values_pol, _ = self.value(state.value, b.state, actions_pol)
            with torch.no_grad():
                _, attn_reg = self.value(state.value, b.state, b.action)
            advantages = values_pol
            if cfg.normalize_advantages:
                advantages = batchnorm(advantages)
            if cfg.soft:
                policy_loss = log_prob_a / cfg.reward_scale - advantages
            else:
                policy_loss = -advantages.detach() * log_prob_a
            policy_loss = torch.mean(policy_loss + attn_reg[None, :])
        if value:
            next_noise = draw_normal(draws.get("next_noise"), shape, b.state, generator)
            next_values = self.next_values(state, b, avail, next_noise)
            values, _ = self.value(state.value, b.state, b.action)
            soft = 1.0 if cfg.soft else 0.0
            returns = (b.reward + cfg.gamma * (1.0 - b.done[:, None]) * next_values
                       - soft * log_prob_a.detach() / cfg.reward_scale)
            value_loss = torch.mean((returns - values) ** 2)
        return policy_loss, value_loss, dist
