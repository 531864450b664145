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

Under ``shared_params: False`` the policy and the critic are per-agent
modules (``per_agent=n``: every parameter has a leading agent axis, as the
JAX package's stacked trees of mapdn_tpu/algos/base.py:185-214), applied
to (b, n, .) inputs agent by agent; a mixer stays shared.  Policies are
deterministic with a fixed std, or Gaussian with the module's own
log-stds (``gaussian_policy``).  Learnable state lives in :class:`AlgoState`
(modules + optimizer states, and a mixer head for algorithms that have
one); the model holds static configuration.

Randomness in a loss (MATD3's target smoothing, COMA's baseline samples,
SQDDPG's coalitions) comes from the ``generator`` passed to ``get_loss``,
or explicitly from its ``draws`` dict, one tensor a draw, so parity runs
can hand in the JAX package's draws.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional

import torch

from mapdn_torch.learn.sampling import batchnorm, select_action_continuous
from mapdn_torch.nets import policy_gru
from mapdn_torch.nets.agents import MLPAgent, MLPAgentGaussian, RNNAgent, RNNAgentGaussian
from mapdn_torch.nets.critics import MLPCritic
from mapdn_torch.utils import profiling
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
    the optimizer states (one second-moment tensor per parameter).  The
    mixer head (``mixer``, ``target_mixer``, ``mixer_opt``) is None and
    empty for an algorithm without a mixer."""
    policy: torch.nn.Module
    value: torch.nn.Module
    target_policy: torch.nn.Module
    target_value: torch.nn.Module
    policy_opt: List[torch.Tensor]
    value_opt: List[torch.Tensor]
    mixer: Optional[torch.nn.Module] = None
    target_mixer: Optional[torch.nn.Module] = None
    mixer_opt: List[torch.Tensor] = dataclasses.field(default_factory=list)


@torch.no_grad()
def soft_update(target, source, tau):
    """target <- (1 - tau) target + tau source, in place."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_((1.0 - tau) * t + tau * s)


def flatten_batch(x):
    """(T, L, ...) -> (T*L, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def mix_detached(x, detached, live):
    """``x.detach() * detached + x * live``: the entries ``live`` marks pass
    gradients, the ones ``detached`` marks only values (the joint action
    of a centralized critic, where an agent's gradient reaches its own
    action only: reference maddpg.py:40-65)."""
    return x.detach() * detached + x * live


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
    uses_mixer = False
    stores_rollout_value = False
    # a stores_rollout_value algorithm whose critic needs actions cannot be
    # evaluated by the trainer's act=None ring value fill (refused there)
    rollout_value_needs_act = False
    stores_next_hidden = True
    # whether the rollout step (get_actions and what it calls) reads no host
    # value that varies from step to step, so that the trainer may capture
    # the step once as a CUDA graph and replay it (learn/rollout_graph.py);
    # set only where that was checked
    rollout_capturable = False
    # whether an update step (the window's gather, get_loss, the gradients
    # and the optimizer step) reads no host value and draws nothing but the
    # noise its loss declares (``loss_noise``), so that the trainer may
    # capture it once as a CUDA graph and replay it for every epoch
    # (learn/update_graph.py); set only where that was checked
    update_capturable = False

    def __init__(self, cfg, device=None, param_dtype=torch.float32):
        if not cfg.continuous:
            raise NotImplementedError(
                "discrete action spaces: the voltage-control benchmark only "
                "exercises the continuous path (reference args/default.yaml "
                "continuous: True; its discrete loss branches are broken, "
                "e.g. coma.py:83). The selection/density utilities exist in "
                "learn.sampling (select_action_discrete, "
                "multinomials_log_density) for custom discrete envs.")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.n = cfg.agent_num
        self.obs_dim = cfg.obs_size
        self.act_dim = cfg.action_dim
        self.hid_dim = cfg.hid_size
        # None: one set of parameters for all agents; else per-agent modules
        self.per_agent = None if cfg.shared_params else self.n
        self.construct_value_net()
        self.policy_tx = ClippedRMSprop(cfg.policy_lrate, cfg.grad_clip_eps)
        self.value_tx = ClippedRMSprop(cfg.value_lrate, cfg.grad_clip_eps)
        self.mixer_tx = ClippedRMSprop(cfg.mixer_lrate or cfg.value_lrate,
                                       cfg.grad_clip_eps)

    # ------------------------------------------------------------- modules
    def _net_kw(self):
        cfg = self.cfg
        return dict(hid_size=cfg.hid_size, layernorm=cfg.layernorm,
                    hid_activation=cfg.hid_activation, init_type=cfg.init_type,
                    init_std=cfg.init_std, param_dtype=self.param_dtype)

    def make_policy_module(self):
        cfg = self.cfg
        if cfg.gaussian_policy:
            cls = {"mlp": MLPAgentGaussian, "rnn": RNNAgentGaussian}.get(cfg.agent_type)
            extra = dict(log_std_min=cfg.LOG_STD_MIN, log_std_max=cfg.LOG_STD_MAX)
        else:
            cls = {"mlp": MLPAgent, "rnn": RNNAgent}.get(cfg.agent_type)
            extra = {}
        if cls is None:
            raise ValueError(f"unknown agent_type {cfg.agent_type}")
        in_dim = self.obs_dim + (self.n if cfg.agent_id else 0)
        return cls(in_dim, action_dim=self.act_dim, per_agent=self.per_agent, **extra,
                   **self._net_kw())

    def construct_value_net(self):
        """Subclasses set self.value_in_dim and define make_value_module."""
        raise NotImplementedError

    def make_value_module(self):
        """An MLP critic over ``value_in_dim`` features, per agent under
        ``shared_params: False`` (subclasses with another critic
        override)."""
        return MLPCritic(self.value_in_dim, output_dim=1, per_agent=self.per_agent,
                         **self._net_kw())

    def make_mixer_module(self):
        """The mixer of an algorithm with ``uses_mixer``."""
        raise NotImplementedError

    # ---------------------------------------------------------------- init
    def init_state(self, generator=None) -> AlgoState:
        """Fresh parameters drawn on the CPU from ``generator`` (so a seed
        gives the same weights on any device), then moved to the device."""
        policy = self.make_policy_module().reset_parameters(generator)
        value = self.make_value_module().reset_parameters(generator)
        mixer = (self.make_mixer_module().reset_parameters(generator)
                 if self.uses_mixer else None)
        return self.state_from_modules(policy, value, mixer)

    def state_from_modules(self, policy, value, mixer=None) -> AlgoState:
        """AlgoState around given behaviour modules: targets are copies,
        optimizer states zero."""
        if (mixer is not None) != self.uses_mixer:
            raise ValueError(f"{type(self).__name__} takes "
                             f"{'a' if self.uses_mixer else 'no'} mixer")
        target = lambda m: copy.deepcopy(m).requires_grad_(False)
        policy, value = policy.to(self.device), value.to(self.device)
        extra = {}
        if mixer is not None:
            mixer = mixer.to(self.device)
            extra = dict(mixer=mixer, target_mixer=target(mixer),
                         mixer_opt=self.mixer_tx.init(list(mixer.parameters())))
        return AlgoState(
            policy=policy, value=value,
            target_policy=target(policy), target_value=target(value),
            policy_opt=self.policy_tx.init(list(policy.parameters())),
            value_opt=self.value_tx.init(list(value.parameters())), **extra)

    def init_hidden(self, batch_size, dtype=torch.float32):
        """(b, n, hid) zero GRU state."""
        return torch.zeros((batch_size, self.n, self.hid_dim), dtype=dtype,
                           device=self.device)

    # --------------------------------------------------------------- policy
    def agent_ids(self, batch_size, dtype=torch.float32):
        eye = torch.eye(self.n, dtype=dtype, device=self.device)
        return eye.expand(batch_size, self.n, self.n)

    def id_dim(self):
        return self.n if self.cfg.agent_id else 0

    def with_ids(self, x):
        """(b, n, d) -> (b, n, d [+ n]): the agent-id one-hot appended."""
        if not self.cfg.agent_id:
            return x
        return torch.cat([x, self.agent_ids(x.shape[0], x.dtype)], dim=-1)

    def own_mask(self, dtype):
        """(n, n) identity: entry (i, j) marks agent i's own slot j."""
        return torch.eye(self.n, dtype=dtype, device=self.device)

    def policy(self, module, obs, last_hid, need_hid=True):
        """(b, n, o) -> means, log_stds, hid (b, n, .) (reference
        model.py:101-139): the agent ids appended, then one forward of the
        (b, n, .) rows, shared or per agent; the module's log-stds under
        ``gaussian_policy``, else the fixed std exp(log fixed_policy_std);
        an MLP agent's hid is ``last_hid``.  Without ``need_hid`` the hid is
        None.  A differentiated call of a shared deterministic GRU policy
        runs as the fused kernels of ``nets/policy_gru.py`` where
        ``policy_gru.fused_reason`` allows; each differentiated call counts
        its rows in ``policy.fused_rows`` or ``policy.plain_rows``."""
        n_id = self.id_dim()
        reason = policy_gru.fused_reason(module, obs, last_hid, n_id, need_hid)
        if reason != "grad":
            rows = obs.shape[0] * obs.shape[1]
            profiling.count("policy.plain_rows" if reason else "policy.fused_rows", rows)
        if reason is None:
            means = policy_gru.fused_policy(module, obs, last_hid, n_id)
            log_stds, hid = None, None
        else:
            means, log_stds, hid = module(self.with_ids(obs), last_hid)
            hid = hid if need_hid else None
        if not self.cfg.gaussian_policy:
            log_stds = torch.full_like(
                means, math.log(self.cfg.fixed_policy_std))
        return means, log_stds, hid

    def get_actions(self, module, obs, last_hid, *, status, exploration,
                    avail, clip=False, generator=None, noise=None, need_hid=True):
        """Sample/evaluate actions; ``avail`` (n, n_actions) mask; the hid
        None without ``need_hid``."""
        means, log_stds, hid = self.policy(module, obs, last_hid, need_hid)
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

    def apply_critic(self, module, inputs):
        """The critic on per-agent inputs (b, n, d) -> (b, n): one forward,
        with shared or per-agent parameters (mapdn_tpu/algos/base.py:205-214)."""
        return module(inputs)[..., 0]

    def next_policy(self, state: AlgoState):
        """The policy that bootstraps next-state actions: the behaviour one
        under ``double_q``, else the target."""
        return state.policy if self.cfg.double_q else state.target_policy

    # ---------------------------------------------------------------- batch
    def unpack(self, batch: Transition) -> Transition:
        """Flatten (T, L, ...) -> (b, ...) with reward normalization
        (reference model.py:304-319)."""
        flat = batch.map(flatten_batch)
        reward = flat.reward
        if self.cfg.reward_normalisation:
            reward = batchnorm(reward)
        return flat.replace(reward=reward)

    def loss_noise(self, which):
        """The names of the standard normals, each of the window's (rows, n,
        act) action shape, that ``get_loss`` draws in an update step of
        ``which`` (its ``draws`` keys), in the order it draws them: the
        update steps draw them before the loss and hand them in
        (learn/update_graph.py).  None by default: the loss draws nothing,
        or draws for itself and is not ``update_capturable``."""
        return ()

    def get_loss(self, state: AlgoState, batch: Transition, avail, *,
                 policy=True, value=True, generator=None, draws=None):
        """(policy_loss, value_loss, (means, log_stds)).  A part not asked
        for (``policy=False`` / ``value=False``) may be None, and its
        network is then not evaluated; random draws come from ``draws``
        where given, else from ``generator``."""
        raise NotImplementedError
