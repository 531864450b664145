"""Policy networks (PyTorch port of mapdn_tpu/nets/agents.py).

* fc1 -> optional LayerNorm -> activation  (reference mlp_agent.py:28-31)
* MLP: fc2 -> activation -> head           (reference mlp_agent.py:32-34)
* RNN: GRU cell(hid) -> head               (reference rnn_agent.py:27-32)
* Gaussian heads: a mean head and a log-std head bounded by tanh to
  [LOG_STD_MIN, LOG_STD_MAX]               (reference rnn_agent_gaussian.py:33-40)

Parameters are held in an explicit ``param_dtype`` (float32 by default, as
flax's) and cast to the input's dtype in the forward, as flax promotes
them; so a float64 input runs a float64 forward on float32 parameters and
the gradients come back in the parameters' dtype.

Two flax conventions are kept on purpose: LayerNorm eps is 1e-6, and the
GRU cell has no r/z biases on the hidden path (torch.nn.GRUCell would add
two trainable biases that change the optimizer's trajectory), gate order
r, z, n.

With ``per_agent=n`` (``shared_params: False``) every module is built from
the per-agent layers :class:`AgentDense`, :class:`AgentLayerNorm` and
:class:`AgentGRUCell`: each parameter has a leading agent axis in flax's
stacked layout (the JAX package vmaps ``module.apply`` over a stack of
parameter trees, mapdn_tpu/algos/base.py:185-214), and the module maps
(b, n, .) to (b, n, .), agent i's features through agent i's parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_ACT = {"relu": torch.relu, "tanh": torch.tanh}


def lecun_normal_(w, fan_in, generator=None):
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (the std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _init_kernel_(w, init_type, init_std, activation, generator):
    """Dense kernel init: Normal(0, init_std) (reference model.py:173-181),
    or orthogonal with the activation's gain."""
    if init_type == "orthogonal":
        gain = {"relu": 2.0**0.5, "tanh": 5.0 / 3.0}[activation]
        return nn.init.orthogonal_(w, gain=gain, generator=generator)
    return nn.init.normal_(w, 0.0, init_std, generator=generator)


class Dense(nn.Module):
    """y = x W^T + b with flax-style dtype promotion."""

    def __init__(self, in_features, out_features, param_dtype=torch.float32,
                 bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype))
                     if bias else None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)

    def reset_lecun_(self, generator=None):
        """flax's ``nn.Dense`` defaults: lecun-normal kernel, zero bias."""
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.zero_()


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm: eps 1e-6, learned scale and bias."""

    def __init__(self, features, param_dtype=torch.float32, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class GRUCell(nn.Module):
    """flax.linen.GRUCell:  r = s(W_ir x + b_ir + W_hr h),
    z = s(W_iz x + b_iz + W_hz h), n = tanh(W_in x + b_in + r (W_hn h + b_hn)),
    h' = (1 - z) n + z h.  Gate blocks are stacked r, z, n as in torch."""

    def __init__(self, in_features, hidden, param_dtype=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.zeros(3 * hidden, in_features, dtype=param_dtype))
        self.weight_hh = nn.Parameter(torch.zeros(3 * hidden, hidden, dtype=param_dtype))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden, dtype=param_dtype))
        self.bias_hn = nn.Parameter(torch.zeros(hidden, dtype=param_dtype))

    def reset_parameters(self, generator=None):
        """flax defaults: lecun-normal input kernels, orthogonal recurrent
        kernels, zero biases (per gate block)."""
        h = self.hidden
        with torch.no_grad():
            for g in range(3):
                lecun_normal_(self.weight_ih[g * h:(g + 1) * h], self.weight_ih.shape[1],
                              generator)
                nn.init.orthogonal_(self.weight_hh[g * h:(g + 1) * h], generator=generator)
            self.bias_ih.zero_()
            self.bias_hn.zero_()

    def forward(self, x, h):
        gi = F.linear(x, self.weight_ih.to(x.dtype), self.bias_ih.to(x.dtype))
        gh = F.linear(h, self.weight_hh.to(x.dtype))
        return _gru_update(gi, gh, h, self.bias_hn.to(x.dtype))


def _gru_update(gi, gh, h, bias_hn):
    """The GRU's gates from the input and hidden products (blocks r, z, n
    on the last axis) and the new hidden state."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * (h_n + bias_hn))
    return (1.0 - z) * n + z * h


def _agent_linear(x, weight, bias=None):
    """(b, n, in) through per-agent kernels (n, in, out) [+ biases (n, out)]
    -> (b, n, out): one batched product over the agent axis."""
    xt = x.transpose(0, 1)
    w = weight.to(x.dtype)
    out = (torch.bmm(xt, w) if bias is None
           else torch.baddbmm(bias.to(x.dtype)[:, None], xt, w))
    return out.transpose(0, 1)


class AgentDense(nn.Module):
    """n Dense layers, one per agent: (b, n, in) -> (b, n, out) with kernels
    (n, in, out) (flax's layout) and biases (n, out)."""

    def __init__(self, n, in_features, out_features, param_dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, in_features, out_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(n, out_features, dtype=param_dtype))

    def reset_lecun_(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        self.bias.zero_()

    def forward(self, x):
        return _agent_linear(x, self.weight, self.bias)

    def twin(self):
        """A shared layer of one agent's shapes."""
        return Dense(*self.weight.shape[1:], self.weight.dtype)

    @torch.no_grad()
    def load_agent_(self, i, dense: Dense):
        self.weight[i].copy_(dense.weight.T)
        self.bias[i].copy_(dense.bias)


class AgentLayerNorm(nn.Module):
    """n LayerNorms over the last axis of (b, n, f), scale and bias (n, f)."""

    def __init__(self, n, features, param_dtype=torch.float32, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(n, features, dtype=param_dtype))

    def forward(self, x):
        y = F.layer_norm(x, self.weight.shape[1:], eps=self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)

    def twin(self):
        """A shared layer of one agent's shapes."""
        return LayerNorm(self.weight.shape[1], self.weight.dtype, self.eps)

    @torch.no_grad()
    def load_agent_(self, i, norm: LayerNorm):
        self.weight[i].copy_(norm.weight)
        self.bias[i].copy_(norm.bias)


class AgentGRUCell(nn.Module):
    """n :class:`GRUCell` s, one per agent, on (b, n, in) and (b, n, h):
    kernels (n, in, 3h) and (n, h, 3h) (flax's stacked ``ir|iz|in`` and
    ``hr|hz|hn`` kernels side by side), biases (n, 3h) and (n, h)."""

    def __init__(self, n, in_features, hidden, param_dtype=torch.float32):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(n, in_features, 3 * hidden, dtype=param_dtype))
        self.weight_hh = nn.Parameter(torch.zeros(n, hidden, 3 * hidden, dtype=param_dtype))
        self.bias_ih = nn.Parameter(torch.zeros(n, 3 * hidden, dtype=param_dtype))
        self.bias_hn = nn.Parameter(torch.zeros(n, hidden, dtype=param_dtype))

    def forward(self, x, h):
        gi = _agent_linear(x, self.weight_ih, self.bias_ih)
        gh = _agent_linear(h, self.weight_hh)
        return _gru_update(gi, gh, h, self.bias_hn.to(x.dtype))

    def twin(self):
        """A shared cell of one agent's shapes."""
        n, in_features, three_h = self.weight_ih.shape
        return GRUCell(in_features, three_h // 3, self.weight_ih.dtype)

    @torch.no_grad()
    def load_agent_(self, i, cell: GRUCell):
        self.weight_ih[i].copy_(cell.weight_ih.T)
        self.weight_hh[i].copy_(cell.weight_hh.T)
        self.bias_ih[i].copy_(cell.bias_ih)
        self.bias_hn[i].copy_(cell.bias_hn)


AGENT_LAYERS = (AgentDense, AgentLayerNorm, AgentGRUCell)


class _Base(nn.Module):
    """Shared stem: fc1 -> optional LayerNorm -> activation.  ``per_agent``
    None: one set of parameters for every input row; an int n: per-agent
    layers for n agents."""

    def __init__(self, in_dim, hid_size=64, layernorm=True,
                 hid_activation="relu", init_type="normal", init_std=0.1,
                 param_dtype=torch.float32, per_agent=None):
        super().__init__()
        self.hid_size = hid_size
        self.hid_activation = hid_activation
        self.init_type = init_type
        self.init_std = init_std
        self.param_dtype = param_dtype
        self.per_agent = per_agent
        self.fc1 = self._dense(in_dim, hid_size)
        self.norm = None
        if layernorm:
            self.norm = (LayerNorm(hid_size, param_dtype) if per_agent is None
                         else AgentLayerNorm(per_agent, hid_size, param_dtype))

    def _dense(self, in_features, out_features):
        if self.per_agent is None:
            return Dense(in_features, out_features, self.param_dtype)
        return AgentDense(self.per_agent, in_features, out_features, self.param_dtype)

    def _gru(self, in_features, hidden):
        if self.per_agent is None:
            return GRUCell(in_features, hidden, self.param_dtype)
        return AgentGRUCell(self.per_agent, in_features, hidden, self.param_dtype)

    def act(self, x):
        return _ACT[self.hid_activation](x)

    def stem(self, x):
        x = self.fc1(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)

    def reset_parameters(self, generator=None):
        """Kernels Normal(0, init_std) (or orthogonal), biases zero,
        LayerNorm identity; GRU cells by their own rule.  Per-agent layers
        are drawn agent by agent, each agent's slice of the whole module
        as a shared module's (the JAX package draws each agent's tree
        from a key of its own)."""
        with torch.no_grad():
            for i in range(self.per_agent or 1):
                for mod in self.modules():
                    per_agent = isinstance(mod, AGENT_LAYERS)
                    layer = mod.twin() if per_agent else mod
                    if isinstance(layer, Dense):
                        _init_kernel_(layer.weight, self.init_type, self.init_std,
                                      self.hid_activation, generator)
                        layer.bias.zero_()
                    elif isinstance(layer, GRUCell):
                        layer.reset_parameters(generator)
                    if per_agent:
                        mod.load_agent_(i, layer)
        return self


class MLPAgent(_Base):
    """Deterministic MLP policy (reference agents/mlp_agent.py:5-32)."""

    def __init__(self, in_dim, action_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.fc2 = self._dense(self.hid_size, self.hid_size)
        self.head = self._dense(self.hid_size, action_dim)

    def forward(self, x, hidden=None):
        h = self.act(self.fc2(self.stem(x)))
        return self.head(h), None, hidden


class RNNAgent(_Base):
    """Deterministic GRU policy (reference agents/rnn_agent.py:5-32)."""

    def __init__(self, in_dim, action_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.gru = self._gru(self.hid_size, self.hid_size)
        self.head = self._dense(self.hid_size, action_dim)

    def forward(self, x, hidden):
        hidden = self.gru(self.stem(x), hidden)
        return self.head(hidden), None, hidden


class _GaussianHead:
    """A log-std head beside the mean head, squashed by tanh into
    [log_std_min, log_std_max] (reference rnn_agent_gaussian.py:33-40):
    log_std = min + (max - min) (tanh(head(h)) + 1) / 2."""

    def _gaussian_init(self, action_dim, log_std_min, log_std_max):
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.log_std_head = self._dense(self.hid_size, action_dim)

    def log_std(self, h):
        span = self.log_std_max - self.log_std_min
        return self.log_std_min + 0.5 * span * (torch.tanh(self.log_std_head(h)) + 1.0)


class MLPAgentGaussian(_GaussianHead, MLPAgent):
    """Gaussian MLP policy (reference agents/mlp_agent_gaussian.py:6-39)."""

    def __init__(self, in_dim, action_dim=1, log_std_min=0.0, log_std_max=0.5, **kw):
        super().__init__(in_dim, action_dim=action_dim, **kw)
        self._gaussian_init(action_dim, log_std_min, log_std_max)

    def forward(self, x, hidden=None):
        h = self.act(self.fc2(self.stem(x)))
        return self.head(h), self.log_std(h), hidden


class RNNAgentGaussian(_GaussianHead, RNNAgent):
    """Gaussian GRU policy (reference agents/rnn_agent_gaussian.py:6-40)."""

    def __init__(self, in_dim, action_dim=1, log_std_min=0.0, log_std_max=0.5, **kw):
        super().__init__(in_dim, action_dim=action_dim, **kw)
        self._gaussian_init(action_dim, log_std_min, log_std_max)

    def forward(self, x, hidden):
        hidden = self.gru(self.stem(x), hidden)
        return self.head(hidden), self.log_std(hidden), hidden
