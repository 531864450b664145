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
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn.to(x.dtype)))
        return (1.0 - z) * n + z * h


class _Base(nn.Module):
    """Shared stem: fc1 -> optional LayerNorm -> activation."""

    def __init__(self, in_dim, hid_size=64, layernorm=True,
                 hid_activation="relu", init_type="normal", init_std=0.1,
                 param_dtype=torch.float32):
        super().__init__()
        self.hid_size = hid_size
        self.hid_activation = hid_activation
        self.init_type = init_type
        self.init_std = init_std
        self.param_dtype = param_dtype
        self.fc1 = Dense(in_dim, hid_size, param_dtype)
        self.norm = LayerNorm(hid_size, param_dtype) if layernorm else None

    def act(self, x):
        return _ACT[self.hid_activation](x)

    def stem(self, x):
        x = self.fc1(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)

    def reset_parameters(self, generator=None):
        """Kernels Normal(0, init_std) (or orthogonal), biases zero,
        LayerNorm identity; GRU cells by their own rule."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Dense):
                    _init_kernel_(mod.weight, self.init_type, self.init_std,
                                  self.hid_activation, generator)
                    mod.bias.zero_()
                elif isinstance(mod, GRUCell):
                    mod.reset_parameters(generator)
        return self


class MLPAgent(_Base):
    """Deterministic MLP policy (reference agents/mlp_agent.py:5-32)."""

    def __init__(self, in_dim, action_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.fc2 = Dense(self.hid_size, self.hid_size, self.param_dtype)
        self.head = Dense(self.hid_size, action_dim, self.param_dtype)

    def forward(self, x, hidden=None):
        h = self.act(self.fc2(self.stem(x)))
        return self.head(h), None, hidden


class RNNAgent(_Base):
    """Deterministic GRU policy (reference agents/rnn_agent.py:5-32)."""

    def __init__(self, in_dim, action_dim=1, **kw):
        super().__init__(in_dim, **kw)
        self.gru = GRUCell(self.hid_size, self.hid_size, self.param_dtype)
        self.head = Dense(self.hid_size, action_dim, self.param_dtype)

    def forward(self, x, hidden):
        hidden = self.gru(self.stem(x), hidden)
        return self.head(hidden), None, hidden


class _GaussianHead:
    """A log-std head beside the mean head, squashed by tanh into
    [log_std_min, log_std_max] (reference rnn_agent_gaussian.py:33-40):
    log_std = min + (max - min) (tanh(head(h)) + 1) / 2."""

    def _gaussian_init(self, action_dim, log_std_min, log_std_max):
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.log_std_head = Dense(self.hid_size, action_dim, self.param_dtype)

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
