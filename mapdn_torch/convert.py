"""Carry parameters of the JAX package's flax networks into the port's.

The input is a flax parameter tree as nested dicts of numpy arrays (with or
without the outer ``{"params": ...}``).  Dense kernels are transposed
(flax stores (in, out)); the GRU's ``ir/iz/in`` input kernels and biases
stack into ``weight_ih``/``bias_ih`` and its ``hr/hz/hn`` recurrent kernels
into ``weight_hh`` (gate order r, z, n), with the ``hn`` bias into
``bias_hn`` (flax has no r/z hidden biases and neither has the port);
LayerNorm scale/bias and ``agent_id_embed`` are copied.  Values keep the
target parameters' dtype.

flax names layers by creation order: in ``MLPAgent``/``MLPCritic`` the
second layer's Dense is created before the stem's, so ``Dense_1`` is fc1
and ``Dense_0`` fc2 there.
"""
from __future__ import annotations

import numpy as np
import torch

from mapdn_torch.nets.agents import MLPAgent, RNNAgent
from mapdn_torch.nets.critics import CentralVCritic, MLPCritic


def _p(tree):
    return tree["params"] if "params" in tree else tree


def _set(param, value):
    with torch.no_grad():
        param.copy_(torch.as_tensor(np.array(value), dtype=param.dtype))


def _dense(mod, tree):
    _set(mod.weight, np.asarray(tree["kernel"]).T)
    _set(mod.bias, tree["bias"])


def _norm(mod, tree):
    if mod is not None:
        _set(mod.weight, tree["scale"])
        _set(mod.bias, tree["bias"])


def load_flax_policy(module, params):
    p = _p(params)
    if isinstance(module, RNNAgent):
        _dense(module.fc1, p["Dense_0"])
        _norm(module.norm, p.get("LayerNorm_0"))
        g = p["GRUCell_0"]
        cat = lambda *xs: np.concatenate([np.asarray(x) for x in xs])
        _set(module.gru.weight_ih, cat(*(np.asarray(g[k]["kernel"]).T
                                         for k in ("ir", "iz", "in"))))
        _set(module.gru.bias_ih, cat(*(g[k]["bias"] for k in ("ir", "iz", "in"))))
        _set(module.gru.weight_hh, cat(*(np.asarray(g[k]["kernel"]).T
                                         for k in ("hr", "hz", "hn"))))
        _set(module.gru.bias_hn, g["hn"]["bias"])
        _dense(module.head, p["Dense_1"])
    elif isinstance(module, MLPAgent):
        _dense(module.fc1, p["Dense_1"])
        _norm(module.norm, p.get("LayerNorm_0"))
        _dense(module.fc2, p["Dense_0"])
        _dense(module.head, p["Dense_2"])
    else:
        raise TypeError(f"no flax layout for {type(module).__name__}")
    return module


def load_flax_critic(module, params):
    p = _p(params)
    if isinstance(module, CentralVCritic):
        _dense(module.fc1, p["Dense_0"])
        _dense(module.fc2, p["Dense_1"])
        _dense(module.head, p["Dense_2"])
        if module.agent_id_embed is not None:
            _set(module.agent_id_embed, p["agent_id_embed"])
    elif isinstance(module, MLPCritic):
        _dense(module.fc1, p["Dense_1"])
        _dense(module.fc2, p["Dense_0"])
        _dense(module.head, p["Dense_2"])
    else:
        raise TypeError(f"no flax layout for {type(module).__name__}")
    _norm(module.norm, p.get("LayerNorm_0"))
    return module


def from_flax(policy_params, value_params, policy, value):
    """Load flax policy and value parameter trees into the port's modules
    ``policy`` (RNNAgent/MLPAgent) and ``value`` (CentralVCritic/MLPCritic),
    in place; returns them."""
    return load_flax_policy(policy, policy_params), load_flax_critic(value, value_params)
