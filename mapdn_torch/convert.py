"""Carry parameters of the JAX package's flax networks into the port's.

The input is a flax parameter tree as nested dicts of numpy arrays (with or
without the outer ``{"params": ...}``).  Dense kernels are transposed
(flax stores (in, out)); the GRU's ``ir/iz/in`` input kernels and biases
stack into ``weight_ih``/``bias_ih`` and its ``hr/hz/hn`` recurrent kernels
into ``weight_hh`` (gate order r, z, n), with the ``hn`` bias into
``bias_hn`` (flax has no r/z hidden biases and neither has the port);
LayerNorm scale/bias and ``agent_id_embed`` are copied.  Values keep the
target parameters' dtype.  A per-agent module (``per_agent=n``) takes the
JAX package's stacked tree of ``shared_params: False``: every leaf has a
leading n axis and the names are unchanged; its layers hold flax's
layout, so Dense kernels and LayerNorm leaves are copied as they are and
the GRU's gate kernels are set side by side on the last axis.

flax names layers by creation order: in ``MLPAgent``/``MLPCritic`` (and
``MLPAgentGaussian``) the second layer's Dense is created before the
stem's, so ``Dense_1`` is fc1 and ``Dense_0`` fc2 there; the Gaussian
agents' log-std head is the Dense after the mean head.  ``AttentionCritic``'s
per-agent layers (``nn.vmap``) hold (n, in, out) kernels, copied as they
are.  In ``QMixer`` the ``name=`` of an ``nn.Sequential`` does not reach the
tree: its layers are numbered ``Dense_k`` in creation order (the two-layer
hypernets ``hyper_w_1`` and ``hyper_w_final``, then ``V``), while a
one-layer hypernet keeps its name.
"""
from __future__ import annotations

import numpy as np
import torch

from mapdn_torch.nets.agents import (
    AgentDense, AgentGRUCell, Dense, MLPAgent, MLPAgentGaussian, RNNAgent, RNNAgentGaussian)
from mapdn_torch.nets.critics import (
    AttentionCritic, CentralVCritic, MLPCritic, QMixer, RNNCritic)


def _p(tree):
    return tree["params"] if "params" in tree else tree


def _set(param, value):
    with torch.no_grad():
        param.copy_(torch.as_tensor(np.array(value), dtype=param.dtype))


def _dense(mod, tree):
    """A Dense layer, or a per-agent one whose (n, in, out) kernels are
    flax's stacked layout."""
    kernel = np.asarray(tree["kernel"])
    _set(mod.weight, kernel if isinstance(mod, AgentDense) else kernel.T)
    if mod.bias is not None:
        _set(mod.bias, tree["bias"])


def _norm(mod, tree):
    if mod is not None:
        _set(mod.weight, tree["scale"])
        _set(mod.bias, tree["bias"])


def _gru(mod, g):
    """flax's six gate Dense layers into a cell: rows r, z, n of the
    transposed kernels, or for a per-agent cell the stacked kernels side by
    side on the last axis."""
    stacked = isinstance(mod, AgentGRUCell)
    kernel = (lambda k: np.asarray(g[k]["kernel"])) if stacked else (
        lambda k: np.asarray(g[k]["kernel"]).T)
    cat = lambda xs: np.concatenate(list(xs), axis=-1 if stacked else 0)
    _set(mod.weight_ih, cat(kernel(k) for k in ("ir", "iz", "in")))
    _set(mod.bias_ih, cat(np.asarray(g[k]["bias"]) for k in ("ir", "iz", "in")))
    _set(mod.weight_hh, cat(kernel(k) for k in ("hr", "hz", "hn")))
    _set(mod.bias_hn, g["hn"]["bias"])


def _rnn(module, p):
    """Stem, GRU cell and head of ``RNNAgent`` and ``RNNCritic``."""
    _dense(module.fc1, p["Dense_0"])
    _norm(module.norm, p.get("LayerNorm_0"))
    _gru(module.gru, p["GRUCell_0"])
    _dense(module.head, p["Dense_1"])


def load_flax_policy(module, params):
    p = _p(params)
    if isinstance(module, RNNAgentGaussian):
        _dense(module.log_std_head, p["Dense_2"])
    elif isinstance(module, MLPAgentGaussian):
        _dense(module.log_std_head, p["Dense_3"])
    if isinstance(module, RNNAgent):
        _rnn(module, p)
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
    elif isinstance(module, RNNCritic):
        _rnn(module, p)
        return module
    elif isinstance(module, AttentionCritic):
        for name in ("sa_encoders", "s_encoders"):
            _dense(getattr(module, name), p[name]["Dense_0"])
        for name in ("critics", "biases"):
            head = getattr(module, name)
            _dense(head.fc, p[name]["Dense_0"])
            _dense(head.out, p[name]["Dense_1"])
        for name in ("key_proj", "sel_proj", "val_proj"):
            _dense(getattr(module, name), p[name])
        return module
    else:
        raise TypeError(f"no flax layout for {type(module).__name__}")
    _norm(module.norm, p.get("LayerNorm_0"))
    return module


def load_flax_mixer(module: QMixer, params):
    p = _p(params)
    numbered = iter(p[f"Dense_{k}"] for k in range(len(p)) if f"Dense_{k}" in p)
    for name in ("hyper_w_1", "hyper_w_final"):
        layer = getattr(module, name)
        if isinstance(layer, Dense):
            _dense(layer, p[name])
        else:
            for d in (m for m in layer if isinstance(m, Dense)):
                _dense(d, next(numbered))
    _dense(module.hyper_b_1, p["hyper_b_1"])
    for d in (m for m in module.V if isinstance(m, Dense)):
        _dense(d, next(numbered))
    if module.gate is not None:
        _set(module.gate, p["gate"])
    return module


def state_from_npz(model, path):
    """An ``AlgoState`` of ``model`` holding the flax parameters saved in the
    ``.npz`` at ``path``: its keys are ``<tree>/<flax path>`` with tree
    ``policy``, ``value`` or ``mixer`` and the path's names joined by ``/``
    (the layout of artifacts/learning_torch/jax_init/).  Targets are copies
    and optimizer states zero, as ``model.state_from_modules`` makes them."""
    trees = {}
    with np.load(path) as saved:
        for key in saved.files:
            *parents, leaf = key.split("/")
            node = trees
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = saved[key]
    policy, value = from_flax(trees["policy"], trees["value"],
                              model.make_policy_module(), model.make_value_module())
    mixer = (load_flax_mixer(model.make_mixer_module(), trees["mixer"])
             if model.uses_mixer else None)
    return model.state_from_modules(policy, value, mixer)


def from_flax(policy_params, value_params, policy, value):
    """Load flax policy and value parameter trees into the port's modules
    ``policy`` (the deterministic or Gaussian RNN/MLP agents) and ``value``
    (CentralVCritic, MLPCritic, RNNCritic or AttentionCritic), in place;
    returns them.
    A mixer's tree goes through :func:`load_flax_mixer`."""
    return load_flax_policy(policy, policy_params), load_flax_critic(value, value_params)
