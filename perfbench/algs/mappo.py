"""MAPPO in the benchmark: its networks' leaves and how the program holds
them, and the reference's update (perfbench/reference/ppo.py) followed
step by step.

A training kind (perfbench/kinds/train.py) reads an algorithm through
these names only, so another algorithm is another file here beside its
reference:

* ``leaves(dims)``: {network: [(name, shape, kind)]} the benchmark draws;
* ``load_weights(algo, drawn)``: the drawn tensors into the program;
* ``state_tensors(algo)``: {key: tensor} of the parameters and optimizer
  state, in a fixed order (the window's snapshots copy them);
* ``BATCH``: the fields of an update batch the check reads;
* ``update_loss(stats, which)``, ``opt_state(algo, which)``: what the
  recorder reads of an update step;
* ``policy(p, obs, hid)``, ``log_prob(action, means, alg)``,
  ``critic(p, obs)``: the reference's networks;
* ``follow(...)``: the reference's trajectory through update steps;
* ``program_first_grads(first_nu)``: the first gradients' norms as the
  optimizer's state holds them after one step;
* ``update_numbers(...)``: the compared numbers of the update;
* ``epochs(alg)``: the update phase's optimizer steps, in order;
* ``chunk_flops(...)``: the networks' FLOPs of one chunk;
* ``fault(name, runner)``: a fault of the update planted in the program,
  or None where the name is not the algorithm's.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from perfbench import check, counting, tracing
from perfbench.reference import nets, ppo

BATCH = ("state", "last_hid", "action", "log_prob_a", "value", "next_value", "reward", "done")
NETS = ("policy", "value")
RMSPROP_DECAY = 0.99
GRAD_EXCLUDE = 1e-3


def leaves(dims):
    return {"policy": nets.policy_leaves(dims["obs"], dims["agents"], dims["hid"], dims["act"]),
            "value": nets.critic_leaves(dims["obs"], dims["agents"], dims["hid"])}


def load_weights(algo, drawn):
    """The drawn weights into the behaviour and target networks (strict:
    every leaf by name and shape)."""
    with torch.no_grad():
        for net, target in (("policy", algo.target_policy), ("value", algo.target_value)):
            for module in (getattr(algo, net), target):
                module.load_state_dict(drawn[net], strict=True)


def opt_state(algo, which):
    """{leaf: the optimizer's second moment} of network ``which``."""
    names = [k for k, _ in getattr(algo, which).named_parameters()]
    return dict(zip(names, getattr(algo, which + "_opt")))


def state_tensors(algo):
    out = {}
    for net in NETS:
        for k, v in getattr(algo, net).named_parameters():
            out[f"{net}/{k}"] = v
    for net in NETS:
        for k, v in opt_state(algo, net).items():
            out[f"{net}_opt/{k}"] = v
    return out


def split_state(flat):
    """{key: tensor} of :func:`state_tensors` -> (params, opt) by network."""
    params = {net: {} for net in NETS}
    opt = {net: {} for net in NETS}
    for key, v in flat.items():
        head, leaf = key.split("/", 1)
        (opt[head[:-4]] if head.endswith("_opt") else params[head])[leaf] = v
    return params, opt


def update_loss(stats, which):
    return float(stats[f"mean_train_{which}_loss"])


def epochs(alg):
    """The update phase's optimizer steps in order: the value epochs, then
    the policy epochs."""
    return ["value"] * alg["value_update_epochs"] + ["policy"] * alg["policy_update_epochs"]


# ------------------------------------------------------------- reference
def policy(p, obs, hid):
    return nets.policy(p, obs, hid)


def critic(p, obs):
    return nets.critic(p, obs)


follow = ppo.follow


def log_prob(action, means, alg):
    return ppo.log_density(action.to(means.dtype), means,
                           math.log(alg["fixed_policy_std"])).sum(-1)


def program_first_grads(first_nu):
    """Each first clipped gradient's norm, from the optimizer's state after
    one step from zero: nu = (1 - decay) g^2."""
    return {w: {k: math.sqrt(float(v.double().sum()) / (1.0 - RMSPROP_DECAY))
                for k, v in nu.items()} for w, nu in first_nu.items()}


def _leaf_gap(cand, ref):
    """Worst leaf of |norm(cand) - norm(ref)| / max(norm(ref), median)."""
    med = float(np.median(list(ref.values())))
    return max(abs(cand[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def change_gap(cand_after, ref_after, start, ref_grads):
    """The worst leaf's gap of the parameters' change from ``start``; leaves
    whose first reference gradient is under GRAD_EXCLUDE of the median
    leaf's move by round-off alone and are left out."""
    change = 0.0
    for net in ref_after:
        g = ref_grads[net]
        med = float(np.median(list(g.values())))
        kept = [k for k in g if g[k] >= GRAD_EXCLUDE * med]
        w0 = {k: start[net][k].double().cpu() for k in kept}
        dn = lambda p: {k: float((p[k].double() - w0[k]).norm()) for k in kept}
        change = max(change, _leaf_gap(dn(cand_after[net]), dn(ref_after[net])))
    return change


def loss_gap(cand, ref):
    """Relative to the larger of the reference's loss and 1 (both losses
    are of unit scale: normalised rewards and advantages)."""
    return max(abs(cand[w] - r) / max(abs(r), 1.0) for w, r in ref.items())


def update_numbers(cand, ref, weights):
    """The set-up chunks' update: the first chunk's ring values, each
    optimizer's first loss and first gradient, the change over the chunks."""
    return {"value": check.rms_rel([cand["fill"]], [ref["fill"]]),
            "loss": loss_gap(cand["losses"], ref["losses"]),
            "grad": max(_leaf_gap(cand["first_grads"][w], ref["first_grads"][w])
                        for w in ref["first_grads"]),
            "change": change_gap(cand["after"], ref["after"], weights, ref["first_grads"])}


def chunk_flops(dims, lanes, chunk_len, capacity, rows, alg):
    return counting.chunk_net_flops(dims, lanes, chunk_len, capacity, rows,
                                    {"value": alg["value_update_epochs"],
                                     "policy": alg["policy_update_epochs"]})


# ---------------------------------------------------------------- faults
@contextlib.contextmanager
def _unchanged():
    from mapdn_torch.algos import base
    with tracing.installed([(base.ClippedRMSprop, "step",
                             lambda fn: lambda self, params, grads, nu: None)]):
        yield


@contextlib.contextmanager
def _half_batch(trainer):
    def half(fn):
        def run(algo, batch, which, shard, generator, loss_draws):
            lanes = batch.reward.shape[1]
            return fn(algo, batch.map(lambda x: x[:, :lanes // 2]), which, shard,
                      generator, loss_draws)
        return run
    with tracing.installed([(trainer, "_update_step", half)]):
        yield


def fault(name, runner):
    """``unchanged``: every optimizer step returns its state unchanged;
    ``half_batch``: each update step sees half of its batch's lanes, the
    mean taken over the rest."""
    if name == "unchanged":
        return _unchanged()
    if name == "half_batch":
        return _half_batch(runner.trainer)
    return None
