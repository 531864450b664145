"""MADDPG in the benchmark: its networks' leaves and how the program holds
them (behaviour and target networks), and the reference's update
(perfbench/reference/ddpg.py) followed step by step.  The names are those
perfbench/algs/mappo.py documents; what the two algorithms share (the
optimizer's state, the first gradients, the gaps) is read from there.

The state a chunk snapshot copies holds the target networks too, so the
check can follow a soft update.  ``update_numbers`` adds ``target``: the
target networks' change over the followed chunks, whose last one crossed
a ``target_update_freq`` boundary.
"""
from __future__ import annotations

import contextlib
import os

from perfbench import check, counting, spec, tracing
from perfbench.reference import ddpg, nets

mappo = spec.alg("mappo", os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

BATCH = ddpg.FIELDS
NETS = ("policy", "value")
TARGETS = ("target_policy", "target_value")

opt_state = mappo.opt_state
update_loss = mappo.update_loss
epochs = mappo.epochs
log_prob = mappo.log_prob
program_first_grads = mappo.program_first_grads
change_gap = mappo.change_gap
loss_gap = mappo.loss_gap
follow = ddpg.follow
load_weights = mappo.load_weights


def leaves(dims):
    return {"policy": nets.policy_leaves(dims["obs"], dims["agents"], dims["hid"], dims["act"]),
            "value": ddpg.critic_leaves(dims["obs"], dims["agents"], dims["hid"], dims["act"])}


def state_tensors(algo):
    out = {}
    for net in NETS + TARGETS:
        for k, v in getattr(algo, net).named_parameters():
            out[f"{net}/{k}"] = v
    for net in NETS:
        for k, v in opt_state(algo, net).items():
            out[f"{net}_opt/{k}"] = v
    return out


def split_state(flat):
    """{key: tensor} of :func:`state_tensors` -> (params of the four
    networks, opt of the two behaviour ones)."""
    params = {net: {} for net in NETS + TARGETS}
    opt = {net: {} for net in NETS}
    for key, v in flat.items():
        head, leaf = key.split("/", 1)
        (opt[head[:-4]] if head.endswith("_opt") else params[head])[leaf] = v
    return params, opt


# ------------------------------------------------------------- reference
def policy(p, obs, hid):
    return nets.policy(p, obs, hid)


def critic(p, obs, act):
    return ddpg.q_values(p, obs, act)


def targets_of(params):
    """The target networks of a :func:`split_state` params dict, keyed as
    the behaviour ones."""
    return {net: params["target_" + net] for net in NETS}


def update_numbers(cand, ref, weights):
    """The set-up chunks' update: the critic's Q on the first batch, each
    optimizer's first loss and first gradient, the behaviour networks'
    change and the targets' change over the chunks."""
    behaviour = lambda after: {net: after[net] for net in NETS}
    return {"value": check.rms_rel([cand["fill"]], [ref["fill"]]),
            "loss": loss_gap(cand["losses"], ref["losses"]),
            "grad": max(mappo._leaf_gap(cand["first_grads"][w], ref["first_grads"][w])
                        for w in ref["first_grads"]),
            "change": change_gap(behaviour(cand["after"]), behaviour(ref["after"]), weights,
                                 ref["first_grads"]),
            "target": change_gap(targets_of(cand["after"]), targets_of(ref["after"]),
                                 weights, ref["first_grads"])}


def critic_flops(dims):
    """One agent row of the critic: fc1 over the joint row, fc2, the head."""
    n, hid = dims["agents"], dims["hid"]
    d_in = (dims["obs"] + dims["act"]) * n + n
    return 2.0 * (d_in * hid + hid * hid + hid)


def chunk_flops(dims, lanes, chunk_len, capacity, rows, alg):
    """The rollout's policy forwards; each value step's critic forward and
    backward and its bootstrap (the next-state policy and the target
    critic, forward only); each policy step's policy and critic forward
    and backward.  ``rows`` window rows an update step, of every agent."""
    pol = counting.policy_flops(dims["obs"], dims["agents"], dims["hid"], dims["act"])
    cri = critic_flops(dims)
    entries = rows * dims["agents"]
    rollout = chunk_len * lanes * dims["agents"] * pol
    value = entries * (3.0 * cri + pol + cri)
    policy_step = entries * 3.0 * (pol + cri)
    return (rollout + alg["value_update_epochs"] * value
            + alg["policy_update_epochs"] * policy_step)


# ---------------------------------------------------------------- faults
@contextlib.contextmanager
def _behaviour_bootstrap():
    from mapdn_torch.learn import losses

    def make(fn):
        return lambda model, state, b, avail, value_module: fn(model, state, b, avail,
                                                               state.value)
    with tracing.installed([(losses, "_bootstrap", make)]):
        yield


def fault(name, runner):
    """``behaviour_bootstrap``: the value loss bootstraps from the
    behaviour critic instead of the target; else MAPPO's faults
    (``unchanged``, ``half_batch``)."""
    if name == "behaviour_bootstrap":
        return _behaviour_bootstrap()
    return mappo.fault(name, runner)
