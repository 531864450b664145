"""MAAC in the benchmark: its networks' leaves (a Gaussian GRU policy and
the attention critic) and how the program holds them (behaviour and target
networks), and the reference's update (perfbench/reference/maac.py)
followed step by step on the program's own windows and loss noise.  The
names are those perfbench/algs/mappo.py documents; what MAAC shares with
MADDPG (the four networks, the targets' change) is read from
perfbench/algs/maddpg.py.  Its kind is perfbench/kinds/train_ring_noise.py,
which keeps each update step's noise beside its window (the batch's
``NOISE`` keys) and reads the policy's log-prob through ``gaussian``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

from perfbench import counting, spec, tracing
from perfbench.reference import ddpg
from perfbench.reference import maac as ref

_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
mappo = spec.alg("mappo", _root)
maddpg = spec.alg("maddpg", _root)

BATCH = ddpg.FIELDS
NOISE = ref.NOISE
NETS = maddpg.NETS
TARGETS = maddpg.TARGETS

opt_state = mappo.opt_state
update_loss = mappo.update_loss
epochs = mappo.epochs
program_first_grads = mappo.program_first_grads
change_gap = mappo.change_gap
loss_gap = mappo.loss_gap
load_weights = mappo.load_weights
state_tensors = maddpg.state_tensors
split_state = maddpg.split_state
targets_of = maddpg.targets_of
update_numbers = maddpg.update_numbers
follow = ref.follow


def leaves(dims):
    return {"policy": ref.policy_leaves(dims["obs"], dims["agents"], dims["hid"], dims["act"]),
            "value": ref.critic_leaves(dims["obs"], dims["agents"], dims["hid"], dims["act"])}


# ------------------------------------------------------------- reference
policy = maddpg.policy
gaussian = ref.gaussian
log_prob = ref.log_prob


def critic_flops(dims):
    """One sample of the attention critic, all agents: the (obs, act) and
    obs encoders, the key, selector and value projections, the logits and
    the weighted sum, the per-agent heads and the bias heads."""
    n, o, a, h = dims["agents"], dims["obs"], dims["act"], dims["hid"]
    encoders = n * ((o + a) * h + o * h)
    attend = 3 * n * h * h + 2 * n * n * h
    heads = n * (2 * h * h + h) + n * (h * h + h)
    return 2.0 * (encoders + attend + heads)


def chunk_flops(dims, lanes, chunk_len, capacity, rows, alg):
    """The rollout's policy forwards; each value step's critic forward and
    backward, the behaviour policy's forward for the entropy term and the
    bootstrap (the target policy and the target critic, forward only);
    each policy step's policy and critic forward and backward and the
    regulariser's critic forward.  ``rows`` window rows an update step."""
    n = dims["agents"]
    pol = (counting.policy_flops(dims["obs"], n, dims["hid"], dims["act"])
           + 2.0 * dims["hid"] * dims["act"])
    cri = critic_flops(dims)
    rollout = chunk_len * lanes * n * pol
    value = rows * (3.0 * cri + 2.0 * n * pol + cri)
    policy_step = rows * (3.0 * n * pol + 3.0 * cri + cri)
    return (rollout + alg["value_update_epochs"] * value
            + alg["policy_update_epochs"] * policy_step)


# ---------------------------------------------------------------- faults
@contextlib.contextmanager
def _half_batch(trainer):
    """Each update step sees the first half of its window's lanes, and the
    same rows of its loss noise."""
    def half(fn):
        def run(algo, batch, which, shard, generator, loss_draws):
            t, lanes = batch.reward.shape[:2]
            cut = lambda x: x.reshape((t, lanes) + tuple(x.shape[1:]))[:, :lanes // 2].flatten(0, 1)
            noise = None if loss_draws is None else {k: cut(v) for k, v in loss_draws.items()}
            return fn(algo, batch.map(lambda x: x[:, :lanes // 2]), which, shard, generator,
                      noise)
        return run
    with tracing.installed([(trainer, "_update_step", half)]):
        yield


@contextlib.contextmanager
def _behaviour_bootstrap(model):
    def make(fn):
        return lambda state, b, avail, noise: fn(
            dataclasses.replace(state, target_value=state.value), b, avail, noise)
    with tracing.installed([(model, "next_values", make)]):
        yield


@contextlib.contextmanager
def _no_entropy(trainer):
    """The value steps run with ``soft`` off: the target leaves out the
    entropy term (the policy steps keep it)."""
    model = trainer.model

    def make(fn):
        def run(algo, batch, which, *rest):
            if which != "value":
                return fn(algo, batch, which, *rest)
            cfg = model.cfg
            model.cfg = cfg.replace(soft=False)
            try:
                return fn(algo, batch, which, *rest)
            finally:
                model.cfg = cfg
        return run
    with tracing.installed([(trainer, "_update_step", make)]):
        yield


@contextlib.contextmanager
def _self_attend():
    from mapdn_torch.nets import critics
    with tracing.installed([(critics, "_self_mask", lambda fn: lambda n, device: torch.zeros(
            n, n, dtype=torch.bool, device=device))]):
        yield


def fault(name, runner):
    """``unchanged``: every optimizer step returns its state unchanged;
    ``half_batch``: each update step sees half of its window's lanes;
    ``behaviour_bootstrap``: the value target's critic is the behaviour
    one; ``no_entropy``: the value target leaves out the soft term;
    ``self_attend``: each agent attends to itself too (the diagonal of the
    logits not masked)."""
    if name == "unchanged":
        return mappo.fault(name, runner)
    if name == "half_batch":
        return _half_batch(runner.trainer)
    if name == "behaviour_bootstrap":
        return _behaviour_bootstrap(runner.trainer.model)
    if name == "no_entropy":
        return _no_entropy(runner.trainer)
    if name == "self_attend":
        return _self_attend()
    return None
