"""Checkpoint / resume with ``torch.save`` (port of mapdn_tpu/utils/checkpoint.py).

The reference saves only a rolling ``model.pt`` with the net weights every
40 episodes (reference train.py:117-119) and cannot resume mid-training.
Here the full training state round-trips: parameters, targets, optimizer
states, the replay ring, the env state, the step counters and the
``torch.Generator`` state, so a resumed run continues the exact stat stream
of the run that was killed.  ``save_model`` is the light weights-only
export in the reference's ``model.pt`` role.

Every file holds plain containers of tensors and numbers and is read back
with ``torch.load(..., weights_only=True)``.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import re

import torch

from mapdn_torch.algos.base import AlgoState, Transition
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn.replay import ReplayState

_MODULES = ("policy", "value", "target_policy", "target_value")
_OPTS = ("policy_opt", "value_opt")
_MIXER_MODULES = ("mixer", "target_mixer")
_MIXER_OPTS = ("mixer_opt",)


def _names(algo: AlgoState):
    """The module and optimizer fields of ``algo``: the mixer's when it has
    one."""
    mixer = algo.mixer is not None
    return (_MODULES + (_MIXER_MODULES if mixer else ()),
            _OPTS + (_MIXER_OPTS if mixer else ()))


def _generations(path):
    """Sorted generation files under a checkpoint directory.

    Matches only complete ``ckpt_<digits>`` names (>= 8 digits; the zero
    padding overflows past 1e8 episodes, so longer suffixes still count):
    a temporary file left by a crash mid-write never counts toward ``keep``
    nor is offered to restore.  Sorted numerically by episode number:
    lexicographic order would rank 9-digit names before 8-digit ones."""
    if not os.path.isdir(path):
        return []
    return sorted((d for d in os.listdir(path)
                   if re.fullmatch(r"ckpt_\d{8,}", d)),
                  key=lambda d: int(d[len("ckpt_"):]))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _algo_payload(algo: AlgoState, optimizer=True):
    modules, opts = _names(algo)
    out = {name: getattr(algo, name).state_dict() for name in modules}
    if optimizer:
        out.update({name: list(getattr(algo, name)) for name in opts})
    return out


def _like(saved, example, what):
    """``saved`` on the example's device, after checking shape and dtype."""
    if (not isinstance(saved, torch.Tensor) or saved.shape != example.shape
            or saved.dtype != example.dtype):
        raise ValueError(f"checkpoint field {what} does not match the run's")
    return saved.to(example.device)


def _algo_from(payload, example: AlgoState) -> AlgoState:
    """A new AlgoState with the saved weights (and optimizer states, where
    saved) in modules shaped like the example's."""
    modules, opts = _names(example)
    if set(_MIXER_MODULES) & set(payload) != set(_MIXER_MODULES) & set(modules):
        raise ValueError("checkpoint's mixer does not match the run's")
    parts = {}
    for name in modules:
        module = copy.deepcopy(getattr(example, name))
        module.load_state_dict(payload[name])
        parts[name] = module
    for name in opts:
        ex = getattr(example, name)
        saved = payload.get(name)
        if saved is None:
            parts[name] = [t.clone() for t in ex]
        elif len(saved) != len(ex):
            raise ValueError(f"checkpoint field {name} does not match the run's")
        else:
            parts[name] = [_like(s, e, name) for s, e in zip(saved, ex)]
    return AlgoState(**parts)


def save_checkpoint(path: str, carry, steps: int, episodes: int, *, keep=2):
    """Full training-state checkpoint (resumable).

    ``path`` is a directory of GENERATIONS: each save writes the file
    ``ckpt_<episodes:08d>`` under a temporary name, moves it into place with
    ``os.replace`` and only then prunes down to the newest ``keep``, so a
    crash mid-write never loses the previous good generation."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {
        "env_state": _fields(carry.env_state),
        "obs": carry.obs,
        "last_hid": carry.last_hid,
        "algo": _algo_payload(carry.algo),
        "replay": {"data": _fields(carry.replay.data), "ptr": carry.replay.ptr,
                   "size": carry.replay.size},
        "generator": carry.generator.get_state(),
        "carry_steps": carry.steps,
        "meta": {"steps": steps, "episodes": episodes},
    }
    dest = os.path.join(path, f"ckpt_{episodes:08d}")
    tmp = f"{dest}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, dest)
    for name in _generations(path)[:-keep]:
        os.remove(os.path.join(path, name))
    # sweep temporary files a crash left behind, so they never accumulate
    for name in os.listdir(path):
        if re.fullmatch(r"ckpt_\d{8,}\.tmp\.\d+", name):
            os.remove(os.path.join(path, name))


def _carry_from(payload, example):
    env_state = EnvState(**{k: _like(payload["env_state"][k], v, f"env_state.{k}")
                            for k, v in _fields(example.env_state).items()})
    replay = ReplayState(
        data=Transition(**{k: _like(payload["replay"]["data"][k], v, f"replay.{k}")
                           for k, v in _fields(example.replay.data).items()}),
        ptr=int(payload["replay"]["ptr"]), size=int(payload["replay"]["size"]))
    generator = torch.Generator(device=example.generator.device)
    generator.set_state(payload["generator"])
    return dataclasses.replace(
        example, env_state=env_state,
        obs=_like(payload["obs"], example.obs, "obs"),
        last_hid=_like(payload["last_hid"], example.last_hid, "last_hid"),
        algo=_algo_from(payload["algo"], example.algo), replay=replay,
        generator=generator, steps=int(payload["carry_steps"]))


def restore_checkpoint(path: str, example_carry):
    """Restore into the structure of ``example_carry`` (which is not
    modified); returns (carry, steps, episodes).

    ``path`` may be a generations directory (newest valid generation wins,
    falling back to older ones if the newest is corrupt) or one checkpoint
    file."""
    path = os.path.abspath(path)
    gens = _generations(path)
    candidates = [os.path.join(path, g) for g in reversed(gens)] or [path]
    err = None
    for cand in candidates:
        try:
            payload = torch.load(cand, map_location="cpu", weights_only=True)
            carry = _carry_from(payload, example_carry)
            break
        except Exception as e:  # corrupt or partial generation: try older
            err = e
    else:
        raise FileNotFoundError(f"no restorable checkpoint under {path}") from err
    meta = payload["meta"]
    return carry, int(meta["steps"]), int(meta["episodes"])


def save_model(path: str, algo_state: AlgoState):
    """Weights-only export (the reference's model.pt analog,
    train.py:117-119): the behaviour and target modules' state dicts."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_algo_payload(algo_state, optimizer=False), path)


def load_model(path: str, example_algo_state: AlgoState) -> AlgoState:
    """The weights of ``path`` in modules shaped like the example's; the
    optimizer states are copied from the example."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return _algo_from(payload, example_algo_state)
