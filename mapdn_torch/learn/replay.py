"""Device-resident ring replay buffer for vectorized rollouts (PyTorch port
of mapdn_tpu/learn/replay.py, transition mode).

The buffer is a :class:`Transition` of ``(capacity, n_env, ...)`` tensors;
``sample_window`` draws a time-contiguous window of ``batch_size`` steps
(reference replay_buffer.py:19-29), optionally on a random subset of lanes.
The write pointer and fill count are host integers.
"""
from __future__ import annotations

import dataclasses

import torch

from mapdn_torch.algos.base import Transition


@dataclasses.dataclass
class ReplayState:
    data: Transition   # (capacity, n_env, ...) tensors
    ptr: int           # next write slot
    size: int          # number of valid slots

    @property
    def capacity(self):
        return self.data.reward.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_replay(capacity: int, example: Transition) -> ReplayState:
    """Allocate from one example transition of (n_env, ...) tensors."""
    data = example.map(lambda x: torch.zeros((capacity,) + tuple(x.shape),
                                             dtype=x.dtype, device=x.device))
    return ReplayState(data=data, ptr=0, size=0)


def add(state: ReplayState, trans: Transition) -> ReplayState:
    """Append one step (FIFO ring), in place."""
    def write(buf, x):
        buf[state.ptr] = x.to(buf.dtype)
        return buf
    state.data.map(write, trans)
    cap = state.capacity
    return state.replace(ptr=(state.ptr + 1) % cap, size=min(state.size + 1, cap))


def add_many(state: ReplayState, stacked: Transition) -> ReplayState:
    """Append T steps of a (T, n_env, ...) stack; when T >= capacity only the
    newest ``capacity`` rows survive (identical to T sequential adds)."""
    cap = state.capacity
    t = stacked.reward.shape[0]
    if t >= cap:
        tail = stacked.map(lambda x, buf: x[t - cap:].to(buf.dtype), state.data)
        return ReplayState(data=tail, ptr=0, size=cap)
    idx = (state.ptr + torch.arange(t)) % cap

    def write(buf, x):
        buf[idx.to(buf.device)] = x.to(buf.dtype)
        return buf
    state.data.map(write, stacked)
    return state.replace(ptr=(state.ptr + t) % cap, size=min(state.size + t, cap))


def _lane_choice(n_env, lanes, generator, device):
    """``lanes`` distinct lane indices, uniform without replacement."""
    return torch.randperm(n_env, generator=generator, device=device)[:lanes]


def sample_window(state: ReplayState, batch_size: int, lanes: int | None = None,
                  generator=None, lane_idx=None, start=None) -> Transition:
    """Contiguous window of ``batch_size`` steps, (batch_size, n_env', ...),
    starting uniformly over the filled region in oldest-first order.  The
    caller guarantees size >= batch_size.

    ``lanes``: gather a random subset of that many lanes (``lane_idx`` gives
    it explicitly); ``start`` gives the window start explicitly."""
    cap = state.capacity
    n_env = state.data.reward.shape[1]
    device = state.data.reward.device
    oldest = 0 if state.size < cap else state.ptr
    subsample = lanes is not None and lanes < n_env
    if subsample and lane_idx is None:
        lane_idx = _lane_choice(n_env, lanes, generator, device)
    if cap == batch_size:
        # the window is the whole ring, un-rotated (lanes gathered first)
        if subsample:
            lane_idx = torch.as_tensor(lane_idx, device=device).long()
            return state.data.map(lambda buf: torch.roll(buf[:, lane_idx], -oldest, 0))
        return state.data.map(lambda buf: torch.roll(buf, -oldest, 0))
    if start is None:
        start = int(torch.randint(0, max(state.size - batch_size, 0) + 1, (),
                                  generator=generator, device=device))
    idx = (oldest + start + torch.arange(batch_size, device=device)) % cap
    window = state.data.map(lambda buf: buf[idx])
    return subsample_lanes(window, lanes, lane_idx=lane_idx) if subsample else window


def subsample_lanes(window: Transition, lanes: int | None, generator=None,
                    lane_idx=None) -> Transition:
    """Random lane subset of a (T, n_env, ...) window."""
    n_env = window.reward.shape[1]
    if lanes is None or lanes >= n_env:
        return window
    device = window.reward.device
    if lane_idx is None:
        lane_idx = _lane_choice(n_env, lanes, generator, device)
    lane_idx = torch.as_tensor(lane_idx, device=device).long()
    return window.map(lambda buf: buf[:, lane_idx])


def clear(state: ReplayState) -> ReplayState:
    """On-policy post-update clear (reference model.py:55-56)."""
    return state.replace(ptr=0, size=0)
