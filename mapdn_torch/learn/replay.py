"""Device-resident replay buffers for vectorized rollouts (PyTorch port of
mapdn_tpu/learn/replay.py).

Transition mode: the buffer is a :class:`Transition` of ``(capacity, n_env,
...)`` tensors; ``sample_window`` draws a time-contiguous window of
``batch_size`` steps (reference replay_buffer.py:19-29), optionally on a
random subset of lanes.  Episodic mode: a pool of ``(capacity, T, n_env,
...)`` episode slots, one vectorized episode a slot (reference
replay_buffer.py:33-58); ``sample_episodes`` draws whole single-lane
episodes.  The write pointer and fill count are host integers; the draws
(``window_start``, ``episode_draws``) stay on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from mapdn_torch.algos.base import Transition
from mapdn_torch.utils import profiling


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
    """Append T steps of a (T, n_env, ...) stack, in place; when T >= capacity
    only the newest ``capacity`` rows survive (identical to T sequential
    adds), written over the ring from its first row."""
    cap = state.capacity
    t = stacked.reward.shape[0]
    if t >= cap:
        state.data.map(lambda buf, x: buf.copy_(x[t - cap:]), stacked)
        return ReplayState(data=state.data, ptr=0, size=cap)
    idx = (state.ptr + torch.arange(t)) % cap

    def write(buf, x):
        buf[idx.to(buf.device)] = x.to(buf.dtype)
        return buf
    state.data.map(write, stacked)
    return state.replace(ptr=(state.ptr + t) % cap, size=min(state.size + t, cap))


def _lane_choice(n_env, lanes, generator, device):
    """``lanes`` distinct lane indices, uniform without replacement."""
    return torch.randperm(n_env, generator=generator, device=device)[:lanes]


def window_start(state: ReplayState, batch_size: int, generator=None) -> torch.Tensor:
    """A window start, uniform over the filled region (oldest first): a new
    0-d int64 tensor on the ring's device at every call, never read back."""
    return torch.randint(0, max(state.size - batch_size, 0) + 1, (),
                         generator=generator, device=state.data.reward.device)


def oldest_row(state: ReplayState) -> int:
    """The ring row that holds the oldest step."""
    return 0 if state.size < state.capacity else state.ptr


def sample_window(state: ReplayState, batch_size: int, lanes: int | None = None,
                  generator=None, lane_idx=None, start=None, oldest=None) -> Transition:
    """Contiguous window of ``batch_size`` steps, (batch_size, n_env', ...),
    starting uniformly over the filled region in oldest-first order.  The
    caller guarantees size >= batch_size.

    ``lanes``: gather a random subset of that many lanes (``lane_idx`` gives
    it explicitly); ``start`` gives the window start explicitly; ``oldest``
    the oldest row (``oldest_row``), a 0-d device tensor where the window
    is shorter than the ring."""
    cap = state.capacity
    n_env = state.data.reward.shape[1]
    device = state.data.reward.device
    if oldest is None:
        oldest = oldest_row(state)
    subsample = lanes is not None and lanes < n_env
    if subsample and lane_idx is None:
        lane_idx = _lane_choice(n_env, lanes, generator, device)
    if cap == batch_size:
        # the window is the whole ring, un-rotated (lanes gathered first);
        # a ring whose oldest row is its first is the window as it stands
        if subsample:
            lane_idx = torch.as_tensor(lane_idx, device=device).long()
            window = state.data.map(lambda buf: buf[:, lane_idx])
        else:
            window = state.data
        return window if oldest == 0 else window.map(lambda buf: torch.roll(buf, -oldest, 0))
    if start is None:
        start = window_start(state, batch_size, generator)
    with profiling.span("replay.gather"):
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


# --------------------------------------------------------------- episodic
# One rollout of n_env lanes contributes n_env episodes to the pool.

def init_episode_replay(capacity: int, example: Transition, t: int) -> ReplayState:
    """Allocate (capacity, T, n_env, ...) episode slots from one example
    transition of (n_env, ...) tensors."""
    data = example.map(lambda x: torch.zeros((capacity, t) + tuple(x.shape),
                                             dtype=x.dtype, device=x.device))
    return ReplayState(data=data, ptr=0, size=0)


def episode_slot(state: ReplayState) -> Transition:
    """The (T, n_env, ...) views of the slot the next episode is written to;
    the rollout writes its steps straight into them."""
    return state.data.map(lambda buf: buf[state.ptr])


def add_episode(state: ReplayState) -> ReplayState:
    """Count the vectorized episode written into ``episode_slot(state)``:
    advance the pointer and the fill."""
    cap = state.capacity
    return state.replace(ptr=(state.ptr + 1) % cap, size=min(state.size + 1, cap))


def episode_draws(state: ReplayState, batch_size: int, generator=None):
    """(slots, lanes), ``batch_size`` each: ``sample_episodes``' draws."""
    kw = dict(generator=generator, device=state.data.reward.device)
    return (torch.randint(0, max(state.size, 1), (batch_size,), **kw),
            torch.randint(0, state.data.reward.shape[2], (batch_size,), **kw))


def sample_episodes(state: ReplayState, batch_size: int, generator=None,
                    draws=None) -> Transition:
    """``batch_size`` whole episodes -> a (T, batch_size, ...) Transition.

    Each draw picks a (slot, lane) pair uniformly over the filled slots and
    all lanes (reference replay_buffer.py:46-52 samples its flat list the
    same way): ``slots`` in [0, max(size, 1)), ``lanes`` in [0, n_env), or
    ``draws = (slots, lanes)`` given explicitly."""
    device = state.data.reward.device
    if draws is None:
        draws = episode_draws(state, batch_size, generator)
    slots, lanes = (torch.as_tensor(d, device=device).long() for d in draws)
    # advanced indices on axes 0 and 2 put the batch axis first
    return state.data.map(lambda buf: buf[slots, :, lanes].transpose(0, 1))
