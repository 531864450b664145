"""One rank's share of a lane axis, drawn and reduced as the whole axis.

A sharded trainer (:mod:`mapdn_torch.parallel`) steps each rank's
contiguous share of the env lanes and computes each loss on the rank's
rows of the sampled batch.  Its ranks seed one generator alike and must
stay in step with the single process on the same seed.  So, inside
``with shard.active():`` of a :class:`LaneShard`:

* :func:`draw` takes a draw at the axis's global extent and keeps this
  rank's rows, so every rank consumes the generator as the single process
  does and holds the numbers the single process holds for those rows;
  :func:`given` keeps this rank's rows of an explicit draw made at the
  global extent (the parity tests' replayed draws);
* :func:`any_lane` and :func:`all_lanes`, the host conditions that guard a
  draw (an auto-reset, a reset retry), are reduced over the ranks;
* :func:`row_sum` sums a batch statistic over every rank's rows.

Outside such a block (one process) each is the plain operation.  The
active shard is a ``contextvars`` variable, set and reset by ``active``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from mapdn_torch.utils import profiling

_ACTIVE = contextvars.ContextVar("mapdn_torch_lane_shard", default=None)


class LaneShard:
    """This rank's ``rows`` (an index tensor) of an axis of ``n_global``
    entries, and the process group that holds the other rows.  ``pad``
    placeholder rows may follow them: a rank that holds none of a batch's
    rows still runs the loss (and its collectives) on a stand-in row, whose
    draws are zeros and which no statistic or share counts."""

    def __init__(self, rows, n_global, group=None, pad=0):
        self.rows = rows
        self.n_global = int(n_global)
        self.group = group
        self.pad = int(pad)

    @property
    def n_local(self):
        return int(self.rows.numel())

    def share(self, mean):
        """A mean over this rank's rows as its term of the mean over all
        rows: scaled by n_local / n_global, and zero (with a zero gradient,
        not the NaN of an empty mean) where the rank holds no row."""
        if self.n_local == 0:
            return torch.where(torch.zeros((), dtype=torch.bool, device=mean.device),
                               mean, torch.zeros_like(mean))
        return mean * (self.n_local / self.n_global)

    @contextlib.contextmanager
    def active(self):
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)


def current():
    """The active :class:`LaneShard`, or None in one process."""
    return _ACTIVE.get()


def _rows(x, shard, axis):
    """``shard``'s rows of ``x`` along ``axis``, then its placeholder rows
    (zeros)."""
    out = x.index_select(axis, shard.rows.to(x.device))
    if shard.pad:
        full = list(x.shape)
        full[axis] = shard.pad
        out = torch.cat([out, out.new_zeros(full)], axis)
    return out


def draw(fn, shape, axis=0):
    """``fn(shape)``, a draw from a generator; under a shard, drawn at the
    global extent of ``axis`` and this rank's rows kept."""
    shard = _ACTIVE.get()
    if shard is None:
        return fn(tuple(shape))
    if shape[axis] != shard.n_local + shard.pad:
        raise ValueError(f"lane draw of shape {tuple(shape)}: axis {axis} holds "
                         f"{shape[axis]} rows, the shard {shard.n_local} and "
                         f"{shard.pad} placeholders")
    full = list(shape)
    full[axis] = shard.n_global
    return _rows(fn(tuple(full)), shard, axis)


def given(x, axis=0):
    """An explicit draw ``x`` (a tensor or an array); under a shard, made at
    the global extent of ``axis``, of which this rank's rows are kept as
    :func:`draw` keeps them."""
    shard = _ACTIVE.get()
    if shard is None:
        return x
    x = torch.as_tensor(x)
    if x.shape[axis] != shard.n_global:
        raise ValueError(f"explicit draw of shape {tuple(x.shape)}: axis {axis} "
                         f"holds {x.shape[axis]} rows, the whole axis {shard.n_global}")
    return _rows(x, shard, axis)


def any_lane(flag):
    """Whether ``flag`` (a bool tensor over this rank's lanes) holds
    anywhere, over every rank under a shard; a host read."""
    with profiling.span("host.sync"):
        local = flag.any()
        shard = _ACTIVE.get()
        if shard is None:
            return bool(local)
        t = local.to(torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=shard.group)
        return bool(t)


def all_lanes(flag):
    """Whether ``flag`` holds on every lane of every rank; a host read."""
    return not any_lane(~flag)


def row_sum(x):
    """``x.sum(0)``, over every rank's rows under a shard (through the
    autograd all-reduce where ``x`` needs a gradient)."""
    shard = _ACTIVE.get()
    if shard is None:
        return x.sum(0)
    s = x.narrow(0, 0, shard.n_local).sum(0)
    if s.requires_grad:
        import torch.distributed.nn.functional as dist_nn
        return dist_nn.all_reduce(s, group=shard.group)
    dist.all_reduce(s, group=shard.group)
    return s

