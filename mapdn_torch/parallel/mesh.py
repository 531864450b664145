"""Multi-GPU training: the env lanes split over the ranks of a
``torch.distributed`` process group (port of mapdn_tpu/parallel/mesh.py).

Rank r of W holds the contiguous global lanes ``[r L/W, (r+1) L/W)``: its
env state, observations, GRU state, replay ring ``(capacity, lanes, ...)``
and episode pool ``(capacity, T, lanes, ...)``.  The learner (parameters,
optimizer state, generator, counters) is replicated.  The JAX package gets
a sharded run equal to the unsharded one from one replicated key and
XLA's collectives; here every rank seeds one generator alike and
:class:`ShardedPGTrainer` keeps the ranks in step with the single process:

* every rollout and reset draw is taken at the global lane count and each
  rank keeps its slice, and the host conditions that guard a draw (a reset
  retry, an auto-reset) are reduced over the ranks
  (:mod:`mapdn_torch.utils.lanes`);
* an update draws its lanes (or episodes) over the global ``n_envs``, and
  each rank computes the loss on the rows it holds, as its share
  (n_local / n_global) of the whole batch's mean; batch statistics
  (``batchnorm``) and a loss's own draws are the whole batch's;
* the gradients (and the logged losses) are summed over the ranks before
  ``global_norm`` and the optimizer step, so the clip sees the global
  gradient and every rank takes the same step;
* the chunk's rollout stats are averaged over the ranks, and the eval runs
  whole on every rank.

Every step runs uncaptured (``shard``): the rollout's gate and the
update's sums are all-reduces.  The update keeps its own loop here.

Each loss of learn/losses.py and algos/*.py is a mean over the batch's
rows, so the shares sum to it.  What is not a per-row mean is reduced on
its own: ``batchnorm``'s mean and std (sums over all ranks' rows), and
MAAC's attention regulariser, a mean over the batch computed without a
graph, whose shares sum to the whole batch's in the logged loss.

Backends: ``"nccl"`` for CUDA with one card a rank
(``cuda:{rank % device_count}``), ``"gloo"`` on the CPU (or for ranks that
share a card, which NCCL refuses).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from mapdn_torch.learn import replay as rb
from mapdn_torch.learn.trainer import PGTrainer, TrainerCarry, _mean_stats
from mapdn_torch.utils import profiling
from mapdn_torch.utils.lanes import LaneShard

BACKENDS = ("nccl", "gloo")


def init_process_group(coordinator, world_size, rank, backend, timeout_s=600):
    """Join the process group of ``world_size`` ranks as ``rank``, meeting
    at ``tcp://<coordinator>`` (``host:port``).  ``backend`` is ``"nccl"``
    (one card a rank: more ranks than cards raise) or ``"gloo"``; a failed
    rendezvous raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend '{backend}'; one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card a rank: {world_size} ranks, "
                         f"{torch.cuda.device_count()} cards (gloo runs ranks on the CPU)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(backend, rank):
    """The device of ``rank``: ``cuda:{rank % device_count}`` under NCCL,
    the CPU under gloo."""
    if backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def lane_range(n_envs, world_size, rank):
    """The global lanes ``[lo, hi)`` that ``rank`` holds."""
    if n_envs % world_size:
        raise ValueError(f"n_envs={n_envs} not divisible by world size {world_size}")
    n = n_envs // world_size
    return rank * n, (rank + 1) * n


def shard_carry(carry: TrainerCarry, world_size, rank) -> TrainerCarry:
    """``rank``'s part of a whole (single-process) carry, laid out as a
    :class:`ShardedPGTrainer`'s (mapdn_tpu/parallel/mesh.py's
    ``_carry_shardings``): env state, obs and GRU state on their lane axis
    0, the ring on axis 1 (the episode pool on axis 2), the learner and
    the generator as they are (replicated)."""
    lo, hi = lane_range(carry.obs.shape[0], world_size, rank)
    pool = carry.replay.data.reward.dim() == 4   # (capacity, T, lanes, n)
    ring_axis = 2 if pool else 1
    env_state = type(carry.env_state)(**{
        k: v[lo:hi] for k, v in vars(carry.env_state).items()})
    data = carry.replay.data.map(lambda x: x.narrow(ring_axis, lo, hi - lo))
    return TrainerCarry(env_state=env_state, obs=carry.obs[lo:hi],
                        last_hid=carry.last_hid[lo:hi], algo=carry.algo,
                        replay=carry.replay.replace(data=data),
                        generator=carry.generator, steps=carry.steps)


class ShardedPGTrainer(PGTrainer):
    """:class:`PGTrainer` over a process group: this rank's share of the
    ``cfg.n_envs`` lanes, a replicated learner, gradients summed over the
    ranks.  Explicit draws (``_train_chunk``'s, as :class:`PGTrainer` takes
    them) are the whole run's, at the global lane count and the whole
    batch: each rank keeps its rows."""

    def __init__(self, cfg, model, env, group=None, device=None):
        super().__init__(cfg, model, env, device)
        if not dist.is_initialized():
            raise RuntimeError("ShardedPGTrainer needs a process group "
                               "(mapdn_torch.parallel.init_process_group)")
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.lo, hi = lane_range(cfg.n_envs, self.world_size, self.rank)
        self.n_envs = hi - self.lo
        self._lanes = LaneShard(torch.arange(self.lo, hi, device=self.device),
                                cfg.n_envs, group)

    def _lane_context(self):
        return self._lanes.active()

    def _update_epochs(self, algo, replay, generator, *, which, epochs, draws):
        """``epochs`` optimizer steps on this rank's rows of freshly sampled
        windows, uncaptured (``PGTrainer._update_epochs``).  A ring whose
        capacity equals batch_size without lane subsampling gives the same
        window every epoch: sampled once."""
        cfg = self.cfg
        if epochs <= 0:
            return {}
        # every epoch here runs under this trainer's lane shard, also where
        # a stubbed ``lanes.current`` hides it from the reason test
        reason = self._update_eager_reason(algo, which, draws) or "shard"
        subsampling = cfg.update_lanes is not None and cfg.update_lanes < cfg.n_envs
        fixed = (not cfg.episodic and replay.capacity == cfg.batch_size
                 and not subsampling)

        def sample(e):
            with profiling.span("update.sample"):
                return self._sample_batch(replay, generator, which, e, draws)

        fixed_batch = sample(0) if fixed else None
        epoch_draws = lambda key, e: None if draws.get(key) is None else draws[key][e]
        stats = []
        for e in range(epochs):
            self._update_counts["eager"][reason] += 1
            profiling.count("train.eager_updates", 1)
            batch, shard = fixed_batch or sample(e)
            with shard.active():
                stats.append(self._update_step(
                    algo, batch.map(self._upcast), which, shard, generator,
                    epoch_draws(which + "_loss", e)))
        return _mean_stats(stats)

    def _sample_batch(self, replay, generator, which, e, draws):
        """The epoch's lanes (or episodes) drawn over the global lanes, as
        the single process draws them (or as ``draws`` gives them); this
        rank's rows of the batch, in the batch's order, and their
        :class:`LaneShard`."""
        cfg = self.cfg
        dev = self.device
        lo, hi = self.lo, self.lo + self.n_envs
        epoch_draws = lambda key: None if draws.get(key) is None else draws[key][e]
        if cfg.episodic:
            kw = dict(generator=generator, device=dev)
            given = epoch_draws(which + "_episodes")
            if given is None:
                slots = torch.randint(0, max(replay.size, 1), (cfg.batch_size,), **kw)
                lanes = torch.randint(0, cfg.n_envs, (cfg.batch_size,), **kw)
            else:
                slots, lanes = (torch.as_tensor(d, device=dev).long() for d in given)
            pos = torch.nonzero((lanes >= lo) & (lanes < hi)).reshape(-1)
            held = (slots[pos], lanes[pos] - lo) if len(pos) else (slots[:1], lanes[:1] * 0)
            batch = rb.sample_episodes(replay, cfg.batch_size, draws=held)
            width, steps = cfg.batch_size, cfg.max_steps
        else:
            subsampling = cfg.update_lanes is not None and cfg.update_lanes < cfg.n_envs
            lane_idx = epoch_draws(which + "_lanes")
            if lane_idx is not None:
                lane_idx = torch.as_tensor(lane_idx, device=dev).long()
            elif subsampling:
                lane_idx = rb._lane_choice(cfg.n_envs, cfg.update_lanes, generator, dev)
            else:
                lane_idx = torch.arange(cfg.n_envs, device=dev)
            start = epoch_draws(which + "_starts")
            if start is None and replay.capacity != cfg.batch_size:
                start = rb.window_start(replay, cfg.batch_size, generator)
            window = rb.sample_window(replay, cfg.batch_size, start=start)
            pos = torch.nonzero((lane_idx >= lo) & (lane_idx < hi)).reshape(-1)
            local = lane_idx[pos] - lo if len(pos) else lane_idx[:1] * 0
            batch = window.map(lambda buf: buf[:, local])
            width, steps = len(lane_idx), cfg.batch_size
        # the batch flattens (T, width) to rows t * width + lane position; a
        # rank that holds no lane of the batch runs on one of its own lanes
        # as a placeholder, counted nowhere
        rows = (torch.arange(steps, device=dev)[:, None] * width + pos[None]).reshape(-1)
        pad = 0 if len(pos) else steps
        return batch, LaneShard(rows, steps * width, self.group, pad=pad)

    def _sum_over_ranks(self, tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out

    def _rollout_stats(self, stats):
        """This rank's lane means as its share of the global lanes', summed
        over the ranks."""
        keys = list(stats)
        summed = self._sum_over_ranks(
            [self._lanes.share(torch.as_tensor(stats[k], device=self.device)) for k in keys])
        return dict(zip(keys, summed))
