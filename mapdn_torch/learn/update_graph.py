"""The trainer's update steps, as CUDA graphs.

One optimizer step of the update phase (the window's gather, the loss,
``torch.autograd.grad``, the global norm, the clip and the RMSprop update
in place) is some hundreds of small kernels at case33's sizes, launched by
the host one epoch after another.  :class:`UpdateGraph` runs every update
step of a single-process trainer: it captures the step of each ``which``
(value, policy, mixer) once and replays it for every later epoch, one
launch an epoch.  An epoch that may not replay
(``PGTrainer._update_eager_reason``: on the CPU too) runs the same code
uncaptured, with the same work and results.

A step reads the algorithm's parameters and optimizer state and the ring
as they are, and updates the parameters and the state in place.  What the
step draws (``sample_window``'s lanes, then ``replay.window_start``;
``sample_episodes``' slots and lanes; then the standard normals its loss
declares, ``model.loss_noise(which)``, by :func:`loss_noise`) is drawn
before each step, outside the graph, by those functions in that order
(or given explicitly), and copied into static buffers; the gather from
the index buffers, with the ring's oldest row held on the device, is in
the step, and the loss takes its noise from the noise buffers as its
``draws``.  An epoch run uncaptured draws the same numbers in the same
order, so a graphed epoch and an uncaptured one are the same, bit for
bit.  Where the window is the whole ring (``capacity == batch_size``)
the step reads the ring itself, so no copy of it is made, and its oldest
row, a host value there, picks the graph.  Each step writes its stats
into its column of a stats buffer from an epoch index held on the
device, so that their means over the epochs add in the order that
``trainer._mean_stats`` adds them.

Capture follows ``learn/rollout_graph.py``: the carry's generator is
registered with each graph, the warm-up is a real epoch run uncaptured on the
current stream, the capture runs on a side stream and releases its cuBLAS
workspace to the pool after it.  Inside a step the modules' parameters
stand aliased by fresh leaves on their storage (:func:`_aliased`): the
backward then accumulates into nodes made on the capture stream, even
where an autograd graph that the caller keeps alive (a copy of a
parameter taken with grad enabled, say) holds the parameters' own nodes,
which belong to the stream they were made on and would tie the capture
to it.  The update graphs share one private pool
of their own; every tensor a capture allocates is freed by its end, so
they may replay in any order.

A step replays only where nothing asks to see it
(``PGTrainer._update_eager_reason``): a replay calls no Python.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from mapdn_torch.algos.base import Transition
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn.rollout_graph import _ROW_ALIGN, _tensors, capture
from mapdn_torch.utils import profiling

_TRANSITION = tuple(f.name for f in dataclasses.fields(Transition))
_MODULES = ("policy", "value", "target_policy", "target_value", "mixer", "target_mixer")
_OPT = ("policy_opt", "value_opt", "mixer_opt")


def loss_noise(names, shape, like, generator):
    """{name: standard normals of ``shape``}, drawn from ``generator`` in
    the order of ``names``, in ``like``'s dtype on its device: a new
    tensor each at every call, read back by nothing."""
    return {k: torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)
            for k in names}


def modules(algo):
    """The algorithm's behaviour and target modules (a mixer's if any)."""
    return [getattr(algo, f) for f in _MODULES if getattr(algo, f) is not None]


def _state(algo):
    """Every tensor of ``algo`` a step reads or writes, with its address."""
    opt = [(t, t.data_ptr()) for f in _OPT for t in getattr(algo, f)]
    return [p for m in modules(algo) for p in _tensors(m)] + opt


@contextlib.contextmanager
def _aliased(mods):
    """Each parameter of ``mods`` replaced in its module, for the block, by
    a new leaf on the same storage (``detach``, the same ``requires_grad``):
    the same values and in-place updates, new autograd nodes."""
    held = [(m, name, p) for module in mods for m in module.modules()
            for name, p in m._parameters.items() if p is not None]
    try:
        for m, name, p in held:
            m._parameters[name] = p.detach().requires_grad_(p.requires_grad)
        yield
    finally:
        for m, name, p in held:
            m._parameters[name] = p


class UpdateGraph:
    """The update-step graphs of one trainer, bound to its model and
    configuration, one algorithm state, the carry's generator and ring."""

    @staticmethod
    def supports(device):
        return device.type == "cuda"

    def __init__(self, trainer, algo, replay, generator):
        self.trainer, self.model, self.cfg = trainer, trainer.model, trainer.cfg
        self.avail = trainer.avail
        self.algo, self.state = algo, _state(algo)
        self.generator = generator
        self.counts = trainer._update_counts
        self.ring = replay.data
        cfg = self.cfg
        # the draws' static copies (outside episodic mode, the lanes only
        # where a window takes a subset, the start where it is shorter than
        # the ring) and the ring's oldest row
        i64 = dict(dtype=torch.int64, device=self.ring.reward.device)
        self.episodes = self.lane_idx = None
        if cfg.episodic:
            self.episodes = tuple(torch.zeros(cfg.batch_size, **i64) for _ in range(2))
        elif cfg.update_lanes is not None and cfg.update_lanes < self.ring.reward.shape[1]:
            self.lane_idx = torch.zeros(cfg.update_lanes, **i64)
        self.start, self.oldest = torch.zeros((), **i64), torch.zeros((), **i64)
        self.epoch = torch.zeros(1, **i64)
        # the loss's noise, one static buffer a name a ``which``, of the
        # window's (rows, n, act) action shape
        lanes = (cfg.batch_size if cfg.episodic else self.ring.reward.shape[1]
                 if self.lane_idx is None else cfg.update_lanes)
        steps = self.ring.reward.shape[1] if cfg.episodic else cfg.batch_size
        self.noise_shape = (steps * lanes,) + tuple(self.ring.action.shape[-2:])
        self.noise = {}
        epochs = (cfg.value_update_epochs, cfg.policy_update_epochs, trainer._mixer_epochs())
        self.width = -(-max(*epochs, 1) // _ROW_ALIGN) * _ROW_ALIGN
        self.keys, self.stats = {}, {}
        self.graphs = {}
        self.pool = self.stream = None

    def binds(self, algo, replay, generator):
        """Whether these graphs step ``algo`` on ``replay`` with ``generator``."""
        tr, now = self.trainer, _state(algo)
        return (tr.model is self.model and tr.cfg is self.cfg and tr.avail is self.avail
                and generator is self.generator and len(now) == len(self.state)
                and all(a is b and pa == pb for (a, pa), (b, pb) in zip(now, self.state))
                and all(getattr(replay.data, f) is getattr(self.ring, f) for f in _TRANSITION))

    def run(self, which, replay, epochs, draws, reason):
        """``epochs`` update steps of ``which`` on ``replay``, each after its
        draws (``draws[which + part][e]`` where given): replayed where
        ``reason`` is None, else run uncaptured and tallied under it.
        Returns their stats, each averaged over the epochs."""
        if epochs > self.width:
            raise RuntimeError(f"{epochs} epochs past the stats buffer's {self.width} columns")
        cfg = self.cfg
        whole = not cfg.episodic and replay.capacity == cfg.batch_size
        oldest = rb.oldest_row(replay)
        if whole:
            region = lambda loss_draws=None: self._region(which, oldest, loss_draws)
        else:
            self.oldest.fill_(oldest)
            region = lambda loss_draws=None: self._region(which, self.oldest, loss_draws)
        key = (which, oldest if whole else None)
        self.epoch.zero_()
        for e in range(epochs):
            given = lambda part: None if draws.get(which + part) is None else draws[which + part][e]
            self._draw(which, replay, given)
            if reason is not None:
                self.counts["eager"][reason] += 1
                profiling.count("train.eager_updates", 1)
                region(given("_loss"))
                continue
            graph = self.graphs.get(key)
            if graph is None:
                region()   # the warm-up: this epoch, uncaptured
                self.graphs[key] = self._capture(region)
                self.counts["captures"][which] += 1
            else:
                graph.replay()
                self.counts["replays"][which] += 1
        stats = self.stats[which]
        return {k: stats[i, :epochs].mean() for i, k in enumerate(self.keys[which])}

    def _draw(self, which, replay, given):
        """The epoch's draws of a step of ``which`` into the static buffers:
        ``given(part)`` where it is not None, else drawn in the step's
        order; where the loss's draws are given, they go to the loss as
        they are and none is drawn for it."""
        cfg, gen, dev = self.cfg, self.generator, self.epoch.device
        as_index = lambda x: torch.as_tensor(x, device=dev).long()
        pick = lambda part, draw: draw() if given(part) is None else given(part)
        if cfg.episodic:
            # batch_size counts whole episodes (reference default.yaml:21)
            drawn = pick("_episodes", lambda: rb.episode_draws(replay, cfg.batch_size, gen))
            torch._foreach_copy_(list(self.episodes), [as_index(d) for d in drawn])
        else:
            if self.lane_idx is not None:
                self.lane_idx.copy_(as_index(pick("_lanes", lambda: rb._lane_choice(
                    replay.data.reward.shape[1], cfg.update_lanes, gen, dev))))
            if replay.capacity != cfg.batch_size:
                self.start.copy_(as_index(pick(
                    "_starts", lambda: rb.window_start(replay, cfg.batch_size, gen))))
        names = self.model.loss_noise(which)
        if names and given("_loss") is None:
            drawn = loss_noise(names, self.noise_shape, self.ring.action, gen)
            bufs = self.noise.get(which)
            if bufs is None:
                bufs = self.noise[which] = {k: torch.empty_like(v) for k, v in drawn.items()}
            torch._foreach_copy_(list(bufs.values()), list(drawn.values()))

    def _region(self, which, oldest, loss_draws=None):
        """One update step: the gather from the static draws, the step (with
        ``loss_draws``, the loss's own where given, else its noise buffers),
        and its stats into column ``epoch`` of the stats buffer."""
        tr, cfg = self.trainer, self.cfg
        if loss_draws is None:
            loss_draws = self.noise.get(which)
        ring = rb.ReplayState(data=self.ring, ptr=0, size=0)
        with profiling.span("update.sample"):
            if cfg.episodic:
                batch = rb.sample_episodes(ring, cfg.batch_size, draws=self.episodes)
            else:
                batch = rb.sample_window(ring, cfg.batch_size, cfg.update_lanes,
                                         lane_idx=self.lane_idx, start=self.start,
                                         oldest=oldest)
        with _aliased(modules(self.algo)):
            out = tr._update_step(self.algo, batch.map(tr._upcast), which, None,
                                  self.generator, loss_draws)
        self.keys.setdefault(which, list(out))
        vals = torch.stack([out[k] for k in self.keys[which]])
        if which not in self.stats:
            self.stats[which] = vals.new_empty((len(vals), self.width))
        self.stats[which].index_copy_(1, self.epoch, vals.unsqueeze(1))
        self.epoch.add_(1)

    def _capture(self, region):
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.ring.reward.device)
        graph, _ = capture(region, self.generator, self.pool, self.stream)
        self.pool = graph.pool()
        return graph
