"""Training traffic on an off-policy ring whose losses draw noise: the ring
kind (perfbench/kinds/train_ring.py), whose runner this one extends, for
an algorithm whose policy has a learned std and whose update steps draw
standard normals for the loss before each step
(``mapdn_torch.learn.update_graph.loss_noise``, handed to the loss as its
``draws``).  The algorithm's file gives ``NOISE``, the names the reference
reads, and ``gaussian`` and ``log_prob``, its policy's log-std and density.

What decides ``correct`` is the ring kind's numbers, with the reference
following each update step on the program's own window and the program's
own noise:

* The set-up chunks: beside each update step's batch, the recorder keeps
  the loss draws the step was handed, copied to the host as the batch is.
* The window's last chunk: the noise each ``loss_noise`` call returned (new
  device tensors, kept by reference as the window starts are, read after
  the window) goes beside the window gathered from its start.
* The policy's means, hidden state and log-prob on the set-up chunks'
  pairs take the log-std from the reference's Gaussian head.

A program whose update steps draw no loss noise cannot be checked here: set-up
stops at once.
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from perfbench import spec, tracing

_ring = spec.kind("train_ring", os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_host = _ring._host


class NoiseSnapshots(_ring.RingSnapshots):
    """The ring kind's snapshots, and the loss noise the chunk that ran last
    drew (references to the device's tensors, read after the window)."""

    def __init__(self, alg, algo):
        super().__init__(alg, algo)
        self.noise = []

    def wrap(self, fn):
        snap = super().wrap(fn)

        def run(carry, draws=None):
            self.noise = []
            return snap(carry, draws)
        return run

    def log_noise(self, fn):
        def run(*args, **kwargs):
            drawn = fn(*args, **kwargs)
            self.noise.append(drawn)
            return drawn
        return run


class _QOnly:
    """The model's critic values alone, of a critic that also returns its
    regulariser."""

    def __init__(self, model):
        self.model = model

    def value(self, *args):
        return self.model.value(*args)[0]


class NoiseRecorder(_ring.RingRecorder):
    """The ring kind's recorder, and each update step's loss draws in its
    batch."""

    def _update(self, fn):
        def noted(algo, batch, which, shard, generator, loss_draws):
            out = fn(algo, batch, which, shard, generator, loss_draws)
            if self._active():
                self.batches[-1].update(self._take(lambda: {
                    k: _host(v).float() for k, v in (loss_draws or {}).items()}))
            return out
        return super()._update(noted)

    @contextlib.contextmanager
    def installed(self, trainer):
        with super().installed(trainer):
            self.model = _QOnly(trainer.model)
            yield self


class Runner(_ring.Runner):
    def setup(self):
        from mapdn_torch.learn import update_graph
        if not hasattr(update_graph, "loss_noise"):
            raise RuntimeError("the program's update steps draw no loss noise before the loss: "
                               "the reference cannot follow them")
        super().setup()
        self.snaps = NoiseSnapshots(self.alg, self.trainer.carry.algo)

    def first_steps(self, rng):
        """The ring kind's, with a recorder that keeps the loss noise."""
        n = min(self.cell["check"]["check"]["lanes"], self.trainer.n_envs)
        self.lanes = np.sort(rng.choice(self.trainer.n_envs, n, replace=False))
        self.rec = NoiseRecorder(self.alg, self.lanes, self.cell["check"]["check"]["chunks"],
                                 self.sync, False)
        with self.rec.installed(self.trainer):
            for _ in range(self.rec.chunks_wanted):
                if self.rec.done():
                    break
                self.trainer.run_episode()
        if not self.rec.done():
            raise RuntimeError("the recorder saw fewer chunks than it follows: the trainer no "
                               "longer calls _train_chunk, _rollout_step and _update_step")
        self.sync()
        return self.rec.copy_seconds

    def _episodes(self, seconds):
        from mapdn_torch.learn import update_graph
        with tracing.installed([(update_graph, "loss_noise", self.snaps.log_noise)]):
            return super()._episodes(seconds)

    def window(self, seconds):
        before = self.trainer.update_counts()
        out = super().window(seconds)
        after = self.trainer.update_counts()
        delta = {k: {r: after[k][r] - before[k][r] for r in after[k]} for k in after}
        print(f"perfbench: the window's update steps: {delta}", file=sys.stderr)
        return out

    # ----------------------------------------------------------------- check
    def keep(self):
        """The ring kind's, each kept window with the noise its step drew."""
        super().keep()
        windows, noise = self.kept["windows"], self.snaps.noise
        if len(noise) != len(windows):
            raise RuntimeError(f"the last chunk drew loss noise {len(noise)} times for "
                               f"{len(windows)} windows")
        for window, drawn in zip(windows, noise):
            window.update({k: _host(v).float() for k, v in drawn.items()})

    def _policy_outputs(self, starts, pairs, dtype, device):
        """Means, new hidden state and the log-prob of the program's action
        under the Gaussian head, from the parameters each pair's chunk
        started with."""
        d = lambda x: x.to(device, dtype)
        out, order = {"means": [], "hid": [], "logp": []}, []
        for c, params in enumerate(starts):
            rows = (pairs["chunk"] == c).nonzero()[:, 0]
            if len(rows) == 0:
                continue
            p = {k: d(v) for k, v in params["policy"].items()}
            means, log_std, hid = self.alg.gaussian(p, d(pairs["obs"][rows]),
                                                    d(pairs["last_hid"][rows]), self.alg_cfg)
            out["means"].append(means.cpu())
            out["hid"].append(hid.cpu())
            out["logp"].append(self.alg.log_prob(d(pairs["action"][rows]), means, log_std).cpu())
            order.append(rows)
        inv = torch.argsort(torch.cat(order))
        return {k: torch.cat(v)[inv] for k, v in out.items()}
