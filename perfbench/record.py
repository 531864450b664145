"""What the first chunks of a training cell produce, kept for the check.

Installed on the trainer for the chunks the reference follows, and removed
before the window: for a sample of lanes drawn from the seed, each rollout
step's inputs and outputs (the env state before and after, the obs and
hidden state fed to the policy, its means, new hidden state, action and
log-prob, the reward and the termination); each update step's batch (once
where the epochs share one) and loss; each optimizer's state after its
first step; the parameters after the last followed chunk.  Everything is
copied to the host as it is taken, so the window's memory is the
program's own.
"""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench import tracing

STATE = ("t", "step", "load_p", "load_q", "pv_p", "sgen_q", "vm", "va", "terminated")


def _host(x):
    return x.detach().to("cpu", copy=True)


class TrainRecorder:
    def __init__(self, alg, lanes, chunks, sync, fixed_batch):
        self.alg = alg
        self.lanes = torch.as_tensor(lanes)
        self.fixed_batch = fixed_batch
        self.chunks_wanted = chunks
        self.sync = sync
        self.copy_seconds = 0.0
        self.chunks = []          # per chunk: {"steps": [...], "updates": [...]}
        self.batches = []         # host copies of the update batches
        self.first_nu = {}        # which -> {leaf: host tensor}
        self.params_after = None  # net -> {leaf: host tensor}
        self._policy_out = None
        self._batch_taken = False

    def done(self):
        """Whether the followed chunks are all recorded."""
        return self.params_after is not None

    def _active(self):
        return self.params_after is None

    def _take(self, fn):
        """``fn()`` with the time it takes counted as the check's."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.copy_seconds += time.perf_counter() - t0
        return out

    # ----------------------------------------------------------- wrappers
    def _chunk(self, fn):
        def run(carry, draws=None):
            if self._active():
                self.chunks.append({"steps": [], "updates": []})
                self._batch_taken = False
            out = fn(carry, draws)
            if self._active() and len(self.chunks) == self.chunks_wanted:
                params, _ = self.alg.split_state(self.alg.state_tensors(out[0].algo))
                self.params_after = self._take(lambda: {
                    net: {k: _host(v) for k, v in p.items()} for net, p in params.items()})
            return out
        return run

    def _actions(self, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._active():
                self._policy_out = (out[3][0], out[4])
            return out
        return run

    def _rollout(self, fn):
        def run(carry, draws=None):
            if not self._active():
                return fn(carry, draws)
            idx = self.lanes.to(carry.obs.device)
            pick = lambda x: x.index_select(0, idx)
            before = {k: pick(getattr(carry.env_state, k)) for k in STATE}
            before.update(obs=pick(carry.obs), last_hid=pick(carry.last_hid))
            new, trans, stats = fn(carry, draws)
            means, hid = self._policy_out
            after = {k: pick(getattr(new.env_state, k)) for k in STATE}
            step = {"before": before, "after": after, "obs_after": pick(new.obs),
                    "means": pick(means), "hid": pick(hid),
                    "action": pick(trans.action), "log_prob": pick(trans.log_prob_a),
                    "reward": pick(trans.reward)[:, 0], "done": pick(trans.done)}
            self.chunks[-1]["steps"].append(self._take(
                lambda: torch.utils._pytree.tree_map(_host, step)))
            return new, trans, stats
        return run

    def _update(self, fn):
        def run(algo, batch, which, shard, generator, loss_draws):
            if not self._active():
                return fn(algo, batch, which, shard, generator, loss_draws)
            # where the epochs share one window (the whole ring, every lane)
            # it is taken once a chunk, else each epoch's sample is
            if not (self.fixed_batch and self._batch_taken):
                self.batches.append(self._take(
                    lambda: {k: _host(getattr(batch, k)).float() for k in self.alg.BATCH}))
                self._batch_taken = True
            out = fn(algo, batch, which, shard, generator, loss_draws)
            self.chunks[-1]["updates"].append(
                {"which": which, "batch": len(self.batches) - 1,
                 "loss": self._take(lambda: self.alg.update_loss(out, which))})
            if which not in self.first_nu:
                nu = self.alg.opt_state(algo, which)
                self.first_nu[which] = self._take(lambda: {k: _host(v) for k, v in nu.items()})
            return out
        return run

    @contextlib.contextmanager
    def installed(self, trainer):
        with tracing.installed([(trainer, "_train_chunk", self._chunk),
                                (trainer, "_rollout_step", self._rollout),
                                (trainer, "_update_step", self._update),
                                (trainer.model, "get_actions", self._actions)]):
            yield self


def for_cell(runner, cell, lanes):
    """The recorder of a training cell's check: its sampled ``lanes``, its
    chunk count from the cell's file; a batch taken once a chunk where the
    epochs share one window."""
    return TrainRecorder(runner.alg, lanes, cell["check"]["check"]["chunks"], runner.sync,
                         runner.fixed_batch)
