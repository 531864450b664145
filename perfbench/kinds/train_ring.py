"""Training traffic on an off-policy ring: the training kind
(perfbench/kinds/train.py), whose runner this one extends, for an
algorithm that keeps its ring across chunks and samples each update step's
window from it (``replay.window_start``, a host read, then a gather), with
target networks that a soft update moves.

What decides ``correct``, besides the training kind's env step and policy
numbers on the set-up chunks (which run through ``run_episode`` with the
recorder installed, as there):

* The set-up chunks' update, followed by the reference from the drawn
  weights through every update step on the windows the program sampled,
  and through the soft update after the last followed chunk (the cell's
  file follows at least the chunks up to the first ``target_update_freq``
  boundary): the critic's Q on the first window (``value``), each
  optimizer's first loss and gradient, the behaviour networks' change
  (``change``) and the targets' (``target``).
* The window's last chunk.  The window starts the program's own
  ``window_start`` returns are kept as it returns them (host integers it
  reads anyway: no synchronize, no copy), beside the chunk snapshots of
  the training kind, which here hold the target networks too.  After the
  window, from the ring as the last chunk left it, its sampled windows
  are gathered; the reference follows that chunk's update steps from the
  state before it, and its soft update where the chunk crossed a
  boundary, in blocks of rows on the run's device in float64: the mean
  losses (``w_loss``), the behaviour networks' change (``w_change``), the
  targets' (``w_target``); and on the chunk's newest ring rows of the
  sampled lanes, the policy's next hidden state (``w_hid``).
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from perfbench import check, record, spec, tracing

_train = spec.kind("train", os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _host(x):
    return x.detach().to("cpu", copy=True)


class RingSnapshots(_train.ChunkSnapshots):
    """The training kind's snapshot before each chunk, and for the chunk
    that ran last: the env steps before it, the window starts it drew and
    its stats (references to the device's tensors, read after the
    window)."""

    def __init__(self, alg, algo):
        super().__init__(alg, algo)
        self.starts, self.steps_before, self.stats = [], 0, None

    def wrap(self, fn):
        snap = super().wrap(fn)

        def run(carry, draws=None):
            self.starts, self.steps_before = [], carry.steps
            out = snap(carry, draws)
            self.stats = out[1]
            return out
        return run

    def log_starts(self, fn):
        def run(*args, **kwargs):
            start = fn(*args, **kwargs)
            self.starts.append(start)
            return start
        return run


class RingRecorder(record.TrainRecorder):
    """The training kind's recorder, and: the program's critic values on
    the first update's window (kept as that window's ``value``, a field an
    off-policy ring never fills), which followed chunks a soft update
    followed, and the target networks after the soft update that follows
    the last followed chunk."""

    def __init__(self, *args):
        super().__init__(*args)
        self.model = None
        self._ended = None   # the followed chunk that just ended, if any

    def _chunk(self, fn):
        inner = super()._chunk(fn)

        def run(carry, draws=None):
            self._ended = None
            recorded = self._active()
            out = inner(carry, draws)
            if recorded:
                self._ended = len(self.chunks)
            return out
        return run

    def _update(self, fn):
        inner = super()._update(fn)

        def run(algo, batch, which, *rest):
            first = self._active() and not self.batches
            if first:
                with torch.no_grad():
                    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
                    q = self.model.value(algo.value, flat(batch.state), flat(batch.action))
                q = self._take(lambda: _host(q).float())
            out = inner(algo, batch, which, *rest)
            if first:
                self.batches[0]["value"] = q
            return out
        return run

    def _soft(self, fn):
        def run(algo):
            out = fn(algo)
            if self._ended is not None:
                self.chunks[self._ended - 1]["soft_update"] = True
                if self._ended == self.chunks_wanted:
                    params, _ = self.alg.split_state(self.alg.state_tensors(algo))
                    self.params_after.update(self._take(lambda: {
                        net: {k: _host(v) for k, v in params[net].items()}
                        for net in self.alg.TARGETS}))
                self._ended = None
            return out
        return run

    @contextlib.contextmanager
    def installed(self, trainer):
        self.model = trainer.model
        with super().installed(trainer), tracing.installed([(trainer, "_soft_update",
                                                              self._soft)]):
            yield self


class Runner(_train.Runner):
    def setup(self):
        super().setup()
        tr = self.trainer
        if tr.model.on_policy or tr.carry.replay.capacity <= self.cfg.batch_size:
            raise ValueError("the off-policy ring kind needs an off-policy algorithm whose ring "
                             "is longer than its update window")
        self.snaps = RingSnapshots(self.alg, tr.carry.algo)

    def first_steps(self, rng):
        """The training kind's, with the recorder of an off-policy ring."""
        n = min(self.cell["check"]["check"]["lanes"], self.trainer.n_envs)
        self.lanes = np.sort(rng.choice(self.trainer.n_envs, n, replace=False))
        self.rec = RingRecorder(self.alg, self.lanes, self.cell["check"]["check"]["chunks"],
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
        from mapdn_torch.learn import replay
        with tracing.installed([(replay, "window_start", self.snaps.log_starts)]):
            return super()._episodes(seconds)

    def window(self, seconds):
        before = self.trainer.rollout_counts()
        out = super().window(seconds)
        after = self.trainer.rollout_counts()
        delta = {k: {r: after[k][r] - before[k][r] for r in after[k]} for k in after}
        print(f"perfbench: the window's rollout steps: {delta}", file=sys.stderr)
        return out

    # ----------------------------------------------------------------- check
    def keep(self):
        """The training kind's, and from the ring as the last chunk left it:
        the windows its update steps sampled, its newest rows of the sampled
        lanes, and whether a soft update followed it."""
        super().keep()
        tr, cfg, snaps = self.trainer, self.cfg, self.snaps
        replay = tr.carry.replay
        data, cap, b = replay.data, replay.capacity, cfg.batch_size
        oldest = 0 if replay.size < cap else replay.ptr
        steps = lambda first, n: (first + torch.arange(n, device=data.reward.device)) % cap
        windows = [{k: _host(getattr(data, k)[steps(oldest + start, b)]).float()
                    for k in self.alg.BATCH} for start in snaps.starts]
        newest = steps(replay.ptr - tr._chunk_len, tr._chunk_len)
        lanes = torch.as_tensor(self.lanes, device=data.reward.device)
        after = snaps.steps_before + tr._chunk_len
        self.kept.update(
            windows=windows,
            newest={k: _host(getattr(data, k)[newest].index_select(1, lanes))
                    for k in ("state", "last_hid", "hid")},
            soft_update=bool(cfg.target) and (after // cfg.target_update_freq
                                              > snaps.steps_before // cfg.target_update_freq),
            chunk_losses={w: float(snaps.stats[f"mean_train_{w}_loss"])
                          for w in set(self.alg.epochs(self.alg_cfg))})

    def _ring_side(self, dtype, tf32, device):
        """The reference's (or the control's) readings of the kept chunk."""
        alg, kept = self.alg, self.kept
        params, opt = alg.split_state(kept["before"])
        updates = [{"which": w, "batch": i} for i, w in enumerate(alg.epochs(self.alg_cfg))]
        if len(updates) != len(kept["windows"]):
            raise RuntimeError(f"the last chunk drew {len(kept['windows'])} windows for "
                               f"{len(updates)} update steps")
        d = lambda x: x.to(device, dtype)
        newest = kept["newest"]
        rows = lambda x: d(x).flatten(0, 1)
        with check.precision(tf32):
            ref = alg.follow({net: params[net] for net in alg.NETS},
                             [{"updates": updates, "soft_update": kept["soft_update"]}],
                             kept["windows"], self.alg_cfg, dtype, device, nu0=opt,
                             targets0=alg.targets_of(params))
            with torch.no_grad():
                pp = {k: d(v) for k, v in params["policy"].items()}
                _, hid = alg.policy(pp, rows(newest["state"]), rows(newest["last_hid"]))
        return {"after": ref["after"], "mean_losses": ref["mean_losses"],
                "first_grads": ref["first_grads"], "hid": hid.reshape(newest["hid"].shape).cpu()}

    def _ring_numbers(self, device, control):
        alg, kept = self.alg, self.kept
        ref = self._ring_side(*check.REFERENCE, device)
        if control:
            cand = self._ring_side(*check.CONTROL, device)
        else:
            cand = {"after": alg.split_state(kept["after"])[0],
                    "mean_losses": kept["chunk_losses"], "hid": kept["newest"]["hid"]}
        start, _ = alg.split_state(kept["before"])
        behaviour = lambda p: {net: p[net] for net in alg.NETS}
        return {"w_loss": alg.loss_gap(cand["mean_losses"], ref["mean_losses"]),
                "w_change": alg.change_gap(behaviour(cand["after"]), behaviour(ref["after"]),
                                           behaviour(start), ref["first_grads"]),
                "w_target": alg.change_gap(alg.targets_of(cand["after"]),
                                           alg.targets_of(ref["after"]), alg.targets_of(start),
                                           ref["first_grads"]),
                "w_hid": check.max_gap(cand["hid"], ref["hid"])}

    def check(self, device, rng, control=False):
        nums = super().check(device, rng, control)
        if self.kept is not None:
            nums.update(self._ring_numbers(device, control))
        return nums
