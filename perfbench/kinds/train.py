"""Training traffic: ``mapdn_torch.train.build_trainer`` on the
configuration's flags, ``lanes`` env lanes and the mix's algorithm
overrides, weights drawn from the seed, then ``PGTrainer.run_episode`` back
to back: whole chunks, each ``lanes`` x ``chunk_len`` env steps.  Every
draw of the trainer (episode starts, data noise, exploration, update
samples) comes from its generator, seeded with the run's seed.  The
algorithm is read through its file in perfbench/algs/, named by the
configuration's ``--alg``.

What decides ``correct``, in float64 against the plain reference:

* The chunks the check follows run in set-up, through ``run_episode``,
  with the recorder installed (perfbench/record.py): on (chunk, step,
  lane) pairs drawn from the seed, the env step (from the program's state
  before the step and its action, the reference's solve, voltages, reward
  and next observation; a lane that terminated: the fresh episode's), the
  data noise of every pending power within [0, 8] of its scale and the
  step counters exact; the policy's means, hidden state and log-prob; and
  the update, followed by the reference from the drawn weights through
  every update step on the batches the program sampled: the first
  chunk's ring values, each optimizer's first loss and first gradient,
  the parameters' change after the last followed chunk.
* The window's last chunk: before every chunk of the window the
  algorithm's parameters and optimizer state are copied on the device
  into buffers made once (no synchronize, no host copy; the chunk itself
  runs untouched).  After the window, from the ring the last chunk left
  (its newest ``capacity`` steps) and the state it started from, the
  reference gives the ring's values (``w_value``); where the ring holds
  the observations and hidden states at the compute precision, the
  log-prob of each stored action (``w_logp``) and each next hidden state
  (``w_hid``) on the sampled lanes; and where the update's batch is the
  whole ring (every lane, one window), the update phase followed from the
  program's parameters and optimizer state before the chunk: the mean
  losses (``w_loss``) and the parameters' change (``w_change``).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import check, counting, record, tracing, traffic, weights

GIB = traffic.GIB


class ChunkSnapshots:
    """Before each chunk: the algorithm's state copied on the device into
    buffers made once."""

    def __init__(self, alg, algo):
        src = alg.state_tensors(algo)
        self.alg, self.keys = alg, list(src)
        self.buf = [torch.empty_like(v) for v in src.values()]
        self.taken = 0

    def wrap(self, fn):
        def run(carry, draws=None):
            torch._foreach_copy_(self.buf, list(self.alg.state_tensors(carry.algo).values()))
            self.taken += 1
            return fn(carry, draws)
        return run

    def host(self):
        return {k: v.detach().to("cpu", copy=True) for k, v in zip(self.keys, self.buf)}


class Runner:
    kind = "train"

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.sync = traffic.sync_of(self.device)
        self.alg = traffic.alg_of(cell)
        self.rec = self.kept = self.last_stats = None

    # ---------------------------------------------------------------- set-up
    def setup(self):
        from mapdn_torch import train
        config, mix = self.cell["config"], self.cell["traffic"]
        extra = ["--n-envs", str(mix["lanes"])]
        if "max_steps" in mix:
            extra += ["--max-steps", str(mix["max_steps"])]
        args = train.parse_args(traffic.flags(config, extra, self.device))
        cfg, _, trainer = train.build_trainer(args, device=self.device,
                                              config=mix.get("overrides", {}))
        traffic.check_config(cfg, config, mix.get("overrides", {}))
        trainer.setup(seed=self.seed)
        env = trainer.env
        self.dims = {"obs": env.obs_size, "agents": env.n_agents,
                     "hid": cfg.hid_size, "act": env.n_actions}
        self.weights = weights.make(self.alg.leaves(self.dims), self.seed, self.device)
        self.alg.load_weights(trainer.carry.algo, self.weights)
        self.trainer, self.cfg = trainer, cfg
        self.alg_cfg = {**config["model"], **config["alg"], **mix.get("overrides", {})}
        self.steps_per_episode = trainer._chunk_len * trainer._chunks_per_episode
        subsample = cfg.update_lanes is not None and cfg.update_lanes < trainer.n_envs
        capacity = trainer.carry.replay.capacity
        self.fixed_batch = capacity == cfg.batch_size and not subsample
        # the update phase of a chunk that refilled an emptied ring from its
        # first row, on the whole ring, is one the reference can follow
        self.window_followed = (self.fixed_batch and trainer.model.on_policy
                                and trainer._chunk_len >= capacity)
        # an on-policy ring, emptied after each update, holds the last
        # chunk's newest steps from its first row
        self.window_rows = min(trainer._chunk_len, capacity) if trainer.model.on_policy else 0
        self.snaps = ChunkSnapshots(self.alg, trainer.carry.algo)

    def first_steps(self, rng):
        """Drive the trainer through the window's own call until the
        recorder has the chunks it follows; returns the seconds spent
        copying what it recorded."""
        n = min(self.cell["check"]["check"]["lanes"], self.trainer.n_envs)
        self.lanes = np.sort(rng.choice(self.trainer.n_envs, n, replace=False))
        self.rec = record.for_cell(self, self.cell, self.lanes)
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

    # ---------------------------------------------------------------- window
    def _episodes(self, seconds):
        """run_episode back to back, at least once, until ``seconds`` have
        passed; returns (episodes, episodes with a non-finite stat,
        seconds)."""
        n = bad = 0
        self.sync()
        t0 = time.perf_counter()
        with tracing.installed([(self.trainer, "_train_chunk", self.snaps.wrap)]):
            while n == 0 or time.perf_counter() - t0 < seconds:
                stats = self.trainer.run_episode()
                n += 1
                bad += not all(math.isfinite(v) for v in stats.values())
        self.sync()
        self.last_stats = stats
        return n, bad, time.perf_counter() - t0

    def window(self, seconds):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        n, bad, dt = self._episodes(seconds)
        lanes, chunks = self.trainer.n_envs, self.trainer._chunks_per_episode
        out = {"train_env_steps_per_s": lanes * self.steps_per_episode * n / dt}
        if self.device.type == "cuda":
            out["train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / GIB
        return {"metrics": out, "attempted": n * chunks, "failed": bad * chunks,
                "seconds": dt}

    # ----------------------------------------------------------------- trace
    def chunk_flops(self):
        tr, cfg = self.trainer, self.cfg
        rows = cfg.batch_size * min(cfg.update_lanes or tr.n_envs, tr.n_envs)
        return self.alg.chunk_flops(self.dims, tr.n_envs, tr._chunk_len,
                                    tr.carry.replay.capacity, rows, self.alg_cfg)

    def trace(self, seconds, peaks):
        """An uninstrumented stretch (MFU), a stretch of synchronize-closed
        spans, then one episode under the profiler."""
        tr, env, model = self.trainer, self.trainer.env, self.trainer.model
        config = self.cell["config"]
        grid_counts = check.grid_counts(config, config["pf_inner_iters"])
        rec = {"kind": "train", "lanes": tr.n_envs}
        episodes0 = tr.episodes
        solves = tracing.SolveLog()
        with tracing.installed([(env, "_solver", solves.wrap)]):
            n, _, dt = self._episodes(seconds / 3)
        chunks = n * tr._chunks_per_episode
        nr = sum(counting.nr_flops(it, *grid_counts) for it in solves.counts())
        rec["stretch"] = {"seconds": dt, "chunks": chunks,
                          "flops": chunks * self.chunk_flops() + nr}

        spans = tracing.SyncSpans(self.sync)
        with tracing.installed([(tr, "_rollout_step", spans.wrap("rollout")),
                                (tr, "_update_phase", spans.wrap("update")),
                                (env, "_solver", spans.wrap("pf_solve"))]):
            self._episodes(0)
        rec["spans"] = {k: {"seconds": spans.seconds[k], "calls": spans.calls[k]}
                        for k in spans.seconds}

        solves = tracing.SolveLog()
        labels = [(tr, "_update_phase", tracing.label("update")),
                  (tr, "_fill_ring_values", tracing.label("value_fill")),
                  (env, "batched_auto_reset_step", tracing.label("rollout.env_step")),
                  (env, "_solver", lambda fn: tracing.label("rollout.pf_solve")(solves.wrap(fn))),
                  (model, "get_actions", tracing.label("rollout.policy"))]
        with tracing.installed(labels), tracing.profiled(self.sync) as held:
            self._episodes(0)
        rec["profile"] = tracing.summarize(held.prof, kernels=("nr_small", "nr_large"))
        rec["profile"]["env_steps"] = self.steps_per_episode
        rec["roofline"] = traffic.roofline(solves.counts(), rec["profile"]["kernels"],
                                           grid_counts, peaks, self.cell["config"]["kernel"])
        rec["attempted"] = (tr.episodes - episodes0) * tr._chunks_per_episode
        return rec

    # ----------------------------------------------------------------- check
    def keep(self):
        """The window's last chunk, on the host: the state it started from,
        the state after it, its ring (the sampled lanes; every lane where
        the update is followed) and the last episode's stats."""
        tr = self.trainer
        data = tr.carry.replay.data
        idx = torch.as_tensor(self.lanes, device=data.reward.device)
        host = lambda x: x.detach().to("cpu", copy=True)
        self.kept = {
            "before": self.snaps.host(),
            "after": {k: host(v) for k, v in self.alg.state_tensors(tr.carry.algo).items()},
            "ring": {k: host(getattr(data, k)[:self.window_rows].index_select(1, idx))
                     for k in self.alg.BATCH},
            "ring_exact": data.state.dtype == tr.env.dtype,
            "batch": ({k: host(getattr(data, k)).float() for k in self.alg.BATCH}
                      if self.window_followed else None),
            "stats": self.last_stats,
            "episode_chunks": tr._chunks_per_episode}

    def release(self):
        self.trainer = None
        self.snaps = None

    def _window_side(self, dtype, tf32, device):
        """The reference's readings of the kept chunk at a precision."""
        alg, a, kept = self.alg, self.alg_cfg, self.kept
        params, opt = alg.split_state(kept["before"])
        ring = kept["ring"]
        d = lambda x: x.to(device, dtype)
        t, l, n = ring["value"].shape
        rows = lambda x: d(x).reshape((t * l,) + tuple(x.shape[2:]))
        out = {}
        with check.precision(tf32), torch.no_grad():
            pv = {k: d(v) for k, v in params["value"].items()}
            out["value"] = alg.critic(pv, rows(ring["state"])).reshape(t, l, n).cpu()
            if kept["ring_exact"]:
                pp = {k: d(v) for k, v in params["policy"].items()}
                means, hid = alg.policy(pp, rows(ring["state"]), rows(ring["last_hid"]))
                out["logp"] = alg.log_prob(rows(ring["action"]), means, a).reshape(t, l, n).cpu()
                hid = hid.reshape(t, l, n, -1).cpu()
                done = ring["done"][:-1, :, None, None] > 0
                out["hid_next"] = torch.where(done, torch.zeros_like(hid[:-1]), hid[:-1])
        if kept["batch"] is not None:
            updates = [{"which": w, "batch": 0} for w in alg.epochs(a)]
            with check.precision(tf32):
                ref = alg.follow(params, [{"updates": updates}], [kept["batch"]], a,
                                 dtype, device, nu0=opt)
            out.update(after=ref["after"], mean_losses=ref["mean_losses"],
                       first_grads=ref["first_grads"])
        return out

    def _window_program(self):
        kept, ring = self.kept, self.kept["ring"]
        out = {"value": ring["value"]}
        if kept["ring_exact"]:
            out["logp"] = ring["log_prob_a"].sum(-1)
            out["hid_next"] = ring["last_hid"][1:]
        if kept["batch"] is not None:
            out["after"], _ = self.alg.split_state(kept["after"])
            out["mean_losses"] = {w: self.alg.update_loss(kept["stats"], w)
                                  for w in set(self.alg.epochs(self.alg_cfg))}
        return out

    def _window_numbers(self, cand, ref):
        kept = self.kept
        nums = {"w_value": check.rms_rel([cand["value"]], [ref["value"]])}
        if "logp" in ref:
            y = kept["ring"]["action"].double().clamp(-1.0, 1.0)
            squash = (1.0 - y * y).sum(-1)
            nums["w_logp"] = check.max_gap(cand["logp"] * squash, ref["logp"] * squash)
            nums["w_hid"] = check.max_gap(cand["hid_next"], ref["hid_next"])
        if "after" in ref:
            start, _ = self.alg.split_state(kept["before"])
            nums["w_change"] = self.alg.change_gap(cand["after"], ref["after"], start,
                                                   ref["first_grads"])
            if kept["episode_chunks"] == 1:
                nums["w_loss"] = self.alg.loss_gap(cand["mean_losses"], ref["mean_losses"])
        return nums

    def _policy_outputs(self, starts, pairs, dtype, device):
        """Means, new hidden state and the log-prob of the program's action,
        from the parameters each pair's chunk started with."""
        d = lambda x: x.to(device, dtype)
        means, hid, order = [], [], []
        for c, params in enumerate(starts):
            rows = (pairs["chunk"] == c).nonzero()[:, 0]
            if len(rows) == 0:
                continue
            p = {k: d(v) for k, v in params["policy"].items()}
            m, h = self.alg.policy(p, d(pairs["obs"][rows]), d(pairs["last_hid"][rows]))
            means.append(m.cpu())
            hid.append(h.cpu())
            order.append(rows)
        inv = torch.argsort(torch.cat(order))
        means, hid = torch.cat(means)[inv], torch.cat(hid)[inv]
        logp = self.alg.log_prob(pairs["action"], means, self.alg_cfg)
        return {"means": means, "hid": hid, "logp": logp}

    def _side(self, pairs, dtype, tf32, device):
        """The reference's (or the control's) readings of the set-up chunks."""
        w = {net: {k: v.cpu() for k, v in p.items()} for net, p in self.weights.items()}
        with check.precision(tf32):
            envr = check.reference_env(self.cell["config"], dtype, device)
            env_ref = check.env_outputs(envr, pairs)
            ref = self.alg.follow(w, self.rec.chunks, self.rec.batches, self.alg_cfg,
                                  dtype, device)
            ref.update(self._policy_outputs(ref["starts"], pairs, dtype, device))
        return envr, env_ref, ref

    def check(self, device, rng, control=False):
        """{number: reading}: the set-up chunks, then the window's last chunk
        (the module's docstring)."""
        pairs = check.draw_pairs(self.rec.chunks, self.cell["check"]["check"]["pairs"], rng)
        w = {net: {k: v.cpu() for k, v in p.items()} for net, p in self.weights.items()}
        envr, env_ref, ref = self._side(pairs, *check.REFERENCE, device)
        with check.precision(False):
            inv = check.invariants(envr, pairs, self.cell["config"]["env"]["episode_limit"])
        if control:
            _, env_c, cand = self._side(pairs, *check.CONTROL, device)
            done = pairs["done"] > 0
            cand.update(vm=torch.where(done[:, None], env_c["vm_reset"], env_c["vm"]),
                        obs=torch.where(done[:, None, None], env_c["obs_reset"], env_c["obs"]),
                        reward=env_c["reward"])
        else:
            rec = self.rec
            losses = {}
            for u in rec.chunks[0]["updates"]:
                losses.setdefault(u["which"], u["loss"])
            first = rec.batches[rec.chunks[0]["updates"][0]["batch"]]["value"]
            cand = {"vm": pairs["after"]["vm"], "obs": pairs["obs_after"],
                    "reward": pairs["reward"], "means": pairs["means"], "hid": pairs["hid"],
                    "logp": pairs["log_prob"].sum(-1), "losses": losses,
                    "fill": first.reshape(-1, first.shape[-1]),
                    "first_grads": self.alg.program_first_grads(rec.first_nu),
                    "after": rec.params_after}
        nums = check.env_numbers(cand, env_ref, pairs)
        y = pairs["action"].double().clamp(-1.0, 1.0)
        squash = (1.0 - y * y).sum(-1)
        nums.update(mean=check.max_gap(cand["means"], ref["means"]),
                    hid=check.max_gap(cand["hid"], ref["hid"]),
                    # a log-prob read back from a float32 tanh output is known
                    # to (rounding of y) / (1 - y^2): the gap is weighed by it
                    logp=check.max_gap(cand["logp"] * squash, ref["logp"] * squash))
        nums.update(self.alg.update_numbers(cand, ref, w))
        nums.update(inv)
        if self.kept is not None and self.window_rows:
            ref_w = self._window_side(*check.REFERENCE, device)
            cand_w = (self._window_side(*check.CONTROL, device) if control
                      else self._window_program())
            nums.update(self._window_numbers(cand_w, ref_w))
        return nums

    # ---------------------------------------------------------------- faults
    def fault(self, name):
        """A fault planted in the program: the algorithm's (perfbench/algs/),
        or ``solver``: the power flow stops at a 1e-4 mismatch instead of
        1e-7, an answer altered where it is produced."""
        planted = self.alg.fault(name, self)
        if planted is not None:
            return planted
        if name == "solver":
            return traffic.solver_fault(self.trainer.env)
        raise ValueError(f"unknown fault {name!r}")
