"""Evaluation traffic: a ``PGTester`` built as
``mapdn_torch.test.build_tester`` builds it (480-step days, greedy, no data
noise), weights drawn from the seed, then ``PGTester.run(day, hour,
quarter, a0)`` back to back over days, hours, quarters and reset set
points drawn from the seed.

What decides ``correct``: every day the window completed (or, where the
cell's file gives a number of ``days``, a sample of that many drawn from
the seed) is replayed by the reference, closed loop, from the same start
and reset set points, all days as lanes of one batch: each step's bus
voltages, reactive powers and reward, by the widest gap.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from perfbench import check, tracing, traffic, weights
from perfbench.reference import env as ref_env


class Runner:
    kind = "eval"

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.sync = traffic.sync_of(self.device)
        self.alg = traffic.alg_of(cell)
        self.rng = np.random.default_rng(seed)

    def setup(self):
        from mapdn_torch import test
        config = self.cell["config"]
        args = test.parse_args(traffic.flags(config, ["--test-mode", "single", "--save-path",
                                                      "build/perfbench_no_model"], self.device))
        tester, _, loaded = test.build_tester(args)
        if loaded:
            raise RuntimeError("the eval cell draws its weights; found a model.pt")
        traffic.check_config(tester.cfg, config, {})
        env = tester.env
        self.dims = {"obs": env.obs_size, "agents": env.n_agents,
                     "hid": tester.cfg.hid_size, "act": env.n_actions}
        self.weights = weights.make(self.alg.leaves(self.dims), self.seed, self.device)
        self.alg.load_weights(tester.algo, self.weights)
        self.tester = tester
        self.max_start_day = env.max_start_day
        self.days = []
        self._run_day(self._draw_day())     # warm-up day
        self.sync()

    def first_steps(self, rng):
        return 0.0

    def _draw_day(self):
        env = self.tester.env
        low, high = env.action_low, env.action_high
        return {"day": int(self.rng.integers(self.max_start_day)),
                "hour": int(self.rng.integers(24)),
                "quarter": int(self.rng.integers(env.steps_per_hour)),
                "a0": (self.rng.random(env.grid.n_sgen) * (high - low) + low).tolist()}

    def _run_day(self, day):
        a0 = torch.tensor(day["a0"], dtype=self.tester.env.dtype)
        return self.tester.run(day["day"], day["hour"], day["quarter"], a0=a0)

    def _play(self):
        """One drawn day, kept with its record and rewards for the check;
        returns its step times (each from the step's policy call to the
        next one's, the last to the day's end)."""
        tester, env = self.tester, self.tester.env
        stamps, rewards = [], []
        act, step = tester._act, env.step

        def timed_act(*a, **kw):
            stamps.append(time.perf_counter())
            return act(*a, **kw)

        def kept_step(*a, **kw):
            out = step(*a, **kw)
            rewards.append(out.reward)
            return out

        day = self._draw_day()
        with tracing.installed([(tester, "_act", lambda fn: timed_act),
                                (env, "step", lambda fn: kept_step)]):
            rec = self._run_day(day)
        marks = stamps + [time.perf_counter()]
        self.days.append(dict(day, record=rec, rewards=rewards))
        finite = all(np.isfinite(x).all() for v in rec.values() for x in v)
        return [b - a for a, b in zip(marks[:-1], marks[1:])], finite

    def window(self, seconds):
        step_s, bad, n = [], 0, 0
        self.sync()
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            times, finite = self._play()
            step_s += times
            bad += not finite
            n += 1
        dt = time.perf_counter() - t0
        return {"metrics": {"eval_steps_per_s": len(step_s) / dt,
                            "eval_step_p95_ms": float(np.percentile(step_s, 95)) * 1e3},
                "attempted": n, "failed": bad, "seconds": dt}

    def trace(self, seconds, peaks):
        tester, env = self.tester, self.tester.env
        config = self.cell["config"]
        grid_counts = check.grid_counts(config, config["pf_inner_iters"])
        rec = {"kind": "eval", "lanes": 1, "attempted": 2}
        spans = tracing.SyncSpans(self.sync)
        with tracing.installed([(env, "_solver", spans.wrap("pf_solve"))]):
            self._play()
        rec["spans"] = {k: {"seconds": spans.seconds[k], "calls": spans.calls[k]}
                        for k in spans.seconds}
        solves = tracing.SolveLog()
        labels = [(tester, "_act", tracing.label("eval.policy")),
                  (env, "step", tracing.label("eval.env_step")),
                  (env, "_solver", lambda fn: tracing.label("eval.pf_solve")(solves.wrap(fn)))]
        with tracing.installed(labels), tracing.profiled(self.sync) as held:
            times, _ = self._play()
        rec["profile"] = tracing.summarize(held.prof, kernels=("nr_small", "nr_large"))
        rec["profile"]["env_steps"] = len(times)
        rec["roofline"] = traffic.roofline(solves.counts(), rec["profile"]["kernels"],
                                           grid_counts, peaks, self.cell["config"]["kernel"])
        return rec

    def keep(self):
        pass

    def release(self):
        self.tester = None

    # ----------------------------------------------------------------- check
    def checked_days(self, rng):
        want = self.cell["check"]["check"]["days"]
        if want == "all" or want >= len(self.days):
            return list(self.days)
        return [self.days[i] for i in sorted(rng.choice(len(self.days), want, replace=False))]

    def _replay(self, days, dtype, tf32, device):
        config, mix = self.cell["config"], self.cell["traffic"]
        with check.precision(tf32):
            envr = check.reference_env(config, dtype, device, episode_limit=mix["episode_limit"])
            p = {k: v.to(device, dtype) for k, v in self.weights["policy"].items()}
            spd, sph = envr.steps_per_day, 60 // envr.series.time_delta
            starts = [d["quarter"] + d["hour"] * sph + d["day"] * spd for d in days]
            a0 = torch.tensor([d["a0"] for d in days], dtype=dtype, device=device)
            out = ref_env.run_days(envr, lambda o, h: self.alg.policy(p, o, h), starts, a0,
                                   mix["episode_limit"])
        return {k: v.cpu() for k, v in out.items()}

    @staticmethod
    def _program(days):
        stack = lambda rows: torch.as_tensor(np.stack(rows))
        return {"vm": torch.stack([stack(d["record"]["bus_voltage"]) for d in days]),
                "sgen_q": torch.stack([stack(d["record"]["pv_reactive"]) for d in days]),
                "reward": torch.stack([torch.stack([r.reshape(()) for r in d["rewards"]]).cpu()
                                       for d in days])}

    @staticmethod
    def numbers(cand, ref, per_day=False):
        """The widest gaps over the days, or (``per_day``) a list a day."""
        if cand["vm"].shape != ref["vm"].shape or cand["reward"].shape != ref["reward"].shape:
            return {k: [math.inf] if per_day else math.inf for k in ("vm", "q", "reward")}
        gap = lambda a, b: (a.double() - b.double()).abs().flatten(1).max(1).values
        out = {"vm": gap(cand["vm"], ref["vm"]), "q": gap(cand["sgen_q"], ref["sgen_q"]),
               "reward": gap(cand["reward"], ref["reward"])}
        return {k: (v.tolist() if per_day else float(v.max())) for k, v in out.items()}

    def check(self, device, rng, control=False, per_day=False):
        days = self.checked_days(rng)
        ref = self._replay(days, *check.REFERENCE, device)
        cand = (self._replay(days, *check.CONTROL, device) if control
                else self._program(days))
        return self.numbers(cand, ref, per_day)

    # ---------------------------------------------------------------- faults
    def fault(self, name):
        """``solver`` (perfbench/traffic.py), or ``frozen_step``: the env step
        returns its state unchanged."""
        if name == "solver":
            return traffic.solver_fault(self.tester.env)
        if name == "frozen_step":
            return frozen_step(self.tester.env)
        raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def frozen_step(env):
    def frozen(fn):
        def run(state, *args, **kwargs):
            out = fn(state, *args, **kwargs)
            out.state = state
            return out
        return run
    with tracing.installed([(env, "step", frozen)]):
        yield
