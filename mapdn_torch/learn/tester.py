"""PGTester: evaluation of a trained policy (PyTorch port of
mapdn_tpu/learn/tester.py; reference utilities/tester.py).

* ``run(day, hour, quarter)``: one fixed day, no noise, the grid telemetry
  of every visited state (reference tester.py:19-63);
* ``run_days(days, ...)``: many fixed days at once, one lane a day, each
  day's mean over its alive steps;
* ``batch_run(num_episodes)``: random episodes, every info metric's flat
  mean and 2 std over all alive steps of all episodes (reference
  tester.py:65-99).

Each is a plain loop over steps on the env's device, greedy actions
(``status="test"``), no data noise.  Random draws come from generators
seeded as the JAX package's keys are (``run`` and ``run_days``: the
reset action from seed 0; ``batch_run``: seed 1), or from explicit
``a0`` / ``draws`` (the parity tests replay the JAX draws).
"""
from __future__ import annotations

import collections
from typing import Dict

import torch

from mapdn_torch.utils import profiling


class PGTester:
    # record key -> EnvState field
    _SNAP_FIELDS = {
        "pv_active": "pv_p", "pv_reactive": "sgen_q", "bus_active": "p_bus",
        "bus_reactive": "q_bus", "bus_voltage": "vm", "line_loss": "pl_mw"}

    def __init__(self, cfg, model, env, algo_state):
        self.cfg = cfg
        self.model = model
        self.env = env
        self.algo = algo_state
        self.avail = env.avail_actions

    def _act(self, obs, hid):
        with profiling.span("eval.act"):
            _, action_pol, _, _, hid = self.model.get_actions(
                self.algo.policy, obs, hid, status="test", exploration=False,
                avail=self.avail)
            return self.env.translate_actions(action_pol), hid

    @torch.no_grad()
    def run(self, day, hour, quarter, a0=None) -> Dict[str, list]:
        """Single-day replay: one entry per visited state, the reset state
        first, ending at the first terminal state (the reference records,
        then breaks); each entry a numpy array of the lane's values."""
        env = self.env
        state, obs, _ = env.manual_reset(day, hour, quarter, a0=a0)
        hid = self.model.init_hidden(1, obs.dtype)
        snaps = [state]
        for _ in range(self.cfg.max_steps):
            with profiling.span("eval.step"):
                actions, hid = self._act(obs, hid)
                out = env.step(state, actions, add_noise=False)
                state, obs = out.state, out.obs
                snaps.append(state)
                with profiling.span("host.sync"):
                    done = bool(out.terminated[0])
            if done:
                break
        with profiling.span("host.sync"):
            return {k: list(torch.stack([getattr(s, f)[0] for s in snaps]).cpu().numpy())
                    for k, f in self._SNAP_FIELDS.items()}

    @torch.no_grad()
    def run_days(self, days, hour=23, quarter=2, a0=None) -> Dict[str, list]:
        """Greedy replay of many fixed days at once, each day a lane, all
        from one reset action.  Returns {metric: [per-day mean over that
        day's alive steps]} for every info metric and 'reward', and
        'days'."""
        env = self.env
        state, obs, _ = env.manual_reset(torch.as_tensor(list(days)), hour, quarter, a0=a0)
        n = obs.shape[0]
        hid = self.model.init_hidden(n, obs.dtype)
        alive = torch.ones(n, dtype=obs.dtype, device=obs.device)
        n_alive = torch.zeros_like(alive)
        sums = collections.defaultdict(lambda: torch.zeros_like(alive))
        for _ in range(self.cfg.max_steps):
            with profiling.span("eval.step"):
                actions, hid = self._act(obs, hid)
                out = env.step(state, actions, add_noise=False)
                for k, v in out.info.items():
                    sums[k] += v * alive
                sums["reward"] += out.reward * alive
                n_alive += alive
                alive = alive * (1.0 - out.terminated.to(alive.dtype))
                state, obs = out.state, out.obs
        ep_len = torch.clamp(n_alive, min=1.0)
        with profiling.span("host.sync"):
            result = {k: [float(x) for x in (v / ep_len).cpu()] for k, v in sums.items()}
        result["days"] = [int(d) for d in days]
        return result

    @torch.no_grad()
    def batch_run(self, num_episodes=100, draws=None) -> Dict[str, tuple]:
        """{"mean_test_" + metric: (mean, 2 std)} over every alive step of
        ``num_episodes`` random episodes, one lane each: the reference
        appends each step's info value to one flat list and takes the mean
        and std of all samples (tester.py:84-97), an alive-step-weighted
        mean, unlike the trainer's eval, which averages per-episode means.
        ``draws``: the env reset's explicit draws (``{"reset": ...}``)."""
        env = self.env
        generator = torch.Generator(device=env.device).manual_seed(1)
        state, obs, _ = env.reset(num_episodes, generator, draws=(draws or {}).get("reset"))
        hid = self.model.init_hidden(num_episodes, obs.dtype)
        alive = torch.ones(num_episodes, dtype=obs.dtype, device=obs.device)
        count = torch.zeros((), dtype=obs.dtype, device=obs.device)
        s1 = collections.defaultdict(lambda: torch.zeros_like(count))
        s2 = collections.defaultdict(lambda: torch.zeros_like(count))
        for _ in range(self.cfg.max_steps):
            with profiling.span("eval.step"):
                actions, hid = self._act(obs, hid)
                out = env.step(state, actions, add_noise=False)
                for k, v in out.info.items():
                    s1[k] += torch.sum(v * alive)
                    s2[k] += torch.sum(v * v * alive)
                count += torch.sum(alive)
                alive = alive * (1.0 - out.terminated.to(alive.dtype))
                state, obs = out.state, out.obs
        count = torch.clamp(count, min=1.0)
        result = {}
        with profiling.span("host.sync"):
            for k in s1:
                mean = s1[k] / count
                var = torch.clamp(s2[k] / count - mean * mean, min=0.0)
                result["mean_test_" + k] = (float(mean), float(2.0 * torch.sqrt(var)))
        return result
