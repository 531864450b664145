"""The voltage-control environment of the plain reference: reactive-power
commands from actions, the power flow, the barrier reward and the
zone-masked observations, as the configuration's ``env`` entry states them
(MAPDN's var_voltage_control: distributed mode, one PV inverter an agent).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import powerflow


def bowl(v, v_ref=1.0, scale=0.1):
    """MAPDN's bowl barrier: 2|v - v_ref| - 0.095 outside the 0.05 band,
    an inverted Gaussian inside."""
    dev = torch.abs(v - v_ref)
    normal = torch.exp(-0.5 * (v - v_ref) ** 2 / scale ** 2) / math.sqrt(2 * math.pi * scale ** 2)
    return torch.where(dev > 0.05, 2.0 * dev - 0.095, -0.01 * normal + 0.04)


BARRIERS = {"bowl": bowl, "l1": lambda v: torch.abs(v - 1.0)}


class Env:
    """One grid and its series on ``device`` in ``dtype`` (float64 for the
    reference, float32 for its control)."""

    def __init__(self, grid, series, env_cfg, dtype=torch.float64, device="cpu"):
        if env_cfg["mode"] != "distributed":
            raise ValueError("the reference implements the distributed mode")
        self.cfg = env_cfg
        self.grid, self.series = grid, series
        self.dtype, self.device = dtype, torch.device(device)
        cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
        self.ybus = torch.complex(t(grid.g), t(grid.b)).to(cdt)
        n = grid.n_bus
        self.load_inc = t(np.eye(n)[:, grid.load_bus])
        self.sgen_inc = t(np.eye(n)[:, grid.sgen_bus])
        groups = [np.nonzero(grid.bus_zone == z)[0] for z in grid.sgen_zone]
        width = max(len(g) for g in groups)
        idx = np.zeros((len(groups), width), np.int64)
        mask = np.zeros((len(groups), width))
        for i, g in enumerate(groups):
            idx[i, :len(g)], mask[i, :len(g)] = g, 1.0
        self.zone_idx = torch.as_tensor(idx, device=device)
        self.zone_mask = t(mask)
        self.pv, self.load_p, self.load_q = t(series.pv), t(series.load_p), t(series.load_q)
        self.pv_std, self.load_p_std, self.load_q_std = (
            t(series.pv_std), t(series.load_p_std), t(series.load_q_std))
        self.s_max = t(series.s_max)
        self.low = env_cfg["action_bias"] - env_cfg["action_scale"]
        self.high = env_cfg["action_bias"] + env_cfg["action_scale"]
        self.barrier = BARRIERS[env_cfg["voltage_barrier_type"]]
        self.steps_per_day = 24 * 60 // series.time_delta

    def data_at(self, t):
        t = torch.clamp(torch.as_tensor(t, device=self.device).long(), 0, self.pv.shape[0] - 1)
        return self.pv[t], self.load_p[t], self.load_q[t]

    def translate(self, a):
        """Network outputs in [-1, 1] -> inverter set points in [low, high]."""
        a = torch.clamp(a, -1.0, 1.0)
        return 0.5 * (a + 1.0) * (self.high - self.low) + self.low

    def q_command(self, setpoint, pv_p):
        """q = a sqrt(s_max^2 - p^2) [Mvar]."""
        return torch.sqrt(torch.clamp(self.s_max ** 2 - pv_p ** 2, min=0.0)) * setpoint

    def solve(self, load_p, load_q, pv_p, sgen_q):
        """(vm, va, converged, p_bus, q_bus) of device powers."""
        sn = 1.0
        p = (pv_p @ self.sgen_inc.T - load_p @ self.load_inc.T) / sn
        q = (sgen_q @ self.sgen_inc.T - load_q @ self.load_inc.T) / sn
        vm, va, ok = powerflow.solve(self.ybus, p, q, self.grid.slack_vm,
                                     tol=1e-10 if self.dtype == torch.float64 else 1e-5)
        p_bus, q_bus = powerflow.bus_powers(self.ybus, vm, va)
        return vm, va, ok, p_bus, q_bus

    def reward(self, vm, sgen_q):
        """-(q_weight mean|q| + voltage_weight mean barrier(vm))."""
        cfg = self.cfg
        return -(torch.mean(torch.abs(sgen_q), -1) * cfg["q_weight"]
                 + torch.mean(self.barrier(vm), -1) * cfg["voltage_weight"])

    def obs(self, p_bus, q_bus, pv_p, sgen_q, vm, va):
        """(B, n_agents, obs) in the order of ``state_space``: each agent sees
        its zone's buses (padded with zeros), bus powers with the PV
        injections added back, angles in radians."""
        take = lambda x: x[:, self.zone_idx] * self.zone_mask
        p_obs = p_bus + pv_p @ self.sgen_inc.T
        q_obs = q_bus + sgen_q @ self.sgen_inc.T
        parts = {"pv": [pv_p[:, :, None]], "demand": [take(p_obs), take(q_obs)],
                 "reactive": [sgen_q[:, :, None]], "vm_pu": [take(vm)],
                 "va_degree": [take(va)]}
        return torch.cat([x for c in self.cfg["state_space"] for x in parts[c]], -1)

    def noise_z(self, t, pv_p, load_p, load_q):
        """The data noise of pending powers at rows ``t`` in units of its
        scale (the configuration's perturbation is scale x |N(0, 1)|)."""
        pv, lp, lq = self.data_at(t)
        return torch.cat([(pv_p - pv) / self.pv_std, (load_p - lp) / self.load_p_std,
                          (load_q - lq) / self.load_q_std], -1)


def run_days(env, policy_step, starts, a0, max_steps):
    """Greedy closed-loop days, one lane a day, no data noise: reset at
    ``starts`` (B,) rows with the set points ``a0`` (B, n_sgen), then steps
    until the episode limit.  ``policy_step(obs, hid) -> (means, hid)``.
    Returns per-step (B, ...) records: vm, sgen_q, p_bus, q_bus, reward
    (the reset state first in the state records) and each lane's
    convergence."""
    hist = env.cfg.get("history", 1)
    t = torch.as_tensor(starts, device=env.device).long() + hist
    pv, lp, lq = env.data_at(t)
    sgen_q = env.q_command(a0.to(env.dtype), pv)
    vm, va, ok, p_bus, q_bus = env.solve(lp, lq, pv, sgen_q)
    rec = {"vm": [vm], "sgen_q": [sgen_q], "p_bus": [p_bus], "q_bus": [q_bus],
           "reward": []}
    obs = env.obs(p_bus, q_bus, pv, sgen_q, vm, va)
    hid = None
    all_ok = ok
    for step in range(1, max_steps):
        means, hid = policy_step(obs, hid)
        sgen_q = env.q_command(env.translate(torch.tanh(means)[..., 0]), pv)
        vm, va, ok, p_bus, q_bus = env.solve(lp, lq, pv, sgen_q)
        all_ok = all_ok & ok
        rec["reward"].append(env.reward(vm, sgen_q))
        t = t + 1
        pv, lp, lq = env.data_at(t)
        for k, x in (("vm", vm), ("sgen_q", sgen_q), ("p_bus", p_bus), ("q_bus", q_bus)):
            rec[k].append(x)
        obs = env.obs(p_bus, q_bus, pv, sgen_q, vm, va)
        if step + 1 >= env.cfg["episode_limit"]:
            break
    out = {k: torch.stack(v, 1) for k, v in rec.items()}
    out["converged"] = all_ok
    return out
