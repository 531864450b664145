"""Natively batched active-voltage-control environment (PyTorch).

Port of mapdn_tpu/envs/voltage_control.py (the reference's VoltageControl
class).  Every tensor carries a leading lane dimension, so one call steps
all lanes and makes one batched power-flow solve; there is no vmap.

    reset : n_lanes              -> (EnvState, obs, global_state)
    step  : (EnvState, actions)  -> StepOutput(EnvState', obs, gs, r, done, info)

Semantics are the JAX package's (see its docstring for the reference
citations): q = a sqrt(s_max^2 - p^2); reward -(mean barrier(v) w_v +
q_weight mean|q|) or the line-loss alternative; a diverged solve costs -200,
rolls the grid back and terminates; reset retries unsolvable windows a
bounded number of times; truncated-gaussian data noise std/100; zone-masked
observations; both task modes.

Every random draw comes from the ``generator`` argument (a
``torch.Generator`` on the env's device), unless the caller hands the draw
in explicitly (the parity tests do, with numbers replayed from JAX):

* ``noise``: a tuple of standard normals (pv (L, n_sgen), load_p (L, n_load),
  load_q (L, n_load)); the env adds ``std * |noise|``;
* ``t0``: (L,) episode-window starts; ``a0``: (L, n_sgen) reset actions.

Under a :class:`mapdn_torch.utils.lanes.LaneShard` (a sharded trainer's
rollout) L is the whole lane count, drawn or given, and the env keeps its
rank's lanes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mapdn_torch.envs.barriers import get_barrier
from mapdn_torch.envs.timeseries import TimeSeries
from mapdn_torch.pf.fused_nr import make_solver
from mapdn_torch.utils import lanes, profiling


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (defaults = the reference's
    args/env_args/var_voltage_control.yaml)."""
    mode: str = "distributed"
    voltage_barrier_type: str = "l1"
    voltage_weight: float = 1.0
    q_weight: float = 0.1
    line_weight: Any = None
    v_upper: float = 1.05
    v_lower: float = 0.95
    episode_limit: int = 240
    history: int = 1
    action_scale: float = 0.8
    action_bias: float = 0.0
    reset_action: bool = True
    state_space: Tuple[str, ...] = ("pv", "demand", "reactive", "vm_pu",
                                    "va_degree")
    destroy_penalty: float = 200.0
    pf_tol: float = 1e-7
    pf_max_iter: int = 20
    reset_retries: int = 4
    # power-flow solver (pf.fused_nr.make_solver): 'auto' (as 'kernel') runs
    # the small CUDA kernel for grids of <= 64 buses and the large one
    # above; 'torch' the torch-op solver
    pf_backend: str = "auto"
    # Richardson refinement steps per Newton direction
    pf_inner_iters: int = 3
    # the torch-op solver's fixed iteration count (None: early exit); the
    # kernels ignore it (pf.fused_nr.make_solver)
    pf_fixed_iter: Any = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class EnvState:
    """Per-lane dynamic state; every field has a leading lane dim L."""
    t: torch.Tensor            # (L,) int64 data row backing the current demand
    step: torch.Tensor         # (L,) int64 in-episode step counter (starts at 1)
    load_p: torch.Tensor       # (L, n_load) pending demand P [MW]
    load_q: torch.Tensor       # (L, n_load) pending demand Q [Mvar]
    pv_p: torch.Tensor         # (L, n_sgen) pending PV P [MW]
    sgen_q: torch.Tensor       # (L, n_sgen) last applied PV Q [Mvar]
    vm: torch.Tensor           # (L, n_bus) last solved voltage magnitude [pu]
    va: torch.Tensor           # (L, n_bus) last solved voltage angle [rad]
    p_bus: torch.Tensor        # (L, n_bus) last res-bus P [MW], consumption>0
    q_bus: torch.Tensor        # (L, n_bus) last res-bus Q [Mvar]
    pl_mw: torch.Tensor        # (L, n_branch) last per-branch loss [MW]
    solved_pv_p: torch.Tensor  # (L, n_sgen) PV P used in the last solve
    sum_rewards: torch.Tensor  # (L,) cumulative episode reward
    terminated: torch.Tensor   # (L,) bool
    obs_hist: torch.Tensor     # (L, history-1, n_agents, obs_base)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class StepOutput:
    state: EnvState
    obs: torch.Tensor           # (L, n_agents, obs_dim)
    global_state: torch.Tensor  # (L, state_dim)
    reward: torch.Tensor        # (L,)
    terminated: torch.Tensor    # (L,) bool
    info: Dict[str, torch.Tensor]


def _lane_where(sel, a, b):
    """Per-lane select between two tensors with a leading lane dim."""
    return torch.where(sel.reshape(sel.shape + (1,) * (a.dim() - 1)), a, b)


def select_state(sel, a: EnvState, b: EnvState) -> EnvState:
    """Lane-wise ``a if sel else b`` over every EnvState field."""
    return EnvState(**{f.name: _lane_where(sel, getattr(a, f.name),
                                           getattr(b, f.name))
                       for f in dataclasses.fields(EnvState)})


def _pad_gather_indices(groups):
    """(n_groups, width) gather indices + mask for ragged zone layouts."""
    width = max(len(g) for g in groups)
    idx = np.zeros((len(groups), width), np.int64)
    mask = np.zeros((len(groups), width), np.float64)
    for i, g in enumerate(groups):
        idx[i, : len(g)] = g
        mask[i, : len(g)] = 1.0
    return idx, mask, width


class VoltageControlEnv:
    """Batched env bound to (grid, timeseries, config); the grid, the data
    and every step tensor live on the grid's device."""

    def __init__(self, grid, ts: TimeSeries, cfg: EnvConfig):
        self.grid = grid
        self.ts = ts
        self.cfg = cfg
        self.barrier = get_barrier(cfg.voltage_barrier_type)
        self.dtype = grid.g_mat.dtype
        self.device = grid.g_mat.device
        self._solver = make_solver(
            grid, backend=cfg.pf_backend, tol=cfg.pf_tol,
            max_iter=cfg.pf_max_iter, inner_iters=cfg.pf_inner_iters,
            fixed_iter=cfg.pf_fixed_iter)

        dev, dt = self.device, self.dtype
        line_mask = grid.is_line.detach().cpu().double().numpy()
        self._line_mask = grid.is_line
        self._n_lines = float(max(line_mask.sum(), 1.0))

        bus_zone = grid.bus_zone.cpu().numpy()
        sgen_zone = grid.sgen_zone.cpu().numpy()
        n_zone = grid.n_zone
        if cfg.mode == "distributed":
            self.n_agents, self.n_actions = grid.n_sgen, 1
        elif cfg.mode == "decentralised":
            self.n_agents, self.n_actions = n_zone, grid.n_sgen
        else:
            raise ValueError(f"unknown mode '{cfg.mode}'")

        zone_buses = [np.nonzero(bus_zone == z)[0] for z in range(1, n_zone + 1)]
        if cfg.mode == "distributed":
            groups = [zone_buses[sgen_zone[i] - 1] for i in range(grid.n_sgen)]
        else:
            groups = zone_buses
        idx, mask, self._zb_width = _pad_gather_indices(groups)
        self._zb_idx = torch.as_tensor(idx, device=dev)
        self._zb_mask = torch.as_tensor(mask, device=dev).to(dt)

        zone_sgens = [np.nonzero(sgen_zone == z)[0] for z in range(1, n_zone + 1)]
        if cfg.mode == "decentralised":
            if any(len(s) == 0 for s in zone_sgens):
                raise ValueError("decentralised mode requires >=1 PV per zone")
            idx, mask, self._zs_width = _pad_gather_indices(zone_sgens)
            self._zs_idx = torch.as_tensor(idx, device=dev)
            self._zs_mask = torch.as_tensor(mask, device=dev).to(dt)
            avail = np.zeros((self.n_agents, grid.n_sgen), np.float64)
            for z, s in enumerate(zone_sgens):
                avail[z, s] = 1.0
            self.avail_actions = torch.as_tensor(avail, device=dev).to(dt)
        else:
            self.avail_actions = torch.ones((self.n_agents, 1), dtype=dt, device=dev)

        w = self._zb_width
        one = 1 if cfg.mode == "distributed" else getattr(self, "_zs_width", 1)
        width = {"demand": 2 * w, "pv": one, "reactive": one, "vm_pu": w,
                 "va_degree": w}
        self.obs_base_size = int(sum(width[c] for c in cfg.state_space))
        self.obs_size = self.obs_base_size * cfg.history
        self.state_size = sum({
            "demand": 2 * grid.n_bus, "pv": grid.n_sgen,
            "reactive": grid.n_sgen, "vm_pu": grid.n_bus,
            "va_degree": grid.n_bus}[c] for c in cfg.state_space)

        # episode-window sampling bounds (reference voltage_control_env.py:381-398)
        self.steps_per_hour = 60 // ts.time_delta
        self.steps_per_day = 24 * self.steps_per_hour
        total_days = ts.n_steps // self.steps_per_day
        episode_days = cfg.episode_limit // self.steps_per_day + 1
        self.max_start_day = max(total_days - episode_days, 1)
        self.action_low = cfg.action_bias - cfg.action_scale
        self.action_high = cfg.action_bias + cfg.action_scale

    # ------------------------------------------------------------------ data
    def _data_at(self, t):
        t = torch.clamp(t, 0, self.ts.n_steps - 1)
        return self.ts.pv[t], self.ts.load_p[t], self.ts.load_q[t]

    def _noisy_data_at(self, t, add_noise, generator=None, noise=None):
        """Truncated-gaussian perturbation, std = column-std/100 (reference
        voltage_control_env.py:491-513), added onto |N(0, 1)| draws."""
        pv, lp, lq = self._data_at(t)
        if add_noise:
            if noise is None:
                noise = tuple(self._randn(x.shape, generator) for x in (pv, lp, lq))
            else:
                noise = tuple(lanes.given(z) for z in noise)
            z_pv, z_lp, z_lq = (torch.as_tensor(z, device=self.device).to(self.dtype)
                                for z in noise)
            pv = pv + self.ts.pv_std * torch.abs(z_pv)
            lp = lp + self.ts.load_p_std * torch.abs(z_lp)
            lq = lq + self.ts.load_q_std * torch.abs(z_lq)
        return pv, lp, lq

    def _randn(self, shape, generator):
        return lanes.draw(lambda s: torch.randn(s, generator=generator, dtype=self.dtype,
                                                device=self.device), shape)

    # ------------------------------------------------------------- power flow
    def _injections(self, load_p, load_q, pv_p, sgen_q):
        """Bus injections [pu], generation positive, of (L, n_load) /
        (L, n_sgen) device powers."""
        g = self.grid
        p = (pv_p @ g.sgen_inc.T - load_p @ g.load_inc.T) / g.sn_mva
        q = (sgen_q @ g.sgen_inc.T - load_q @ g.load_inc.T) / g.sn_mva
        return p, q

    def _solve(self, load_p, load_q, pv_p, sgen_q, vm0=None, va0=None):
        g = self.grid
        p, q = self._injections(load_p, load_q, pv_p, sgen_q)
        if vm0 is None:   # flat start (pandapower init='auto' for PQ nets)
            vm0 = torch.ones_like(p)
            vm0[:, 0] = g.slack_vm
        if va0 is None:
            va0 = torch.zeros_like(p)
        with profiling.span("pf.solve"):
            res = self._solver(p, q, vm0, va0)
        profiling.count("pf.lane_solves", p.shape[0])
        profiling.count("pf.nr_iters", res.n_iter)
        return res

    def clip_reactive_power(self, actions, pv_p):
        """q = a sqrt(s_max^2 - p^2), guarded against noise pushing p above
        s_max (reference voltage_control_env.py:568-572)."""
        cap = torch.sqrt(torch.clamp(self.ts.s_max**2 - pv_p**2, min=0.0))
        return cap * actions

    # ------------------------------------------------------------------ reset
    def _sample_start(self, n_lanes, generator=None):
        """day/hour/interval decomposition (voltage_control_env.py:381-398)."""
        def randint(high):
            return lanes.draw(lambda s: torch.randint(
                0, high, s, generator=generator, device=self.device), (n_lanes,))
        day = randint(self.max_start_day)
        hour = randint(24)
        interval = randint(self.steps_per_hour)
        return interval + hour * self.steps_per_hour + day * self.steps_per_day

    def _attempt_reset(self, t0, add_noise, generator=None, vm0=None,
                       va0=None, noise=None, a0=None):
        """One reset attempt for every lane (one batched solve)."""
        with profiling.span("env.reset"):
            t = torch.as_tensor(t0, device=self.device).long() + self.cfg.history
            pv, lp, lq = self._noisy_data_at(t, add_noise, generator, noise)
            n_lanes, n_sgen = pv.shape
            if self.cfg.reset_action:
                if a0 is None:
                    a0 = lanes.draw(lambda s: torch.rand(
                        s, generator=generator, dtype=self.dtype, device=self.device),
                        (n_lanes, n_sgen))
                    a0 = a0 * (self.action_high - self.action_low) + self.action_low
                else:
                    a0 = lanes.given(a0)
                q0 = self.clip_reactive_power(
                    torch.as_tensor(a0, device=self.device).to(self.dtype), pv)
            else:
                q0 = torch.zeros_like(pv)
            res = self._solve(lp, lq, pv, q0, vm0=vm0, va0=va0)
            ok = res.converged
            # a failed solve must not leak NaNs into observations: fall back to a
            # flat profile (the caller retries on the converged flag)

            def fin(x, fb):
                return _lane_where(ok, torch.where(torch.isfinite(x), x, fb), fb)

            state = EnvState(
                t=t, step=torch.ones_like(t),
                load_p=lp, load_q=lq, pv_p=pv, sgen_q=q0,
                vm=fin(res.vm, torch.ones_like(res.vm)),
                va=fin(res.va, torch.zeros_like(res.va)),
                p_bus=fin(res.p_bus, torch.zeros_like(res.p_bus)),
                q_bus=fin(res.q_bus, torch.zeros_like(res.q_bus)),
                pl_mw=fin(res.pl_mw, torch.zeros_like(res.pl_mw)),
                solved_pv_p=pv,
                sum_rewards=torch.zeros(n_lanes, dtype=self.dtype, device=self.device),
                terminated=torch.zeros(n_lanes, dtype=torch.bool, device=self.device),
                obs_hist=torch.zeros(
                    (n_lanes, max(self.cfg.history - 1, 0), self.n_agents,
                     self.obs_base_size), dtype=self.dtype, device=self.device))
            return state, ok

    def reset(self, n_lanes, generator=None, draws: Optional[dict] = None):
        """Random-window reset with bounded solvability retry
        (voltage_control_env.py:96-135 retries unboundedly; here at most
        cfg.reset_retries attempts, keeping the last one).  A lane whose
        attempts all fail comes back terminated.  ``draws``: optional
        explicit ``t0``, ``noise`` and ``a0`` of the first attempt."""
        draws = draws or {}
        t0 = draws.get("t0")
        t0 = self._sample_start(n_lanes, generator) if t0 is None else lanes.given(t0)
        state, ok = self._attempt_reset(t0, True, generator,
                                        noise=draws.get("noise"),
                                        a0=draws.get("a0"))
        tries = 1
        # under a lane shard every rank retries while a lane of any rank
        # failed, so that all ranks draw alike
        while tries < self.cfg.reset_retries and not lanes.all_lanes(ok):
            again, ok2 = self._attempt_reset(
                self._sample_start(n_lanes, generator), True, generator)
            state = select_state(ok, state, again)
            ok = ok | ok2
            tries += 1
        state = state.replace(terminated=~ok)
        obs, state = self._obs_and_push_hist(state)
        return state, obs, self.get_state(state)

    def manual_reset(self, day, hour, interval, a0=None, generator=None):
        """Deterministic start, no noise (voltage_control_env.py:137-176),
        one lane a day: ``day`` is an int (one lane) or an (L,) tensor of
        days.  With ``reset_action`` every lane starts
        from one reset action, ``a0`` (n_sgen,) or one draw from
        ``generator`` (by default a CPU generator seeded 0, so that a day
        starts alike on every device): the JAX package draws it from
        PRNGKey(0) in every lane it vmaps over."""
        day = torch.as_tensor(day, device=self.device).long().reshape(-1)
        t0 = interval + hour * self.steps_per_hour + day * self.steps_per_day
        if self.cfg.reset_action:
            if a0 is None:
                if generator is None:
                    generator = torch.Generator().manual_seed(0)
                a0 = torch.rand((self.grid.n_sgen,), generator=generator,
                                dtype=self.dtype, device=generator.device)
                a0 = a0 * (self.action_high - self.action_low) + self.action_low
            a0 = torch.as_tensor(a0, device=self.device).to(self.dtype)
            a0 = a0.reshape(1, -1).expand(t0.shape[0], -1)
        state, _ = self._attempt_reset(t0, False, generator, a0=a0)
        obs, state = self._obs_and_push_hist(state)
        return state, obs, self.get_state(state)

    # ------------------------------------------------------------------- step
    def translate_actions(self, agent_actions):
        """(L, n_agents, n_actions) network outputs in [-1, 1] -> (L, n_sgen)
        per-sgen actions in [low, high] (reference util.py:123-132); the
        decentralised mode routes zone rows to sgens by the avail mask."""
        a = torch.clamp(agent_actions, -1.0, 1.0)
        a = 0.5 * (a + 1.0) * (self.action_high - self.action_low) + self.action_low
        if self.cfg.mode == "distributed":
            return a[..., :, 0]
        return torch.sum(a * self.avail_actions, dim=-2)

    def step(self, state: EnvState, sgen_actions, generator=None,
             add_noise=True, noise=None) -> StepOutput:
        """One transition of every lane; ``sgen_actions`` (L, n_sgen)."""
        with profiling.span("env.step"):
            cfg = self.cfg
            sgen_actions = torch.as_tensor(sgen_actions, device=self.device).to(self.dtype)
            q_cmd = self.clip_reactive_power(sgen_actions, state.pv_p)
            # warm start from the previous solved operating point
            res = self._solve(state.load_p, state.load_q, state.pv_p, q_cmd,
                              vm0=state.vm, va0=state.va)
            ok = res.converged

            # masked rollback on divergence (voltage_control_env.py:183-196)
            sel = lambda a, b: _lane_where(ok, a, b)
            vm = sel(res.vm, state.vm)
            va = sel(res.va, state.va)
            p_bus = sel(res.p_bus, state.p_bus)
            q_bus = sel(res.q_bus, state.q_bus)
            pl = sel(res.pl_mw, state.pl_mw)
            sgen_q = sel(q_cmd, state.sgen_q)
            solved_pv = sel(state.pv_p, state.solved_pv_p)

            reward, info = self._calc_reward(vm, pl, sgen_q)
            attempted_q_loss = torch.mean(torch.abs(q_cmd), dim=-1)
            reward = torch.where(ok, reward, reward - cfg.destroy_penalty)
            zero = torch.zeros_like(reward)
            info["destroy"] = torch.where(ok, zero, zero + 1.0)
            info["totally_controllable_ratio"] = torch.where(
                ok, info["totally_controllable_ratio"], zero)
            info["q_loss"] = torch.where(ok, info["q_loss"], attempted_q_loss)

            t_next = state.t + 1
            pv, lp, lq = self._noisy_data_at(t_next, add_noise, generator, noise)
            step = state.step + 1
            # an incoming terminated flag (failed reset attempt) propagates so the
            # auto-reset path re-resets the lane on its next step
            terminated = state.terminated | (step >= cfg.episode_limit) | ~ok
            profiling.count("env.terminated_lanes", terminated)

            new_state = state.replace(
                t=t_next, step=step, load_p=lp, load_q=lq, pv_p=pv,
                sgen_q=sgen_q, vm=vm, va=va, p_bus=p_bus, q_bus=q_bus,
                pl_mw=pl, solved_pv_p=solved_pv,
                sum_rewards=state.sum_rewards + reward, terminated=terminated)
            obs, new_state = self._obs_and_push_hist(new_state)
            return StepOutput(state=new_state, obs=obs,
                              global_state=self.get_state(new_state),
                              reward=reward, terminated=terminated, info=info)

    # ------------------------------------------------------------ reward/info
    def _calc_reward(self, vm, pl_mw, sgen_q):
        """Barrier + q/line loss and the engineering info metrics
        (voltage_control_env.py:574-623)."""
        cfg = self.cfg
        v = vm
        n = v.shape[-1]
        below = torch.sum(v < cfg.v_lower, dim=-1).to(v.dtype)
        above = torch.sum(v > cfg.v_upper, dim=-1).to(v.dtype)
        pct_out = (below + above) / n
        v_ref = 0.5 * (cfg.v_lower + cfg.v_upper)

        line_loss = torch.sum(pl_mw * self._line_mask, dim=-1)
        avg_line_loss = line_loss / self._n_lines
        q_loss = torch.mean(torch.abs(sgen_q), dim=-1)
        v_loss = torch.mean(self.barrier(v), dim=-1) * cfg.voltage_weight
        if cfg.line_weight is not None:
            loss = avg_line_loss * cfg.line_weight + v_loss
        elif cfg.q_weight is not None:
            loss = q_loss * cfg.q_weight + v_loss
        else:
            raise ValueError("need q_weight or line_weight")

        zero = torch.zeros_like(v)
        info = {
            "percentage_of_v_out_of_control": pct_out,
            "percentage_of_lower_than_lower_v": below / n,
            "percentage_of_higher_than_upper_v": above / n,
            "totally_controllable_ratio": (pct_out <= 1e-3).to(v.dtype),
            "average_voltage_deviation": torch.mean(torch.abs(v - v_ref), dim=-1),
            "average_voltage": torch.mean(v, dim=-1),
            "max_voltage_drop_deviation": torch.amax(
                torch.where(v < cfg.v_lower, cfg.v_lower - v, zero), dim=-1),
            "max_voltage_rise_deviation": torch.amax(
                torch.where(v > cfg.v_upper, v - cfg.v_upper, zero), dim=-1),
            "total_line_loss": line_loss,
            "q_loss": q_loss,
            "destroy": torch.zeros_like(q_loss),
        }
        return -loss, info

    # ------------------------------------------------------- obs/global state
    def _base_obs(self, state: EnvState):
        """(L, n_agents, obs_base_size) zone-masked observation; bus p/q have
        the PV injections added back, va in radians."""
        g = self.grid
        p_obs = state.p_bus + state.pv_p @ g.sgen_inc.T
        q_obs = state.q_bus + state.sgen_q @ g.sgen_inc.T
        take = lambda arr: arr[:, self._zb_idx] * self._zb_mask
        parts = []
        for comp in self.cfg.state_space:
            if comp == "demand":
                parts += [take(p_obs), take(q_obs)]
            elif comp in ("pv", "reactive"):
                x = state.pv_p if comp == "pv" else state.sgen_q
                if self.cfg.mode == "distributed":
                    parts.append(x[:, :, None])
                else:
                    parts.append(x[:, self._zs_idx] * self._zs_mask)
            elif comp == "vm_pu":
                parts.append(take(state.vm))
            elif comp == "va_degree":
                parts.append(take(state.va))
        return torch.cat(parts, dim=-1)

    def _obs_and_push_hist(self, state: EnvState):
        base = self._base_obs(state)
        if self.cfg.history <= 1:
            return base, state
        frames = torch.cat([state.obs_hist, base[:, None]], dim=1)
        obs = frames.permute(0, 2, 1, 3).reshape(base.shape[0], self.n_agents, -1)
        return obs, state.replace(obs_hist=frames[:, 1:])

    def get_state(self, state: EnvState):
        """(L, state_size) global state (voltage_control_env.py:213-230; va in
        degrees)."""
        parts = []
        for comp in self.cfg.state_space:
            if comp == "demand":
                parts += [state.p_bus, state.q_bus]
            elif comp == "pv":
                parts.append(state.pv_p)
            elif comp == "reactive":
                parts.append(state.sgen_q)
            elif comp == "vm_pu":
                parts.append(state.vm)
            elif comp == "va_degree":
                parts.append(state.va * (180.0 / math.pi))
        return torch.cat(parts, dim=-1)

    # ------------------------------------------------------------- auto-reset
    def batched_auto_reset_step(self, states, sgen_actions, generator=None,
                                add_noise=True, draws: Optional[dict] = None,
                                always_reset=False):
        """:meth:`step`, then one warm-started reset attempt (a second batched
        solve) for the terminated lanes, run only when some lane terminated
        (``always_reset`` runs it every step).  On a reset boundary the
        returned obs/global_state come from the fresh episode; a failed
        reset leaves the lane terminated so it re-resets on its next step.

        ``draws``: optional explicit ``step_noise``, ``t0``, ``reset_noise``
        and ``a0`` (see the module docstring)."""
        draws = draws or {}
        out = self.step(states, sgen_actions, generator, add_noise,
                        noise=draws.get("step_noise"))
        if not always_reset and not lanes.any_lane(out.terminated):
            return out
        n_lanes = out.reward.shape[0]
        t0 = draws.get("t0")
        t0 = self._sample_start(n_lanes, generator) if t0 is None else lanes.given(t0)
        fresh, ok = self._attempt_reset(
            t0, add_noise, generator, vm0=states.vm, va0=states.va,
            noise=draws.get("reset_noise"), a0=draws.get("a0"))
        fresh = fresh.replace(terminated=~ok)
        obs_f, fresh = self._obs_and_push_hist(fresh)
        sel = out.terminated
        return dataclasses.replace(
            out, state=select_state(sel, fresh, out.state),
            obs=_lane_where(sel, obs_f, out.obs),
            global_state=_lane_where(sel, self.get_state(fresh),
                                     out.global_state))

    def auto_reset_step(self, states, sgen_actions, generator=None,
                        add_noise=True, draws=None):
        """:meth:`batched_auto_reset_step` with the reset attempt computed
        every step (the JAX package's branchless per-lane variant)."""
        return self.batched_auto_reset_step(states, sgen_actions, generator,
                                            add_noise, draws, always_reset=True)

    # -------------------------------------------------------------- env info
    def get_env_info(self):
        """PyMARL-style env info (reference multiagentenv.py:62-67)."""
        return {"state_shape": self.state_size, "obs_shape": self.obs_size,
                "n_actions": self.n_actions, "n_agents": self.n_agents,
                "episode_limit": self.cfg.episode_limit}


def make_env(case="case33", cfg: EnvConfig | None = None, *, data_path=None,
             days=40, seed=0, dtype=torch.float32, device=None,
             pv_scale=1.0, demand_scale=1.0):
    """Build the env of a named case on ``device`` (the GPU when None; pass
    ``device="cpu"`` to run on the CPU), with the MAPDN CSVs of
    ``data_path`` where it holds them, else with synthetic data."""
    from mapdn_torch.envs.timeseries import dataset_for_case
    from mapdn_torch.grid.cases import make_case

    cfg = cfg or EnvConfig()
    grid, load_p, load_q, pv_max = make_case(case, dtype=dtype, device=device)
    ts = dataset_for_case(case, load_p, load_q, pv_max, data_path=data_path,
                          days=days, seed=seed, dtype=dtype, device=grid.device,
                          pv_scale=pv_scale, demand_scale=demand_scale)
    return VoltageControlEnv(grid, ts, cfg)
