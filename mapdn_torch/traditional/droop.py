"""Volt-var droop control baseline (PyTorch port of
mapdn_tpu/traditional/droop.py).

The piecewise volt-var law of the reference's Matlab/MATPOWER droop
baseline (traditional_control/pf_droop_matpower_all.m:196-230) and its
damped fixed point of (power flow -> local droop response), gain 0.1 for
up to 100 iterations (:18-19, 120-150), over a batch of operating points
at once: every iteration is one batched solve through the env's solver
(on the card, the small kernel at case33).

The JAX package runs the fixed point under ``jax.vmap`` of a
``lax.while_loop``, which iterates while any lane's condition holds and
freezes each finished lane's carry.  Here each iteration updates only the
lanes whose own condition still holds, so every lane stops where it would
alone, and the loop ends when none is left (one flag read back to the host
per iteration).
"""
from __future__ import annotations

import dataclasses

import torch

from mapdn_torch.envs.voltage_control import _lane_where
from mapdn_torch.pf.newton import PFResult


def droop_control_law(v, p, s_rated, q_max_manual=None,
                      va=0.95, vb=1.0, vc=1.0, vd=1.05):
    """Piecewise volt-var curve (reference pf_droop_matpower_all.m:196-230).

    Saturated at +-q_max outside [va, vd], dead zone in [vb, vc], linear
    ramps between.  All arguments broadcast; elementwise.
    """
    q_max = torch.sqrt(torch.clamp(s_rated**2 - p**2, min=0.0))
    if q_max_manual is not None:
        q_max = torch.minimum(q_max, torch.as_tensor(q_max_manual).to(q_max))
    # low ramp: 0 at vb down-scaling to +q_max at va
    k_low = q_max / (va - vb)
    q_low = k_low * (v - vb)
    # high ramp: 0 at vc to -q_max at vd
    k_high = -q_max / (vc - vd)
    q_high = k_high * (vc - v)
    return torch.where(v <= va, q_max,
           torch.where(v > vd, -q_max,
           torch.where((v >= vb) & (v <= vc), torch.zeros_like(q_max),
           torch.where(v < vb, q_low, q_high))))


def _select_result(sel, a: PFResult, b: PFResult) -> PFResult:
    """Lane-wise ``a if sel else b`` over every PFResult field."""
    return PFResult(**{f.name: _lane_where(sel, getattr(a, f.name), getattr(b, f.name))
                       for f in dataclasses.fields(PFResult)})


def droop_solve(env, load_p, load_q, pv_p, *, gain=0.1, max_ite=100,
                v_tol=1e-4, reactive_ratio=1.0):
    """Batched droop fixed point for given operating points.

    Args shaped (L, n_load) / (L, n_sgen) [MW/Mvar].  Returns
    (sgen_q, PFResult, n_iter): each lane's converged droop reactive
    dispatch, its final power-flow solution and its own iteration count
    (L,).  A lane stops once its PV-bus voltages move less than ``v_tol``
    (2-norm) in an iteration, or after ``max_ite`` iterations.
    """
    grid, cfg = env.grid, env.cfg
    s_rated = env.ts.s_max
    q_max_manual = reactive_ratio * s_rated

    def active(res, v_pv_last, it):
        dv = torch.sqrt(torch.sum((res.vm[:, grid.sgen_bus] - v_pv_last) ** 2, dim=-1))
        return (it < max_ite) & (dv >= v_tol)

    q = torch.zeros_like(pv_p)
    res = env._solve(load_p, load_q, pv_p, q)
    v_pv_last = torch.full_like(pv_p, 100.0)  # pass the first break check
    it = torch.zeros(pv_p.shape[0], dtype=torch.int32, device=pv_p.device)
    act = active(res, v_pv_last, it)
    while bool(act.any()):
        v_pv = res.vm[:, grid.sgen_bus]
        q_new = droop_control_law(v_pv, pv_p, s_rated, q_max_manual,
                                  va=cfg.v_lower, vd=cfg.v_upper)
        q_next = (1.0 - gain) * q + gain * q_new
        res_next = env._solve(load_p, load_q, pv_p, q_next, vm0=res.vm, va0=res.va)
        # a finished lane keeps its carry, as under jax.vmap(lax.while_loop)
        q = _lane_where(act, q_next, q)
        v_pv_last = _lane_where(act, v_pv, v_pv_last)
        res = _select_result(act, res_next, res)
        it = it + act.to(torch.int32)
        act = active(res, v_pv_last, it)
    return q, res, it
