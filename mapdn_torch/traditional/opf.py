"""Reactive-power OPF baseline through a differentiable power flow (PyTorch
port of mapdn_tpu/traditional/opf.py).

The reference's MATPOWER OPF baseline (traditional_control/
opf_matpower_all.m) chooses, per operating point, each inverter's q within
+-sqrt(S^2 - P^2) (P fixed, :78-79) to minimise network loss subject to the
voltage limits, by an interior-point NLP per instant.  Here, as in the JAX
package, a batch of instants is solved at once by projected gradient
descent through a fixed-iteration power flow (plain torch ops, so autograd
applies), with a quadratic voltage-violation penalty.  The optimiser is
Adam written out as ``optax.adam`` defines it, its step scaled by each
inverter's capacity and projected onto it.
"""
from __future__ import annotations

import torch

from mapdn_torch.pf.newton import branch_results, nr_solve

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _fixed_iter_pf(grid, p_inj, q_inj, n_iter=8):
    """Differentiable power flow: ``n_iter`` chord iterations through the
    frozen flat-start Jacobian inverse from a flat start, in Y-normalised
    units (mapdn_tpu/traditional/opf.py::_fixed_iter_pf).  (L, n) -> vm, va."""
    n = grid.n_bus
    y_diag = torch.sqrt(torch.diagonal(grid.g_mat) ** 2 + torch.diagonal(grid.b_mat) ** 2)
    inv_c = 1.0 / torch.max(y_diag)
    g = grid.g_mat * inv_c
    b = grid.b_mat * inv_c
    rsg = grid.rowsum_g * inv_c
    rsb = grid.rowsum_b * inv_c
    w = grid.j0_inv / inv_c
    p_spec = (p_inj * inv_c)[..., 1:]
    q_spec = (q_inj * inv_c)[..., 1:]

    ones = torch.ones_like(p_inj)
    vm = torch.cat([ones[..., :1] * grid.slack_vm, ones[..., 1:]], -1)
    va = torch.zeros_like(p_inj)
    for _ in range(n_iter):
        e = vm * torch.cos(va)
        f = vm * torch.sin(va)
        # cancellation-safe currents G (e-1) - B f + rowsum_g
        # (mapdn_tpu/pf/newton.py::_currents)
        e1 = e - 1.0
        ir = e1 @ g.T - f @ b.T + rsg
        ii = f @ g.T + e1 @ b.T + rsb
        p = e * ir + f * ii
        q = f * ir - e * ii
        fvec = torch.cat([p_spec - p[..., 1:], q_spec - q[..., 1:]], -1)
        dx = fvec @ w.T
        va = torch.cat([va[..., :1], va[..., 1:] + dx[..., : n - 1]], -1)
        vm = torch.cat([vm[..., :1], vm[..., 1:] * (1.0 + dx[..., n - 1:])], -1)
    return vm, va


def opf_objective(env, load_p, load_q, pv_p, q, *, penalty=200.0, n_pf_iter=8):
    """Each lane's network loss [MW] plus ``penalty`` times its squared
    voltage-band violations [pu^2] at reactive dispatch ``q``, (L,)."""
    cfg = env.cfg
    p_inj, q_inj = env._injections(load_p, load_q, pv_p, q)
    vm, va = _fixed_iter_pf(env.grid, p_inj, q_inj, n_iter=n_pf_iter)
    pl, _ = branch_results(env.grid, vm, va)
    viol = (torch.clamp(vm - cfg.v_upper, min=0.0) ** 2
            + torch.clamp(cfg.v_lower - vm, min=0.0) ** 2)
    return torch.sum(pl, dim=-1) + penalty * torch.sum(viol, dim=-1)


def opf_solve(env, load_p, load_q, pv_p, *, steps=150, lr=0.05,
              penalty=200.0, n_pf_iter=8):
    """Batched VAR OPF: min total loss s.t. v in [v_lower, v_upper],
    |q| <= sqrt(s_max^2 - p^2), for (L, n_load) / (L, n_sgen) operating
    points.

    Returns (sgen_q, PFResult of the final solve, objective trace (L,
    steps)): each lane's objective after each step.  The final solve is the
    torch-op :func:`mapdn_torch.pf.newton.nr_solve` at the env's tolerance.
    """
    q_cap = torch.sqrt(torch.clamp(env.ts.s_max**2 - pv_p**2, min=0.0))

    def objective(q):
        return opf_objective(env, load_p, load_q, pv_p, q, penalty=penalty,
                             n_pf_iter=n_pf_iter)

    q = torch.zeros_like(pv_p)
    mu = torch.zeros_like(q)
    nu = torch.zeros_like(q)
    trace = []
    for count in range(1, steps + 1):
        q.requires_grad_(True)
        obj = objective(q)
        if count > 1:            # the objective after the previous step
            trace.append(obj.detach())
        # the lanes' sum: each lane's gradient is its own
        (grad,) = torch.autograd.grad(obj.sum(), q)
        q = q.detach()
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * nu
        mu_hat = mu / (1 - ADAM_B1**count)
        nu_hat = nu / (1 - ADAM_B2**count)
        upd = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        q = torch.clamp(q + upd * q_cap, -q_cap, q_cap)  # scaled + projected
    with torch.no_grad():
        trace.append(objective(q))
    res = nr_solve(env.grid, *env._injections(load_p, load_q, pv_p, q),
                   tol=env.cfg.pf_tol, max_iter=env.cfg.pf_max_iter)
    return q, res, torch.stack(trace, dim=-1)
