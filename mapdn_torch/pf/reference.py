"""Independent numpy Newton-Raphson oracle (copy of mapdn_tpu/pf/reference.py).

A deliberately *different* implementation from the batched solvers:
complex-arithmetic NR with the MATPOWER-style dSbus_dV Jacobian and dense
solves in float64.  The synthetic cases calibrate their impedances with it.

Both implementations solve the same mathematical problem pandapower's NR
solves (polar NR on a pi-model network, power-mismatch convergence test,
tol 1e-8 pu as in pandapower's default), so agreement to ~1e-8 between the
two is strong evidence of correctness.
"""
from __future__ import annotations

import numpy as np


def nr_solve_ref(g_mat, b_mat, p_inj, q_inj, slack_vm=1.0, tol=1e-8, max_iter=30):
    """Solve one power flow with bus 0 as slack.

    Args:
      g_mat, b_mat: (n, n) real/imag parts of Ybus [pu].
      p_inj, q_inj: (n,) specified net injections [pu], generation positive.
        Entries at the slack bus are ignored.
      slack_vm: slack voltage magnitude [pu].

    Returns:
      (vm, va, converged, n_iter): voltage magnitude [pu], angle [rad].
    """
    ybus = np.asarray(g_mat, np.float64) + 1j * np.asarray(b_mat, np.float64)
    n = ybus.shape[0]
    pq = np.arange(1, n)  # all non-slack buses are PQ in this benchmark
    sbus = np.asarray(p_inj, np.float64) + 1j * np.asarray(q_inj, np.float64)

    v = np.ones(n, np.complex128)
    v[0] = slack_vm

    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        ibus = ybus @ v
        mis = v * np.conj(ibus) - sbus
        f = np.concatenate([mis[pq].real, mis[pq].imag])
        if np.max(np.abs(f)) < tol:
            converged = True
            it -= 1
            break

        # MATPOWER dSbus_dV (polar form)
        diag_v = np.diag(v)
        diag_i = np.diag(ibus)
        diag_vnorm = np.diag(v / np.abs(v))
        ds_dva = 1j * diag_v @ np.conj(diag_i - ybus @ diag_v)
        ds_dvm = diag_v @ np.conj(ybus @ diag_vnorm) + np.conj(diag_i) @ diag_vnorm

        j11 = ds_dva[np.ix_(pq, pq)].real
        j12 = ds_dvm[np.ix_(pq, pq)].real
        j21 = ds_dva[np.ix_(pq, pq)].imag
        j22 = ds_dvm[np.ix_(pq, pq)].imag
        jac = np.block([[j11, j12], [j21, j22]])

        dx = np.linalg.solve(jac, f)
        va = np.angle(v)
        vm = np.abs(v)
        va[pq] -= dx[: len(pq)]
        vm[pq] -= dx[len(pq):]
        v = vm * np.exp(1j * va)

    return np.abs(v), np.angle(v), converged, it


def branch_results_ref(vm, va, f_bus, t_bus, br_r, br_x, br_b, tap, sn_mva=1.0):
    """Per-branch loss [MW] computed from a solved voltage profile (oracle)."""
    v = np.asarray(vm) * np.exp(1j * np.asarray(va))
    ys = 1.0 / (np.asarray(br_r) + 1j * np.asarray(br_x))
    bc = 1j * np.asarray(br_b) / 2.0
    t = np.asarray(tap)
    vf, vt = v[f_bus], v[t_bus]
    i_f = (ys + bc) / t**2 * vf - ys / t * vt
    i_t = (ys + bc) * vt - ys / t * vf
    s_f = vf * np.conj(i_f) * sn_mva
    s_t = vt * np.conj(i_t) * sn_mva
    return (s_f + s_t).real
