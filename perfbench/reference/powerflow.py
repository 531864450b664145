"""Batched AC power flow of the plain reference: full polar Newton-Raphson
with the exact Jacobian (MATPOWER's dSbus/dV), dense solves, bus 0 slack.

A different algorithm from the program's (which iterates a frozen
flat-start preconditioner); both solve the same equations, so their
converged voltages agree to the program's tolerance.
"""
from __future__ import annotations

import torch


def solve(ybus, p_inj, q_inj, slack_vm=1.0, tol=1e-10, max_iter=30):
    """(vm, va, converged) of (B, n) injections [pu], generation positive.

    ``ybus`` is the (n, n) complex admittance matrix in the precision the
    solve runs in (complex128 for the reference, complex64 for its
    control)."""
    cdt = ybus.dtype
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    bsz, n = p_inj.shape
    m = n - 1
    s_spec = torch.complex(p_inj.to(rdt), q_inj.to(rdt))
    vm = torch.ones((bsz, n), dtype=rdt, device=ybus.device)
    vm[:, 0] = slack_vm
    va = torch.zeros_like(vm)
    converged = torch.zeros(bsz, dtype=torch.bool, device=ybus.device)
    eye = torch.eye(n, dtype=cdt, device=ybus.device)
    for _ in range(max_iter + 1):
        v = torch.polar(vm, va)
        cur = v @ ybus.T
        mis = v * cur.conj() - s_spec
        f = torch.cat([mis[:, 1:].real, mis[:, 1:].imag], 1)
        converged = f.abs().amax(1) < tol
        if bool(converged.all()):
            break
        # dS/dVa = j diag(V) conj(diag(I) - Y diag(V));
        # dS/dVm = diag(V) conj(Y diag(V/|V|)) + conj(diag(I)) diag(V/|V|)
        vn = v / vm.to(cdt)
        y_dv = ybus[None] * v[:, None, :]
        ds_dva = 1j * v[:, :, None] * (eye[None] * cur[:, None, :] - y_dv).conj()
        ds_dvm = (v[:, :, None] * (ybus[None] * vn[:, None, :]).conj()
                  + (eye[None] * cur.conj()[:, None, :]) * vn[:, None, :])
        a, b = ds_dva[:, 1:, 1:], ds_dvm[:, 1:, 1:]
        jac = torch.cat([torch.cat([a.real, b.real], 2),
                         torch.cat([a.imag, b.imag], 2)], 1)
        # lanes already converged take a zero step
        dx = torch.linalg.solve(jac, f[..., None])[..., 0]
        dx = torch.where(converged[:, None], torch.zeros_like(dx), dx)
        va = torch.cat([va[:, :1], va[:, 1:] - dx[:, :m]], 1)
        vm = torch.cat([vm[:, :1], vm[:, 1:] - dx[:, m:]], 1)
    return vm, va, converged


def bus_powers(ybus, vm, va, sn_mva=1.0):
    """Bus powers [MW, Mvar] of solved voltages, consumption positive."""
    v = torch.polar(vm, va)
    s = v * (v @ ybus.T).conj()
    return -s.real * sn_mva, -s.imag * sn_mva
