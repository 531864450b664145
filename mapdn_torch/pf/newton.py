"""Batched Newton-Raphson AC power flow in plain PyTorch ops.

Port of ``mapdn_tpu/pf/newton.py::nr_solve`` (early-exit loop): the
matrix-free inexact Newton method with the frozen flat-start preconditioner
``W = J0^-1`` and preconditioned Richardson refinement of each direction,

    d = W F,   then inner_iters times   d += W (F - J d),

with ``J d`` applied matrix-free through the packed admittance ``Y``.  Every
state vector is one ``(lanes, 2n)`` tensor of [real-half | imag-half]; the
slack row is a mask.  The system is solved in Y-normalized units
((Y, S) scaled by 1/max|y_diag|), and convergence is
``max|F| / max(max|spec|, 1) < tol`` per lane, with a lane also stopping on
a non-finite error or on max vm^2 > 100 (reported as not converged).

This is the ``"torch"`` backend of :func:`mapdn_torch.pf.fused_nr.make_solver`
and the float64 path of the parity tests; the case33 hot path runs the
hand-written CUDA kernel of :mod:`mapdn_torch.pf.fused_nr` instead.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class PFResult:
    vm: torch.Tensor          # (..., n_bus) voltage magnitude [pu]
    va: torch.Tensor          # (..., n_bus) voltage angle [rad]
    p_bus: torch.Tensor       # (..., n_bus) bus active power, consumption>0 [MW]
    q_bus: torch.Tensor       # (..., n_bus) bus reactive power [Mvar]
    pl_mw: torch.Tensor       # (..., n_branch) per-branch active loss [MW]
    loading: torch.Tensor     # (..., n_branch) loading percent of max_i_ka
    converged: torch.Tensor   # (...,) bool
    n_iter: torch.Tensor      # (...,) int32


def packed_operators(grid):
    """Y-normalized packed operators of one grid, lanes-major (x @ op):

        [Ir, Ii]   = [e-1, f] @ ypack + rowsum
        [dIr, dIi] = [de, df] @ ypack
        [dth, dnu] = [fP, fQ] @ wpack
    """
    n = grid.n_bus
    m = n - 1
    y_diag = torch.sqrt(torch.diagonal(grid.g_mat) ** 2
                        + torch.diagonal(grid.b_mat) ** 2)
    inv_c = 1.0 / torch.max(y_diag)
    g = grid.g_mat * inv_c
    b = grid.b_mat * inv_c
    ypack = torch.cat([torch.cat([g.T, b.T], 1), torch.cat([-b.T, g.T], 1)], 0)
    w = grid.j0_inv / inv_c
    blk = {}
    for name, (r, c) in {"tp": (0, 0), "tq": (0, 1),
                         "np": (1, 0), "nq": (1, 1)}.items():
        full = torch.zeros((n, n), dtype=g.dtype, device=g.device)
        full[1:, 1:] = w[r * m:(r + 1) * m, c * m:(c + 1) * m]
        blk[name] = full.T
    wpack = torch.cat([torch.cat([blk["tp"], blk["np"]], 1),
                       torch.cat([blk["tq"], blk["nq"]], 1)], 0)
    rowsum = torch.cat([grid.rowsum_g, grid.rowsum_b]) * inv_c
    half = torch.ones(n, dtype=g.dtype, device=g.device)
    half[0] = 0.0
    mask = torch.cat([half, half])
    return dict(inv_c=inv_c, ypack=ypack, wpack=wpack, rowsum=rowsum, mask=mask)


def nr_solve(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20, inner_iters=3,
             vm0=None, va0=None, ops=None):
    """Batched matrix-free NR solve of ``(..., n_bus)`` injections [pu]
    (generation positive, slack entries ignored); flat start by default.

    ``ops``: precomputed :func:`packed_operators` (computed here if None).
    Each loop iteration reads one flag back to the host for the early exit.
    """
    n = grid.n_bus
    batch_shape = p_inj.shape[:-1]
    dtype = grid.g_mat.dtype
    ops = ops or packed_operators(grid)
    ypack, wpack, rowsum, mask = ops["ypack"], ops["wpack"], ops["rowsum"], ops["mask"]
    p_inj = p_inj.reshape(-1, n).to(dtype)
    q_inj = q_inj.reshape(-1, n).to(dtype)
    lanes = p_inj.shape[0]

    spec = torch.cat([p_inj, q_inj], -1) * (ops["inv_c"] * mask)
    if vm0 is None:
        vm0 = torch.ones((lanes, n), dtype=dtype, device=p_inj.device)
        vm0[:, 0] = grid.slack_vm
    if va0 is None:
        va0 = torch.zeros((lanes, n), dtype=dtype, device=p_inj.device)
    vm0 = vm0.reshape(-1, n).to(dtype)
    va0 = va0.reshape(-1, n).to(dtype)
    v = torch.cat([vm0 * torch.cos(va0), vm0 * torch.sin(va0)], -1)

    s_ref = torch.clamp(spec.abs().amax(-1), min=1.0)
    base = torch.cat([torch.ones(n, dtype=dtype, device=v.device),
                      torch.zeros(n, dtype=dtype, device=v.device)])

    def mismatch(v):
        cur = (v - base) @ ypack + rowsum
        e, f = v[:, :n], v[:, n:]
        ir, ii = cur[:, :n], cur[:, n:]
        pq = torch.cat([e * ir + f * ii, f * ir - e * ii], -1)
        return (spec - pq) * mask, cur

    def newton_dir(fvec, v, cur):
        e, f = v[:, :n], v[:, n:]
        ir, ii = cur[:, :n], cur[:, n:]
        d = fvec @ wpack
        for _ in range(inner_iters):
            dth, dnu = d[:, :n], d[:, n:]
            de = -f * dth + e * dnu
            df = e * dth + f * dnu
            dcur = torch.cat([de, df], -1) @ ypack
            dir_, dii = dcur[:, :n], dcur[:, n:]
            jv = torch.cat([de * ir + e * dir_ + df * ii + f * dii,
                            df * ir + f * dir_ - de * ii - e * dii], -1) * mask
            d = d + (fvec - jv) @ wpack
        return d

    def err_of(fvec):
        return fvec.abs().amax(-1) / s_ref

    fvec, cur = mismatch(v)
    err = err_of(fvec)
    # amax propagates NaN like jnp.max: a NaN lane never reads as converged
    done = err < tol
    it = torch.zeros(lanes, dtype=torch.int32, device=v.device)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        d = newton_dir(fvec, v, cur)
        gate = 1.0 - done[:, None].to(dtype)
        e, f = v[:, :n], v[:, n:]
        dth, dnu = d[:, :n], d[:, n:]
        cos_d = torch.cos(gate * dth)
        sin_d = torch.sin(gate * dth)
        scale = 1.0 + gate * dnu
        v = torch.cat([scale * (e * cos_d - f * sin_d),
                       scale * (f * cos_d + e * sin_d)], -1)
        it = it + (~done).to(torch.int32)
        fvec, cur = mismatch(v)
        err = err_of(fvec)
        vm_sq = (v[:, :n] ** 2 + v[:, n:] ** 2).amax(-1)
        bad = ~torch.isfinite(err) | (vm_sq > 100.0)
        done = done | (err < tol) | bad

    converged = (err < tol) & torch.isfinite(err)
    e, f = v[:, :n], v[:, n:]
    vm = torch.sqrt(e * e + f * f)
    va = torch.atan2(f, e)
    return _result(grid, vm, va, converged, it, batch_shape)


def _result(grid, vm, va, converged, n_iter, batch_shape):
    """PFResult with the bus/branch quantities of the solved voltages."""
    n = grid.n_bus
    vm = vm.reshape(batch_shape + (n,))
    va = va.reshape(batch_shape + (n,))
    p_bus, q_bus = bus_injections(grid, vm, va)
    pl_mw, loading = branch_results(grid, vm, va)
    return PFResult(vm=vm, va=va, p_bus=p_bus, q_bus=q_bus, pl_mw=pl_mw,
                    loading=loading, converged=converged.reshape(batch_shape),
                    n_iter=n_iter.reshape(batch_shape))


def _calc_pq(grid, e, f):
    """P, Q from rectangular voltages (pu), cancellation-safe currents
    G (e-1) - B f + rowsum_g (see mapdn_tpu/pf/newton.py::_currents)."""
    e1 = e - 1.0
    ir = e1 @ grid.g_mat.T - f @ grid.b_mat.T + grid.rowsum_g
    ii = f @ grid.g_mat.T + e1 @ grid.b_mat.T + grid.rowsum_b
    return e * ir + f * ii, f * ir - e * ii


def bus_injections(grid, vm, va):
    """res_bus-equivalent bus powers [MW/Mvar], consumption positive."""
    e = vm * torch.cos(va)
    f = vm * torch.sin(va)
    p, q = _calc_pq(grid, e, f)
    return -p * grid.sn_mva, -q * grid.sn_mva


def branch_results(grid, vm, va):
    """Per-branch active loss [MW] and loading percent from solved voltages."""
    e = vm * torch.cos(va)
    f = vm * torch.sin(va)
    ef, ff = e[..., grid.f_bus], f[..., grid.f_bus]
    et, ft = e[..., grid.t_bus], f[..., grid.t_bus]

    ysg, ysb = grid.ys_g, grid.ys_b
    bc = grid.br_b / 2.0
    t = grid.tap
    yffg, yffb = ysg / t**2, (ysb + bc) / t**2
    yftg, yftb = -ysg / t, -ysb / t
    yttg, yttb = ysg, ysb + bc

    ifr = yffg * ef - yffb * ff + yftg * et - yftb * ft
    ifi = yffg * ff + yffb * ef + yftg * ft + yftb * et
    itr = yttg * et - yttb * ft + yftg * ef - yftb * ff
    iti = yttg * ft + yttb * et + yftg * ff + yftb * ef

    pl_mw = ((ef * ifr + ff * ifi) + (et * itr + ft * iti)) * grid.sn_mva
    i_f = torch.sqrt(ifr**2 + ifi**2)
    i_t = torch.sqrt(itr**2 + iti**2)
    # base current on the from-bus voltage level: I_base[kA] = S/(sqrt3 * V)
    i_base = grid.sn_mva / (math.sqrt(3.0) * grid.vn_kv[grid.f_bus])
    loading = torch.maximum(i_f, i_t) * i_base / grid.max_i_ka * 100.0
    return pl_mw, loading
