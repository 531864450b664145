"""Immutable grid data model (PyTorch port of mapdn_tpu/grid/model.py).

The grid is built once in numpy float64 and converted to tensors of the
requested dtype on the requested device at the end; time-varying
quantities (load P/Q, PV P/Q) live in the environment state, never here.

Electrical model (identical to the JAX package): pi-model branches on a
common system base ``sn_mva``,

    z_base(line) = vn_kv(from_bus)^2 / sn_mva
    y_series     = 1 / (r_pu + j x_pu)
    b_charge     = 2 pi f * c_nf * 1e-9 * z_base

a dense Y-bus split into real G and imaginary B, the flat-start polar
Jacobian inverse ``j0_inv`` (the solver's frozen preconditioner) and the
exact row sums of G/B (cancellation-safe currents in float32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mapdn_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of one distribution network (tensors + metadata)."""

    # bus tables
    vn_kv: torch.Tensor          # (n_bus,) nominal voltage per bus [kV]
    bus_zone: torch.Tensor       # (n_bus,) int zone id; 0 = main (slack) zone
    slack_bus: torch.Tensor      # () int index of the ext-grid bus
    slack_vm: torch.Tensor       # () slack voltage setpoint [pu]
    # branch tables (lines + trafos unified)
    f_bus: torch.Tensor          # (n_branch,) from-bus index
    t_bus: torch.Tensor          # (n_branch,) to-bus index
    br_r: torch.Tensor           # (n_branch,) series resistance [pu]
    br_x: torch.Tensor           # (n_branch,) series reactance [pu]
    br_b: torch.Tensor           # (n_branch,) total charging susceptance [pu]
    tap: torch.Tensor            # (n_branch,) off-nominal tap ratio
    max_i_ka: torch.Tensor       # (n_branch,) thermal limit [kA]
    is_line: torch.Tensor        # (n_branch,) 1 line / 0 transformer
    # admittance matrix and solver constants
    g_mat: torch.Tensor          # (n_bus, n_bus) Re(Ybus) [pu]
    b_mat: torch.Tensor          # (n_bus, n_bus) Im(Ybus) [pu]
    j0_inv: torch.Tensor         # (2(n-1), 2(n-1)) flat-start Jacobian inverse
    rowsum_g: torch.Tensor       # (n_bus,) exact row sums of G
    rowsum_b: torch.Tensor       # (n_bus,) exact row sums of B
    ys_g: torch.Tensor           # (n_branch,) Re(1/(r+jx))
    ys_b: torch.Tensor           # (n_branch,) Im(1/(r+jx))
    # device incidence
    load_bus: torch.Tensor       # (n_load,)
    sgen_bus: torch.Tensor       # (n_sgen,)
    sgen_zone: torch.Tensor      # (n_sgen,)
    load_inc: torch.Tensor       # (n_bus, n_load) 0/1
    sgen_inc: torch.Tensor       # (n_bus, n_sgen) 0/1
    # static metadata
    name: str = "grid"
    sn_mva: float = 1.0
    f_hz: float = 50.0
    n_bus: int = 0
    n_branch: int = 0
    n_load: int = 0
    n_sgen: int = 0
    n_zone: int = 0              # excluding the main zone

    @property
    def dtype(self):
        return self.g_mat.dtype

    @property
    def device(self):
        return self.g_mat.device


def build_ybus(n_bus, f_bus, t_bus, r_pu, x_pu, b_pu, tap):
    """Dense Y-bus from pi-model branches (numpy float64, build time only).

        Y[f,f] += (ys + j b/2) / t^2     Y[t,t] += ys + j b/2
        Y[f,t] += -ys / t                Y[t,f] += -ys / t
    """
    ys = 1.0 / (np.asarray(r_pu, np.float64) + 1j * np.asarray(x_pu, np.float64))
    bc = 1j * np.asarray(b_pu, np.float64) / 2.0
    tap = np.asarray(tap, np.float64)

    y = np.zeros((n_bus, n_bus), dtype=np.complex128)
    yff = (ys + bc) / (tap * tap)
    ytt = ys + bc
    yft = -ys / tap
    np.add.at(y, (f_bus, f_bus), yff)
    np.add.at(y, (t_bus, t_bus), ytt)
    np.add.at(y, (f_bus, t_bus), yft)
    np.add.at(y, (t_bus, f_bus), yft)
    return y.real, y.imag


def make_grid(*, name, vn_kv, f_bus, t_bus, r_ohm, x_ohm, c_nf, max_i_ka,
              load_bus, sgen_bus, bus_zone, sgen_zone, slack_bus=0,
              slack_vm=1.0, sn_mva=1.0, f_hz=50.0, tap=None, is_line=None,
              shunt_bus=None, shunt_p_mw=None, shunt_q_mvar=None,
              dtype=torch.float32, device=None):
    """Assemble a :class:`Grid` from physical-unit branch tables.

    ``shunt_*``: optional fixed shunts consuming S = P + jQ at 1 pu, added to
    the Y-bus diagonal as (P - jQ)/sn_mva.
    """
    device = resolve_device(device)
    vn_kv = np.asarray(vn_kv, np.float64)
    f_bus = np.asarray(f_bus, np.int32)
    t_bus = np.asarray(t_bus, np.int32)
    n_bus = len(vn_kv)
    n_branch = len(f_bus)
    if tap is None:
        tap = np.ones(n_branch)
    if is_line is None:
        is_line = np.ones(n_branch)

    z_base = vn_kv[f_bus] ** 2 / sn_mva
    r_pu = np.asarray(r_ohm, np.float64) / z_base
    x_pu = np.asarray(x_ohm, np.float64) / z_base
    b_pu = 2.0 * np.pi * f_hz * np.asarray(c_nf, np.float64) * 1e-9 * z_base

    g_mat, b_mat = build_ybus(n_bus, f_bus, t_bus, r_pu, x_pu, b_pu, tap)

    if shunt_bus is not None and len(shunt_bus):
        sb = np.asarray(shunt_bus, np.int32)
        np.add.at(g_mat, (sb, sb), np.asarray(shunt_p_mw, np.float64) / sn_mva)
        np.add.at(b_mat, (sb, sb), -np.asarray(shunt_q_mvar, np.float64) / sn_mva)

    # flat-start polar Jacobian (scaled-dVm form) and its inverse:
    #   H = -B + diag(-q0), N = G + diag(p0), Jq = -G + diag(p0),
    #   L = -B + diag(q0)  with p0 = G.sum(1), q0 = -B.sum(1); bus 0 is slack
    p0 = g_mat.sum(axis=1)
    q0 = -b_mat.sum(axis=1)
    h0 = -b_mat - np.diag(q0)
    n0 = g_mat + np.diag(p0)
    jq0 = -g_mat + np.diag(p0)
    l0 = -b_mat + np.diag(q0)
    r_ = slice(1, None)
    j0 = np.block([[h0[r_, r_], n0[r_, r_]], [jq0[r_, r_], l0[r_, r_]]])
    j0_inv = np.linalg.inv(j0)

    ys = 1.0 / (r_pu + 1j * x_pu)

    load_bus = np.asarray(load_bus, np.int32)
    sgen_bus = np.asarray(sgen_bus, np.int32)
    n_load = len(load_bus)
    n_sgen = len(sgen_bus)
    load_inc = np.zeros((n_bus, n_load), np.float64)
    load_inc[load_bus, np.arange(n_load)] = 1.0
    sgen_inc = np.zeros((n_bus, n_sgen), np.float64)
    sgen_inc[sgen_bus, np.arange(n_sgen)] = 1.0

    bus_zone = np.asarray(bus_zone, np.int32)
    sgen_zone = np.asarray(sgen_zone, np.int32)

    a = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    return Grid(
        vn_kv=a(vn_kv), bus_zone=i(bus_zone), slack_bus=i(slack_bus),
        slack_vm=a(slack_vm),
        f_bus=i(f_bus), t_bus=i(t_bus), br_r=a(r_pu), br_x=a(x_pu),
        br_b=a(b_pu), tap=a(tap), max_i_ka=a(max_i_ka), is_line=a(is_line),
        g_mat=a(g_mat), b_mat=a(b_mat), j0_inv=a(j0_inv),
        rowsum_g=a(g_mat.sum(axis=1)), rowsum_b=a(b_mat.sum(axis=1)),
        ys_g=a(ys.real), ys_b=a(ys.imag),
        load_bus=i(load_bus), sgen_bus=i(sgen_bus), sgen_zone=i(sgen_zone),
        load_inc=a(load_inc), sgen_inc=a(sgen_inc),
        name=name, sn_mva=float(sn_mva), f_hz=float(f_hz), n_bus=n_bus,
        n_branch=n_branch, n_load=n_load, n_sgen=n_sgen,
        n_zone=int(bus_zone.max()))
