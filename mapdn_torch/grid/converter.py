"""Import real MAPDN / pandapower grids into a :class:`Grid` (PyTorch port of
mapdn_tpu/grid/converter.py).

The reference ships its networks as pandapower pickles (``model.p``,
reference voltage_control_env.py:400-405).  pandapower is an optional
dependency (nothing else needs it): given a live net, or a pickle where
pandapower is installed, these helpers convert buses, lines, transformers
(as tap-ratio branches), fixed shunts, loads, sgens and zones into a
:class:`mapdn_torch.grid.model.Grid`, reordering buses so that the
ext-grid bus is index 0 (the solver's slack).  A net's tables are pandas
DataFrames; pandas is imported by whoever built the net, not here.
"""
from __future__ import annotations

import numpy as np
import torch

from mapdn_torch.grid.model import make_grid


def _zone_ids(zone_values):
    """Map the reference's zone labels ('main', 'zone1', ...) to ints with
    main = 0 (reference voltage_control_env.py:84 excludes the main zone)."""
    ids = np.zeros(len(zone_values), np.int32)
    for i, z in enumerate(zone_values):
        z = str(z)
        if z.startswith("zone"):
            ids[i] = int(z[4:])
    return ids


def _reject(cond, what, detail):
    """Refuse to convert a net feature the Grid cannot represent: a dropped
    element would give quietly wrong physics on a real ``model.p``."""
    if cond:
        raise ValueError(
            f"from_pandapower: unsupported net feature: {what} ({detail}). "
            "Extend mapdn_torch.grid.converter/make_grid rather than "
            "ignoring it — a dropped element changes the power flow.")


def _check_in_service(net, table):
    df = getattr(net, table, None)
    if df is not None and len(df) and "in_service" in df.columns:
        _reject((~df.in_service.astype(bool)).any(), f"{table}.in_service=False",
                "out-of-service elements would need removing from the Y-bus")


def from_pandapower(net, name="imported", dtype=torch.float32, device=None,
                    ignore_shift_degree=False):
    """Convert a live pandapower net; the grid's tensors live on ``device``
    (the GPU when None, as :func:`mapdn_torch.grid.make_case`).

    Returns (grid, base_load_p MW, base_load_q Mvar, sgen_p_max MW) like
    ``make_case``; sgen_p_max is the sgen ``p_mw`` column (the env takes
    s_max from the time series' maximum, as the reference does,
    voltage_control_env.py:515-521).

    Unrepresentable features raise instead of being dropped:
    out-of-service elements, several ext grids, a nonzero ext-grid
    ``va_degree`` and a nonzero trafo ``shift_degree``.  Fixed shunts
    (``net.shunt``) become Y-bus diagonal terms.
    ``ignore_shift_degree=True`` drops trafo phase shifts, which is what
    ``pp.runpp`` itself does on these distribution nets
    (``calculate_voltage_angles`` resolves to False below 70 kV), but it
    must be asked for.
    """
    sn_mva = float(getattr(net, "sn_mva", 1.0))
    f_hz = float(getattr(net, "f_hz", 50.0))

    for table in ("line", "trafo", "load", "sgen", "shunt", "ext_grid"):
        _check_in_service(net, table)
    for table in ("trafo3w", "impedance", "ward", "xward", "dcline", "gen",
                  "storage"):
        df = getattr(net, table, None)
        _reject(df is not None and len(df), f"net.{table} rows",
                "this element type has no Grid representation yet")

    _reject(len(net.ext_grid) != 1, "ext_grid count != 1",
            f"{len(net.ext_grid)} external grids; the solver has one slack")
    if "va_degree" in net.ext_grid.columns:
        _reject(abs(float(net.ext_grid.va_degree.iloc[0] or 0.0)) > 1e-9,
                "ext_grid.va_degree != 0",
                "the solver pins the slack angle at 0")

    bus_idx = list(net.bus.index)
    slack = int(net.ext_grid.bus.iloc[0])
    order = [slack] + [b for b in bus_idx if b != slack]
    pos = {b: i for i, b in enumerate(order)}

    vn_kv = net.bus.vn_kv.loc[order].to_numpy(float, copy=True)  # writable, for torch
    zones = _zone_ids(net.bus.zone.loc[order].to_numpy())

    f_bus, t_bus, r_ohm, x_ohm, c_nf, max_i, tap = [], [], [], [], [], [], []
    is_line = []
    for _, ln in net.line.iterrows():
        f_bus.append(pos[int(ln.from_bus)])
        t_bus.append(pos[int(ln.to_bus)])
        length = float(ln.length_km)
        par = float(getattr(ln, "parallel", 1) or 1)
        r_ohm.append(float(ln.r_ohm_per_km) * length / par)
        x_ohm.append(float(ln.x_ohm_per_km) * length / par)
        c_nf.append(float(ln.c_nf_per_km) * length * par)
        max_i.append(float(ln.max_i_ka) * par)
        tap.append(1.0)
        is_line.append(1.0)

    if getattr(net, "trafo", None) is not None and len(net.trafo):
        if not ignore_shift_degree and "shift_degree" in net.trafo.columns:
            shifts = net.trafo.shift_degree.fillna(0.0).astype(float)
            _reject((shifts.abs() > 1e-9).any(), "trafo.shift_degree != 0",
                    "phase shifts need a complex tap in build_ybus; pass "
                    "ignore_shift_degree=True to drop them like pp.runpp "
                    "does with calculate_voltage_angles=False")
        for _, tr in net.trafo.iterrows():
            # the short-circuit-data transformer model: a series branch whose
            # impedance is referred to the LV side (pandapower's convention),
            # with an HV-side off-nominal tap ratio; the magnetising branch
            # (i0/pfe) is ignored (negligible on these MV feeders)
            hv, lv = pos[int(tr.hv_bus)], pos[int(tr.lv_bus)]
            vn_lv = float(tr.vn_lv_kv)
            z_base = vn_lv**2 / float(tr.sn_mva)
            zk = float(tr.vk_percent) / 100.0 * z_base
            rk = float(tr.vkr_percent) / 100.0 * z_base
            xk = np.sqrt(max(zk**2 - rk**2, 0.0))
            ratio = (float(tr.vn_hv_kv) / vn_kv[hv]) / (vn_lv / vn_kv[lv])
            tp = float(getattr(tr, "tap_pos", 0) or 0)
            tn = float(getattr(tr, "tap_neutral", 0) or 0)
            st = float(getattr(tr, "tap_step_percent", 0) or 0)
            ratio *= 1.0 + (tp - tn) * st / 100.0
            # rk/xk are ohms on the LV side; make_grid per-units a branch on
            # its FROM (= HV) bus's base, so move them to that base:
            # z_pu = z_ohm_lv / (vn_lv_bus^2/sn) = z_ohm_lv*(vn_hv/vn_lv)^2
            #        / (vn_hv_bus^2/sn)
            base_xfer = (vn_kv[hv] / vn_kv[lv]) ** 2
            f_bus.append(hv)
            t_bus.append(lv)
            r_ohm.append(rk * base_xfer)
            x_ohm.append(xk * base_xfer)
            c_nf.append(0.0)
            max_i.append(float(tr.sn_mva) / (np.sqrt(3) * vn_lv))
            tap.append(ratio)
            # a trafo branch is left out of the reward's line loss (the
            # reference reads res_line only, voltage_control_env.py:599-600)
            is_line.append(0.0)

    load_bus = np.array([pos[int(b)] for b in net.load.bus], np.int32)
    load_p = net.load.p_mw.to_numpy(float)
    load_q = net.load.q_mvar.to_numpy(float)

    shunt_bus = shunt_p = shunt_q = None
    if getattr(net, "shunt", None) is not None and len(net.shunt):
        sh = net.shunt
        step = sh.step.to_numpy(float) if "step" in sh.columns else 1.0
        shunt_bus = np.array([pos[int(b)] for b in sh.bus], np.int32)
        shunt_p = sh.p_mw.to_numpy(float) * step
        shunt_q = sh.q_mvar.to_numpy(float) * step

    sgen_bus = np.array([pos[int(b)] for b in net.sgen.bus], np.int32)
    sgen_zone = _zone_ids(net.sgen.name.to_numpy())
    sgen_p = net.sgen.p_mw.to_numpy(float)

    vm_slack = float(net.ext_grid.vm_pu.iloc[0])
    grid = make_grid(
        name=name, vn_kv=vn_kv, f_bus=np.array(f_bus, np.int32),
        t_bus=np.array(t_bus, np.int32), r_ohm=np.array(r_ohm),
        x_ohm=np.array(x_ohm), c_nf=np.array(c_nf),
        max_i_ka=np.array(max_i), load_bus=load_bus, sgen_bus=sgen_bus,
        bus_zone=zones, sgen_zone=sgen_zone, slack_vm=vm_slack,
        sn_mva=sn_mva, f_hz=f_hz, tap=np.array(tap),
        is_line=np.array(is_line), shunt_bus=shunt_bus,
        shunt_p_mw=shunt_p, shunt_q_mvar=shunt_q, dtype=dtype, device=device)
    return grid, load_p, load_q, sgen_p


def load_pickle(path, name=None, dtype=torch.float32, device=None):
    """Load a MAPDN ``model.p`` (needs pandapower to unpickle)."""
    try:
        import pandapower as pp
    except ImportError as e:
        raise ImportError(
            "converting a pandapower pickle requires the optional "
            "pandapower dependency; the built-in cases "
            "(mapdn_torch.grid.make_case) need no extra packages") from e
    net = pp.from_pickle(path)
    return from_pandapower(net, name=name or path, dtype=dtype, device=device)
