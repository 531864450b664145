"""Grids and time series of the plain reference, in numpy float64.

A frozen copy of the tables and builders the configurations name (the
33-bus Baran-Wu feeder, the deterministic synthetic radial feeders, the
synthetic PV and demand series), so that the reference makes its inputs
again from the configuration file alone and reads nothing the program
made.  Only what the environment needs is kept: the bus admittance
matrix, the device incidences, the zones and the base powers.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RefGrid:
    g: np.ndarray             # (n, n) Re(Ybus) [pu]
    b: np.ndarray             # (n, n) Im(Ybus) [pu]
    load_bus: np.ndarray      # (n_load,)
    sgen_bus: np.ndarray      # (n_sgen,)
    bus_zone: np.ndarray      # (n,) zone id, 0 the slack zone
    sgen_zone: np.ndarray     # (n_sgen,)
    base_load_p: np.ndarray   # (n_load,) MW
    base_load_q: np.ndarray   # (n_load,) Mvar
    sgen_p_max: np.ndarray    # (n_sgen,) MW
    sn_mva: float = 1.0
    slack_vm: float = 1.0

    @property
    def n_bus(self):
        return self.g.shape[0]


@dataclasses.dataclass(frozen=True)
class RefSeries:
    pv: np.ndarray            # (T, n_sgen) MW
    load_p: np.ndarray        # (T, n_load) MW
    load_q: np.ndarray        # (T, n_load) Mvar
    pv_std: np.ndarray        # (n_sgen,) column std / 100
    load_p_std: np.ndarray
    load_q_std: np.ndarray
    s_max: np.ndarray         # (n_sgen,) 1.2 * max PV
    time_delta: int = 3


def build_ybus(n_bus, f_bus, t_bus, r_pu, x_pu, b_pu, tap):
    """Dense Y-bus of pi-model branches: (G, B)."""
    ys = 1.0 / (np.asarray(r_pu, np.float64) + 1j * np.asarray(x_pu, np.float64))
    bc = 1j * np.asarray(b_pu, np.float64) / 2.0
    tap = np.asarray(tap, np.float64)
    y = np.zeros((n_bus, n_bus), dtype=np.complex128)
    yft = -ys / tap
    np.add.at(y, (f_bus, f_bus), (ys + bc) / (tap * tap))
    np.add.at(y, (t_bus, t_bus), ys + bc)
    np.add.at(y, (f_bus, t_bus), yft)
    np.add.at(y, (t_bus, f_bus), yft)
    return y.real, y.imag


def nr_oracle(g_mat, b_mat, p_inj, q_inj, slack_vm=1.0, tol=1e-8, max_iter=30):
    """One complex-arithmetic polar NR solve (MATPOWER's dSbus_dV), bus 0
    slack; used only to calibrate the synthetic feeders' impedances."""
    ybus = np.asarray(g_mat) + 1j * np.asarray(b_mat)
    n = ybus.shape[0]
    pq = np.arange(1, n)
    sbus = np.asarray(p_inj) + 1j * np.asarray(q_inj)
    v = np.ones(n, np.complex128)
    v[0] = slack_vm
    converged = False
    for _ in range(max_iter):
        ibus = ybus @ v
        mis = v * np.conj(ibus) - sbus
        f = np.concatenate([mis[pq].real, mis[pq].imag])
        if np.max(np.abs(f)) < tol:
            converged = True
            break
        diag_v, diag_i = np.diag(v), np.diag(ibus)
        diag_vn = np.diag(v / np.abs(v))
        ds_dva = 1j * diag_v @ np.conj(diag_i - ybus @ diag_v)
        ds_dvm = diag_v @ np.conj(ybus @ diag_vn) + np.conj(diag_i) @ diag_vn
        jac = np.block([[ds_dva[np.ix_(pq, pq)].real, ds_dvm[np.ix_(pq, pq)].real],
                        [ds_dva[np.ix_(pq, pq)].imag, ds_dvm[np.ix_(pq, pq)].imag]])
        dx = np.linalg.solve(jac, f)
        va, vm = np.angle(v), np.abs(v)
        va[pq] -= dx[:len(pq)]
        vm[pq] -= dx[len(pq):]
        v = vm * np.exp(1j * va)
    return np.abs(v), np.angle(v), converged


def _grid(n_bus, f_bus, t_bus, r_ohm, x_ohm, vn_kv, load_bus, sgen_bus, bus_zone,
          sgen_zone, load_p, load_q, sgen_p_max):
    """A RefGrid of physical-unit branch tables (no charging, unit taps,
    1 MVA base)."""
    z_base = vn_kv ** 2
    g, b = build_ybus(n_bus, f_bus, t_bus, np.asarray(r_ohm) / z_base,
                      np.asarray(x_ohm) / z_base, np.zeros(len(f_bus)),
                      np.ones(len(f_bus)))
    return RefGrid(g=g, b=b, load_bus=np.asarray(load_bus, np.int64),
                   sgen_bus=np.asarray(sgen_bus, np.int64),
                   bus_zone=np.asarray(bus_zone, np.int64),
                   sgen_zone=np.asarray(sgen_zone, np.int64),
                   base_load_p=np.asarray(load_p, np.float64),
                   base_load_q=np.asarray(load_q, np.float64),
                   sgen_p_max=np.asarray(sgen_p_max, np.float64))


# case33: Baran & Wu 33-bus radial feeder, 12.66 kV.
# Columns: from(1-idx), to(1-idx), R[ohm], X[ohm]
_CASE33_BRANCHES = [
    (1, 2, 0.0922, 0.0470),
    (2, 3, 0.4930, 0.2511),
    (3, 4, 0.3660, 0.1864),
    (4, 5, 0.3811, 0.1941),
    (5, 6, 0.8190, 0.7070),
    (6, 7, 0.1872, 0.6188),
    (7, 8, 0.7114, 0.2351),
    (8, 9, 1.0300, 0.7400),
    (9, 10, 1.0440, 0.7400),
    (10, 11, 0.1966, 0.0650),
    (11, 12, 0.3744, 0.1238),
    (12, 13, 1.4680, 1.1550),
    (13, 14, 0.5416, 0.7129),
    (14, 15, 0.5910, 0.5260),
    (15, 16, 0.7463, 0.5450),
    (16, 17, 1.2890, 1.7210),
    (17, 18, 0.7320, 0.5740),
    (2, 19, 0.1640, 0.1565),
    (19, 20, 1.5042, 1.3554),
    (20, 21, 0.4095, 0.4784),
    (21, 22, 0.7089, 0.9373),
    (3, 23, 0.4512, 0.3083),
    (23, 24, 0.8980, 0.7091),
    (24, 25, 0.8960, 0.7011),
    (6, 26, 0.2030, 0.1034),
    (26, 27, 0.2842, 0.1447),
    (27, 28, 1.0590, 0.9337),
    (28, 29, 0.8042, 0.7006),
    (29, 30, 0.5075, 0.2585),
    (30, 31, 0.9744, 0.9630),
    (31, 32, 0.3105, 0.3619),
    (32, 33, 0.3410, 0.5302),
]
# bus(1-idx), P[kW], Q[kvar] — loads at buses 2..33 (32 loads)
_CASE33_LOADS = [
    (2, 100, 60), (3, 90, 40), (4, 120, 80), (5, 60, 30), (6, 60, 20),
    (7, 200, 100), (8, 200, 100), (9, 60, 20), (10, 60, 20), (11, 45, 30),
    (12, 60, 35), (13, 60, 35), (14, 120, 80), (15, 60, 10), (16, 60, 20),
    (17, 60, 20), (18, 90, 40), (19, 90, 40), (20, 90, 40), (21, 90, 40),
    (22, 90, 40), (23, 90, 50), (24, 420, 200), (25, 420, 200), (26, 60, 25),
    (27, 60, 25), (28, 60, 20), (29, 120, 70), (30, 200, 600), (31, 150, 70),
    (32, 210, 100), (33, 60, 40),
]

def case33():
    """The 33-bus feeder with 6 PV stations over 4 zones."""
    br = np.array(_CASE33_BRANCHES, np.float64)
    f_bus = br[:, 0].astype(np.int64) - 1
    t_bus = br[:, 1].astype(np.int64) - 1
    bus_zone = np.zeros(33, np.int64)
    bus_zone[1:10], bus_zone[10:18], bus_zone[18:25], bus_zone[25:33] = 1, 2, 3, 4
    load_bus = np.array([l[0] - 1 for l in _CASE33_LOADS])
    load_p = np.array([l[1] for l in _CASE33_LOADS], np.float64) / 1000.0
    load_q = np.array([l[2] for l in _CASE33_LOADS], np.float64) / 1000.0
    sgen_bus = np.array([8, 13, 17, 21, 24, 30])
    return _grid(33, f_bus, t_bus, br[:, 2], br[:, 3], 12.66, load_bus, sgen_bus,
                 bus_zone, bus_zone[sgen_bus], load_p, load_q,
                 np.full(6, 8.8 / 6))


def synthetic_radial(n_bus, n_load, n_sgen, n_zone, vn_kv, total_load_mw,
                     pv_penetration, seed):
    """A deterministic radial feeder of the given dimensions: a random tree
    that mostly chains, loads by a Dirichlet draw, impedances sized by the
    power carried and scaled so that the no-PV solve's lowest voltage is
    about 0.94, zones as index chunks, at least one PV a zone."""
    rng = np.random.RandomState(seed)
    parents = np.zeros(n_bus, np.int32)
    for b in range(1, n_bus):
        parents[b] = b - 1 if (b == 1 or rng.rand() < 0.7) else rng.randint(1, b)
    f_bus = parents[1:]
    t_bus = np.arange(1, n_bus, dtype=np.int32)
    bus_zone = np.zeros(n_bus, np.int32)
    chunk = (n_bus - 1) / n_zone
    for i, b in enumerate(range(1, n_bus)):
        bus_zone[b] = min(int(i / chunk) + 1, n_zone)
    load_bus = np.sort(rng.choice(np.arange(1, n_bus), size=n_load,
                                  replace=n_load > n_bus - 1))
    w = rng.dirichlet(np.ones(n_load) * 4.0)
    load_p = w * total_load_mw
    load_q = load_p * rng.uniform(0.25, 0.5, n_load)
    p_bus_load = np.zeros(n_bus)
    np.add.at(p_bus_load, load_bus, load_p)
    p_down = np.zeros(n_bus)
    for b in range(n_bus - 1, 0, -1):
        p_down[b] += p_bus_load[b]
        p_down[parents[b]] += p_down[b]
    length = rng.uniform(0.3, 1.2, n_bus - 1)
    base_r = rng.uniform(0.15, 0.45, n_bus - 1) * length
    xr = rng.uniform(0.6, 0.9, n_bus - 1)
    size = np.clip(p_down[t_bus] / (total_load_mw / n_zone), 0.05, None)
    r_ohm = base_r / size
    x_ohm = r_ohm * xr

    def vm_min_for(mult):
        g, b = build_ybus(n_bus, f_bus, t_bus, mult * r_ohm / vn_kv ** 2,
                          mult * x_ohm / vn_kv ** 2, np.zeros(n_bus - 1),
                          np.ones(n_bus - 1))
        p = np.zeros(n_bus)
        q = np.zeros(n_bus)
        np.add.at(p, load_bus, -load_p)
        np.add.at(q, load_bus, -load_q)
        vm, _, conv = nr_oracle(g, b, p, q, tol=1e-10)
        return vm.min() if conv else 0.0

    lo, hi = 1e-4, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if vm_min_for(mid) > 0.94:
            lo = mid
        else:
            hi = mid
    r_ohm, x_ohm = lo * r_ohm, lo * x_ohm
    sgen_zone = np.array([i % n_zone + 1 for i in range(n_sgen)], np.int32)
    sgen_bus = np.zeros(n_sgen, np.int32)
    for i, z in enumerate(sgen_zone):
        sgen_bus[i] = rng.choice(np.nonzero(bus_zone == z)[0])
    sgen_p_max = rng.dirichlet(np.ones(n_sgen) * 8.0) * (pv_penetration * total_load_mw)
    return _grid(n_bus, f_bus, t_bus, r_ohm, x_ohm, vn_kv, load_bus, sgen_bus,
                 bus_zone, sgen_zone, load_p, load_q, sgen_p_max)


def make_grid(spec):
    """The grid a configuration's ``grid`` entry names."""
    spec = dict(spec)
    builder = spec.pop("builder")
    if builder == "case33":
        return case33()
    if builder == "synthetic_radial":
        return synthetic_radial(**spec)
    raise ValueError(f"unknown grid builder {builder!r}")


def synthetic_series(grid, days=40, time_delta=3, seed=0):
    """MAPDN-like series: a clear-sky PV bell times AR(1) daily weather times
    cloud noise, a double-peak demand with weekly modulation and noise;
    noise scales are the columns' std / 100, inverter capacity 1.2 x max
    PV."""
    rng = np.random.RandomState(seed)
    steps_per_day = 24 * 60 // time_delta
    t = np.arange(days * steps_per_day)
    hour = (t % steps_per_day) * time_delta / 60.0
    day = t // steps_per_day
    solar = np.clip(np.sin(np.pi * (hour - 6.0) / 12.0), 0.0, None) ** 1.3
    weather = np.empty(days)
    w = 0.7
    for d in range(days):
        w = np.clip(0.6 * w + 0.4 * rng.uniform(0.15, 1.0), 0.05, 1.0)
        weather[d] = w
    n_sgen = len(grid.sgen_p_max)
    cloud = np.clip(1.0 - 0.25 * np.abs(rng.randn(len(t), n_sgen)), 0.2, 1.0)
    pv = (solar[:, None] * weather[day][:, None] * cloud) * grid.sgen_p_max[None, :]
    shape = (0.55 + 0.25 * np.exp(-0.5 * ((hour - 9.0) / 2.5) ** 2)
             + 0.45 * np.exp(-0.5 * ((hour - 19.5) / 2.0) ** 2))
    shape = shape * (1.0 - 0.12 * ((day % 7) >= 5).astype(np.float64))
    n_load = len(grid.base_load_p)
    jitter_p = 1.0 + 0.05 * rng.randn(len(t), n_load)
    jitter_q = 1.0 + 0.05 * rng.randn(len(t), n_load)
    load_p = np.clip(shape[:, None] * jitter_p, 0.05, None) * grid.base_load_p[None, :]
    load_q = np.clip(shape[:, None] * jitter_q, 0.05, None) * grid.base_load_q[None, :]
    return RefSeries(pv=pv, load_p=load_p, load_q=load_q,
                     pv_std=pv.std(axis=0) / 100.0,
                     load_p_std=load_p.std(axis=0) / 100.0,
                     load_q_std=load_q.std(axis=0) / 100.0,
                     s_max=1.2 * pv.max(axis=0), time_delta=time_delta)
