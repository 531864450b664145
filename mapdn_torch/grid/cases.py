"""Built-in grid scenarios (PyTorch port of mapdn_tpu/grid/cases.py).

* ``case33`` — the IEEE/Baran-Wu 33-bus feeder with 6 PV stations over 4
  zones (the reference's case33 scenario scale).
* ``case69`` — the Baran-Wu 69-bus feeder with 12 PVs over 6 zones.
* ``case141`` / ``case322`` — deterministic synthetic radial feeders with
  the reference's dimensions, calibrated with the float64 numpy oracle so
  the no-PV nominal solve lands at vm_min ~0.94.

The tables and builders are numpy, identical to the JAX package's, so every
grid array comes out bitwise equal in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from mapdn_torch.grid.model import build_ybus, make_grid
from mapdn_torch.pf.reference import nr_solve_ref

# ---------------------------------------------------------------------------
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


def _case33(dtype=torch.float32, device=None):
    br = np.array(_CASE33_BRANCHES, np.float64)
    f_bus = br[:, 0].astype(np.int32) - 1
    t_bus = br[:, 1].astype(np.int32) - 1
    n_bus = 33

    # 4 zones over the feeder arms + main zone {slack}:
    #   zone1: trunk buses 2..10, zone2: trunk tail 11..18,
    #   zone3: arms 19..22 and 23..25, zone4: arm 26..33   (1-indexed)
    bus_zone = np.zeros(n_bus, np.int32)
    for b in range(1, 10):
        bus_zone[b] = 1
    for b in range(10, 18):
        bus_zone[b] = 2
    for b in range(18, 25):
        bus_zone[b] = 3
    for b in range(25, 33):
        bus_zone[b] = 4

    load_bus = np.array([l[0] - 1 for l in _CASE33_LOADS], np.int32)
    load_p = np.array([l[1] for l in _CASE33_LOADS], np.float64) / 1000.0  # MW
    load_q = np.array([l[2] for l in _CASE33_LOADS], np.float64) / 1000.0  # Mvar

    # 6 PV stations / 4 zones (scenario scale per reference README.md:299-303)
    sgen_bus = np.array([8, 13, 17, 21, 24, 30], np.int32)  # 0-indexed buses
    sgen_zone = bus_zone[sgen_bus]
    # nameplate active-power capacity [MW]; total ~8.8 MW vs 3.715 MW load,
    # the high-penetration regime the benchmark targets
    sgen_p_max = np.full(len(sgen_bus), 8.8 / len(sgen_bus))

    grid = make_grid(
        name="case33",
        vn_kv=np.full(n_bus, 12.66),
        f_bus=f_bus,
        t_bus=t_bus,
        r_ohm=br[:, 2],
        x_ohm=br[:, 3],
        c_nf=np.zeros(len(f_bus)),
        max_i_ka=np.full(len(f_bus), 0.4),
        load_bus=load_bus,
        sgen_bus=sgen_bus,
        bus_zone=bus_zone,
        sgen_zone=sgen_zone,
        sn_mva=1.0,
        dtype=dtype,
        device=device,
    )
    return grid, load_p, load_q, sgen_p_max


# ---------------------------------------------------------------------------
# case69: Baran & Wu 69-bus radial feeder, 12.66 kV (IEEE Trans. Power
# Delivery 4(1), 1989).  Columns: from(1-idx), to(1-idx), R[ohm], X[ohm].
_CASE69_BRANCHES = [
    (1, 2, 0.0005, 0.0012), (2, 3, 0.0005, 0.0012), (3, 4, 0.0015, 0.0036),
    (4, 5, 0.0251, 0.0294), (5, 6, 0.3660, 0.1864), (6, 7, 0.3811, 0.1941),
    (7, 8, 0.0922, 0.0470), (8, 9, 0.0493, 0.0251), (9, 10, 0.8190, 0.2707),
    (10, 11, 0.1872, 0.0619), (11, 12, 0.7114, 0.2351), (12, 13, 1.0300, 0.3400),
    (13, 14, 1.0440, 0.3450), (14, 15, 1.0580, 0.3496), (15, 16, 0.1966, 0.0650),
    (16, 17, 0.3744, 0.1238), (17, 18, 0.0047, 0.0016), (18, 19, 0.3276, 0.1083),
    (19, 20, 0.2106, 0.0690), (20, 21, 0.3416, 0.1129), (21, 22, 0.0140, 0.0046),
    (22, 23, 0.1591, 0.0526), (23, 24, 0.3463, 0.1145), (24, 25, 0.7488, 0.2475),
    (25, 26, 0.3089, 0.1021), (26, 27, 0.1732, 0.0572),
    (3, 28, 0.0044, 0.0108), (28, 29, 0.0640, 0.1565), (29, 30, 0.3978, 0.1315),
    (30, 31, 0.0702, 0.0232), (31, 32, 0.3510, 0.1160), (32, 33, 0.8390, 0.2816),
    (33, 34, 1.7080, 0.5646), (34, 35, 1.4740, 0.4873),
    (3, 36, 0.0044, 0.0108), (36, 37, 0.0640, 0.1565), (37, 38, 0.1053, 0.1230),
    (38, 39, 0.0304, 0.0355), (39, 40, 0.0018, 0.0021), (40, 41, 0.7283, 0.8509),
    (41, 42, 0.3100, 0.3623), (42, 43, 0.0410, 0.0478), (43, 44, 0.0092, 0.0116),
    (44, 45, 0.1089, 0.1373), (45, 46, 0.0009, 0.0012),
    (4, 47, 0.0034, 0.0084), (47, 48, 0.0851, 0.2083), (48, 49, 0.2898, 0.7091),
    (49, 50, 0.0822, 0.2011),
    (8, 51, 0.0928, 0.0473), (51, 52, 0.3319, 0.1114),
    (9, 53, 0.1740, 0.0886), (53, 54, 0.2030, 0.1034), (54, 55, 0.2842, 0.1447),
    (55, 56, 0.2813, 0.1433), (56, 57, 1.5900, 0.5337), (57, 58, 0.7837, 0.2630),
    (58, 59, 0.3042, 0.1006), (59, 60, 0.3861, 0.1172), (60, 61, 0.5075, 0.2585),
    (61, 62, 0.0974, 0.0496), (62, 63, 0.1450, 0.0738), (63, 64, 0.7105, 0.3619),
    (64, 65, 1.0410, 0.5302),
    (11, 66, 0.2012, 0.0611), (66, 67, 0.0047, 0.0014),
    (12, 68, 0.7394, 0.2444), (68, 69, 0.0047, 0.0016),
]
# bus(1-idx), P[kW], Q[kvar] — 48 loads, total 3.802 MW / 2.695 Mvar
_CASE69_LOADS = [
    (6, 2.6, 2.2), (7, 40.4, 30.0), (8, 75.0, 54.0), (9, 30.0, 22.0),
    (10, 28.0, 19.0), (11, 145.0, 104.0), (12, 145.0, 104.0), (13, 8.0, 5.5),
    (14, 8.0, 5.5), (16, 45.5, 30.0), (17, 60.0, 35.0), (18, 60.0, 35.0),
    (20, 1.0, 0.6), (21, 114.0, 81.0), (22, 5.0, 3.5), (24, 28.0, 20.0),
    (26, 14.0, 10.0), (27, 14.0, 10.0), (28, 26.0, 18.6), (29, 26.0, 18.6),
    (33, 14.0, 10.0), (34, 19.5, 14.0), (35, 6.0, 4.0), (36, 26.0, 18.55),
    (37, 26.0, 18.55), (39, 24.0, 17.0), (40, 24.0, 17.0), (41, 1.2, 1.0),
    (43, 6.0, 4.3), (45, 39.22, 26.3), (46, 39.22, 26.3), (48, 79.0, 56.4),
    (49, 384.7, 274.5), (50, 384.7, 274.5), (51, 40.5, 28.3), (52, 3.6, 2.7),
    (53, 4.35, 3.5), (54, 26.4, 19.0), (55, 24.0, 17.2), (59, 100.0, 72.0),
    (61, 1244.0, 888.0), (62, 32.0, 23.0), (64, 227.0, 162.0), (65, 59.0, 42.0),
    (66, 18.0, 13.0), (67, 18.0, 13.0), (68, 28.0, 20.0), (69, 28.0, 20.0),
]


def _case69(dtype=torch.float32, device=None):
    br = np.array(_CASE69_BRANCHES, np.float64)
    f_bus = br[:, 0].astype(np.int32) - 1
    t_bus = br[:, 1].astype(np.int32) - 1
    n_bus = 69

    # 6 zones over the feeder's natural arms (1-indexed bus ranges):
    #   zone1 trunk head 2..14, zone2 trunk tail 15..27,
    #   zone3 lateral 28..35, zone4 laterals 36..46 + 47..50,
    #   zone5 lateral 53..65, zone6 laterals 51..52 + 66..67 + 68..69
    bus_zone = np.zeros(n_bus, np.int32)
    for lo, hi, z in [(2, 14, 1), (15, 27, 2), (28, 35, 3), (36, 50, 4),
                      (53, 65, 5), (51, 52, 6), (66, 69, 6)]:
        bus_zone[lo - 1:hi] = z

    load_bus = np.array([l[0] - 1 for l in _CASE69_LOADS], np.int32)
    load_p = np.array([l[1] for l in _CASE69_LOADS], np.float64) / 1000.0
    load_q = np.array([l[2] for l in _CASE69_LOADS], np.float64) / 1000.0

    # 12 PV stations over the 6 zones, reference-style high penetration
    # (case33: 8.8 MW PV vs 3.7 MW load); deep buses see the largest
    # voltage swings, so PVs sit mid/end-of-arm like the reference's
    sgen_bus = np.array([10, 13, 20, 26, 31, 34, 40, 49, 57, 63, 66, 68],
                        np.int32)  # 0-indexed
    sgen_zone = bus_zone[sgen_bus]
    sgen_p_max = np.full(len(sgen_bus), 9.0 / len(sgen_bus))

    grid = make_grid(
        name="case69",
        vn_kv=np.full(n_bus, 12.66),
        f_bus=f_bus,
        t_bus=t_bus,
        r_ohm=br[:, 2],
        x_ohm=br[:, 3],
        c_nf=np.zeros(len(f_bus)),
        max_i_ka=np.full(len(f_bus), 0.4),
        load_bus=load_bus,
        sgen_bus=sgen_bus,
        bus_zone=bus_zone,
        sgen_zone=sgen_zone,
        sn_mva=1.0,
        dtype=dtype,
        device=device,
    )
    return grid, load_p, load_q, sgen_p_max


def _synthetic_radial(
    name,
    n_bus,
    n_load,
    n_sgen,
    n_zone,
    vn_kv,
    total_load_mw,
    pv_penetration,
    seed,
    dtype=torch.float32,
    device=None,
):
    """Deterministic synthetic radial feeder with given dimensions.

    A random tree over ``n_bus`` buses (each bus b>=1 attaches to a random
    earlier bus with strong preference for the immediate predecessor, which
    yields feeder-like chains with occasional laterals), MV-cable impedances,
    loads spread over the buses (possibly several per bus, as in the
    reference's case322 with 337 loads on 322 buses), zones as contiguous
    subtree chunks, and PVs spread across zones (>=1 per zone so the
    decentralised task mode is well-defined).
    """
    rng = np.random.RandomState(seed)
    parents = np.zeros(n_bus, np.int32)
    for b in range(1, n_bus):
        parents[b] = b - 1 if (b == 1 or rng.rand() < 0.7) else rng.randint(1, b)
    f_bus = parents[1:]
    t_bus = np.arange(1, n_bus, dtype=np.int32)

    # zones: contiguous index chunks over non-slack buses (zone id 1..n_zone)
    bus_zone = np.zeros(n_bus, np.int32)
    chunk = (n_bus - 1) / n_zone
    for i, b in enumerate(range(1, n_bus)):
        bus_zone[b] = min(int(i / chunk) + 1, n_zone)

    load_bus = np.sort(rng.choice(np.arange(1, n_bus), size=n_load, replace=n_load > n_bus - 1))
    w = rng.dirichlet(np.ones(n_load) * 4.0)
    load_p = w * total_load_mw
    load_q = load_p * rng.uniform(0.25, 0.5, n_load)  # power factor ~0.9..0.97

    # conductor sizing: impedance inversely proportional to the power carried
    # (trunk cables are thick, laterals thin), then a global multiplier is
    # calibrated against the float64 oracle so the no-PV nominal solve lands
    # at vm_min ~ 0.94 — a realistic, feasible-with-margin feeder
    p_bus_load = np.zeros(n_bus)
    np.add.at(p_bus_load, load_bus, load_p)
    p_down = np.zeros(n_bus)
    for b in range(n_bus - 1, 0, -1):
        p_down[b] += p_bus_load[b]
        p_down[parents[b]] += p_down[b]
    length = rng.uniform(0.3, 1.2, n_bus - 1)
    base_r = rng.uniform(0.15, 0.45, n_bus - 1) * length
    xr = rng.uniform(0.6, 0.9, n_bus - 1)  # x/r ratio of MV cable
    size = np.clip(p_down[t_bus] / (total_load_mw / n_zone), 0.05, None)
    r_ohm = base_r / size
    x_ohm = r_ohm * xr

    def vm_min_for(mult):
        z_base = vn_kv**2 / 1.0
        g, b = build_ybus(n_bus, f_bus, t_bus, mult * r_ohm / z_base,
                          mult * x_ohm / z_base, np.zeros(n_bus - 1),
                          np.ones(n_bus - 1))
        p = np.zeros(n_bus)
        q = np.zeros(n_bus)
        np.add.at(p, load_bus, -load_p)
        np.add.at(q, load_bus, -load_q)
        vm, _, conv, _ = nr_solve_ref(g, b, p, q, tol=1e-10)
        return vm.min() if conv else 0.0

    lo, hi = 1e-4, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if vm_min_for(mid) > 0.94:
            lo = mid
        else:
            hi = mid
    mult = lo
    r_ohm = mult * r_ohm
    x_ohm = mult * x_ohm

    # PVs: at least one per zone, remainder spread round-robin over zones
    zones = list(range(1, n_zone + 1))
    sgen_zone_list = [zones[i % n_zone] for i in range(n_sgen)]
    sgen_bus = np.zeros(n_sgen, np.int32)
    for i, z in enumerate(sgen_zone_list):
        zone_buses = np.nonzero(bus_zone == z)[0]
        sgen_bus[i] = rng.choice(zone_buses)
    sgen_zone = np.array(sgen_zone_list, np.int32)
    total_pv = pv_penetration * total_load_mw
    sgen_p_max = rng.dirichlet(np.ones(n_sgen) * 8.0) * total_pv

    grid = make_grid(
        name=name,
        vn_kv=np.full(n_bus, vn_kv),
        f_bus=f_bus,
        t_bus=t_bus,
        r_ohm=r_ohm,
        x_ohm=x_ohm,
        c_nf=np.zeros(n_bus - 1),
        max_i_ka=np.full(n_bus - 1, 0.4),
        load_bus=load_bus,
        sgen_bus=sgen_bus,
        bus_zone=bus_zone,
        sgen_zone=sgen_zone,
        sn_mva=1.0,
        dtype=dtype,
        device=device,
    )
    return grid, load_p, load_q, sgen_p_max


def _case141(dtype=torch.float32, device=None):
    # reference scenario scale: 141 buses / 84 loads / 9 regions / 22 PVs
    return _synthetic_radial(
        "case141", 141, 84, 22, 9, vn_kv=12.5, total_load_mw=12.19,
        pv_penetration=2.0, seed=141, dtype=dtype, device=device)


def _case322(dtype=torch.float32, device=None):
    # reference scenario scale: 322 buses / 337 loads / 22 regions / 38 PVs
    return _synthetic_radial(
        "case322", 322, 337, 38, 22, vn_kv=20.0, total_load_mw=1.5 * 12.19,
        pv_penetration=2.5, seed=322, dtype=dtype, device=device)


CASES = {
    "case33": _case33,
    "case69": _case69,
    "case141": _case141,
    "case322": _case322,
}
# aliases matching the reference's CLI scenario names (train.py:33-42)
for _alias, _base in [
    ("case33_3min_final", "case33"),
    ("case141_3min_final", "case141"),
    ("case322_3min_final", "case322"),
]:
    CASES[_alias] = CASES[_base]


def make_case(name, dtype=torch.float32, device=None):
    """Return (grid, base_load_p MW, base_load_q Mvar, sgen_p_max MW); the
    grid's tensors live on ``device`` (the GPU when None)."""
    if name not in CASES:
        raise KeyError(f"unknown case '{name}'; available: {sorted(CASES)}")
    return CASES[name](dtype=dtype, device=device)
