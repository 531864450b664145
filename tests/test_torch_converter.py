"""mapdn_torch's pandapower import (``mapdn_torch.grid.converter``) at
float64 on the CPU: the eight tests of tests/test_converter.py on the port,
on that file's mock net (pandas tables with pandapower's columns: a 110 kV
slack at a non-zero label, a transformer with an off-neutral tap, a
parallel line, zones, shunts), against the same independently assembled
Y-bus and golden fixture; every field of the port's imported ``Grid``
against the JAX package's; and that ``chip_smoke.py``'s feeder, which the
card imports, is that mock net."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.grid.converter import from_pandapower, load_pickle
from mapdn_torch.pf.newton import nr_solve_dense
from mapdn_tpu.grid.converter import from_pandapower as jax_from_pandapower
from test_converter import make_mock_net, make_mock_net_with_shunt, reference_ybus

torch.set_num_threads(1)

ORDER = [7, 3, 11, 12, 15]       # the mock net's labels, slack first


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


def _import(net):
    return from_pandapower(net, dtype=torch.float64, device="cpu")


def _np(x):
    return x.cpu().numpy()


def _injections(grid, load_p, load_q, sgen_p):
    """Bus injections [pu] of the net's base loads and sgens."""
    n = grid.n_bus
    p = np.zeros(n)
    q = np.zeros(n)
    np.add.at(p, _np(grid.load_bus), -load_p)
    np.add.at(q, _np(grid.load_bus), -load_q)
    np.add.at(p, _np(grid.sgen_bus), sgen_p)
    return torch.as_tensor(p / grid.sn_mva), torch.as_tensor(q / grid.sn_mva)


def test_import_reorders_slack_and_maps_tables():
    net = make_mock_net()
    grid, load_p, load_q, sgen_p = _import(net)

    # ext-grid bus (label 7) must be index 0; others keep relative order
    assert float(grid.vn_kv[0]) == 110.0
    assert float(grid.slack_vm) == 1.02
    np.testing.assert_array_equal(_np(grid.bus_zone), [0, 0, 1, 1, 2])
    assert grid.n_bus == 5 and grid.n_branch == 4
    assert grid.n_zone == 2

    # loads/sgens repositioned: labels 11,12,15 -> indices 2,3,4
    np.testing.assert_array_equal(_np(grid.load_bus), [2, 3, 4])
    np.testing.assert_array_equal(_np(grid.sgen_bus), [3, 4])
    np.testing.assert_array_equal(_np(grid.sgen_zone), [1, 2])
    np.testing.assert_allclose(load_p, [1.5, 0.8, 1.1])
    np.testing.assert_allclose(load_q, [0.5, 0.25, 0.3])
    np.testing.assert_allclose(sgen_p, [0.6, 0.9])

    # parallel line (row 1): r halved, charging & thermal limit doubled
    z_base = 12.66**2 / net.sn_mva
    r_pu = _np(grid.br_r)
    assert r_pu[1] == pytest.approx(0.3 * 0.7 / 2 / z_base, rel=1e-12)
    assert float(grid.max_i_ka[1]) == pytest.approx(0.5, rel=1e-12)

    # trafo branch (last row): impedance per-united on the LV-bus base,
    # tap ratio includes rating mismatch and the off-neutral tap
    zk = 0.11 * 12.5**2 / 25.0
    rk = 0.0042 * 12.5**2 / 25.0
    xk = np.sqrt(zk**2 - rk**2)
    assert r_pu[3] == pytest.approx(rk / z_base, rel=1e-12)
    assert _np(grid.br_x)[3] == pytest.approx(xk / z_base, rel=1e-12)
    want_ratio = (110.0 / 110.0) / (12.5 / 12.66) * (1 + 2 * 1.5 / 100)
    assert float(grid.tap[3]) == pytest.approx(want_ratio, rel=1e-12)


def test_imported_grid_ybus_matches_independent_assembly():
    grid, *_ = _import(make_mock_net())
    y_ref = reference_ybus(make_mock_net(), ORDER)
    np.testing.assert_allclose(_np(grid.g_mat), y_ref.real, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(grid.b_mat), y_ref.imag, rtol=1e-12, atol=1e-12)


def test_imported_grid_solves_and_balances_power():
    """Import -> float64 NR solve -> complex power balance against the
    independent Y-bus at every PQ bus (1e-9 pu)."""
    net = make_mock_net()
    grid, load_p, load_q, sgen_p = _import(net)
    p, q = _injections(grid, load_p, load_q, sgen_p)
    res = nr_solve_dense(grid, p, q, tol=1e-10)
    assert bool(res.converged)

    v = _np(res.vm) * np.exp(1j * _np(res.va))
    assert abs(v[0] - 1.02) < 1e-12                      # slack held
    s = v * np.conj(reference_ybus(net, ORDER) @ v)      # independent KCL
    np.testing.assert_allclose(s.real[1:], p.numpy()[1:], atol=1e-9)
    np.testing.assert_allclose(s.imag[1:], q.numpy()[1:], atol=1e-9)


def test_golden_fixture_import_and_solve_parity():
    """The stored float64 oracle voltages of the mock feeder
    (tests/fixtures/golden_feeder.json), to 1e-8."""
    path = os.path.join(os.path.dirname(__file__), "fixtures", "golden_feeder.json")
    with open(path) as f:
        gold = json.load(f)
    grid, load_p, load_q, sgen_p = _import(make_mock_net())
    res = nr_solve_dense(grid, *_injections(grid, load_p, load_q, sgen_p), tol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(_np(res.vm), gold["vm"], atol=1e-8)
    np.testing.assert_allclose(_np(res.va), gold["va"], atol=1e-8)
    np.testing.assert_allclose(float(torch.sum(res.pl_mw)), gold["total_loss_mw"], atol=1e-8)


def test_shunt_import_ybus_and_power_balance():
    """net.shunt rows land on the Y-bus diagonal (Y += (P - jQ)/sn per unit
    step) and the solved voltages satisfy an independently assembled KCL
    that models the shunts as voltage-dependent loads."""
    net = make_mock_net_with_shunt()
    grid, load_p, load_q, sgen_p = _import(net)

    y_ref = reference_ybus(net, ORDER)
    pos = {b: i for i, b in enumerate(ORDER)}
    for _, sh in net.shunt.iterrows():
        k = pos[int(sh.bus)]
        y_ref[k, k] += (sh.p_mw - 1j * sh.q_mvar) * sh.step / net.sn_mva
    np.testing.assert_allclose(_np(grid.g_mat), y_ref.real, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(grid.b_mat), y_ref.imag, rtol=1e-12, atol=1e-12)

    p, q = _injections(grid, load_p, load_q, sgen_p)
    res = nr_solve_dense(grid, p, q, tol=1e-10)
    assert bool(res.converged)
    v = _np(res.vm) * np.exp(1j * _np(res.va))
    s = v * np.conj(y_ref @ v)
    np.testing.assert_allclose(s.real[1:], p.numpy()[1:], atol=1e-9)
    np.testing.assert_allclose(s.imag[1:], q.numpy()[1:], atol=1e-9)
    # the capacitor must raise the local voltage against the no-shunt net
    grid0, *_ = _import(make_mock_net())
    res0 = nr_solve_dense(grid0, p, q, tol=1e-10)
    assert float(res.vm[2]) > float(res0.vm[2])


def test_unrepresentable_features_raise_not_drop():
    net = make_mock_net()
    net.trafo["shift_degree"] = [150.0]
    with pytest.raises(ValueError, match="shift_degree"):
        _import(net)
    # explicit opt-in reproduces pp.runpp's calculate_voltage_angles=False
    grid, *_ = from_pandapower(net, device="cpu", ignore_shift_degree=True)
    assert grid.n_branch == 4

    net = make_mock_net()
    net.ext_grid["va_degree"] = [30.0]
    with pytest.raises(ValueError, match="va_degree"):
        _import(net)

    net = make_mock_net()
    net.line["in_service"] = [True, False, True]
    with pytest.raises(ValueError, match="in_service"):
        _import(net)

    net = make_mock_net()
    net.ext_grid = pd.DataFrame({"bus": [7, 3], "vm_pu": [1.02, 1.0]})
    with pytest.raises(ValueError, match="ext_grid"):
        _import(net)

    net = make_mock_net()
    net.trafo3w = pd.DataFrame({"hv_bus": [7]})
    with pytest.raises(ValueError, match="mapdn_torch.grid.converter"):
        _import(net)


def test_load_pickle_without_pandapower_raises_helpfully():
    with pytest.raises(ImportError, match="pandapower"):
        load_pickle("/nonexistent/model.p", device="cpu")


def test_reward_line_loss_excludes_trafo_branches():
    """The reference's line-loss reward term reads res_line only (lines, not
    trafos; voltage_control_env.py:599-600): on the imported grid (3 lines
    and 1 trafo) the env's total_line_loss is the sum of the line branches'
    losses, strictly below the all-branch sum."""
    from mapdn_torch.envs.timeseries import synthetic_dataset
    from mapdn_torch.envs.voltage_control import EnvConfig, VoltageControlEnv

    grid, load_p, load_q, sgen_p = _import(make_mock_net())
    np.testing.assert_array_equal(_np(grid.is_line), [1, 1, 1, 0])
    ts = synthetic_dataset(load_p, load_q, sgen_p, days=2, seed=0,
                           dtype=torch.float64, device="cpu")
    env = VoltageControlEnv(grid, ts, EnvConfig(episode_limit=8))
    state, _, _ = env.manual_reset(0, 12, 0)
    out = env.step(state, torch.zeros((1, grid.n_sgen), dtype=torch.float64),
                   add_noise=False)
    pl = _np(out.state.pl_mw)[0]
    assert pl.shape == (4,) and pl[3] > 0.0  # the trafo branch has loss
    got = float(out.info["total_line_loss"][0])
    np.testing.assert_allclose(got, pl[:3].sum(), rtol=1e-9)
    assert got < pl.sum() - 1e-12


@pytest.mark.parametrize("make_net", [make_mock_net, make_mock_net_with_shunt],
                         ids=["feeder", "feeder_with_shunts"])
def test_every_grid_field_matches_jax(make_net):
    """Every field of the port's imported Grid against the JAX package's
    import of the same net, float64, within 1e-12, and the returned base
    powers equal."""
    grid, *bases = _import(make_net())
    jgrid, *jbases = jax_from_pandapower(make_net(), dtype=jnp.float64)
    for f in dataclasses.fields(grid):
        got, want = getattr(grid, f.name), getattr(jgrid, f.name)
        if isinstance(got, torch.Tensor):
            assert got.shape == np.shape(want), f.name
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-12,
                                       err_msg=f.name)
        else:
            assert got == want, f.name
    for got, want in zip(bases, jbases):
        np.testing.assert_array_equal(got, want)


def test_chip_smoke_feeder_is_the_mock_net():
    """chip_smoke.py [converter] imports this feeder on the card: its tables
    are tests/test_converter.py's."""
    import chip_smoke

    got, want = chip_smoke.feeder_net(), make_mock_net()
    assert (got.sn_mva, got.f_hz) == (want.sn_mva, want.f_hz)
    for table in ("bus", "ext_grid", "line", "trafo", "load", "sgen"):
        pd.testing.assert_frame_equal(getattr(got, table), getattr(want, table))
