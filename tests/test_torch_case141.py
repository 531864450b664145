"""case141 MAPPO: MAPDN's third scenario, whose agents observe 66 columns,
past the fused policy kernels' first 64-column obs tile.

On the CPU: the benchmark's grid for ``case141_mappo``
(perfbench/reference/grids.py) against the port's ``make_case("case141")``
(buses, branches, loads, PV buses, zones); the env's shapes; the policy
count of perfbench/policy_counting.py; and the cell
``case141_mappo.train4096`` through ``perfbench.harness.run`` cut to 4
lanes and 8-step chunks (one chunk an episode, 10 + 10 epochs on the whole
ring, as the cell runs): ``build_trainer`` → ``PGTrainer.run_episode`` on
case141 against the float64 reference in perfbench/reference/, through
the module's own ops and through the fused policy's autograd Function (its
plain versions, float32 CPU tensors standing for the card's), correct
under the cell's limits, and not correct with the update broken.

On a GPU (``cuda``, skipped elsewhere): the graphed case141 update phase
(the policy epochs on the kernels' second obs tile) and rollout step
(``nr_large`` at npad 256) against the uncaptured ones, bit for bit.
Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_case141.py -q
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from mapdn_torch.envs import make_env
from mapdn_torch.grid import make_case
from mapdn_torch.nets import policy_gru
from perfbench import harness, policy_counting, spec
from perfbench.reference import grids

torch.set_num_threads(1)

CELL = "case141_mappo.train4096"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    with open(os.path.join(ROOT, "perfbench", "configs", "case141_mappo.json")) as fh:
        return json.load(fh)


def _branches(f_bus, t_bus):
    return {tuple(sorted(int(v) for v in pair)) for pair in zip(f_bus, t_bus)}


def test_reference_grid_is_the_ports_case141():
    ref = grids.make_grid(_config()["grid"])
    grid, load_p, load_q, pv_max = make_case("case141", dtype=torch.float64, device="cpu")
    assert ref.g.shape == (141, 141) and grid.n_bus == 141 and grid.n_branch == 140
    off = np.triu(ref.g != 0, 1) | np.triu(ref.b != 0, 1)
    assert _branches(*np.nonzero(off)) == _branches(grid.f_bus.tolist(), grid.t_bus.tolist())
    np.testing.assert_array_equal(ref.g, grid.g_mat.numpy())
    np.testing.assert_array_equal(ref.b, grid.b_mat.numpy())
    np.testing.assert_array_equal(ref.load_bus, grid.load_bus.numpy())
    np.testing.assert_array_equal(ref.base_load_p, np.asarray(load_p))
    np.testing.assert_array_equal(ref.base_load_q, np.asarray(load_q))
    assert len(ref.load_bus) == 84
    np.testing.assert_array_equal(ref.sgen_bus, grid.sgen_bus.numpy())
    np.testing.assert_array_equal(ref.sgen_p_max, np.asarray(pv_max))
    assert len(ref.sgen_bus) == 22
    np.testing.assert_array_equal(ref.bus_zone, grid.bus_zone.numpy())
    np.testing.assert_array_equal(ref.sgen_zone, grid.sgen_zone.numpy())
    assert set(ref.bus_zone[1:].tolist()) == set(range(1, 10))


def test_case141_agents_observe_66_columns():
    """22 agents over 9 zones, each seeing its zone's buses times the 5
    features of state_space: 66 columns, past one 64-column tile and
    within two; the state is 608 wide."""
    info = make_env("case141", device="cpu").get_env_info()
    assert (info["n_agents"], info["obs_shape"], info["state_shape"]) == (22, 66, 608)
    assert policy_gru.HIDDEN < info["obs_shape"] <= policy_gru.MAX_OBS
    assert info["n_agents"] <= policy_gru.max_agents(info["obs_shape"])


def test_policy_count():
    """case322's update batch is 691.7 GFLOP a step; case141's
    139,904 FLOP a row, 0.40 TFLOP over its 2,883,584 rows."""
    assert policy_counting.step_flops(4_980_736, 62) / 1e9 == pytest.approx(691.72461568)
    assert policy_counting.step_flops(1, 66) == 139_904
    assert policy_counting.step_flops(2_883_584, 66) / 1e12 == pytest.approx(0.4034, abs=1e-4)
    assert policy_counting.step_bytes(1, 62) == 4 * (2 * (62 + 64) + 2 * 321)


def _tiny_cell():
    """The cell at 4 lanes: 8-step chunks, one an episode, the whole 8-step
    ring the batch of every epoch (as 4096 lanes run the yaml's 32)."""
    c = copy.deepcopy(spec.cell(CELL))
    over = dict(c["traffic"]["overrides"], replay_buffer_size=4 * 8, batch_size=8,
                behaviour_update_freq=8)
    c["traffic"] = dict(c["traffic"], lanes=4, max_steps=8, overrides=over)
    c["check"]["check"] = dict(c["check"]["check"], lanes=4, pairs=64)
    return c


def _run(monkeypatch, fused=False, fault_name=None):
    cell = _tiny_cell()
    calls = []
    if fused:
        monkeypatch.setattr(policy_gru, "_on_card", lambda t: t.dtype == torch.float32)
        apply = policy_gru._FusedPolicy.apply

        def counted(obs, *args):
            calls.append(obs.shape)
            return apply(obs, *args)
        monkeypatch.setattr(policy_gru._FusedPolicy, "apply", counted)
    planted = []
    if fault_name is not None:
        runner_cls = spec.kind(cell["traffic"]["kind"]).Runner
        setup = runner_cls.setup

        def plant(self):
            setup(self)
            planted.append(self.fault(fault_name))
            planted[-1].__enter__()
        monkeypatch.setattr(runner_cls, "setup", plant)
    try:
        result, _ = harness.run(CELL, 2 ** 31 + 141, 0.0, 0, device="cpu", cell=cell)
    finally:
        for p in planted:
            p.__exit__(None, None, None)
    return result, calls


@pytest.mark.parametrize("path", ["module", "fused"])
def test_tiny_cell_is_correct_on_the_cpu(monkeypatch, path):
    result, calls = _run(monkeypatch, fused=path == "fused")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    checks = result["checks"]
    assert {"vm", "mean", "logp", "loss", "grad", "change", "w_value", "w_logp",
            "w_change"} <= set(checks)
    assert np.isfinite([row["value"] for row in checks.values()]).all()
    if path == "fused":
        # every policy epoch of the three followed chunks and the window's:
        # the whole ring, 8 steps x 4 lanes x 22 agents of 66 columns
        assert len(calls) >= 4 * 10 and set(calls) == {(8 * 4 * 22, 66)}


def test_tiny_cell_fails_with_the_update_unchanged(monkeypatch):
    result, _ = _run(monkeypatch, fault_name="unchanged")
    assert not result["correct"]
    failed = {k for k, row in result["checks"].items()
              if row["limit"] is not None and row["value"] > row["limit"]}
    assert {"change", "w_change"} <= failed, failed


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_graphed_case141_policy_update_matches_uncaptured(cuda):
    """case141 MAPPO at hidden width 64 (22 agents, obs 66): its policy
    epochs run the fused kernels' second obs tile, and the update phase
    graphed equals the uncaptured one bit for bit, every epoch's stats
    too."""
    from test_torch_update_graph import _graphed_update_against_eager
    launches = policy_gru.policy_bwd.launches
    _graphed_update_against_eager(2, case="case141", hid_size=64, lanes_=64, chunk=20,
                                  episode_limit=25, ring_steps=20, batch_size=20,
                                  value_update_epochs=2, policy_update_epochs=3)
    # the eager side's 2 x 3 epochs, the graphed side's warm-up and capture
    assert policy_gru.policy_bwd.launches - launches == 2 * 3 + 2


@pytest.mark.cuda
def test_graphed_case141_rollout_matches_eager(cuda):
    """case141's rollout steps replay ``nr_large`` at npad 256 inside the
    step graph, bit for bit the uncaptured steps."""
    from mapdn_torch.pf import fused_nr
    from test_torch_rollout_graph import _graphed_against_eager
    large = fused_nr.nr_solve_large.launches
    tr = _graphed_against_eager(2, lanes_=64, chunk=20, episode_limit=25, ring_steps=8,
                                batch_size=8, case="case141", hid_size=64)
    assert fused_nr.get_ctx(tr.env.grid).npad == 256
    assert fused_nr.nr_solve_large.launches - large >= 2 * 2 * 20
    counts = tr.rollout_counts()
    assert counts["captures"]["step"] == 1 and counts["replays"]["step"] == 2 * 20 - 1
    assert sum(counts["eager"].values()) == 0
