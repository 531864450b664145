"""The benchmark's counts of the work the inputs need."""
import numpy as np
import pytest
import torch

from perfbench import counting
from perfbench.reference import grids

from mapdn_torch.envs import timeseries
from mapdn_torch.grid.cases import make_case
from mapdn_torch.pf import fused_nr, newton


def _injections(grid, load_p, load_q, pv_max, lanes, seed):
    rng = np.random.default_rng(seed)
    lp = torch.tensor(load_p[None] * rng.uniform(0.4, 1.3, (lanes, len(load_p))))
    lq = torch.tensor(load_q[None] * rng.uniform(0.4, 1.3, (lanes, len(load_q))))
    pv = torch.tensor(pv_max[None] * rng.uniform(0.0, 1.0, (lanes, len(pv_max))))
    q = torch.tensor(pv_max[None] * rng.uniform(-0.5, 0.5, (lanes, len(pv_max))))
    return (pv @ grid.sgen_inc.T - lp @ grid.load_inc.T,
            q @ grid.sgen_inc.T - lq @ grid.load_inc.T)


@pytest.mark.parametrize("case,plain", [("case33", fused_nr.nr_solve_small_ref),
                                        ("case141", fused_nr.nr_solve_large_ref)])
def test_count_same_for_torch_op_and_kernel_plain(case, plain):
    """The torch-op solver and the kernel's plain version run the same
    iterations on the same inputs, so the count, which reads only those,
    is the same: it counts the work the inputs need, not an
    implementation's."""
    grid, lp, lq, pv = make_case(case, dtype=torch.float64, device="cpu")
    p, q = _injections(grid, lp, lq, pv, 24, 0)
    a = newton.nr_solve(grid, p, q, tol=1e-7, max_iter=20, inner_iters=3)
    b = plain(grid, p, q, tol=1e-7, max_iter=20, inner_iters=3)
    assert torch.equal(a.n_iter, b.n_iter)
    assert a.n_iter.min() >= 1
    g = grids.make_grid({"builder": "case33"} if case == "case33" else
                        {"builder": "synthetic_radial", "n_bus": 141, "n_load": 84, "n_sgen": 22,
                         "n_zone": 9, "vn_kv": 12.5, "total_load_mw": 12.19,
                         "pv_penetration": 2.0, "seed": 141})
    nnz = counting.y_nonzeros(g.g, g.b)
    assert nnz == counting.y_nonzeros(grid.g_mat.numpy(), grid.b_mat.numpy())
    fa = counting.nr_flops(a.n_iter.numpy(), grid.n_bus, nnz, 3)
    fb = counting.nr_flops(b.n_iter.numpy(), grid.n_bus, nnz, 3)
    assert fa == fb > 0


def test_counts_by_hand():
    # a 3-bus chain: G and B have 7 nonzeros each, 28 in the block operator;
    # W is 4 x 4; a lane of 2 iterations with 3 refinements takes
    # 1 + 2 * 4 Y products and 2 * 4 W products
    g = np.array([[1.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 1.0]])
    assert counting.y_nonzeros(g, -g) == 28
    assert counting.nr_flops([2], 3, 28, 3) == 2 * 28 * 9 + 2 * 16 * 8
    assert counting.nr_flops([2, 0], 3, 28, 3) == 2 * 28 * 10 + 2 * 16 * 8
    assert counting.nr_bytes(2, 3, 28) == 4 * (2 * (12 + 6 + 2) + 2 * 28 + 16 + 12)
    t, by = counting.roofline_seconds(67e12, 1.0, {"float32_flops": 67e12,
                                                   "hbm_bytes_per_s": 3.35e12})
    assert t == 1.0 and by == "flops"


def test_network_counts():
    # obs 38 + 6 ids -> 64, GRU 64 -> 3 x 64 twice, head 1
    assert counting.policy_flops(38, 6, 64, 1) == 2 * (44 * 64 + 2 * 64 * 192 + 64)
    assert counting.critic_flops(38, 6, 64) == 2 * (228 * 64 + 6 * (64 * 64 + 64))
    dims = {"obs": 38, "agents": 6, "hid": 64, "act": 1}
    f = counting.chunk_net_flops(dims, 8, 2, 4, 10, {"value": 1, "policy": 0})
    assert f == (2 * 8 * 6 * counting.policy_flops(38, 6, 64, 1)
                 + 5 * 8 * counting.critic_flops(38, 6, 64)
                 + 3 * 10 * counting.critic_flops(38, 6, 64))


def test_series_copy_is_the_programs():
    g = grids.case33()
    grid, lp, lq, pv = make_case("case33", dtype=torch.float64, device="cpu")
    s = grids.synthetic_series(g)
    ts = timeseries.synthetic_dataset(lp, lq, pv, dtype=torch.float64, device="cpu")
    assert np.array_equal(s.pv, ts.pv.numpy()) and np.array_equal(s.load_p, ts.load_p.numpy())
