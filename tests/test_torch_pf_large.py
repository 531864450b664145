"""The large-grid NR path of mapdn_torch against the JAX package's: the
packed operands (``NRContext`` against ``PallasNRContext``, bit for bit in
float32), and the plain version of the kernel (``nr_solve_large_ref``)
against ``nr_solve_pallas`` in Pallas interpret mode, at the tolerances of
tests/test_pallas.py.  The CUDA kernel itself is held against the plain
version in tests/test_torch_kernels.py, where a GPU is present."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.grid import make_case as torch_case
from mapdn_torch.pf.fused_nr import (
    NRContext, get_ctx, make_solver, nr_solve_large, nr_solve_large_ref,
    nr_solve_small, nr_solve_small_ref)
from mapdn_torch.pf.newton import branch_results, nr_solve
from mapdn_tpu.grid import make_case as jax_case
from mapdn_tpu.pf.pallas_nr import PallasNRContext, nr_solve_pallas

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


def _injections(case, lanes):
    """Base loads scaled 0.6 .. 1.2 across lanes (tests/test_pallas.py)."""
    grid, load_p, load_q, _ = jax_case(case, dtype=jnp.float64)
    n = grid.n_bus
    p = np.zeros(n)
    q = np.zeros(n)
    np.add.at(p, np.asarray(grid.load_bus), -load_p)
    np.add.at(q, np.asarray(grid.load_bus), -load_q)
    scale = np.linspace(0.6, 1.2, lanes)[:, None]
    return grid, p[None] * scale, q[None] * scale


@pytest.mark.parametrize("case", ["case33", "case141", "case322"])
def test_context_operators_bitwise(case):
    jg, *_ = jax_case(case, dtype=jnp.float64)
    tg, *_ = torch_case(case, dtype=torch.float64, device="cpu")
    jctx, tctx = PallasNRContext(jg), NRContext(tg)
    assert (tctx.n, tctx.npad, tctx.slack_vm) == (jctx.n, jctx.npad, jctx.slack_vm)
    assert tctx.inv_c == jctx.inv_c
    for name in ("ypack", "wpack", "rowsum", "mask"):
        got = getattr(tctx, name)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got.astype(np.float32), getattr(jctx, name),
                                      err_msg=f"{case}.{name}")


@pytest.mark.parametrize("case,lanes", [("case33", 8), ("case322", 4)])
def test_large_plain_matches_pallas_interpret(case, lanes):
    """The plain version in float32 on the float32 casts of the operands,
    as the kernel computes, against the Pallas kernel run by the
    interpreter on the same operands.

    The two sum their products in other orders, so a lane whose error lands
    next to tol can stop one Newton iteration apart (n_iter within 1, as
    tests/test_pallas.py allows).  Lanes that ran the same iterations are
    held to the tolerances of tests/test_pallas.py:30-37.  At case322 the
    convergence test is loose: it is taken in Y-normalized units (inv_c =
    1.07e-5), and a lane that meets tol = 1e-7 after one iteration still
    lies up to 4.8e-4 from the converged solution, which bounds a lane one
    iteration apart (1e-3)."""
    jgrid, p, q = _injections(case, lanes)
    ref = nr_solve_pallas(jgrid, jnp.asarray(p, jnp.float32),
                          jnp.asarray(q, jnp.float32), interpret=True)
    g64, *_ = torch_case(case, dtype=torch.float64, device="cpu")
    g32, *_ = torch_case(case, dtype=torch.float32, device="cpu")
    out = nr_solve_large_ref(g32, torch.tensor(p, dtype=torch.float32),
                             torch.tensor(q, dtype=torch.float32), ctx=NRContext(g64))
    assert bool(out.converged.all()) and bool(np.asarray(ref.converged).all())
    d_it = np.abs(out.n_iter.numpy() - np.asarray(ref.n_iter))
    assert d_it.max() <= 1
    same = d_it == 0
    assert same.sum() >= lanes // 2
    # JAX takes the branch results of its float32 voltages on its float64
    # grid; so does the port here
    pl_mw = branch_results(g64, out.vm.double(), out.va.double())[0]
    for name, got, atol in (("vm", out.vm, 5e-6), ("va", out.va, 5e-6),
                            ("pl_mw", pl_mw, 2e-3)):
        got, want = got.numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got[same], want[same], atol=atol, err_msg=name)
        np.testing.assert_allclose(got, want, atol=max(atol, 1e-3), err_msg=name)


@pytest.fixture(scope="module")
def case322():
    _, p, q = _injections("case322", 8)
    grid, *_ = torch_case("case322", dtype=torch.float64, device="cpu")
    return grid, torch.tensor(p), torch.tensor(q)


def test_large_plain_isolates_diverged_lanes(case322):
    grid, p, q = case322
    pb = p.clone()
    pb[2:4] *= 500.0
    out = nr_solve_large_ref(grid, pb, q)
    assert bool(out.converged[:2].all()) and bool(out.converged[4:].all())
    assert not bool(out.converged[2:4].any())
    assert bool(torch.isfinite(out.vm[:2]).all())


def test_large_plain_warm_start_takes_no_iteration(case322):
    grid, p, q = case322
    cold = nr_solve_large_ref(grid, p, q)
    warm = nr_solve_large_ref(grid, p, q, vm0=cold.vm, va0=cold.va)
    assert bool(warm.converged.all()) and int(warm.n_iter.max()) == 0
    torch.testing.assert_close(warm.vm, cold.vm, rtol=0, atol=1e-12)


def test_large_plain_nan_lane_never_converges(case322):
    grid, p, q = case322
    pn = p.clone()
    pn[3, 7] = float("nan")
    out = nr_solve_large_ref(grid, pn, q)
    assert not bool(out.converged[3])
    assert bool(out.converged[:3].all()) and bool(out.converged[4:].all())


def test_large_plain_matches_torch_op_solver_float64(case322):
    """The same algorithm in float64: the plain version on the padded
    packed operands and the torch-op nr_solve agree to rounding."""
    grid, p, q = case322
    out = nr_solve_large_ref(grid, p, q)
    ref = nr_solve(grid, p, q)
    np.testing.assert_array_equal(out.n_iter.numpy(), ref.n_iter.numpy())
    for name in ("vm", "va", "p_bus", "q_bus", "pl_mw"):
        np.testing.assert_allclose(getattr(out, name).numpy(), getattr(ref, name).numpy(),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_solver_dispatch_by_grid_size(case322):
    """'auto' (as 'kernel'): case33 -> small kernel path, case141 and
    case322 -> large kernel path (the H100 timings of make_solver's
    docstring); 'torch' the torch-op solver; CPU tensors launch no
    kernel."""
    g322, p322, q322 = case322
    launches = (nr_solve_small.launches, nr_solve_large.launches)
    solves = {}
    for case in ("case33", "case141"):
        grid, *_ = torch_case(case, dtype=torch.float64, device="cpu")
        _, p, q = _injections(case, 2)
        solves[case] = grid, torch.tensor(p), torch.tensor(q)
    g33, p33, q33 = solves["case33"]
    np.testing.assert_array_equal(make_solver(g33)(p33, q33).vm.numpy(),
                                  nr_solve_small_ref(g33, p33, q33).vm.numpy())
    g141, p141, q141 = solves["case141"]
    np.testing.assert_array_equal(make_solver(g141)(p141, q141).vm.numpy(),
                                  nr_solve_large_ref(g141, p141, q141).vm.numpy())
    np.testing.assert_array_equal(make_solver(g141, backend="torch")(p141, q141).vm.numpy(),
                                  nr_solve(g141, p141, q141).vm.numpy())
    np.testing.assert_array_equal(make_solver(g322)(p322, q322).vm.numpy(),
                                  nr_solve_large_ref(g322, p322, q322).vm.numpy())
    np.testing.assert_array_equal(make_solver(g322, backend="torch")(p322, q322).vm.numpy(),
                                  nr_solve(g322, p322, q322).vm.numpy())
    assert (nr_solve_small.launches, nr_solve_large.launches) == launches
    assert get_ctx(g322) is get_ctx(g322) and get_ctx(g322).npad == 384


def test_make_solver_rejects_grid_above_large_kernel_limit():
    """A grid off the CPU whose npad the large kernel cannot hold raises
    when its solver is built, not at its first solve; on the CPU the plain
    version has no such limit."""
    big = types.SimpleNamespace(n_bus=400, device=torch.device("meta"))
    with pytest.raises(ValueError, match="npad=512"):
        make_solver(big, backend="auto")


def test_large_wrapper_rejects_other_devices(case322):
    grid, p, q = case322
    with pytest.raises(ValueError, match="unsupported device"):
        nr_solve_large(grid, p.to("meta"), q.to("meta"))
