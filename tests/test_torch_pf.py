"""mapdn_torch power flow vs the JAX package's: the torch-op solver against
JAX ``nr_solve`` in float64, and the NR kernel's plain version against
``nr_solve_pallas_small`` in Pallas interpret mode (tolerances of
tests/test_pallas.py).  The CUDA kernel itself is held against the plain
version in tests/test_torch_kernels.py, where a GPU is present."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdn_torch.grid import make_case as torch_case
from mapdn_torch.pf.fused_nr import make_solver, nr_solve_small, nr_solve_small_ref
from mapdn_torch.pf.newton import nr_solve
from mapdn_tpu.grid import make_case as jax_case
from mapdn_tpu.pf.newton import nr_solve as jax_nr_solve
from mapdn_tpu.pf.pallas_nr import nr_solve_pallas_small

torch.set_num_threads(1)


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


@pytest.mark.parametrize("case", ["case33", "case141"])
def test_nr_solve_matches_jax_float64(case):
    jgrid, p, q = _injections(case, 8)
    tgrid, *_ = torch_case(case, dtype=torch.float64, device="cpu")
    ref = jax_nr_solve(jgrid, jnp.asarray(p), jnp.asarray(q))
    out = nr_solve(tgrid, torch.tensor(p), torch.tensor(q))
    assert bool(out.converged.all())
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(out.n_iter.numpy(), np.asarray(ref.n_iter))
    for name in ("vm", "va", "p_bus", "q_bus", "pl_mw"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-9, err_msg=name)


@pytest.fixture(scope="module")
def case33():
    jgrid, p, q = _injections("case33", 8)
    tgrid, *_ = torch_case("case33", dtype=torch.float64, device="cpu")
    return jgrid, tgrid, p, q


def test_small_plain_matches_pallas_interpret(case33):
    jgrid, tgrid, p, q = case33
    ref = nr_solve_pallas_small(jgrid, jnp.asarray(p, jnp.float32),
                                jnp.asarray(q, jnp.float32), interpret=True)
    out = nr_solve_small_ref(tgrid, torch.tensor(p), torch.tensor(q))
    assert bool(out.converged.all()) and bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(out.vm.numpy(), np.asarray(ref.vm), atol=2e-5)
    np.testing.assert_allclose(out.va.numpy(), np.asarray(ref.va), atol=2e-5)
    assert np.abs(out.n_iter.numpy() - np.asarray(ref.n_iter)).max() <= 1


def test_small_plain_isolates_diverged_lanes(case33):
    _, tgrid, p, q = case33
    pb = p[:4].copy()
    pb[2:4] *= 500.0
    out = nr_solve_small_ref(tgrid, torch.tensor(pb), torch.tensor(q[:4]))
    assert bool(out.converged[0]) and bool(out.converged[1])
    assert not bool(out.converged[2]) and not bool(out.converged[3])
    assert bool(torch.isfinite(out.vm[:2]).all())


def test_small_plain_warm_start_takes_no_iteration(case33):
    _, tgrid, p, q = case33
    cold = nr_solve_small_ref(tgrid, torch.tensor(p), torch.tensor(q))
    warm = nr_solve_small_ref(tgrid, torch.tensor(p), torch.tensor(q),
                              vm0=cold.vm, va0=cold.va)
    assert bool(warm.converged.all())
    assert int(warm.n_iter.max()) == 0


def test_small_plain_nan_lane_never_converges(case33):
    _, tgrid, p, q = case33
    pn = p.copy()
    pn[3, 7] = np.nan
    out = nr_solve_small_ref(tgrid, torch.tensor(pn), torch.tensor(q))
    assert not bool(out.converged[3])
    assert bool(out.converged[:3].all()) and bool(out.converged[4:].all())


def test_solver_dispatch_by_configuration(case33):
    """'auto' takes the kernel path for n_bus <= 64 (its plain version on
    the CPU) and the torch-op solver above; 'torch' forces the latter."""
    _, tgrid, p, q = case33
    pt, qt = torch.tensor(p), torch.tensor(q)
    launches = nr_solve_small.launches
    auto = make_solver(tgrid, backend="auto")(pt, qt)
    small = nr_solve_small_ref(tgrid, pt, qt)
    np.testing.assert_array_equal(auto.vm.numpy(), small.vm.numpy())
    forced = make_solver(tgrid, backend="torch")(pt, qt)
    np.testing.assert_array_equal(forced.vm.numpy(), nr_solve(tgrid, pt, qt).vm.numpy())
    assert nr_solve_small.launches == launches   # CPU tensors launch nothing

    g141, *_ = torch_case("case141", dtype=torch.float64, device="cpu")
    _, p141, q141 = _injections("case141", 2)
    p141, q141 = torch.tensor(p141), torch.tensor(q141)
    big = make_solver(g141, backend="auto")(p141, q141)
    np.testing.assert_array_equal(big.vm.numpy(), nr_solve(g141, p141, q141).vm.numpy())
    with pytest.raises(ValueError):
        make_solver(tgrid, backend="xla")
