"""The power-flow surfaces of mapdn_torch against the JAX package at
float64 on the CPU: ``nr_solve(fixed_iter=)`` (tests/test_pf.py:106-135),
``nr_solve_dense``, ``nr_solve`` at case69 and case322 and on the four
random radial feeders of tests/test_pf.py:137-142, the native float64
oracle against the numpy one (tests/test_native.py), an env step with
``pf_fixed_iter`` against the JAX env's, and the grid sizes that
``make_solver("auto")`` sends to each solver."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import native
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.grid import make_case as torch_case
from mapdn_torch.grid.cases import _synthetic_radial
from mapdn_torch.pf import fused_nr
from mapdn_torch.pf.fused_nr import make_solver, solver_path
from mapdn_torch.pf.newton import nr_solve, nr_solve_dense
from mapdn_torch.pf.reference import nr_solve_ref
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.grid import make_case as jax_case
from mapdn_tpu.grid.cases import _synthetic_radial as jax_radial
from mapdn_tpu.pf.newton import nr_solve as jax_nr_solve
from mapdn_tpu.pf.newton import nr_solve_dense as jax_nr_solve_dense

torch.set_num_threads(1)

FIELDS = ("vm", "va", "p_bus", "q_bus", "pl_mw", "loading")


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # one BLAS thread in each of Tier-1's xdist workers (ROADMAP's rules)
    with threadpool_limits(1, user_api="blas"):
        yield


def _scaled_loads(grid, load_p, load_q, scales):
    """Injections [pu] of the case's loads times each of ``scales``."""
    n = grid.n_bus
    p = np.zeros((len(scales), n))
    q = np.zeros((len(scales), n))
    for i, s in enumerate(scales):
        np.add.at(p[i], np.asarray(grid.load_bus), -np.asarray(load_p) * s)
        np.add.at(q[i], np.asarray(grid.load_bus), -np.asarray(load_q) * s)
    return p, q


def _both(case, scales):
    jgrid, lp, lq, _ = jax_case(case, dtype=jnp.float64)
    tgrid, *_ = torch_case(case, dtype=torch.float64, device="cpu")
    p, q = _scaled_loads(jgrid, np.asarray(lp), np.asarray(lq), scales)
    return jgrid, tgrid, p, q


def _assert_result_close(out, ref, atol):
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(out.n_iter.numpy(), np.asarray(ref.n_iter))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def case33_loads():
    # tests/test_pf.py:116-126: 32 lanes at load scales 0.4 .. 1.4
    rng = np.random.RandomState(3)
    return _both("case33", [0.4 + rng.rand() for _ in range(32)])


@pytest.mark.parametrize("fixed_iter", [1, 10])
def test_fixed_iter_matches_jax_and_the_while_path(case33_loads, fixed_iter):
    """The straight-line path is the while path's recursion with masked
    freezes: at 10 iterations the while path's fixed point (atol 1e-12, as
    tests/test_pf.py:130-131), at 1 a lane short of its budget reports not
    converged; and JAX's verdicts, counts and numbers (atol 1e-11)."""
    jgrid, tgrid, p, q = case33_loads
    pt, qt = torch.tensor(p), torch.tensor(q)
    out = nr_solve(tgrid, pt, qt, tol=1e-9, fixed_iter=fixed_iter)
    ref = jax_nr_solve(jgrid, jnp.asarray(p), jnp.asarray(q), tol=1e-9,
                       fixed_iter=fixed_iter)
    _assert_result_close(out, ref, atol=1e-11)
    while_path = nr_solve(tgrid, pt, qt, tol=1e-9)
    if fixed_iter == 10:
        assert bool(out.converged.all()) and bool(while_path.converged.all())
        np.testing.assert_allclose(out.vm.numpy(), while_path.vm.numpy(), atol=1e-12)
        np.testing.assert_array_equal(out.n_iter.numpy(), while_path.n_iter.numpy())
    else:
        assert not bool(out.converged.all())
        assert int(out.n_iter.max()) == 1


@pytest.mark.parametrize("case", ["case33", "case69"])
def test_nr_solve_dense_matches_jax(case):
    """The explicit-Jacobian oracle: the loop's global count on every lane,
    tol 1e-8 on the absolute mismatch; within 1e-9 of JAX's (float64
    dense solves of the same Jacobians; the tolerance of
    tests/test_torch_pf.py), and within 1e-8 of the numpy oracle."""
    jgrid, tgrid, p, q = _both(case, np.linspace(0.6, 1.2, 6))
    out = nr_solve_dense(tgrid, torch.tensor(p), torch.tensor(q))
    ref = jax_nr_solve_dense(jgrid, jnp.asarray(p), jnp.asarray(q))
    assert bool(out.converged.all())
    _assert_result_close(out, ref, atol=1e-9)
    assert len(set(out.n_iter.tolist())) == 1
    for i in range(len(p)):
        vm_o, va_o, ok, _ = nr_solve_ref(tgrid.g_mat.numpy(), tgrid.b_mat.numpy(),
                                         p[i], q[i])
        assert ok
        np.testing.assert_allclose(out.vm[i].numpy(), vm_o, atol=1e-8)
        np.testing.assert_allclose(out.va[i].numpy(), va_o, atol=1e-8)


def test_nr_solve_dense_freezes_a_diverged_lane():
    """A lane loaded 1e4 times over stops (vm > 10 or non-finite) and
    reports not converged, as JAX's; the solvable lanes converge."""
    jgrid, tgrid, p, q = _both("case33", [0.8, 1.0])
    p[1] *= 1e4
    out = nr_solve_dense(tgrid, torch.tensor(p), torch.tensor(q))
    ref = jax_nr_solve_dense(jgrid, jnp.asarray(p), jnp.asarray(q))
    assert out.converged.tolist() == [True, False]
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(out.vm[0].numpy(), np.asarray(ref.vm[0]), atol=1e-10)


@pytest.mark.parametrize("case,lanes", [("case69", 6), ("case322", 3)])
def test_nr_solve_matches_jax_float64(case, lanes):
    """The torch-op solver where parity was not held before (case33 and
    case141 are in tests/test_torch_pf.py), at the same tolerance."""
    jgrid, tgrid, p, q = _both(case, np.linspace(0.6, 1.2, lanes))
    out = nr_solve(tgrid, torch.tensor(p), torch.tensor(q))
    ref = jax_nr_solve(jgrid, jnp.asarray(p), jnp.asarray(q))
    assert bool(out.converged.all())
    _assert_result_close(out, ref, atol=1e-9)


# tests/test_pf.py:137-142: (seed, n_bus, n_load, n_sgen, n_zone)
FEEDERS = [(1, 24, 14, 4, 3), (2, 57, 35, 7, 5), (3, 101, 60, 11, 7),
           (4, 203, 150, 19, 11)]


def _feeder(seed, n_bus, n_load, n_sgen, n_zone):
    args = (f"rand{seed}", n_bus, n_load, n_sgen, n_zone)
    kw = dict(vn_kv=12.5, total_load_mw=0.09 * n_bus, pv_penetration=2.0,
              seed=1000 + seed)
    jgrid, load_p, load_q, pv_max = jax_radial(*args, **kw, dtype=jnp.float64)
    tgrid, *_ = _synthetic_radial(*args, **kw, dtype=torch.float64, device="cpu")
    # tests/test_pf.py's injections: loads, and PV at 20-90 % of capacity
    # with reactive power within +-30 %
    rng = np.random.RandomState(seed)
    pv_max = np.asarray(pv_max)
    sgen_p = pv_max * rng.uniform(0.2, 0.9, len(pv_max))
    sgen_q = pv_max * rng.uniform(-0.3, 0.3, len(pv_max))
    sn = float(jgrid.sn_mva)
    p = np.zeros(jgrid.n_bus)
    q = np.zeros(jgrid.n_bus)
    np.add.at(p, np.asarray(jgrid.load_bus), -np.asarray(load_p) / sn)
    np.add.at(q, np.asarray(jgrid.load_bus), -np.asarray(load_q) / sn)
    np.add.at(p, np.asarray(jgrid.sgen_bus), sgen_p / sn)
    np.add.at(q, np.asarray(jgrid.sgen_bus), sgen_q / sn)
    return jgrid, tgrid, p[None], q[None]


@pytest.mark.parametrize("feeder", FEEDERS, ids=[f"rand{f[0]}-{f[1]}bus" for f in FEEDERS])
def test_random_feeders_match_the_oracle_and_jax(feeder):
    """Each random feeder through the torch-op solver and through the path
    "auto" picks for it: within 1e-6 of the numpy oracle at tol 1e-10 (the
    tolerance of tests/test_pf.py:164-168), within 1e-9 of JAX's
    ``nr_solve``; "auto"'s path (the large kernel's plain version above 64
    buses) within 1e-9 of the torch-op solver."""
    jgrid, tgrid, p, q = _feeder(*feeder)
    pt, qt = torch.tensor(p), torch.tensor(q)
    vm_o, va_o, ok, _ = nr_solve_ref(tgrid.g_mat.numpy(), tgrid.b_mat.numpy(),
                                     p[0], q[0], tol=1e-10)
    assert ok
    out = nr_solve(tgrid, pt, qt, tol=1e-10)
    assert bool(out.converged[0])
    np.testing.assert_allclose(out.vm[0].numpy(), vm_o, atol=1e-6)
    np.testing.assert_allclose(out.va[0].numpy(), va_o, atol=1e-6)
    ref = jax_nr_solve(jgrid, jnp.asarray(p), jnp.asarray(q), tol=1e-10)
    _assert_result_close(out, ref, atol=1e-9)
    auto = make_solver(tgrid, tol=1e-10)(pt, qt)
    assert bool(auto.converged[0])
    np.testing.assert_allclose(auto.vm.numpy(), out.vm.numpy(), atol=1e-9)
    np.testing.assert_allclose(auto.va.numpy(), out.va.numpy(), atol=1e-9)


def test_native_oracle_matches_numpy_oracle():
    """tests/test_native.py's check on the port's build: 8 case33 lanes
    within 1e-12 of the numpy oracle, and the library's ABI."""
    tgrid, lp, lq, _ = torch_case("case33", dtype=torch.float64, device="cpu")
    p, q = _scaled_loads(tgrid, lp, lq, np.linspace(0.6, 1.2, 8))
    g, b = tgrid.g_mat.numpy(), tgrid.b_mat.numpy()
    assert native.available() and native.get_lib().mapdn_native_abi_version() == 1
    # built beside the kernels, under the checkout's build/
    assert os.path.dirname(native._lib_path()) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
        "mapdn_torch_native")
    vm, va, conv, iters = native.nr_solve_batch(tgrid.g_mat, tgrid.b_mat, p, q)
    assert conv.all() and vm.shape == (8, tgrid.n_bus) and iters.shape == (8,)
    for i in range(8):
        vm_o, va_o, ok, it = nr_solve_ref(g, b, p[i], q[i])
        assert ok and iters[i] == it
        np.testing.assert_allclose(vm[i], vm_o, atol=1e-12)
        np.testing.assert_allclose(va[i], va_o, atol=1e-12)


def test_native_oracle_flags_divergence_and_keeps_batch_shape():
    tgrid, lp, lq, _ = torch_case("case33", dtype=torch.float64, device="cpu")
    p, q = _scaled_loads(tgrid, lp, lq, [0.8, 1.0, 1.2, 0.9])
    p[1] *= 1e4   # an unsolvable overload in lane 1 only
    vm, va, conv, _ = native.nr_solve_batch(tgrid.g_mat, tgrid.b_mat,
                                            p.reshape(2, 2, -1), q.reshape(2, 2, -1))
    assert conv.shape == (2, 2) and vm.shape == (2, 2, tgrid.n_bus)
    assert conv.tolist() == [[True, False], [True, True]]
    assert np.all(np.isfinite(vm[0, 0]))
    with pytest.raises(ValueError, match="injections"):
        native.nr_solve_batch(tgrid.g_mat, tgrid.b_mat, p[:, :5], q[:, :5])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A build that fails raises when the oracle is called, and
    ``available`` says so; nothing solves in its place."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="build failed"):
        native.nr_solve_batch(np.eye(2), np.eye(2), np.zeros(2), np.zeros(2))
    assert not native.available()


def _to_torch_state(js):
    return EnvState(**{f.name: torch.as_tensor(np.array(getattr(js, f.name)))
                       for f in dataclasses.fields(EnvState)})


def test_env_step_with_pf_fixed_iter_matches_jax():
    """``EnvConfig.pf_fixed_iter=10`` reaches the torch-op solver (the JAX
    env's XLA path on the CPU): a noiseless step of 4 lanes from JAX's
    reset states, every state field, obs and reward within 1e-10 (the
    tolerance of tests/test_torch_env.py), the solves' iteration counts
    JAX's."""
    jenv = jax_make_env("case33", JaxEnvConfig(episode_limit=3, pf_fixed_iter=10),
                        days=8, dtype=jnp.float64)
    tenv = make_env("case33", EnvConfig(episode_limit=3, pf_fixed_iter=10,
                                        pf_backend="torch"),
                    days=8, dtype=torch.float64, device="cpu")
    jstates, _, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(7), 4))
    acts = np.random.RandomState(0).uniform(-0.8, 0.8, (4, 6))
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    jout = jax.jit(jax.vmap(lambda s, a, k: jenv.step(s, a, k, add_noise=False)))(
        jstates, jnp.asarray(acts), keys)
    tout = tenv.step(_to_torch_state(jstates), torch.tensor(acts), add_noise=False)
    for f in dataclasses.fields(EnvState):
        np.testing.assert_allclose(getattr(tout.state, f.name).numpy(),
                                   np.asarray(getattr(jout.state, f.name)),
                                   rtol=1e-9, atol=1e-10, err_msg=f.name)
    for name in ("obs", "global_state", "reward"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)
    assert not bool(tout.terminated.any())
    # the solver really runs a fixed count: one iteration from a flat start
    # is short of tol, and reports not converged
    short = make_env("case33", EnvConfig(pf_fixed_iter=1, pf_backend="torch"),
                     days=8, dtype=torch.float64, device="cpu")
    s = tout.state
    flat = short._solve(s.load_p, s.load_q, s.pv_p, s.sgen_q)
    assert not bool(flat.converged.any()) and flat.n_iter.tolist() == [1] * 4
    assert bool(tenv._solve(s.load_p, s.load_q, s.pv_p, s.sgen_q).converged.all())


# "auto"'s table (make_solver's docstring, PERF.md PR 9): the grids and the
# path each takes
AUTO = {"case33": "small", "case69": "large", "case141": "large",
        "case322": "large", "rand4-203bus": "large"}


@pytest.mark.parametrize("name", list(AUTO))
def test_auto_picks_the_measured_path(name, monkeypatch):
    """The path "auto" picks for each grid, by ``solver_path`` and by the
    solver it builds: the one each grid's solve is sent to."""
    if name.startswith("rand"):
        _, grid, *_ = _feeder(*FEEDERS[3])
    else:
        grid, *_ = torch_case(name, dtype=torch.float64, device="cpu")
    assert solver_path(grid.n_bus, "auto") == AUTO[name]
    assert solver_path(grid.n_bus, "torch") == "torch"
    called = []
    for fn in ("nr_solve_small", "nr_solve_large", "nr_solve"):
        real = getattr(fused_nr, fn)
        monkeypatch.setattr(fused_nr, fn, lambda *a, _fn=fn, _real=real, **k:
                            called.append(_fn) or _real(*a, **k))
    p = torch.zeros((2, grid.n_bus), dtype=torch.float64)
    make_solver(grid)(p, p)
    assert called == [{"small": "nr_solve_small", "large": "nr_solve_large",
                       "torch": "nr_solve"}[AUTO[name]]]
