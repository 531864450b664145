"""mapdn_torch's droop and OPF baselines (``mapdn_torch.traditional``)
against the JAX package's at float64 on the CPU: tests/test_traditional.py's
three physics checks on the port (one operating point as a batch of one
lane), the droop law on a grid of v x p, the batched droop fixed point
against ``jax.vmap(droop_solve)`` lane by lane (a finished lane freezes
while others iterate), the differentiable power flow, the OPF objective's
gradient and its optimisation against ``jax.vmap(opf_solve)``, and the
learning report's ``engineering_baselines`` against the JAX script's
(scripts/learning_report.py, loaded by path) on the same rows."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.traditional import droop_control_law, droop_solve, opf_solve
from mapdn_torch.traditional.opf import _fixed_iter_pf, opf_objective
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.traditional import droop_control_law as jax_droop_control_law
from mapdn_tpu.traditional import droop_solve as jax_droop_solve
from mapdn_tpu.traditional import opf_solve as jax_opf_solve
from mapdn_tpu.traditional.opf import _fixed_iter_pf as jax_fixed_iter_pf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    """The learning report's env build (40 synthetic days of seed 7) at
    float64, in both packages."""
    env = make_env("case33", EnvConfig(episode_limit=240), days=40, seed=7,
                   dtype=torch.float64, device="cpu")
    jenv = jax_make_env("case33", JaxEnvConfig(episode_limit=240), days=40, seed=7,
                        dtype=jnp.float64)
    return env, jenv


def _report_rows(env, n):
    """The first ``n`` operating points the learning report draws."""
    rows = np.random.default_rng(7).integers(0, env.ts.n_steps, size=n)
    r = torch.as_tensor(rows)
    return env.ts.load_p[r], env.ts.load_q[r], env.ts.pv[r]


def _jnp(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


def _high_pv_point(env):
    """An operating point with heavy PV injection (overvoltage risk), as a
    batch of one lane."""
    ts = env.ts
    t = int(torch.argmax(torch.sum(ts.pv, dim=1)))
    return ts.load_p[t:t + 1] * 0.5, ts.load_q[t:t + 1] * 0.5, ts.pv[t:t + 1]


# --- tests/test_traditional.py on the port --------------------------------

def test_droop_law_shape():
    s = torch.tensor([1.0], dtype=torch.float64)
    p = torch.tensor([0.6], dtype=torch.float64)
    q_max = float(np.sqrt(1 - 0.36))
    law = lambda v: float(droop_control_law(torch.tensor([v], dtype=torch.float64), p, s)[0])
    # saturation regions
    np.testing.assert_allclose(law(0.90), q_max, rtol=1e-6)
    np.testing.assert_allclose(law(1.10), -q_max, rtol=1e-6)
    # dead zone
    assert law(1.0) == 0.0
    # linear ramps: halfway points
    np.testing.assert_allclose(law(0.975), q_max / 2, rtol=1e-5)
    np.testing.assert_allclose(law(1.025), -q_max / 2, rtol=1e-5)


def test_droop_reduces_overvoltage():
    env = make_env("case33", EnvConfig(), days=8, dtype=torch.float64, device="cpu")
    lp, lq, pv = _high_pv_point(env)
    res_nc = env._solve(lp, lq, pv, torch.zeros_like(pv))
    q, res, it = droop_solve(env, lp, lq, pv)
    assert bool(res.converged.all()) and it.shape == (1,)
    v_max_nc = float(torch.max(res_nc.vm))
    assert float(torch.max(res.vm)) <= v_max_nc + 1e-9
    # overvoltage -> droop absorbs vars (negative q) at the worst buses
    if v_max_nc > 1.0:
        assert float(torch.min(q)) < 0.0


def test_opf_beats_no_control():
    env = make_env("case33", EnvConfig(), days=8, dtype=torch.float64, device="cpu")
    lp, lq, pv = _high_pv_point(env)
    q, res, trace = opf_solve(env, lp, lq, pv, steps=60)
    assert bool(res.converged.all()) and trace.shape == (1, 60)
    # objective decreased over the optimisation
    assert float(trace[0, -1]) <= float(trace[0, 0]) + 1e-9
    # q respects capacity
    cap = torch.sqrt(torch.clamp(env.ts.s_max**2 - pv**2, min=0.0))
    assert bool((q.abs() <= cap + 1e-9).all())
    # voltage band violations no worse than no control
    res_nc = env._solve(lp, lq, pv, torch.zeros_like(pv))
    viol = lambda r: float(torch.sum(torch.clamp(r.vm - 1.05, min=0) ** 2
                                     + torch.clamp(0.95 - r.vm, min=0) ** 2))
    assert viol(res) <= viol(res_nc) + 1e-12


# --- parity with the JAX package -------------------------------------------

def test_droop_control_law_matches_jax():
    """Every region of the law, its edges included, on a grid of v x p, with
    and without a manual cap."""
    v = np.concatenate([np.linspace(0.9, 1.1, 81), [0.95, 1.0, 1.05]])[:, None]
    p = np.linspace(0.0, 1.3, 14)[None, :]
    vv, pp = np.broadcast_arrays(v, p)
    s = np.full(pp.shape[1], 1.2)
    for cap in (None, 0.5 * s):
        got = droop_control_law(torch.as_tensor(vv), torch.as_tensor(pp), torch.as_tensor(s),
                                None if cap is None else torch.as_tensor(cap))
        want = jax_droop_control_law(jnp.asarray(vv), jnp.asarray(pp), jnp.asarray(s),
                                     None if cap is None else jnp.asarray(cap))
        _close(got, want, 0, 1e-15, f"law cap={cap is not None}")


def test_droop_solve_matches_jax_vmap(envs):
    """8 of the learning report's rows as one batch against
    ``jax.vmap(droop_solve)``: each lane's q and solution within 1e-9 and its
    own iteration count (16 to 23 here)."""
    env, jenv = envs
    lp, lq, pv = _report_rows(env, 8)
    q, res, it = droop_solve(env, lp, lq, pv)
    jq, jres, jit_ = jax.jit(jax.vmap(lambda a, b, c: jax_droop_solve(jenv, a, b, c)))(
        *_jnp(lp, lq, pv))
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit_))
    assert len(set(it.tolist())) > 1          # the lanes stop apart
    for name, got, want in (("q", q, jq), ("vm", res.vm, jres.vm), ("va", res.va, jres.va),
                            ("pl_mw", res.pl_mw, jres.pl_mw)):
        _close(got, want, 0, 1e-9, name)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))


def test_droop_freezes_finished_lanes(envs):
    """A lane that stops at iteration k keeps its k-th q and solution while
    another lane of the batch iterates on: batched, each lane gives what it
    gives alone."""
    env, _ = envs
    lp, lq, pv = _report_rows(env, 8)
    _, _, it = droop_solve(env, lp, lq, pv)
    fast, slow = int(torch.argmin(it)), int(torch.argmax(it))
    pair = torch.tensor([fast, slow])
    q, res, it2 = droop_solve(env, lp[pair], lq[pair], pv[pair])
    assert it2[0] < it2[1]
    for lane, i in enumerate((fast, slow)):
        q1, res1, it1 = droop_solve(env, lp[i:i + 1], lq[i:i + 1], pv[i:i + 1])
        assert int(it1[0]) == int(it2[lane])
        _close(q[lane], q1[0], 0, 1e-12, f"q lane {lane}")
        _close(res.vm[lane], res1.vm[0], 0, 1e-12, f"vm lane {lane}")


def test_fixed_iter_pf_matches_jax(envs):
    env, jenv = envs
    lp, lq, pv = _report_rows(env, 4)
    qg = 0.3 * pv
    p, q = env._injections(lp, lq, pv, qg)
    vm, va = _fixed_iter_pf(env.grid, p, q, n_iter=8)
    jvm, jva = jax_fixed_iter_pf(jenv.grid, *_jnp(p, q), n_iter=8)
    _close(vm, jvm, 0, 1e-12, "vm")
    _close(va, jva, 0, 1e-12, "va")


def test_opf_objective_gradient_matches_jax(envs):
    """The gradient of the OPF objective (loss plus the voltage penalty,
    summed over lanes) through the fixed-iteration power flow, against
    ``jax.grad`` of opf.py's objective, at a point that violates the band."""
    from mapdn_tpu.pf.newton import branch_results as jax_branch_results

    env, jenv = envs
    lp, lq, pv = _report_rows(env, 4)
    q0 = 0.5 * pv * torch.tensor([1.0, -1.0, 0.5, -0.5], dtype=torch.float64)[:, None]
    cfg, penalty = env.cfg, 200.0

    def objective(q):
        return opf_objective(env, lp, lq, pv, q, penalty=penalty).sum()

    jlp, jlq, jpv = _jnp(lp, lq, pv)

    def jax_objective(q):      # mapdn_tpu/traditional/opf.py:150-157, over lanes
        p_inj, q_inj = jax.vmap(jenv._injections)(jlp, jlq, jpv, q)
        vm, va = jax_fixed_iter_pf(jenv.grid, p_inj, q_inj)
        pl, _ = jax_branch_results(jenv.grid, vm, va)
        viol = (jnp.maximum(vm - cfg.v_upper, 0.0) ** 2
                + jnp.maximum(cfg.v_lower - vm, 0.0) ** 2)
        return jnp.sum(pl) + penalty * jnp.sum(viol)

    q = q0.clone().requires_grad_(True)
    val = objective(q)
    (grad,) = torch.autograd.grad(val, q)
    jval, jgrad = jax.value_and_grad(jax_objective)(jnp.asarray(q0.numpy()))
    _close(val.detach(), jval, 1e-12, 0, "objective")
    assert float(grad.abs().max()) > 1e-3
    _close(grad, jgrad, 0, 1e-10, "gradient")


def test_opf_solve_matches_jax_vmap(envs):
    """``opf_solve(steps=20)`` on 4 report rows against
    ``jax.vmap(opf_solve)``: q within 1e-8, each lane's objective trace
    (4, 20) within 1e-9 relative, the final solve's vm within 1e-9."""
    env, jenv = envs
    lp, lq, pv = _report_rows(env, 4)
    q, res, trace = opf_solve(env, lp, lq, pv, steps=20)
    jq, jres, jtrace = jax.jit(jax.vmap(
        lambda a, b, c: jax_opf_solve(jenv, a, b, c, steps=20)))(*_jnp(lp, lq, pv))
    assert trace.shape == np.shape(jtrace) == (4, 20)
    _close(q, jq, 0, 1e-8, "q")
    _close(trace, jtrace, 1e-9, 0, "trace")
    _close(res.vm, jres.vm, 0, 1e-9, "vm")
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))
    assert bool((trace[:, -1] <= trace[:, 0]).all())


def _jax_report():
    """scripts/learning_report.py as a module, its env build at float64."""
    spec = importlib.util.spec_from_file_location(
        "jax_learning_report", os.path.join(ROOT, "scripts", "learning_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._build_env = lambda case: jax_make_env(
        case, JaxEnvConfig(episode_limit=240), days=40, seed=7, dtype=jnp.float64)
    return module


def test_engineering_baselines_match_the_jax_script():
    """The port's ``engineering_baselines`` against the JAX script's on the
    same 8 rows, both env builds at float64 (the script's float32 build
    swapped for float64 in the loaded module; the file is unchanged): every
    stat within 1e-8."""
    from mapdn_torch.scripts.learning_report import engineering_baselines

    got = engineering_baselines(n_samples=8, device="cpu", dtype=torch.float64)
    want = _jax_report().engineering_baselines(n_samples=8)
    assert set(got) == set(want) == {"droop_baseline", "opf_baseline"}
    for name in got:
        assert set(got[name]) == set(want[name])
        assert got[name]["n_samples"] == want[name]["n_samples"] == 8
        for k, v in want[name].items():
            assert abs(got[name][k] - v) <= 1e-8, (name, k, got[name][k], v)
