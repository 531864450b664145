"""The plain reference against the port at small sizes on the CPU, float64,
and the import rules it keeps."""

import numpy as np
import pytest
import torch

from perfbench import check, imports, spec, weights
from perfbench.reference import grids, nets, powerflow, ppo

from mapdn_torch import train
from mapdn_torch.algos.base import Transition
from mapdn_torch.learn.losses import ppo_loss

CONFIGS = {name: spec.cell(cell)["config"] for name, cell in
           (("case33", "case33_mappo.train512"), ("case322", "case322_mappo.train4096"))}
MAPPO = spec.alg("mappo")


def program(case, lanes=6):
    config = CONFIGS[case]
    args = train.parse_args(list(config["flags"]) + ["--platform", "cpu", "--n-envs", str(lanes)])
    cfg, _, trainer = train.build_trainer(args, device=torch.device("cpu"))
    return cfg, trainer


@pytest.mark.parametrize("case", ["case33", "case322"])
def test_grid_copy_is_the_programs(case):
    _, tr = program(case)
    g = grids.make_grid(CONFIGS[case]["grid"])
    pg = tr.env.grid
    assert np.allclose(g.g, pg.g_mat.double().numpy(), rtol=1e-6, atol=0)
    assert np.array_equal(g.sgen_bus, pg.sgen_bus.numpy())
    assert np.array_equal(g.bus_zone, pg.bus_zone.numpy())


def test_reference_imports_nothing_of_the_program():
    assert imports.reference_imports() == {}
    assert imports.loaded_forbidden(["jax.numpy", "mapdn_torch.pf"]) == ["jax"]
    assert imports.loaded_forbidden(["mapdn_tpu_extra", "mapdn_torch", "jaxtyping"]) == []
    assert imports.loaded_forbidden(["mapdn_tpu.pf"]) == ["mapdn_tpu"]


@pytest.mark.parametrize("case", ["case33", "case322"])
def test_env_step_against_the_port(case):
    """The port's env step at float64 from a reset, against the reference's
    solve, reward and obs on the same state and actions."""
    from mapdn_torch.envs import make_env
    config = CONFIGS[case]
    env_cfg = train.build_env_cfg(dict(config["env"]))
    penv = make_env(config["flags"][5], env_cfg, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    state, obs, _ = penv.reset(5, gen)
    acts = torch.rand(5, penv.n_agents, 1, generator=gen, dtype=torch.float64) * 2 - 1
    out = penv.step(state, penv.translate_actions(acts), gen)
    r = check.reference_env(config, torch.float64, "cpu")
    q = r.q_command(r.translate(acts[..., 0]), state.pv_p)
    vm, va, ok, pb, qb = r.solve(state.load_p, state.load_q, state.pv_p, q)
    assert ok.all()
    assert torch.allclose(vm, out.state.vm, atol=2e-5)
    assert torch.allclose(q, out.state.sgen_q, atol=1e-12)
    assert torch.allclose(r.reward(vm, q), out.reward, atol=2e-5)
    assert torch.allclose(r.obs(pb, qb, out.state.pv_p, q, vm, va), out.obs, atol=2e-3)
    z = r.noise_z(out.state.t, out.state.pv_p, out.state.load_p, out.state.load_q)
    assert z.min() >= -1e-9 and z.max() < 8
    # the reset's obs from the reset's own state
    vm0, va0, ok0, pb0, qb0 = r.solve(state.load_p, state.load_q, state.pv_p, state.sgen_q)
    assert torch.allclose(r.obs(pb0, qb0, state.pv_p, state.sgen_q, vm0, va0), obs, atol=2e-3)


def test_powerflow_to_tight_tolerance():
    from mapdn_torch.pf.newton import nr_solve
    _, tr = program("case33")
    pg = tr.env.grid
    g = grids.case33()
    y = torch.complex(torch.tensor(g.g), torch.tensor(g.b))
    rng = np.random.default_rng(1)
    p = torch.tensor(-rng.uniform(0, 0.2, (4, 33)))
    q = torch.tensor(-rng.uniform(0, 0.1, (4, 33)))
    vm, va, ok = powerflow.solve(y, p, q)
    grid64 = type(pg)(**{f: (getattr(pg, f).double() if torch.is_tensor(getattr(pg, f))
                             and getattr(pg, f).is_floating_point() else getattr(pg, f))
                         for f in pg.__dataclass_fields__})
    res = nr_solve(grid64, p, q, tol=1e-12, max_iter=50, inner_iters=3)
    assert ok.all() and res.converged.all()
    assert torch.allclose(vm, res.vm, atol=1e-10) and torch.allclose(va, res.va, atol=1e-10)


def test_networks_and_loss_against_the_port():
    """The drawn weights in the port's modules and the reference's
    functions: the same means, hidden states, values and PPO losses."""
    cfg, tr = program("case33", lanes=4)
    dims = {"obs": tr.env.obs_size, "agents": tr.env.n_agents, "hid": 64, "act": 1}
    w = weights.make(MAPPO.leaves(dims), 2 ** 31 + 7, "cpu")
    algo = tr.carry.algo
    MAPPO.load_weights(algo, w)
    w64 = {net: {k: v.double() for k, v in d.items()} for net, d in w.items()}
    gen = torch.Generator().manual_seed(0)
    b, n, o, h = 5, dims["agents"], dims["obs"], 64
    obs = torch.randn(b, n, o, generator=gen, dtype=torch.float64)
    hid = torch.randn(b, n, h, generator=gen, dtype=torch.float64) * 0.5
    m_p, _, h_p = tr.model.policy(algo.policy, obs, hid)
    m_r, h_r = nets.policy(w64["policy"], obs, hid)
    assert torch.allclose(m_p, m_r, atol=1e-12) and torch.allclose(h_p, h_r, atol=1e-12)
    assert torch.allclose(tr.model.value(algo.value, obs), nets.critic(w64["value"], obs), atol=1e-12)

    t, l = 6, 3
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    done = (torch.rand(t, l, generator=gen) < 0.2).double()
    batch = Transition(state=r(t, l, n, o), action=torch.tanh(r(t, l, n, 1)),
                       log_prob_a=r(t, l, n, 1) - 1.0, value=r(t, l, n), next_value=r(t, l, n),
                       reward=r(t, l, 1).expand(t, l, n), next_state=r(t, l, n, o), done=done,
                       last_step=done, last_hid=r(t, l, n, h) * 0.5, hid=r(t, l, n, 0))
    pl, vl, _ = ppo_loss(tr.model, algo, batch, tr.avail)
    alg = {**CONFIGS["case33"]["model"], **CONFIGS["case33"]["alg"]}
    rb = {k: getattr(batch, k) for k in ("state", "last_hid", "action", "log_prob_a", "value",
                                         "next_value", "reward", "done")}
    prep = ppo.prepared(rb, alg, torch.float64, "cpu")
    v_ref, _ = ppo.loss_grads("value", w64["value"], prep, alg)
    p_ref, _ = ppo.loss_grads("policy", w64["policy"], prep, alg)
    assert abs(float(vl.detach()) - v_ref) < 1e-10
    # the trainer logs the surrogate less entr x entropy; ppo_loss gives the surrogate
    assert abs(float(pl.detach()) - alg["entr"] * ppo.entropy(alg) - p_ref) < 1e-10


def test_replay_days_is_a_closed_loop():
    cell = spec.cell("case33_mappo.eval1")
    cell["traffic"] = dict(cell["traffic"], episode_limit=20)
    runner = spec.kind("eval").Runner(cell, 5, "cpu")
    runner.weights = weights.make(MAPPO.leaves({"obs": 38, "agents": 6, "hid": 64, "act": 1}),
                                  5, "cpu")
    days = [{"day": 3, "hour": 10, "quarter": 4, "a0": [0.1] * 6}]
    out = runner._replay(days, torch.float64, False, "cpu")
    assert out["vm"].shape == (1, 20, 33) and out["reward"].shape == (1, 19)
    assert bool(out["converged"].all())
