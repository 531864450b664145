"""Per-agent parameters (``shared_params: False``) and ``RNNCritic`` in
mapdn_torch, against the JAX package's stacked parameter trees.

The counterparts of the six tests of tests/test_nonshared.py (parameters
stacked per agent; identical obs acting differently; a stack of one
module's slice giving the shared forward; finite, non-zero losses and
gradients of the nine algorithms; maac refusing; a training episode of
iddpg and mappo), then at float64 against JAX from converted stacked
weights: the nine algorithms' actions, values, losses and gradients at
case33's widths (the batch and draws of tests/test_torch_algos.py), one
training chunk of non-shared iddpg and mappo against JAX ``_train_chunk``
(the replay of tests/test_torch_trainer_algos.py), ``RNNCritic``'s
forward, shared and per agent, against flax's, and a checkpoint round
trip of per-agent state."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import MODEL_REGISTRY, Transition, make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.nets.agents import AGENT_LAYERS
from mapdn_torch.nets.critics import RNNCritic
from mapdn_torch.utils.checkpoint import (
    load_model, restore_checkpoint, save_checkpoint, save_model)
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.algos.base import Transition as JaxTransition
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
from mapdn_tpu.nets.critics import RNNCritic as JaxRNNCritic
from mapdn_tpu.utils.config import load_config as jax_load_config
from test_torch_algos import AVAIL, _batch, loss_draws, positions
from test_torch_cli import _assert_carries_equal
from test_torch_trainer_algos import COMMON, _f64, _np, _port_algo, _replay_chunk

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


NONSHARED_ALGS = sorted(a for a in MODEL_REGISTRY if a not in ("maac", "random"))
N_AGENTS, OBS, ACT, HID = 4, 12, 1, 16          # tests/test_algos.py's tiny sizes
N, CASE_OBS, CASE_HID = 6, 38, 64               # case33's widths
ATOL, RTOL = 1e-9, 1e-8                         # tests/test_torch_algos.py:47
np64 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def tiny_model(alg, shared=False, dtype=torch.float32, **over):
    cfg, _ = load_config(alg, overrides=dict(
        agent_num=N_AGENTS, obs_size=OBS, action_dim=ACT, hid_size=HID, sample_size=3,
        shared_params=shared, **over))
    return make_model(alg, cfg, device="cpu", param_dtype=dtype)


def tiny_batch(seed=1, t=4, l=2):
    rng = np.random.RandomState(seed)
    z = lambda *s: torch.tensor(rng.randn(t, l, *s), dtype=torch.float32)
    done = torch.tensor((rng.rand(t, l) < 0.2).astype(np.float32))
    return Transition(state=z(N_AGENTS, OBS), action=torch.tanh(z(N_AGENTS, ACT)),
                      log_prob_a=0.1 * z(N_AGENTS, ACT), value=z(N_AGENTS),
                      next_value=z(N_AGENTS), reward=z(1).expand(t, l, N_AGENTS),
                      next_state=z(N_AGENTS, OBS), done=done, last_step=done,
                      last_hid=torch.zeros(t, l, N_AGENTS, HID),
                      hid=torch.zeros(t, l, N_AGENTS, HID))


def test_policy_params_are_stacked_per_agent():
    model = tiny_model("iddpg")
    state = model.init_state(torch.Generator().manual_seed(0))
    for module in (state.policy, state.value, state.target_policy, state.target_value):
        for name, p in module.named_parameters():
            assert p.shape[0] == N_AGENTS, (name, p.shape)
    assert len(state.policy_opt) == len(list(state.policy.parameters()))


def test_agents_with_identical_obs_act_differently():
    """Distinct per-agent parameters break the symmetry that shared ones
    with agent-id one-hots would carry entirely."""
    model = tiny_model("iddpg", agent_id=False)
    state = model.init_state(torch.Generator().manual_seed(0))
    obs = torch.randn(1, 1, OBS, generator=torch.Generator().manual_seed(1)).expand(
        1, N_AGENTS, OBS)
    with torch.no_grad():
        means, _, _ = model.policy(state.policy, obs, model.init_hidden(1))
    assert float((means - means[:, :1]).abs().max()) > 1e-6


def _stack_of(shared_module, stacked_module):
    """Every agent's slice of ``stacked_module`` loaded from the shared
    module's parameters."""
    for name, layer in stacked_module.named_modules():
        if isinstance(layer, AGENT_LAYERS):
            for i in range(N_AGENTS):
                layer.load_agent_(i, shared_module.get_submodule(name))
    return stacked_module


@pytest.mark.parametrize("agent_type", ["rnn", "mlp"])
def test_shared_and_nonshared_same_function_class(agent_type):
    """A per-agent stack whose every slice holds the same parameters gives
    the shared forward (atol 1e-12 at float64), policy and critic."""
    shared = tiny_model("iddpg", shared=True, dtype=torch.float64, agent_type=agent_type)
    stacked = tiny_model("iddpg", dtype=torch.float64, agent_type=agent_type)
    s = shared.init_state(torch.Generator().manual_seed(0))
    policy = _stack_of(s.policy, stacked.make_policy_module())
    value = _stack_of(s.value, stacked.make_value_module())
    rng = np.random.RandomState(1)
    obs = torch.tensor(rng.randn(3, N_AGENTS, OBS))
    hid = torch.tensor(0.3 * rng.randn(3, N_AGENTS, HID))
    act = torch.tensor(rng.uniform(-1, 1, (3, N_AGENTS, ACT)))
    with torch.no_grad():
        for a, b in zip(shared.policy(s.policy, obs, hid), stacked.policy(policy, obs, hid)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
        torch.testing.assert_close(shared.value(s.value, obs, act),
                                   stacked.value(value, obs, act), rtol=0, atol=1e-12)


def test_init_draws_each_agent_as_a_shared_module():
    """Agent i's slice is a shared module drawn from the generator's state
    after agents 0..i-1: each agent's draws whole, in agent order."""
    drawn = tiny_model("iddpg").make_policy_module().reset_parameters(
        torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    shared = tiny_model("iddpg", shared=True)
    built = tiny_model("iddpg").make_policy_module()
    for i in range(N_AGENTS):
        one = shared.make_policy_module().reset_parameters(gen)
        for name, layer in built.named_modules():
            if isinstance(layer, AGENT_LAYERS):
                layer.load_agent_(i, one.get_submodule(name))
    for (name, p), q in zip(drawn.named_parameters(), built.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    assert float((drawn.fc1.weight[0] - drawn.fc1.weight[1]).abs().max().detach()) > 0


@pytest.mark.parametrize("alg", NONSHARED_ALGS)
def test_nonshared_loss_and_grads_finite(alg):
    model = tiny_model(alg)
    state = model.init_state(torch.Generator().manual_seed(0))
    pl, vl, _ = model.get_loss(state, tiny_batch(), torch.ones(N_AGENTS, ACT),
                               generator=torch.Generator().manual_seed(2))
    assert math.isfinite(float(pl.detach())) and math.isfinite(float(vl.detach()))
    for loss, module, name in ((pl, state.policy, "policy"), (vl, state.value, "value")):
        grads = torch.autograd.grad(loss, list(module.parameters()), retain_graph=True,
                                    allow_unused=True, materialize_grads=True)
        norms = [float(g.abs().sum()) for g in grads]
        assert all(math.isfinite(x) for x in norms), f"{alg} {name} grads NaN"
        assert sum(norms) > 0, f"{alg} {name} grads all zero"


def test_maac_nonshared_raises():
    with pytest.raises(NotImplementedError, match="attention critic"):
        tiny_model("maac")


def _smoke_trainer(alg, seed=0):
    env = make_env("case33", EnvConfig(episode_limit=8), days=8, device="cpu")
    info = env.get_env_info()
    cfg, _ = load_config(alg)
    cfg = cfg.replace(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], max_steps=8, behaviour_update_freq=4,
        batch_size=4, value_update_epochs=2, policy_update_epochs=1,
        target_update_freq=8, n_envs=2, num_eval_episodes=2,
        replay_buffer_size=64, hid_size=32, shared_params=False)
    model = make_model(alg, cfg, device="cpu")
    return model, PGTrainer(cfg, model, env).setup(seed=seed)


@pytest.mark.parametrize("alg", ["iddpg", "mappo"])
def test_trainer_smoke_nonshared(alg):
    """One episode moves every agent's slice of the policy."""
    _, trainer = _smoke_trainer(alg)
    p0 = [p.clone() for p in trainer.carry.algo.policy.parameters()]
    stats = trainer.run_episode()
    assert math.isfinite(stats["mean_train_reward"])
    moved = torch.stack([(p1 - q).flatten(1).abs().amax(1) for p1, q in
                         zip(trainer.carry.algo.policy.parameters(), p0)]).amax(0)
    assert moved.shape == (6,) and bool((moved > 0).all()), moved
    assert math.isfinite(trainer.evaluate()["mean_test_reward"])


# ------------------------------------------------- float64 parity with JAX
@pytest.fixture(scope="module", params=NONSHARED_ALGS)
def pair(request):
    """JAX's non-shared state at case33's widths (targets from another key)
    in float64, and the port's from the same stacked trees."""
    alg = request.param
    over = dict(agent_num=N, obs_size=CASE_OBS, action_dim=1, hid_size=CASE_HID,
                shared_params=False)
    jcfg, _ = jax_load_config(alg, overrides=over)
    jmodel = jax_make_model(alg, jcfg)
    init = jax.jit(jmodel.init_state)
    jstate, other = _f64(init(jax.random.PRNGKey(0))), _f64(init(jax.random.PRNGKey(1)))
    jstate = jstate.replace(target_policy_params=other.policy_params,
                            target_value_params=other.value_params,
                            target_mixer_params=other.mixer_params)
    for leaf in jax.tree_util.tree_leaves((jstate.policy_params, jstate.value_params)):
        assert leaf.shape[0] == N

    tcfg, _ = load_config(alg, overrides=over)
    tmodel = make_model(alg, tcfg, device="cpu", param_dtype=torch.float64)
    mods = {}
    for name, pp, vp in (("", jstate.policy_params, jstate.value_params),
                         ("target_", jstate.target_policy_params, jstate.target_value_params)):
        mods[name + "policy"], mods[name + "value"] = convert.from_flax(
            np64(pp), np64(vp), tmodel.make_policy_module(), tmodel.make_value_module())
    mixers = {}
    if tmodel.uses_mixer:
        for name, mp in (("mixer", jstate.mixer_params),
                         ("target_mixer", jstate.target_mixer_params)):
            mixers[name] = convert.load_flax_mixer(tmodel.make_mixer_module(), np64(mp))
    tstate = tmodel.state_from_modules(mods["policy"], mods["value"], mixers.get("mixer"))
    tstate = dataclasses.replace(
        tstate, target_policy=mods["target_policy"].requires_grad_(False),
        target_value=mods["target_value"].requires_grad_(False))
    if mixers:
        tstate.target_mixer = mixers["target_mixer"].requires_grad_(False)
    return alg, jcfg, jmodel, jstate, tmodel, tstate


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _as_module(tmodel, tree, which):
    """A flax-layout tree (parameters or gradients) in the port's layout."""
    if which == "policy":
        return convert.load_flax_policy(tmodel.make_policy_module(), np64(tree))
    if which == "mixer":
        return convert.load_flax_mixer(tmodel.make_mixer_module(), np64(tree))
    return convert.load_flax_critic(tmodel.make_value_module(), np64(tree))


def test_nonshared_actions_and_values_match_jax(pair):
    alg, jcfg, jmodel, jstate, tmodel, tstate = pair
    rng = np.random.RandomState(1)
    obs, hid = rng.randn(5, N, CASE_OBS), 0.3 * rng.randn(5, N, CASE_HID)
    act = rng.uniform(-1, 1, (5, N, 1))
    key = jax.random.PRNGKey(2)
    jout = jmodel.get_actions(jstate.policy_params, jnp.asarray(obs), jnp.asarray(hid), key,
                              status="train", exploration=True, avail=jnp.asarray(AVAIL))
    noise = np.array(jax.random.normal(key, (5, N, 1), jnp.float64))
    with torch.no_grad():
        tout = tmodel.get_actions(tstate.policy, torch.tensor(obs), torch.tensor(hid),
                                  status="train", exploration=True,
                                  avail=torch.tensor(AVAIL), noise=noise)
    for what, got, want in (("actions", tout[0], jout[0]), ("log_prob", tout[2], jout[2]),
                            ("means", tout[3][0], jout[3][0]), ("hid", tout[4], jout[4])):
        _close(got, want, f"{alg} {what}")
    args, kw = (jnp.asarray(obs), jnp.asarray(act)), {}
    if alg == "sqddpg":
        args += (jax.random.PRNGKey(6),)
        kw["positions"] = positions(jax.random.PRNGKey(6), 5, jcfg.sample_size)
    want = jmodel.value(jstate.value_params, *args)
    with torch.no_grad():
        got = tmodel.value(tstate.value, torch.tensor(obs), torch.tensor(act), **kw)
    for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, f"{alg} value")


def test_nonshared_losses_and_gradients_match_jax(pair):
    alg, jcfg, jmodel, jstate, tmodel, tstate = pair
    raw = _batch(tmodel.stores_next_hidden)
    jbatch = JaxTransition(**{k: jnp.asarray(v) for k, v in raw.items()})
    tbatch = Transition(**{k: torch.tensor(v) for k, v in raw.items()})
    key = jax.random.PRNGKey(7)
    avail = jnp.asarray(AVAIL)

    def jloss(pp, vp, mp):
        st = jstate.replace(policy_params=pp, value_params=vp, mixer_params=mp)
        pl, vl, _ = jmodel.get_loss(st, jbatch, avail, key)
        return pl, vl

    def jloss_and_grads(pp, vp, mp):
        gp = jax.grad(lambda p: jloss(p, vp, mp)[0])(pp)
        gv = jax.grad(lambda v: jloss(pp, v, mp)[1])(vp)
        gm = jax.grad(lambda m: jloss(pp, vp, m)[1])(mp)
        return jloss(pp, vp, mp), gp, gv, gm

    (jpl, jvl), jgp, jgv, jgm = jax.jit(jloss_and_grads)(
        jstate.policy_params, jstate.value_params, jstate.mixer_params)
    draws = loss_draws(alg, key, jcfg, raw["state"].shape[0] * raw["state"].shape[1])
    tpl, tvl, _ = tmodel.get_loss(tstate, tbatch, torch.tensor(AVAIL), draws=draws)
    _close(float(tpl.detach()), float(jpl), f"{alg} policy loss")
    _close(float(tvl.detach()), float(jvl), f"{alg} value loss")
    parts = [(tpl, "policy", jgp), (tvl, "value", jgv)]
    if tmodel.uses_mixer:
        parts.append((tvl, "mixer", jgm))
    for loss, which, jtree in parts:
        module = getattr(tstate, which)
        grads = torch.autograd.grad(loss, list(module.parameters()), retain_graph=True)
        want = _as_module(tmodel, jtree, which)
        for g, (name, w) in zip(grads, want.named_parameters()):
            _close(g.numpy(), w.detach().numpy(), f"{alg} {which}.{name}")


@pytest.mark.parametrize("alg", ["iddpg", "mappo"])
def test_nonshared_chunk_matches_jax(alg):
    """One 5-step chunk at 4 case33 lanes on a ring of capacity 4 (the
    stack-emit path), 2 value epochs and 1 policy epoch on windows of 2
    lanes, every draw replayed: the ring, the stats and every parameter
    and optimizer state."""
    chunk = 5
    jenv = jax_make_env("case33", JaxEnvConfig(episode_limit=240), days=8, dtype=jnp.float64)
    info = jenv.get_env_info()
    over = dict(COMMON, replay_buffer_size=16, behaviour_update_freq=chunk, max_steps=chunk,
                agent_num=info["n_agents"], obs_size=info["obs_shape"],
                action_dim=info["n_actions"], shared_params=False)
    jcfg, _ = jax_load_config(alg, overrides=over)
    jtr = JaxPGTrainer(jcfg, jax_make_model(alg, jcfg), jenv)
    carry = jax.jit(jtr.init_carry)(jax.random.PRNGKey(0))
    carry = carry.replace(algo=_f64(carry.algo))
    _, draws = _replay_chunk(carry.rng, jenv, jcfg, alg, chunk, 4, 4)
    jout, jstats = jax.jit(jtr._train_chunk)(carry)

    tenv = make_env("case33", EnvConfig(episode_limit=240), days=8, dtype=torch.float64,
                    device="cpu")
    tcfg, _ = load_config(alg, overrides=over)
    tmodel = make_model(alg, tcfg, device="cpu", param_dtype=torch.float64)
    ttr = PGTrainer(tcfg, tmodel, tenv)
    env_state = EnvState(**{f.name: torch.as_tensor(np.array(getattr(carry.env_state, f.name)))
                            for f in dataclasses.fields(EnvState)})
    tcarry = ttr.carry_from(env_state, torch.tensor(_np(carry.obs)),
                            _port_algo(tmodel, carry.algo), torch.Generator(),
                            torch.tensor(_np(carry.last_hid)))
    tout, tstats = ttr._train_chunk(tcarry, draws)

    np.testing.assert_allclose(tout.obs.numpy(), _np(jout.obs), rtol=0, atol=1e-9)
    for f in dataclasses.fields(tout.replay.data):
        got, want = getattr(tout.replay.data, f.name), getattr(jout.replay.data, f.name)
        assert tuple(got.shape) == tuple(want.shape), f.name
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-9, err_msg=f.name)
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-8, atol=1e-9,
                                   err_msg=k)
    pol, val = tmodel.make_policy_module, tmodel.make_value_module
    for module, tree, make, load in (
            (tout.algo.policy, jout.algo.policy_params, pol, convert.load_flax_policy),
            (tout.algo.value, jout.algo.value_params, val, convert.load_flax_critic)):
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for (name, got), ref in zip(module.named_parameters(), want.parameters()):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                       rtol=0, atol=1e-8, err_msg=f"{alg} {name}")
    for nu, tree, make, load in (
            (tout.algo.value_opt, jout.algo.value_opt[1][0].nu, val, convert.load_flax_critic),
            (tout.algo.policy_opt, jout.algo.policy_opt[1][0].nu, pol, convert.load_flax_policy)):
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for got, ref in zip(nu, want.parameters()):
            np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=0, atol=1e-8)


@pytest.mark.parametrize("per_agent", [None, 3])
def test_rnn_critic_matches_flax(per_agent):
    """``RNNCritic``: (value, hidden) from flax's parameters at float64,
    one module, or a stack of 3 applied agent by agent (vmap)."""
    kw = dict(hid_size=HID, layernorm=True, hid_activation="relu", init_type="normal",
              init_std=0.1)
    jmod = JaxRNNCritic(output_dim=2, **kw)
    rng = np.random.RandomState(0)
    lead = (5,) if per_agent is None else (5, per_agent)
    x, h = rng.randn(*lead, OBS), 0.3 * rng.randn(*lead, HID)
    init = lambda k: jmod.init(k, jnp.zeros((1, OBS)), jnp.zeros((1, HID)))
    if per_agent is None:
        params = _f64(init(jax.random.PRNGKey(0)))
        jv, jh = jmod.apply(params, jnp.asarray(x), jnp.asarray(h))
    else:
        params = _f64(jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0), per_agent)))
        jv, jh = jax.vmap(jmod.apply, in_axes=(0, 1, 1), out_axes=1)(
            params, jnp.asarray(x), jnp.asarray(h))
    module = convert.load_flax_critic(
        RNNCritic(OBS, output_dim=2, param_dtype=torch.float64, per_agent=per_agent, **kw),
        np64(params))
    with torch.no_grad():
        tv, th = module(torch.tensor(x), torch.tensor(h))
    assert tuple(tv.shape) == lead + (2,)
    _close(tv, jv, "value")
    _close(th, jh, "hidden")


def test_nonshared_checkpoint_round_trip(tmp_path):
    """Per-agent parameters, targets and optimizer states through
    save_model / load_model and the resumable checkpoint; the restored run
    trains on as the unbroken one; a shared model.pt does not load into a
    per-agent model."""
    model, t_a = _smoke_trainer("iddpg")
    t_a.run_episode()
    algo = t_a.carry.algo
    assert float(algo.policy_opt[0].abs().max()) > 0.0
    mpath = str(tmp_path / "model.pt")
    save_model(mpath, algo)
    restored = load_model(mpath, model.init_state(torch.Generator().manual_seed(123)))
    for name in ("policy", "value", "target_policy", "target_value"):
        for a, b in zip(getattr(algo, name).parameters(), getattr(restored, name).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    cdir = str(tmp_path / "ckpt")
    save_checkpoint(cdir, t_a.carry, t_a.steps, t_a.episodes)
    stats_a = t_a.run_episode()
    _, t_b = _smoke_trainer("iddpg", seed=99)
    carry, steps, episodes = restore_checkpoint(cdir, t_b.carry)
    t_b.carry, t_b.steps, t_b.episodes = carry, steps, episodes
    assert t_b.run_episode() == stats_a
    _assert_carries_equal(t_a.carry, t_b.carry)

    shared = tiny_model("iddpg", shared=True)
    save_model(str(tmp_path / "shared.pt"), shared.init_state(torch.Generator()))
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_model(str(tmp_path / "shared.pt"), tiny_model("iddpg").init_state(torch.Generator()))
