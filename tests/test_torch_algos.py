"""The algorithms of mapdn_torch against the JAX package's, in float64, at
case33's widths (6 agents, obs 38, action 1, GRU hid 64): the JAX
``init_state`` parameters (with targets from another key, so a swap of
behaviour and target shows) carried across with ``convert.from_flax``,
then on one batch (T = 4, L = 3, numpy seed) the rollout's actions, the
critic's ``value()`` (MAAC's with its attention regulariser), both losses
and their gradients against the policy and the value parameters, and for
FACMADDPG the value loss's gradient against the mixer's.  The losses'
draws (MATD3's target noise, COMA's baseline samples, SQDDPG's
coalitions, MAAC's policy and target-policy samples) are drawn with
``jax.random`` in the JAX code's key-split order and handed to the port.  Agent 2's action
slot is unavailable, so every mask is exercised."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import make_model
from mapdn_torch.algos.base import Transition
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.algos.base import Transition as JaxTransition
from mapdn_tpu.utils.config import load_config as jax_load_config

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


ALGS = ["iddpg", "maddpg", "matd3", "ippo", "iac", "coma", "sqddpg", "random", "maac",
        "facmaddpg"]
N, OBS, HID = 6, 38, 64
T, L = 4, 3
OVERRIDES = dict(agent_num=N, obs_size=OBS, action_dim=1, hid_size=HID)
ATOL, RTOL = 1e-9, 1e-8
AVAIL = np.ones((N, 1))
AVAIL[2] = 0.0
f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)
np64 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _batch(stores_next_hidden, seed=4):
    rng = np.random.RandomState(seed)
    done = (rng.rand(T, L) < 0.25).astype(np.float64)
    return dict(
        state=rng.randn(T, L, N, OBS), action=rng.uniform(-0.99, 0.99, (T, L, N, 1)),
        log_prob_a=rng.randn(T, L, N, 1) - 1.0, value=rng.randn(T, L, N),
        next_value=rng.randn(T, L, N), reward=np.repeat(rng.randn(T, L, 1), N, -1),
        next_state=rng.randn(T, L, N, OBS), done=done, last_step=done,
        last_hid=0.3 * rng.randn(T, L, N, HID),
        hid=0.3 * rng.randn(T, L, N, HID if stores_next_hidden else 0))


def positions(key, b, s):
    """SQDDPG's coalitions from one key (mapdn_tpu/algos/sqddpg.py:35-37)."""
    perms = jax.vmap(lambda k: jax.random.permutation(k, N))(jax.random.split(key, b * s))
    return np.array(perms).reshape(b, s, N)


def loss_draws(alg, key, cfg, b):
    """A loss's draws from its key, in the JAX code's split order."""
    if alg == "matd3":                      # matd3.py:57, sampling.py:118
        return {"target_noise": np.array(jax.random.normal(
            jax.random.split(key)[1], (b, N, 1), jnp.float64))}
    if alg == "coma":                       # coma.py:56, :69-70
        return {"sample_noise": np.array(jax.random.normal(
            jax.random.split(key)[1], (cfg.sample_size, b, N, 1), jnp.float64))}
    if alg == "sqddpg":                     # sqddpg.py:72, :83-93
        k = jax.random.split(key, 5)
        return {name: positions(kk, b, cfg.sample_size) for name, kk in
                zip(("policy_positions", "value_positions", "next_positions"), k[2:])}
    if alg == "maac":                       # maac.py:50-61
        return {name: np.array(jax.random.normal(k, (b, N, 1), jnp.float64))
                for name, k in zip(("policy_noise", "next_noise"), jax.random.split(key))}
    return {}


@pytest.fixture(scope="module", params=ALGS)
def pair(request):
    alg = request.param
    jcfg, _ = jax_load_config(alg, overrides=OVERRIDES)
    jmodel = jax_make_model(alg, jcfg)
    init = jax.jit(jmodel.init_state)
    jstate, other = f64(init(jax.random.PRNGKey(0))), f64(init(jax.random.PRNGKey(1)))
    jstate = jstate.replace(target_policy_params=other.policy_params,
                            target_value_params=other.value_params,
                            target_mixer_params=other.mixer_params)

    tcfg, _ = load_config(alg, overrides=OVERRIDES)
    tmodel = make_model(alg, tcfg, device="cpu", param_dtype=torch.float64)
    modules = {}
    for name, pp, vp in (("", jstate.policy_params, jstate.value_params),
                         ("target_", jstate.target_policy_params,
                          jstate.target_value_params)):
        modules[name + "policy"], modules[name + "value"] = convert.from_flax(
            np64(pp), np64(vp), tmodel.make_policy_module(), tmodel.make_value_module())
    mixers = {}
    if tmodel.uses_mixer:
        for name, mp in (("mixer", jstate.mixer_params),
                         ("target_mixer", jstate.target_mixer_params)):
            mixers[name] = convert.load_flax_mixer(tmodel.make_mixer_module(), np64(mp))
    tstate = tmodel.state_from_modules(modules["policy"], modules["value"],
                                       mixers.get("mixer"))
    tstate = dataclasses.replace(
        tstate, target_policy=modules["target_policy"].requires_grad_(False),
        target_value=modules["target_value"].requires_grad_(False))
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


def test_rollout_actions_match_jax(pair):
    """The rollout's exploring actions from the same standard normals."""
    alg, _, jmodel, jstate, tmodel, tstate = pair
    rng = np.random.RandomState(1)
    obs, hid = rng.randn(5, N, OBS), 0.3 * rng.randn(5, N, HID)
    key = jax.random.PRNGKey(2)
    jout = jmodel.get_actions(jstate.policy_params, jnp.asarray(obs), jnp.asarray(hid),
                              key, status="train", exploration=True,
                              avail=jnp.asarray(AVAIL))
    noise = np.array(jax.random.normal(key, (5, N, 1), jnp.float64))
    with torch.no_grad():
        tout = tmodel.get_actions(tstate.policy, torch.tensor(obs), torch.tensor(hid),
                                  status="train", exploration=True,
                                  avail=torch.tensor(AVAIL), noise=noise)
    for what, got, want in (("actions", tout[0], jout[0]), ("restore", tout[1], jout[1]),
                            ("log_prob", tout[2], jout[2]), ("means", tout[3][0], jout[3][0]),
                            ("log_stds", tout[3][1], jout[3][1]), ("hid", tout[4], jout[4])):
        _close(got, want, f"{alg} {what}")


def test_value_matches_jax(pair):
    alg, jcfg, jmodel, jstate, tmodel, tstate = pair
    rng = np.random.RandomState(3)
    obs, act = rng.randn(5, N, OBS), rng.uniform(-1, 1, (5, N, 1))
    args, kw = (jnp.asarray(obs), jnp.asarray(act)), {}
    if alg == "sqddpg":
        key = jax.random.PRNGKey(6)
        args += (key,)
        kw["positions"] = positions(key, 5, jcfg.sample_size)
    want = jmodel.value(jstate.value_params, *args)
    with torch.no_grad():
        got = tmodel.value(tstate.value, torch.tensor(obs), torch.tensor(act), **kw)
    if isinstance(want, tuple):     # matd3's twin (q1, q2); maac's (q, attend_reg)
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        for i in range(2):
            assert tuple(got[i].shape) == tuple(want[i].shape)
            _close(got[i], want[i], f"{alg} output {i}")
    else:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, alg)


def _grads(loss, params):
    if not loss.requires_grad:              # the random baseline's zero loss
        return [torch.zeros_like(p) for p in params]
    return torch.autograd.grad(loss, params, retain_graph=True)


def test_losses_and_gradients_match_jax(pair):
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
    draws = loss_draws(alg, key, jcfg, T * L)
    tpl, tvl, _ = tmodel.get_loss(tstate, tbatch, torch.tensor(AVAIL), draws=draws)
    _close(float(tpl.detach()), float(jpl), f"{alg} policy loss")
    _close(float(tvl.detach()), float(jvl), f"{alg} value loss")
    parts = [(tpl, "policy", jgp), (tvl, "value", jgv)]
    if tmodel.uses_mixer:
        parts.append((tvl, "mixer", jgm))
    for loss, which, jtree in parts:
        module = getattr(tstate, which)
        grads = _grads(loss, list(module.parameters()))
        want = _as_module(tmodel, jtree, which)
        for g, (name, w) in zip(grads, want.named_parameters()):
            _close(g.numpy(), w.detach().numpy(), f"{alg} {which}.{name}")
