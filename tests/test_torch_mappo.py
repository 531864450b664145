"""mapdn_torch networks and MAPPO learner vs the JAX package's, in float64:
parameters carried across with ``convert.from_flax``, then forwards, GAE,
the PPO losses and their gradients, and one clipped-RMSprop step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdn_torch import convert
from mapdn_torch.algos import MAPPO
from mapdn_torch.algos.base import Transition
from mapdn_torch.learn.losses import gae_advantages, ppo_loss
from mapdn_torch.nets.agents import MLPAgent
from mapdn_torch.nets.critics import MLPCritic
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.algos.base import Transition as JaxTransition
from mapdn_tpu.learn import losses as jax_losses
from mapdn_tpu.nets import agents as jax_agents
from mapdn_tpu.nets import critics as jax_critics
from mapdn_tpu.utils.config import load_config as jax_load_config

torch.set_num_threads(1)

N, OBS, HID = 3, 5, 8
OVERRIDES = dict(agent_num=N, obs_size=OBS, action_dim=1, hid_size=HID)
f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)
np64 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


@pytest.fixture(scope="module")
def models():
    jcfg, _ = jax_load_config("mappo", overrides=OVERRIDES)
    tcfg, _ = load_config("mappo", overrides=OVERRIDES)
    jmodel = jax_make_model("mappo", jcfg)
    jstate = f64(jax.jit(jmodel.init_state)(jax.random.PRNGKey(0)))
    tmodel = MAPPO(tcfg, device="cpu", param_dtype=torch.float64)
    policy, value = convert.from_flax(
        np64(jstate.policy_params), np64(jstate.value_params),
        tmodel.make_policy_module(), tmodel.make_value_module())
    return jmodel, jstate, tmodel, tmodel.state_from_modules(policy, value)


def _as_module(tmodel, tree, which):
    """A flax-layout tree (params or gradients) in the port's layout."""
    if which == "policy":
        return convert.load_flax_policy(tmodel.make_policy_module(), np64(tree))
    return convert.load_flax_critic(tmodel.make_value_module(), np64(tree))


def _assert_module_close(got, want, tol):
    for (name, a), b in zip(got.named_parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=tol, err_msg=name)


def test_policy_and_critic_forwards(models):
    jmodel, jstate, tmodel, tstate = models
    rng = np.random.RandomState(0)
    obs = rng.randn(7, N, OBS)
    hid = 0.3 * rng.randn(7, N, HID)
    jm, _, jh = jmodel.policy(jstate.policy_params, jnp.asarray(obs), jnp.asarray(hid))
    tm, _, th = tmodel.policy(tstate.policy, torch.tensor(obs), torch.tensor(hid))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), rtol=0, atol=1e-9)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0, atol=1e-9)
    jv = jmodel.value(jstate.value_params, jnp.asarray(obs))
    tv = tmodel.value(tstate.value, torch.tensor(obs))
    assert tv.shape == (7, N)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["mlp_agent", "mlp_critic"])
def test_mlp_forwards(kind):
    x = np.random.RandomState(1).randn(4, OBS)
    if kind == "mlp_agent":
        jmod = jax_agents.MLPAgent(hid_size=HID, action_dim=2)
        tmod = MLPAgent(OBS, action_dim=2, hid_size=HID, param_dtype=torch.float64)
        params = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS)))
        want = jmod.apply(f64(params), jnp.asarray(x))[0]
        got = convert.load_flax_policy(tmod, np64(params))(torch.tensor(x))[0]
    else:
        jmod = jax_critics.MLPCritic(hid_size=HID, output_dim=2)
        tmod = MLPCritic(OBS, output_dim=2, hid_size=HID, param_dtype=torch.float64)
        params = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS)))
        want = jmod.apply(f64(params), jnp.asarray(x))
        got = convert.load_flax_critic(tmod, np64(params))(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-9)


def test_gae_advantages():
    rng = np.random.RandomState(3)
    r, nv, v = rng.randn(3, 6, 4, N)
    mask = (rng.rand(6, 4, 1) > 0.3).astype(np.float64)
    want = jax_losses.gae_advantages(jnp.asarray(r), jnp.asarray(nv), jnp.asarray(v),
                                     jnp.asarray(mask), 0.99, 0.95)
    got = gae_advantages(*(torch.tensor(a) for a in (r, nv, v, mask)), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def _batch(T=4, L=3, seed=4):
    rng = np.random.RandomState(seed)
    done = (rng.rand(T, L) < 0.25).astype(np.float64)
    return dict(
        state=rng.randn(T, L, N, OBS), action=rng.uniform(-0.99, 0.99, (T, L, N, 1)),
        log_prob_a=rng.randn(T, L, N, 1) - 1.0, value=rng.randn(T, L, N),
        next_value=rng.randn(T, L, N), reward=np.repeat(rng.randn(T, L, 1), N, -1),
        next_state=rng.randn(T, L, N, OBS), done=done, last_step=done,
        last_hid=0.3 * rng.randn(T, L, N, HID), hid=np.zeros((T, L, N, 0)))


def test_ppo_loss_and_gradients(models):
    jmodel, jstate, tmodel, tstate = models
    raw = _batch()
    avail = np.ones((N, 1))
    jbatch = JaxTransition(**{k: jnp.asarray(v) for k, v in raw.items()})
    tbatch = Transition(**{k: torch.tensor(v) for k, v in raw.items()})
    key = jax.random.PRNGKey(0)

    def jloss(pp, vp):
        st = jstate.replace(policy_params=pp, value_params=vp)
        pl, vl, _ = jax_losses.ppo_loss(jmodel, st, jbatch, jnp.asarray(avail), key)
        return pl, vl

    def jloss_and_grads(pp, vp):
        gp = jax.grad(lambda p: jloss(p, vp)[0])(pp)
        gv = jax.grad(lambda v: jloss(pp, v)[1])(vp)
        return jloss(pp, vp), gp, gv

    (jpl, jvl), jgp, jgv = jax.jit(jloss_and_grads)(jstate.policy_params,
                                                    jstate.value_params)

    tpl, tvl, (means, log_stds) = ppo_loss(tmodel, tstate, tbatch, torch.tensor(avail))
    assert means.shape == (12, N, 1) and log_stds.shape == (12, N, 1)
    np.testing.assert_allclose(float(tpl.detach()), float(jpl), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(tvl.detach()), float(jvl), rtol=1e-9, atol=1e-12)
    gp = torch.autograd.grad(tpl, list(tstate.policy.parameters()))
    gv = torch.autograd.grad(tvl, list(tstate.value.parameters()))
    for grads, jtree, which in ((gp, jgp, "policy"), (gv, jgv, "value")):
        want = _as_module(tmodel, jtree, which)
        for g, (name, w) in zip(grads, want.named_parameters()):
            np.testing.assert_allclose(g.numpy(), w.detach().numpy(), rtol=0,
                                       atol=1e-9, err_msg=f"{which}.{name}")


@pytest.mark.parametrize("grad_scale", [0.01, 30.0])
def test_clipped_rmsprop_step_matches_optax(models, grad_scale):
    """One optimizer step from fresh state, below and above the clip norm."""
    jmodel, jstate, tmodel, _ = models
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(grad_scale * rng.randn(*p.shape)), jstate.value_params)
    updates, _ = jax.jit(jmodel.value_tx.update)(
        grads, f64(jmodel.value_tx.init(jstate.value_params)), jstate.value_params)
    want = jax.tree_util.tree_map(lambda p, u: p + u, jstate.value_params, updates)

    module = _as_module(tmodel, jstate.value_params, "value")
    params = list(module.parameters())
    nu = tmodel.value_tx.init(params)
    tmodel.value_tx.step(params, [p.detach() for p in
                                  _as_module(tmodel, grads, "value").parameters()], nu)
    _assert_module_close(module, _as_module(tmodel, want, "value"), 1e-12)
