"""The networks of MAAC and FACMADDPG in mapdn_torch against the JAX
package's flax modules, in float64: the Gaussian agents (MLP and GRU), the
attention critic and the QMIX mixer.  Parameters are the flax modules'
``init`` (key 0) carried across with ``convert``; inputs come from a numpy
seed.  Forwards agree to 1e-12 (float64 rounding of a few hundred
products), and the parameter gradients of a scalar of the outputs to
1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.nets.agents import Dense, MLPAgentGaussian, RNNAgentGaussian
from mapdn_torch.nets.critics import AgentDense, AttentionCritic, QMixer
from mapdn_tpu.nets import agents as jax_agents
from mapdn_tpu.nets import critics as jax_critics

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


N, OBS, ACT, HID, B = 6, 10, 1, 16, 7
FWD_ATOL, GRAD_ATOL = 1e-12, 1e-10
np64 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _init(module, *example):
    return np64(jax.jit(module.init)(jax.random.PRNGKey(0), *example))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x, np.float64)


def _close(got, want, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol, err_msg=what)


def _grads_close(tmodule, loss, jgrads, load, atol):
    """The port's parameter gradients of ``loss`` against JAX's tree,
    carried into the port's layout by ``load``."""
    params = list(tmodule.parameters())
    grads = torch.autograd.grad(loss, params)
    want = load(np64(jgrads))
    for g, (name, w) in zip(grads, want.named_parameters()):
        _close(g, w, atol, name)


@pytest.mark.parametrize("kind", ["mlp", "rnn"])
def test_gaussian_agent_matches_flax(kind):
    """Mean, tanh-bounded log-std and GRU state; the log-std spans the
    configuration's [LOG_STD_MIN, LOG_STD_MAX] = [0, 0.5] unclamped."""
    jcls, tcls = {"mlp": (jax_agents.MLPAgentGaussian, MLPAgentGaussian),
                  "rnn": (jax_agents.RNNAgentGaussian, RNNAgentGaussian)}[kind]
    in_dim = OBS + N
    jmod = jcls(hid_size=HID, action_dim=2, log_std_min=0.0, log_std_max=0.5)
    rng = np.random.RandomState(0)
    x, h = 3.0 * rng.randn(B, in_dim), 0.3 * rng.randn(B, HID)
    params = _init(jmod, jnp.zeros((1, in_dim)), jnp.zeros((1, HID)))
    make = lambda: tcls(in_dim, action_dim=2, hid_size=HID, log_std_min=0.0,
                        log_std_max=0.5, param_dtype=torch.float64)
    tmod = convert.load_flax_policy(make(), params)

    jmean, jlog_std, jh = jax.jit(jmod.apply)(params, jnp.asarray(x), jnp.asarray(h))
    tmean, tlog_std, th = tmod(torch.tensor(x), torch.tensor(h))
    _close(tmean, jmean, FWD_ATOL, "mean")
    _close(tlog_std, jlog_std, FWD_ATOL, "log_std")
    _close(th, jh, FWD_ATOL, "hidden")
    assert 0.0 <= float(tlog_std.detach().min()) and float(tlog_std.detach().max()) <= 0.5

    def jscalar(p):
        m, ls, hh = jmod.apply(p, jnp.asarray(x), jnp.asarray(h))
        return jnp.sum(m * m) + jnp.sum(jnp.sin(ls)) + jnp.sum(hh)

    _grads_close(tmod, torch.sum(tmean**2) + torch.sum(torch.sin(tlog_std)) + torch.sum(th),
                 jax.jit(jax.grad(jscalar))(params), lambda t: convert.load_flax_policy(make(), t),
                 GRAD_ATOL)


@pytest.mark.parametrize("heads", [1, 2, 3])
def test_attention_critic_matches_flax(heads):
    """q and the attention regulariser; 3 heads leave hid 16 a head width
    of 5 and 15 projected features (the JAX module's head_dim * heads)."""
    jmod = jax_critics.AttentionCritic(n_agents=N, obs_dim=OBS, act_dim=ACT, hid_size=HID,
                                       attend_heads=heads)
    params = _init(jmod, jnp.zeros((1, N, OBS)), jnp.zeros((1, N, ACT)))
    make = lambda: AttentionCritic(N, OBS, ACT, hid_size=HID, attend_heads=heads,
                                   param_dtype=torch.float64)
    tmod = convert.load_flax_critic(make(), params)
    rng = np.random.RandomState(1)
    obs, act = rng.randn(B, N, OBS), rng.uniform(-1, 1, (B, N, ACT))

    jq, jreg = jax.jit(jmod.apply)(params, jnp.asarray(obs), jnp.asarray(act))
    tq, treg = tmod(torch.tensor(obs), torch.tensor(act))
    assert tuple(tq.shape) == (B, N) and tuple(treg.shape) == (N,)
    _close(tq, jq, FWD_ATOL, "q")
    _close(treg, jreg, FWD_ATOL, "attend_reg")

    def jscalar(p):
        q, reg = jmod.apply(p, jnp.asarray(obs), jnp.asarray(act))
        return jnp.sum(jnp.tanh(q)) + jnp.sum(reg)

    _grads_close(tmod, torch.sum(torch.tanh(tq)) + torch.sum(treg), jax.jit(jax.grad(jscalar))(params),
                 lambda t: convert.load_flax_critic(make(), t), GRAD_ATOL)


def test_attention_critic_ignores_norm_in():
    """JAX declares ``norm_in`` and never reads it; so does the port."""
    rng = np.random.RandomState(2)
    obs, act = torch.tensor(rng.randn(B, N, OBS)), torch.tensor(rng.randn(B, N, ACT))
    outs = []
    for norm_in in (False, True):
        mod = AttentionCritic(N, OBS, ACT, hid_size=HID, norm_in=norm_in,
                              param_dtype=torch.float64)
        outs.append(mod.reset_parameters(torch.Generator().manual_seed(0))(obs, act))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("skip", [False, True])
def test_qmixer_matches_flax(layers, gated, skip):
    """q_tot on the global state; one- and two-layer hypernets (whose
    unnamed layers flax numbers in creation order), the gate and the skip
    connection."""
    sd = N * OBS
    jmod = jax_critics.QMixer(n_agents=N, state_dim=sd, embed_dim=8, hypernet_layers=layers,
                              hypernet_embed=12, gated=gated, skip_connections=skip)
    params = _init(jmod, jnp.zeros((1, N)), jnp.zeros((1, sd)))
    make = lambda: QMixer(N, sd, embed_dim=8, hypernet_layers=layers, hypernet_embed=12,
                          gated=gated, skip_connections=skip, param_dtype=torch.float64)
    tmod = convert.load_flax_mixer(make(), params)
    assert sum(p.numel() for p in tmod.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    rng = np.random.RandomState(3)
    qs, states = rng.randn(B, N), rng.randn(B, sd)

    jq = jax.jit(jmod.apply)(params, jnp.asarray(qs), jnp.asarray(states))
    tq = tmod(torch.tensor(qs), torch.tensor(states))
    assert tuple(tq.shape) == (B, 1)
    _close(tq, jq, FWD_ATOL, "q_tot")

    def jscalar(p):
        return jnp.sum(jnp.sin(jmod.apply(p, jnp.asarray(qs), jnp.asarray(states))))

    _grads_close(tmod, torch.sum(torch.sin(tq)), jax.jit(jax.grad(jscalar))(params),
                 lambda t: convert.load_flax_mixer(make(), t), GRAD_ATOL)


@pytest.mark.parametrize("which", ["attention", "qmixer"])
def test_reset_parameters_draws_flax_dense_defaults(which):
    """The critics' fresh parameters follow flax's ``nn.Dense`` defaults:
    lecun-normal kernels (truncated at 2 std, std sqrt(1/fan_in) after the
    truncation's correction), zero biases; the mixer's gate starts at 0.5."""
    if which == "attention":
        mod = AttentionCritic(N, OBS, ACT, hid_size=64, attend_heads=2)
    else:
        mod = QMixer(N, N * OBS, gated=True)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    layers = [m for m in mod.modules() if isinstance(m, (Dense, AgentDense))]
    assert layers
    for layer in layers:
        w = layer.weight.detach().double()
        fan_in = w.shape[1]
        bound = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= bound + 1e-7
        if w.numel() >= 4096:                   # a sample large enough for its std
            assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
        if layer.bias is not None:
            assert float(layer.bias.detach().abs().max()) == 0.0
    if which == "qmixer":
        assert float(mod.gate.detach()) == 0.5
