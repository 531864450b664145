"""The discrete-action helpers of mapdn_torch/learn/sampling.py against the
JAX package's (mapdn_tpu/learn/sampling.py:30-102), at float64 on the CPU.

Mirrors of tests/test_semantics.py's discrete tests (:147, :371, :394,
:405, :428, :455), each also run through the JAX function on the same
draws: the Gumbel uniforms are ``jax.random.uniform`` of the JAX key, the
categorical classes are the ones the JAX call drew.  Tolerances: 1e-12
on actions and log densities (the same float64 operations), 1e-9 on
gradients through autograd against ``jax.grad``; empirical laws within
0.03 over 4000 draws of the port's own generator, as the JAX tests hold
theirs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.learn import sampling
from mapdn_tpu.learn import sampling as jsampling

torch.set_num_threads(1)

N_SAMPLES = 4000


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other
    with threadpool_limits(1, user_api="blas"):
        yield


class _DiscreteCfg:
    """The config fields the discrete selection reads (reference
    util.py:87-121), as tests/test_semantics.py's shim."""
    def __init__(self, epsilon_softmax=False, gumbel_softmax=False, softmax_eps=0.1):
        self.epsilon_softmax = epsilon_softmax
        self.gumbel_softmax = gumbel_softmax
        self.softmax_eps = softmax_eps


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _logits(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def test_categorical_entropy_matches_jax():
    logits = _logits((4, 6, 5))
    want = float(jsampling.categorical_entropy(jnp.asarray(logits)))
    got = float(sampling.categorical_entropy(_t(logits)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the uniform law's entropy is log n
    np.testing.assert_allclose(float(sampling.categorical_entropy(torch.zeros(3, 5,
                                                                              dtype=torch.float64))),
                               np.log(5), rtol=1e-12)


@pytest.mark.parametrize("temperature", [0.01, 0.1, 1.0])
def test_gumbel_softmax_sample_matches_jax(temperature):
    """tests/test_semantics.py:147: at T=0.01 a draw is near one-hot;
    every temperature equal to the JAX draw from the same uniforms."""
    logits = np.array([[2.0, -1.0, 0.5, -3.0]])
    key = jax.random.PRNGKey(0)
    want = np.asarray(jsampling.gumbel_softmax_sample(key, jnp.asarray(logits), temperature))
    u = np.array(jax.random.uniform(key, logits.shape, jnp.float64))
    got = sampling.gumbel_softmax_sample(_t(logits), temperature, u=u).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert abs(got.sum() - 1.0) < 1e-12
    if temperature == 0.01:
        assert got.max() > 0.99


def test_multinomials_log_density_matches_closed_form():
    """tests/test_semantics.py:371: a hard one-hot's density is log
    softmax at its class, a relaxed sample's the convex combination; the
    trailing axis kept; both equal to the JAX function's."""
    logits = _logits((4, 6))
    idx = np.array([0, 3, 5, 2])
    onehot = np.eye(6)[idx]
    got = sampling.multinomials_log_density(_t(onehot), _t(logits)).numpy()
    assert got.shape == (4, 1)
    want = np.asarray(jsampling.multinomials_log_density(jnp.asarray(onehot),
                                                         jnp.asarray(logits)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(got[:, 0], logp[np.arange(4), idx], rtol=1e-12)
    relaxed = np.array([[0.5, 0.5, 0, 0, 0, 0]])
    got_r = float(sampling.multinomials_log_density(_t(relaxed), _t(logits[:1]))[0, 0])
    np.testing.assert_allclose(got_r, 0.5 * logp[0, 0] + 0.5 * logp[0, 1], rtol=1e-12)


def test_select_action_discrete_test_mode_greedy():
    """tests/test_semantics.py:394, and a tie: greedy is ``p == max(p)``,
    so every tied class is 1, as in the JAX function."""
    logits = np.array([[0.1, 2.0, -1.0], [3.0, 0.0, 0.5], [1.0, 1.0, 0.0]])
    got, logp = sampling.select_action_discrete(_DiscreteCfg(), _t(logits), status="test")
    assert logp is None
    want, _ = jsampling.select_action_discrete(_DiscreteCfg(), jax.random.PRNGKey(0),
                                               jnp.asarray(logits), status="test")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 0], [1, 0, 0], [1, 1, 0]])


def _jax_draws(cfg, logits, seed, **kw):
    """``N_SAMPLES`` JAX draws of ``select_action_discrete`` on ``logits``
    (one key each): (actions, log_prob)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), N_SAMPLES)
    return jax.jit(jax.vmap(lambda k: jsampling.select_action_discrete(
        cfg, k, jnp.asarray(logits), **kw)))(keys)


@pytest.mark.parametrize("branch", ["epsilon_softmax", "plain"])
def test_select_action_discrete_categorical_matches_jax(branch):
    """tests/test_semantics.py:405 (epsilon-softmax) and :455 (plain
    categorical): on the classes the JAX calls drew, the port's one-hots
    and log-probs equal JAX's; the port's own draws follow
    (1 - eps) * softmax + eps / n, or softmax, within 0.03."""
    if branch == "epsilon_softmax":
        cfg, logits, seed = _DiscreteCfg(epsilon_softmax=True, softmax_eps=0.2), [[1.0, 0.0, -1.0]], 1
    else:
        cfg, logits, seed = _DiscreteCfg(), [[0.5, -0.5, 1.5]], 3
    logits = np.asarray(logits)
    jacts, jlp = _jax_draws(cfg, logits, seed, status="train", exploration=True)
    jacts, jlp = np.asarray(jacts), np.asarray(jlp)
    batch = np.broadcast_to(logits, (N_SAMPLES,) + logits.shape)
    acts, lp = sampling.select_action_discrete(cfg, _t(batch), draws=jacts.argmax(-1))
    np.testing.assert_array_equal(acts.numpy(), jacts)
    np.testing.assert_allclose(lp.numpy(), jlp, rtol=0, atol=1e-12)

    soft = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))[0]
    law = 0.8 * soft + 0.2 / 3 if branch == "epsilon_softmax" else soft
    gen = torch.Generator().manual_seed(seed)
    own, own_lp = sampling.select_action_discrete(cfg, _t(batch), generator=gen)
    np.testing.assert_allclose(own.numpy()[:, 0].mean(0), law, atol=0.03)
    if branch == "epsilon_softmax":
        # the log of the smoothed probability at the drawn class
        np.testing.assert_allclose(own_lp.numpy()[:, 0, 0], np.log(law[own.numpy()[:, 0].argmax(-1)]),
                                   rtol=1e-12)


def test_select_action_discrete_gumbel_paths():
    """tests/test_semantics.py:428: with exploration a differentiable
    simplex point at T=0.1, without a detached T=1.0 sample; on JAX's
    uniforms the actions, log-probs and gradients of sum(a^2) equal JAX's,
    and the detached branch's gradient is zero."""
    cfg = _DiscreteCfg(gumbel_softmax=True)
    logits = np.array([[1.0, 0.0, -0.5], [0.2, 0.3, -0.1]])
    key = jax.random.PRNGKey(2)
    u = np.array(jax.random.uniform(key, logits.shape, jnp.float64))
    for exploration in (True, False):
        jfn = lambda lg: jsampling.select_action_discrete(
            cfg, key, lg, status="train", exploration=exploration)
        ja, jlp = jfn(jnp.asarray(logits))
        jgrad = np.asarray(jax.grad(lambda lg: jnp.sum(jfn(lg)[0] ** 2))(jnp.asarray(logits)))

        lg = _t(logits).requires_grad_(True)
        a, lp = sampling.select_action_discrete(cfg, lg, exploration=exploration, draws=u)
        loss = torch.sum(a ** 2)
        # a loss of the detached sample has no graph: its gradient is zero,
        # as jax.grad gives (the trainer's _grads does the same)
        grad = (torch.autograd.grad(loss, lg)[0] if loss.requires_grad
                else torch.zeros_like(lg))
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), rtol=0, atol=1e-12)
        np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=0, atol=1e-12)
        assert lp.shape == (2, 1)
        np.testing.assert_allclose(a.detach().sum(-1).numpy(), 1.0, rtol=1e-12)
        np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=1e-9)
        if exploration:
            assert float(grad.abs().max()) > 0
        else:
            np.testing.assert_array_equal(grad.numpy(), 0.0)
            assert not a.requires_grad and lp.requires_grad
