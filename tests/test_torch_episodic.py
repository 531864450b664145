"""Episodic mode of mapdn_torch's trainer (``cfg.episodic``) against the
JAX package's: ``sample_episodes`` on one pool with replayed keys; the
episode cadence of tests/test_algos.py:157-181; and, at float64 on case33,
two episodes collected by ``_train_chunk`` then ``_episodic_update`` with
the draws of ``PRNGKey(7)`` (as tests/test_parallel.py:114-125 runs the
JAX trainer) for coma (on-policy: the pool is cleared), mappo (the
rollout values filled over each episode) and iddpg (off-policy: the pool
is kept; then the soft target update).  4 lanes, 6-step episodes, a pool
of 2 slots, batches of 4 episodes, every draw replayed from the JAX key
splits with the helpers of tests/test_torch_trainer_algos.py.  Last, a
checkpoint round trip of an episodic carry and a resumed run equal to an
unbroken one."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import Transition, make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.learn import replay as jax_rb
from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
from mapdn_tpu.utils.config import load_config as jax_load_config
from test_torch_cli import _assert_carries_equal
from test_torch_trainer_algos import _f64, _lane_noise, _loss_draws, _np, _port_algo

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


L, T, HID, BATCH = 4, 6, 16, 4
EPISODIC = dict(n_envs=L, max_steps=T, episodic=True, batch_size=BATCH,
                replay_buffer_size=2 * L, value_update_epochs=2, policy_update_epochs=1,
                hid_size=HID, replay_bf16=False, update_epoch_unroll=1, rollout_unroll=1)


def _pool(seed, capacity=3, t=5, n_env=7, n=2, o=3, h=4):
    """A filled (capacity, T, n_env, ...) pool of numpy arrays, every field
    distinct."""
    rng = np.random.RandomState(seed)
    shapes = dict(state=(n, o), action=(n, 1), log_prob_a=(n, 1), value=(n,),
                  next_value=(n,), reward=(n,), next_state=(n, o), done=(), last_step=(),
                  last_hid=(n, h), hid=(n, h))
    return {k: rng.randn(capacity, t, n_env, *s) for k, s in shapes.items()}


@pytest.mark.parametrize("size", [1, 2, 3])
def test_sample_episodes_matches_jax(size):
    """The same (slot, lane) draws give the same (T, batch, ...) batch: the
    batch axis second, as JAX's ``moveaxis``; and the port's own draws stay
    in the filled slots."""
    data = _pool(size)
    jstate = jax_rb.ReplayState(data={k: jnp.asarray(v) for k, v in data.items()},
                                ptr=jnp.asarray(size % 3, jnp.int32),
                                size=jnp.asarray(size, jnp.int32))
    key = jax.random.PRNGKey(size)
    want = jax_rb.sample_episodes(jstate, key, 9)
    k_slot, k_lane = jax.random.split(key)               # replay.py:181
    slots = np.array(jax.random.randint(k_slot, (9,), 0, max(size, 1)))
    lanes = np.array(jax.random.randint(k_lane, (9,), 0, 7))
    tstate = rb.ReplayState(data=Transition(**{k: torch.tensor(v) for k, v in data.items()}),
                            ptr=size % 3, size=size)
    got = rb.sample_episodes(tstate, 9, draws=(slots, lanes))
    for k, v in data.items():
        w = np.asarray(want[k])
        assert w.shape == (5, 9) + v.shape[3:], k
        np.testing.assert_array_equal(getattr(got, k).numpy(), w, err_msg=k)
    np.testing.assert_array_equal(got.reward.numpy(), data["reward"][slots, :, lanes].swapaxes(0, 1))
    drawn = rb.sample_episodes(tstate, 500, generator=torch.Generator().manual_seed(0))
    picked = {float(x) for x in drawn.done[0]}
    filled = {float(x) for x in data["done"][:size, 0].ravel()}
    assert picked <= filled and len(picked) > 1


def _episodic_trainer(alg, seed=0, **over):
    env = make_env("case33", EnvConfig(episode_limit=T), days=2, device="cpu")
    info = env.get_env_info()
    cfg, _ = load_config(alg)
    cfg = cfg.replace(**dict(
        dict(agent_num=info["n_agents"], obs_size=info["obs_shape"],
             action_dim=info["n_actions"], n_envs=3, max_steps=T, episodic=True,
             behaviour_update_freq=2, target_update_freq=4, batch_size=2,
             replay_buffer_size=12, value_update_epochs=2, policy_update_epochs=1,
             num_eval_episodes=2, hid_size=HID), **over))
    model = make_model(alg, cfg, device="cpu")
    return env, model, cfg, PGTrainer(cfg, model, env).setup(seed=seed)


def test_episodic_mode_trains():
    """tests/test_algos.py's cadence: no update at episode 1, one at episode
    2; the soft target update at episode 4 and not before; 4 slots of 3
    lanes, the pointer wrapping."""
    _, _, _, trainer = _episodic_trainer("iddpg")
    assert trainer.carry.replay.data.reward.shape == (4, T, 3, 6)
    target = [p.clone() for p in trainer.carry.algo.target_policy.parameters()]
    moved = lambda: max(float((p - q).abs().max()) for p, q in
                        zip(trainer.carry.algo.target_policy.parameters(), target))
    s1 = trainer.run_episode()
    assert "mean_train_value_loss" not in s1
    s2 = trainer.run_episode()
    assert "mean_train_value_loss" in s2
    assert math.isfinite(s2["mean_train_value_loss"])
    assert math.isfinite(s2["mean_train_reward"])
    trainer.run_episode()
    assert moved() == 0.0 and trainer.episodes == 3
    trainer.run_episode()
    assert moved() > 0.0
    trainer.run_episode()
    replay = trainer.carry.replay
    assert (replay.ptr, replay.size, trainer.steps) == (1, 4, 5 * T)
    assert math.isfinite(trainer.evaluate()["mean_test_reward"])


def _update_draws(alg, cfg, key, size, n):
    """The draws of JAX ``_episodic_update(carry, key)``: each epoch's
    (slots, lanes) and its loss's draws (trainer.py:363, :355, :307;
    replay.py:181-184)."""
    draws = {}
    for which, k_phase in zip(("value", "policy"), jax.random.split(key, 3)):
        episodes, loss = [], []
        for k in jax.random.split(k_phase, getattr(cfg, f"{which}_update_epochs")):
            k_samp, k_loss = jax.random.split(k)
            k_slot, k_lane = jax.random.split(k_samp)
            episodes.append((np.array(jax.random.randint(k_slot, (BATCH,), 0, max(size, 1))),
                             np.array(jax.random.randint(k_lane, (BATCH,), 0, L))))
            loss.append(_loss_draws(alg, k_loss, cfg, T * BATCH, n))
        draws.update({f"{which}_episodes": episodes, f"{which}_loss": loss})
    return draws


def _chunk_draws(rng, env):
    """The step draws of one JAX episodic ``_train_chunk`` from its carry's
    rng (no update key: the update runs outside the chunk)."""
    steps = []
    for _ in range(T):
        rng, k_act, k_env = jax.random.split(rng, 3)
        k_step = jax.vmap(lambda k: jax.random.split(k, 3))(jax.random.split(k_env, L))[:, 0]
        steps.append({"action_noise": _np(jax.random.normal(k_act, (L, env.n_agents, 1),
                                                            jnp.float64)),
                      "env": {"step_noise": _lane_noise(env, k_step)}})
    return rng, {"steps": steps}


@pytest.fixture(scope="module", params=["coma", "mappo", "iddpg"])
def episodic_pair(request):
    alg = request.param
    env_cfg = dict(episode_limit=240)     # no lane ends inside the run
    jenv = jax_make_env("case33", JaxEnvConfig(**env_cfg), days=8, dtype=jnp.float64)
    info = jenv.get_env_info()
    over = dict(EPISODIC, agent_num=info["n_agents"], obs_size=info["obs_shape"],
                action_dim=info["n_actions"])
    jcfg, _ = jax_load_config(alg, overrides=over)
    jtr = JaxPGTrainer(jcfg, jax_make_model(alg, jcfg), jenv)
    carry = jax.jit(jtr.init_carry)(jax.random.PRNGKey(0))
    carry = carry.replace(algo=_f64(carry.algo))
    assert carry.replay.data.reward.shape[:3] == (2, T, L)
    # the port's start, read before the JAX chunks take the carry
    start = dict(env_state={f.name: np.array(getattr(carry.env_state, f.name))
                            for f in dataclasses.fields(EnvState)},
                 obs=_np(carry.obs), last_hid=_np(carry.last_hid),
                 algo=jax.tree_util.tree_map(np.array, carry.algo))

    rng, chunk_draws, jstats = carry.rng, [], []
    jout = carry
    for _ in range(2):
        rng, d = _chunk_draws(rng, jenv)
        chunk_draws.append(d)
        jout, st = jtr._jit_chunk(jout)
        jstats.append(st)
    jmid = jout
    jout, jupd = jtr._jit_episodic_update(jout, jax.random.PRNGKey(7))

    tenv = make_env("case33", EnvConfig(**env_cfg), days=8, dtype=torch.float64, device="cpu")
    tcfg, _ = load_config(alg, overrides=over)
    tmodel = make_model(alg, tcfg, device="cpu", param_dtype=torch.float64)
    ttr = PGTrainer(tcfg, tmodel, tenv)
    env_state = EnvState(**{k: torch.as_tensor(v) for k, v in start["env_state"].items()})
    tout = ttr.carry_from(env_state, torch.tensor(start["obs"]),
                          _port_algo(tmodel, start["algo"]), torch.Generator(),
                          torch.tensor(start["last_hid"]))
    tstats = []
    for d in chunk_draws:
        tout, st = ttr._train_chunk(tout, d)
        tstats.append(st)
    tmid = {f.name: getattr(tout.replay.data, f.name).clone()
            for f in dataclasses.fields(Transition)}
    assert (tout.replay.ptr, tout.replay.size) == (int(jmid.replay.ptr), int(jmid.replay.size))
    draws = _update_draws(alg, jcfg, jax.random.PRNGKey(7), int(jmid.replay.size),
                          info["n_agents"])
    tout, tupd = ttr._episodic_update(tout, draws)
    extra = {}
    if alg == "iddpg":
        ttr._soft_update(tout.algo)
        extra["target"] = (jax.jit(jtr._soft_update)(jout.algo), tout.algo)
    return alg, tmodel, jmid, jout, jstats, jupd, tmid, tout, tstats, tupd, extra


def test_episodes_and_pool_match_jax(episodic_pair):
    alg, tmodel, jmid, jout, jstats, _, tmid, tout, tstats, _, _ = episodic_pair
    assert tout.steps == int(jout.steps) == 2 * T
    np.testing.assert_allclose(tout.obs.numpy(), _np(jout.obs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tout.last_hid.numpy(), _np(jout.last_hid), rtol=0, atol=1e-9)
    for f in dataclasses.fields(EnvState):
        np.testing.assert_allclose(getattr(tout.env_state, f.name).numpy(),
                                   _np(getattr(jout.env_state, f.name)),
                                   rtol=0, atol=1e-9, err_msg=f.name)
    # the pool after both episodes, before the update: (slots, T, lanes, ...)
    for name, got in tmid.items():
        want = getattr(jmid.replay.data, name)
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-9, err_msg=name)
    if alg == "mappo":
        assert float(tmid["value"].abs().max()) > 0.0    # the values were filled
    # after the update: coma and mappo cleared, iddpg kept
    assert (tout.replay.ptr, tout.replay.size) == (int(jout.replay.ptr), int(jout.replay.size))
    assert tout.replay.size == (0 if tmodel.on_policy else 2)
    for t, j in zip(tstats, jstats):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-8, atol=1e-9,
                                       err_msg=k)


def test_episodic_update_matches_jax(episodic_pair):
    alg, tmodel, _, jout, _, jupd, _, tout, _, tupd, extra = episodic_pair
    assert set(tupd) == set(jupd)
    for k in jupd:
        np.testing.assert_allclose(float(tupd[k]), float(jupd[k]), rtol=1e-8, atol=1e-9,
                                   err_msg=k)
    algo = jout.algo
    pol, val = tmodel.make_policy_module, tmodel.make_value_module
    pairs = [(tout.algo.policy, algo.policy_params, pol, convert.load_flax_policy),
             (tout.algo.value, algo.value_params, val, convert.load_flax_critic)]
    if "target" in extra:
        jalgo, talgo = extra["target"]
        pairs += [(talgo.target_policy, jalgo.target_policy_params, pol,
                   convert.load_flax_policy),
                  (talgo.target_value, jalgo.target_value_params, val,
                   convert.load_flax_critic)]
    for module, tree, make, load in pairs:
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for (name, got), ref in zip(module.named_parameters(), want.parameters()):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                       rtol=0, atol=1e-8, err_msg=f"{alg} {name}")
    for nu, tree, make, load in ((tout.algo.value_opt, algo.value_opt[1][0].nu, val,
                                  convert.load_flax_critic),
                                 (tout.algo.policy_opt, algo.policy_opt[1][0].nu, pol,
                                  convert.load_flax_policy)):
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for got, ref in zip(nu, want.parameters()):
            np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=0, atol=1e-8)


def test_episodic_checkpoint_round_trip_and_resume(tmp_path):
    """An episodic carry (a part-filled pool of mappo's episodes with its
    values) saves and restores into a fresh trainer's carry exactly; the
    restored trainer then trains on as the unbroken one does."""
    cdir = str(tmp_path / "ckpt")
    _, _, cfg, t_a = _episodic_trainer("mappo", replay_buffer_size=9)
    t_a.run_episode()
    assert t_a.carry.replay.size == 1 and float(t_a.carry.replay.data.value.abs().max()) > 0
    save_checkpoint(cdir, t_a.carry, t_a.steps, t_a.episodes)
    stats_a = [t_a.run_episode() for _ in range(3)]

    _, _, _, t_b = _episodic_trainer("mappo", seed=99, replay_buffer_size=9)
    carry, steps, episodes = restore_checkpoint(cdir, t_b.carry)
    assert (steps, episodes) == (T, 1)
    t_b.carry, t_b.steps, t_b.episodes = carry, steps, episodes
    stats_b = [t_b.run_episode() for _ in range(3)]
    assert stats_a == stats_b
    assert "mean_train_value_loss" in stats_b[0] and "mean_train_value_loss" not in stats_b[1]
    _assert_carries_equal(t_a.carry, t_b.carry)
