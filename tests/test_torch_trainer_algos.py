"""Training chunks of mapdn_torch's PGTrainer against JAX
``PGTrainer._train_chunk`` in float64 at case33 for six algorithms of the
sweep: maddpg, matd3, coma, ippo, maac and facmaddpg.

As in tests/test_torch_trainer.py: 4 lanes, batch_size 4, update_lanes 2
(windows gather lanes), 2 value epochs and 1 policy epoch, every draw
replayed from the JAX key splits (action noise, env step noise, the
epochs' window starts and lane indices, and the losses' own draws:
MATD3's target noise, COMA's baseline samples, MAAC's policy and
target-policy samples) and handed to the port.
matd3, coma, ippo and maac run one 5-step chunk on a ring of capacity 4 =
batch_size refilled by the chunk (the stack-emit path of the 512-lane
runs).  facmaddpg runs two such chunks: the first a warm-up chunk
(``replay_warmup`` 5, so no update and zero stats, the mixer's included),
the second with 2 value, 1 policy and 2 mixer epochs, and the soft target
update of policy, critic and mixer on the 10-step boundary.  maddpg runs two chunks as one JAX ``_train_episode``: 60 steps
each, the configuration's, on a ring of capacity 80 that the second chunk
wraps (the off-policy ring survives the chunk and windows start at random
in it), and the soft target update fires on the 120-step boundary of
``target_update_freq``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
from mapdn_tpu.utils.config import load_config as jax_load_config

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


L, LANES, HID, BATCH = 4, 2, 16, 4
COMMON = dict(n_envs=L, batch_size=BATCH, update_lanes=LANES, value_update_epochs=2,
              policy_update_epochs=1, replay_bf16=False, hid_size=HID,
              update_epoch_unroll=1, rollout_unroll=1)
# (chunk length, chunks, overrides): one short chunk, or maddpg's two
# 60-step chunks on a ring of 80 steps (replay_buffer_size counts one
# lane's transitions: 320 / 4 lanes)
RUNS = {"matd3": (5, 1, dict(replay_buffer_size=16)),
        "coma": (5, 1, dict(replay_buffer_size=16)),
        "ippo": (5, 1, dict(replay_buffer_size=16)),
        "maac": (5, 1, dict(replay_buffer_size=16)),
        "facmaddpg": (5, 2, dict(replay_buffer_size=16, replay_warmup=5,
                                 target_update_freq=10, mixer_update_epochs=2)),
        "maddpg": (60, 2, dict(replay_buffer_size=320, target_update_freq=120))}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _np(x):
    return np.array(x, np.float64)


def _lane_noise(env, keys):
    """The standard normals each lane's env draws from its key
    (voltage_control.py:248-255)."""
    g = env.grid
    noise = [[], [], []]
    for k in keys:
        for i, (kk, size) in enumerate(zip(jax.random.split(k, 3),
                                           (g.n_sgen, g.n_load, g.n_load))):
            noise[i].append(_np(jax.random.normal(kk, (size,), jnp.float64)))
    return tuple(np.stack(z) for z in noise)


def _loss_draws(alg, key, cfg, b, n):
    """A loss's draws from its key (matd3.py:57, coma.py:56, :69-70,
    maac.py:50-61)."""
    k1, k2 = jax.random.split(key)
    if alg == "maac":
        return {name: _np(jax.random.normal(k, (b, n, 1), jnp.float64))
                for name, k in (("policy_noise", k1), ("next_noise", k2))}
    if alg == "matd3":
        return {"target_noise": _np(jax.random.normal(k2, (b, n, 1), jnp.float64))}
    if alg == "coma":
        return {"sample_noise": _np(jax.random.normal(
            k2, (cfg.sample_size, b, n, 1), jnp.float64))}
    return {}


def _replay_chunk(rng, env, cfg, alg, chunk, size, capacity):
    """The draws of one JAX _train_chunk from its carry's rng, and the rng
    it leaves; ``size`` is the ring's fill at the update."""
    steps = []
    for _ in range(chunk):
        rng, k_act, k_env = jax.random.split(rng, 3)
        action_noise = jax.random.normal(k_act, (L, env.n_agents, 1), jnp.float64)
        k_step = jax.vmap(lambda k: jax.random.split(k, 3))(
            jax.random.split(k_env, L))[:, 0]
        steps.append({"action_noise": _np(action_noise),
                      "env": {"step_noise": _lane_noise(env, k_step)}})
    rng, k_upd = jax.random.split(rng)
    draws = {"steps": steps}
    phases = ("value", "policy", "mixer") if alg == "facmaddpg" else ("value", "policy")
    for which, key in zip(phases, jax.random.split(k_upd, 3)):
        lanes, starts, loss = [], [], []
        for k in jax.random.split(key, getattr(cfg, f"{which}_update_epochs")):
            k_samp, k_loss = jax.random.split(k)            # trainer.py:307
            k_start, k_lane = jax.random.split(k_samp)      # replay.py:96
            if capacity != BATCH:                           # replay.py:119-120
                starts.append(int(jax.random.randint(k_start, (), 0, size - BATCH + 1)))
            lanes.append(np.asarray(jax.random.choice(k_lane, L, (LANES,), replace=False)))
            loss.append(_loss_draws(alg, k_loss, cfg, BATCH * LANES, env.n_agents))
        draws.update({f"{which}_lanes": np.stack(lanes), f"{which}_loss": loss,
                      f"{which}_starts": starts or None})
    return rng, draws


def _port_algo(tmodel, algo):
    """The port's AlgoState of a JAX one's behaviour parameters (targets
    copied, optimizer states zero, as in the JAX ``init_state``)."""
    tree = lambda t: jax.tree_util.tree_map(_np, t)
    policy, value = convert.from_flax(tree(algo.policy_params), tree(algo.value_params),
                                      tmodel.make_policy_module(), tmodel.make_value_module())
    mixer = (convert.load_flax_mixer(tmodel.make_mixer_module(), tree(algo.mixer_params))
             if tmodel.uses_mixer else None)
    return tmodel.state_from_modules(policy, value, mixer)


@pytest.fixture(scope="module", params=list(RUNS))
def run_pair(request):
    alg = request.param
    chunk, chunks, extra = RUNS[alg]
    env_cfg = dict(episode_limit=240)
    jenv = jax_make_env("case33", JaxEnvConfig(**env_cfg), days=8, dtype=jnp.float64)
    info = jenv.get_env_info()
    over = dict(COMMON, **extra, behaviour_update_freq=chunk, max_steps=chunk * chunks,
                agent_num=info["n_agents"], obs_size=info["obs_shape"],
                action_dim=info["n_actions"])
    jcfg, _ = jax_load_config(alg, overrides=over)
    jtr = JaxPGTrainer(jcfg, jax_make_model(alg, jcfg), jenv)
    carry = jax.jit(jtr.init_carry)(jax.random.PRNGKey(0))
    # float64 parameters and optimizer state (the JAX nets keep float32)
    carry = carry.replace(algo=_f64(carry.algo))
    capacity = jtr._ring_capacity
    rng, draws = carry.rng, []
    for c in range(chunks):
        size = min((c + 1) * chunk, capacity)
        rng, d = _replay_chunk(rng, jenv, jcfg, alg, chunk, size, capacity)
        draws.append(d)
    jout, jstats = jax.jit(jtr._train_episode)(carry)

    tenv = make_env("case33", EnvConfig(**env_cfg), days=8, dtype=torch.float64,
                    device="cpu")
    tcfg, _ = load_config(alg, overrides=over)
    tmodel = make_model(alg, tcfg, device="cpu", param_dtype=torch.float64)
    ttr = PGTrainer(tcfg, tmodel, tenv)
    assert ttr._ring_capacity == capacity
    assert ttr._chunks_per_episode == chunks
    env_state = EnvState(**{f.name: torch.as_tensor(np.array(getattr(carry.env_state, f.name)))
                            for f in dataclasses.fields(EnvState)})

    def fresh_carry():
        return ttr.carry_from(env_state, torch.tensor(_np(carry.obs)),
                              _port_algo(tmodel, carry.algo), torch.Generator(),
                              torch.tensor(_np(carry.last_hid)))

    if alg == "facmaddpg":
        # the warm-up chunk alone: no update, and zero stats under every
        # key the update phase gives, the mixer's included
        _, warm = ttr._train_chunk(fresh_carry(), draws[0])
        for k in ("mean_train_value_loss", "mean_train_policy_loss",
                  "mean_train_mixer_loss", "mean_train_mixer_grad_norm"):
            assert float(warm[k]) == 0.0, k
    tcarry = fresh_carry()
    tout, tstats = ttr._train_episode(tcarry, draws)
    init_target = convert.load_flax_policy(
        tmodel.make_policy_module(), jax.tree_util.tree_map(_np, carry.algo.target_policy_params))
    return alg, tmodel, jout, jstats, tout, tstats, init_target


def test_chunks_rollout_and_ring_match_jax(run_pair):
    alg, tmodel, jout, jstats, tout, tstats, _ = run_pair
    chunk, chunks, _ = RUNS[alg]
    assert tout.steps == int(jout.steps) == chunk * chunks
    np.testing.assert_allclose(tout.obs.numpy(), _np(jout.obs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tout.last_hid.numpy(), _np(jout.last_hid), rtol=0, atol=1e-9)
    for f in dataclasses.fields(EnvState):
        np.testing.assert_allclose(getattr(tout.env_state, f.name).numpy(),
                                   _np(getattr(jout.env_state, f.name)),
                                   rtol=0, atol=1e-9, err_msg=f.name)
    # the ring: kept off-policy (maddpg's wrapped by its second chunk),
    # cleared on-policy (only ptr/size reset)
    assert (tout.replay.ptr, tout.replay.size) == (int(jout.replay.ptr), int(jout.replay.size))
    assert tout.replay.size == (0 if tmodel.on_policy else tout.replay.capacity)
    for f in dataclasses.fields(tout.replay.data):
        got, want = getattr(tout.replay.data, f.name), getattr(jout.replay.data, f.name)
        assert tuple(got.shape) == tuple(want.shape), f.name
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-9, err_msg=f.name)
    for k in ("mean_train_reward", "mean_train_q_loss", "mean_train_total_line_loss"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=0,
                                   atol=1e-9, err_msg=k)


def test_chunks_update_matches_jax(run_pair):
    alg, tmodel, jout, jstats, tout, tstats, init_target = run_pair
    assert set(tstats) == set(jstats)
    keys = ["mean_train_value_loss", "mean_train_policy_loss",
            "mean_train_value_grad_norm", "mean_train_policy_grad_norm",
            "mean_train_entropy"]
    if tmodel.uses_mixer:
        keys += ["mean_train_mixer_loss", "mean_train_mixer_grad_norm"]
    for k in keys:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-8,
                                   atol=1e-9, err_msg=k)
    algo = jout.algo
    pol, val = tmodel.make_policy_module, tmodel.make_value_module
    modules = [(tout.algo.policy, algo.policy_params, pol, convert.load_flax_policy),
               (tout.algo.value, algo.value_params, val, convert.load_flax_critic),
               (tout.algo.target_policy, algo.target_policy_params, pol,
                convert.load_flax_policy),
               (tout.algo.target_value, algo.target_value_params, val,
                convert.load_flax_critic)]
    opts = [(tout.algo.value_opt, algo.value_opt[1][0].nu, val, convert.load_flax_critic),
            (tout.algo.policy_opt, algo.policy_opt[1][0].nu, pol, convert.load_flax_policy)]
    if tmodel.uses_mixer:
        mix, load_mix = tmodel.make_mixer_module, convert.load_flax_mixer
        modules += [(tout.algo.mixer, algo.mixer_params, mix, load_mix),
                    (tout.algo.target_mixer, algo.target_mixer_params, mix, load_mix)]
        opts.append((tout.algo.mixer_opt, algo.mixer_opt[1][0].nu, mix, load_mix))
    for module, tree, make, load in modules:
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for (name, got), ref in zip(module.named_parameters(), want.parameters()):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                       rtol=0, atol=1e-8, err_msg=f"{alg} {name}")
    for nu, tree, make, load in opts:
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for got, ref in zip(nu, want.parameters()):
            np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=0, atol=1e-8)
    # the soft update fires on maddpg's 120-step boundary and facmaddpg's
    # 10-step one, and only there
    moved = max(float((t - i).detach().abs().max()) for t, i in
                zip(tout.algo.target_policy.parameters(), init_target.parameters()))
    assert (moved > 0.0) == (alg in ("maddpg", "facmaddpg")), moved
