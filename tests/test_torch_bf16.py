"""The bf16 replay ring (``replay_bf16``, the ring of bench_torch.py's
configuration) against the JAX package's, on the CPU.

One MAPPO chunk of tests/test_torch_trainer.py's shape (case33, 4 lanes,
chunk 5, a ring of capacity 4 refilled by the chunk, 2 update lanes, 2
value epochs and 1 policy epoch) with ``replay_bf16=True``, from the same
initial carry and the JAX chunk's draws replayed, against JAX
``PGTrainer._train_chunk``, at two compute dtypes:

* float64 (parameters too): the bf16 fields (``state``, ``next_state``,
  ``last_hid``, ``hid``) equal bit for bit, every other field, the stats
  and the parameters within tests/test_torch_trainer.py's tolerances
  (1e-9; stats 1e-8 relative).  The ring's bf16 states widen to the
  compute dtype before they meet the networks, as flax's promotion gives
  in the JAX package (``PGTrainer._upcast``).
* float32, as bench_torch.py runs: the two packages' env steps differ by
  float32 rounding of cancelling sums (the bus injections ``p_bus`` by up
  to 1.3e-4 here), so a state near a bf16 rounding edge rounds to the
  neighbouring bf16 value: each bf16 field within the float32 obs'
  difference (2e-4) plus one bf16 unit in the last place of JAX's, the
  float32 fields within 5e-5 absolute, the update
  stats within 1e-2 relative (the limit of ``chip_smoke.py [bf16]``; the
  policy loss, a mean of advantages near zero, differs most: 1.7e-3).

Also the port's mirror of tests/test_semantics.py::test_replay_bf16_storage_semantics
at float32: which fields are bf16, finite stats over two chunks, the
stored states the float32 ring's rounded to bf16, and batches at the
compute dtype after the upcast.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch import convert
from mapdn_torch.algos import MAPPO
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from mapdn_tpu.algos import make_model as jax_make_model
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
from mapdn_tpu.utils.config import load_config as jax_load_config
from test_torch_trainer import OVERRIDES, _f64, _np, _replay_draws

torch.set_num_threads(1)

BF16_FIELDS = ("state", "next_state", "last_hid", "hid")
F32_FIELDS = ("action", "log_prob_a", "value", "next_value", "reward", "done", "last_step")
BF16 = dict(OVERRIDES, replay_bf16=True)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other
    with threadpool_limits(1, user_api="blas"):
        yield


def _f32(x):
    """A ring field as float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _envs(episode_limit=240, dtype="float32"):
    jenv = jax_make_env("case33", JaxEnvConfig(episode_limit=episode_limit), days=8,
                        dtype=getattr(jnp, dtype))
    tenv = make_env("case33", EnvConfig(episode_limit=episode_limit), days=8,
                    dtype=getattr(torch, dtype), device="cpu")
    info = jenv.get_env_info()
    widths = dict(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                  action_dim=info["n_actions"])
    return jenv, tenv, widths


@pytest.fixture(scope="module", params=["float64", "float32"])
def bf16_chunk(request):
    dtype = request.param
    jenv, tenv, widths = _envs(dtype=dtype)
    jcfg, _ = jax_load_config("mappo", overrides={**BF16, **widths})
    jtr = JaxPGTrainer(jcfg, jax_make_model("mappo", jcfg), jenv)
    carry = jax.jit(jtr.init_carry)(jax.random.PRNGKey(0))
    if dtype == "float64":
        carry = carry.replace(algo=_f64(carry.algo))
    draws = _replay_draws(carry.rng, jenv, jcfg, getattr(jnp, dtype))
    jout, jstats = jax.jit(jtr._train_chunk)(carry)

    tcfg, _ = load_config("mappo", overrides={**BF16, **widths})
    tmodel = MAPPO(tcfg, device="cpu", param_dtype=getattr(torch, dtype))
    ttr = PGTrainer(tcfg, tmodel, tenv)
    policy, value = convert.from_flax(
        jax.tree_util.tree_map(np.asarray, carry.algo.policy_params),
        jax.tree_util.tree_map(np.asarray, carry.algo.value_params),
        tmodel.make_policy_module(), tmodel.make_value_module())
    env_state = EnvState(**{f.name: torch.as_tensor(np.array(getattr(carry.env_state, f.name)))
                            for f in dataclasses.fields(EnvState)})
    tcarry = ttr.carry_from(env_state, torch.as_tensor(np.asarray(carry.obs)),
                            tmodel.state_from_modules(policy, value), torch.Generator(),
                            torch.as_tensor(np.asarray(carry.last_hid)))
    tout, tstats = ttr._train_chunk(tcarry, draws)
    assert ttr._stack_emit and tout.replay.capacity == 4
    return dtype, tmodel, jout, jstats, tout, tstats


def _bf16_ulp(x):
    """One bf16 unit in the last place at each |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def test_bf16_ring_matches_jax(bf16_chunk):
    """Each field of the ring after the chunk: the bf16 ones bf16 in both
    packages (bit for bit at float64; at float32 within the obs' 2e-4 and
    one bf16 ulp), the
    rest at the compute dtype (within 1e-9 at float64, 5e-5 at float32)."""
    dtype, _, jout, jstats, tout, tstats = bf16_chunk
    jdata, tdata = jout.replay.data, tout.replay.data
    atol = 1e-9 if dtype == "float64" else 5e-5
    for name in BF16_FIELDS:
        assert getattr(jdata, name).dtype == jnp.bfloat16, name
        assert getattr(tdata, name).dtype == torch.bfloat16, name
        got, want = _f32(getattr(tdata, name)), _f32(getattr(jdata, name))
        if dtype == "float64":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert np.all(np.abs(got - want) <= 2e-4 + _bf16_ulp(want)), name
    for name in F32_FIELDS:
        assert str(getattr(jdata, name).dtype) == dtype, name
        assert getattr(tdata, name).dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_np(getattr(tdata, name)), _np(getattr(jdata, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(_np(tout.obs), _np(jout.obs), rtol=0,
                               atol=1e-9 if dtype == "float64" else 2e-4)
    for k in ("mean_train_reward", "mean_train_q_loss", "mean_train_total_line_loss"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-8 if dtype == "float64" else 1e-3, err_msg=k)


def test_bf16_update_matches_jax(bf16_chunk):
    """The update phase on the upcast bf16 batches: at float64 the stats
    within 1e-8 relative and the parameters within 1e-8 of JAX's
    (tests/test_torch_trainer.py's tolerances); at float32 the stats within
    1e-2 relative."""
    dtype, tmodel, jout, jstats, tout, tstats = bf16_chunk
    assert set(tstats) == set(jstats)
    for k in ("mean_train_value_loss", "mean_train_policy_loss",
              "mean_train_value_grad_norm", "mean_train_policy_grad_norm",
              "mean_train_entropy"):
        assert np.isfinite(float(tstats[k])), k
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-8 if dtype == "float64" else 1e-2,
                                   atol=1e-9 if dtype == "float64" else 0, err_msg=k)
    if dtype == "float32":
        return
    for module, tree, make, load in (
            (tout.algo.policy, jout.algo.policy_params, tmodel.make_policy_module,
             convert.load_flax_policy),
            (tout.algo.value, jout.algo.value_params, tmodel.make_value_module,
             convert.load_flax_critic)):
        want = load(make(), jax.tree_util.tree_map(_np, tree))
        for (name, got), ref in zip(module.named_parameters(), want.parameters()):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                       rtol=0, atol=1e-8, err_msg=name)


def test_replay_bf16_storage_semantics():
    """tests/test_semantics.py:320 for the port: with ``replay_bf16`` the
    bulk ring fields are bfloat16 and log-probs, rewards and values
    float32 (the same fields as the JAX package's ring); two chunks give
    finite stats; the stored states are the float32 run's rounded to bf16
    (the rollout precedes any update); sampled batches are float32 after
    the trainer's upcast."""
    jenv, tenv, widths = _envs(episode_limit=8)
    small = dict(widths, max_steps=8, behaviour_update_freq=4, batch_size=4,
                 value_update_epochs=1, policy_update_epochs=1, replay_buffer_size=16,
                 n_envs=4, hid_size=16, replay_bf16=True)
    jcfg, _ = jax_load_config("mappo", overrides=small)
    jtrans = JaxPGTrainer(jcfg, jax_make_model("mappo", jcfg), jenv)._example_transition(
        jnp.zeros((4, widths["agent_num"], widths["obs_size"]), jnp.float32))
    cfg, _ = load_config("mappo", overrides=small)
    tr = PGTrainer(cfg, MAPPO(cfg, device="cpu"), tenv).setup(seed=0)
    for f in dataclasses.fields(tr.carry.replay.data):
        want = getattr(jtrans, f.name).dtype
        got = getattr(tr.carry.replay.data, f.name).dtype
        assert (got == torch.bfloat16) == (want == jnp.bfloat16), f.name
        assert got in (torch.bfloat16, torch.float32), f.name
    assert {f.name for f in dataclasses.fields(tr.carry.replay.data)
            if getattr(tr.carry.replay.data, f.name).dtype == torch.bfloat16} == set(BF16_FIELDS)

    carry, stats = tr._train_chunk(tr.carry)
    carry, stats = tr._train_chunk(carry)
    assert all(np.isfinite(float(v)) for v in stats.values()), stats

    cfg32 = cfg.replace(replay_bf16=False)
    c32, _ = PGTrainer(cfg32, MAPPO(cfg32, device="cpu"), tenv).setup(seed=0)._train_chunk(
        PGTrainer(cfg32, MAPPO(cfg32, device="cpu"), tenv).setup(seed=0).carry)
    c16, _ = PGTrainer(cfg, MAPPO(cfg, device="cpu"), tenv).setup(seed=0)._train_chunk(
        PGTrainer(cfg, MAPPO(cfg, device="cpu"), tenv).setup(seed=0).carry)
    s32 = c32.replay.data.state
    np.testing.assert_array_equal(_f32(c16.replay.data.state), _f32(s32.to(torch.bfloat16)))
    np.testing.assert_allclose(_f32(c16.replay.data.state), s32.numpy(), rtol=1e-2, atol=1e-2)

    batch = rb.sample_window(carry.replay, 4, generator=carry.generator).map(tr._upcast)
    assert batch.state.dtype == torch.float32 and batch.last_hid.dtype == torch.float32

    # at float64 the upcast gives float64, the dtype flax's promotion gives
    # the JAX package's float64 parameters
    f64 = make_env("case33", EnvConfig(episode_limit=8), days=8, dtype=torch.float64,
                   device="cpu")
    tr64 = PGTrainer(cfg, MAPPO(cfg, device="cpu", param_dtype=torch.float64), f64)
    assert tr64._upcast(carry.replay.data.state).dtype == torch.float64
