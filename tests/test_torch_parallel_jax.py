"""ShardedPGTrainer over 2 gloo processes against the JAX package's
PGTrainer on the same draws, float64, case33, 4 lanes (2 a rank): the
sharded code (each rank's lanes of the carry, the placeholder row of a rank
that holds none of a batch, the n_local / n_global shares, batchnorm's
all-reduced statistics, the episodic batch gathered over the ranks) held
to the reference, not only to the port's own single process.

Every draw is replayed from the JAX key splits at the global lane count and
the whole batch (as tests/test_torch_trainer.py and
tests/test_torch_episodic.py replay them) and handed to both ranks, which
keep their rows.  Two profiles, each with an update epoch whose batch
lies on one rank alone (the other runs its placeholder row) and epochs
whose batch both ranks share (batchnorm's statistics cross the ranks):

* ``mappo-two-update-lanes``: one 5-step chunk on a ring of capacity 4 =
  batch_size, then 2 value epochs and 1 policy epoch on windows of two
  sampled lanes; MAPPO standardizes rewards and advantages (batchnorm);
* ``coma-episodic-two-episodes``: two 6-step episodes into a pool of 2
  slots, then ``_episodic_update`` on batches of two episodes, with COMA's
  baseline samples (a loss draw on the batch-row axis 1) and standardized
  advantages.

The tolerances are those of the single-process parity tests: the rollout,
the ring and the stats within 1e-9 (the stats rtol 1e-8), the parameters
and the optimizer's second moments within atol 1e-8.  The workers are
this file, run as ``python tests/test_torch_parallel_jax.py --worker RANK
PORT IN OUT``; they import no JAX."""
import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mapdn_torch.algos import make_model  # noqa: E402
from mapdn_torch.envs import EnvConfig, make_env  # noqa: E402
from mapdn_torch.envs.voltage_control import EnvState  # noqa: E402
from mapdn_torch.parallel import ShardedPGTrainer  # noqa: E402
from mapdn_torch.utils.config import load_config  # noqa: E402
from test_torch_parallel import WORLD, _free_port, _spawn, carry_tensors  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


L, HID = 4, 16
ENV_CFG = dict(episode_limit=240)     # no lane ends inside the run
# name -> (alg, overrides, chunk length, chunks, episodic update)
PROFILES = {
    "mappo-two-update-lanes": ("mappo", dict(
        behaviour_update_freq=5, batch_size=4, replay_buffer_size=16,
        update_lanes=2), 5, 1, False),
    "coma-episodic-two-episodes": ("coma", dict(
        max_steps=6, episodic=True, batch_size=2, replay_buffer_size=2 * L,
        normalize_advantages=True), 6, 2, True),
}
COMMON = dict(n_envs=L, value_update_epochs=2, policy_update_epochs=1, hid_size=HID,
              replay_bf16=False, update_epoch_unroll=1, rollout_unroll=1)


def _env():
    return make_env("case33", EnvConfig(**ENV_CFG), days=8, dtype=torch.float64,
                    device="cpu")


def _port(alg, over):
    cfg, _ = load_config(alg, overrides=over)
    return cfg, make_model(alg, cfg, device="cpu", param_dtype=torch.float64)


def worker(rank, port, inp, out):
    """One rank: every profile from its JAX start, sharded over the gloo
    group, on the replayed draws."""
    from mapdn_torch.parallel import init_process_group

    init_process_group(f"localhost:{port}", WORLD, rank, "gloo")
    try:
        results = {}
        for name, case in torch.load(inp, weights_only=False).items():
            alg, *_, episodic = PROFILES[name]
            cfg, model = _port(alg, case["over"])
            trainer = ShardedPGTrainer(cfg, model, _env())
            lo, hi = trainer.lo, trainer.lo + trainer.n_envs
            env_state = EnvState(**{k: torch.as_tensor(v[lo:hi])
                                    for k, v in case["env_state"].items()})
            carry = trainer.carry_from(env_state, torch.tensor(case["obs"][lo:hi]),
                                       case["algo"], torch.Generator(),
                                       torch.tensor(case["last_hid"][lo:hi]))
            stats = []
            for draws in case["chunk_draws"]:
                carry, st = trainer._train_chunk(carry, draws)
                stats.append(st)
            if episodic:
                carry, st = trainer._episodic_update(carry, case["update_draws"])
                stats.append(st)
            results[name] = (*carry_tensors(carry),
                             [{k: float(v) for k, v in st.items()} for st in stats])
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ the JAX side
def _jax_runs():
    """Each profile's JAX start, draws and outputs."""
    import jax
    import jax.numpy as jnp

    from mapdn_tpu.algos import make_model as jax_make_model
    from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
    from mapdn_tpu.envs import make_env as jax_make_env
    from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
    from mapdn_tpu.utils.config import load_config as jax_load_config
    from test_torch_trainer_algos import _f64, _lane_noise, _loss_draws, _np, _port_algo

    jenv = jax_make_env("case33", JaxEnvConfig(**ENV_CFG), days=8, dtype=jnp.float64)
    info = jenv.get_env_info()
    n = info["n_agents"]

    def step_draws(rng, chunk):
        steps = []
        for _ in range(chunk):
            rng, k_act, k_env = jax.random.split(rng, 3)
            k_step = jax.vmap(lambda k: jax.random.split(k, 3))(
                jax.random.split(k_env, L))[:, 0]
            steps.append({"action_noise": _np(jax.random.normal(k_act, (L, n, 1),
                                                                jnp.float64)),
                          "env": {"step_noise": _lane_noise(jenv, k_step)}})
        return rng, steps

    def update_draws(alg, cfg, key, episodic, size):
        """Each epoch's lanes (or (slot, lane) episodes) and loss draws
        (trainer.py:307, :355, :363; replay.py:96, :110, :181-184)."""
        draws, rows = {}, cfg.batch_size * (cfg.max_steps if episodic else cfg.update_lanes)
        for which, k_phase in zip(("value", "policy"), jax.random.split(key, 3)):
            picks, loss = [], []
            for k in jax.random.split(k_phase, getattr(cfg, f"{which}_update_epochs")):
                k_samp, k_loss = jax.random.split(k)
                k_a, k_b = jax.random.split(k_samp)
                if episodic:
                    picks.append((np.array(jax.random.randint(k_a, (cfg.batch_size,), 0,
                                                              max(size, 1))),
                                  np.array(jax.random.randint(k_b, (cfg.batch_size,), 0, L))))
                else:
                    picks.append(np.asarray(jax.random.choice(
                        k_b, L, (cfg.update_lanes,), replace=False)))
                loss.append(_loss_draws(alg, k_loss, cfg, rows, n))
            draws[f"{which}_{'episodes' if episodic else 'lanes'}"] = (
                picks if episodic else np.stack(picks))
            draws[f"{which}_loss"] = loss
        return draws

    runs = {}
    for name, (alg, extra, chunk, chunks, episodic) in PROFILES.items():
        over = dict(COMMON, **extra, agent_num=n, obs_size=info["obs_shape"],
                    action_dim=info["n_actions"])
        jcfg, _ = jax_load_config(alg, overrides=over)
        jtr = JaxPGTrainer(jcfg, jax_make_model(alg, jcfg), jenv)
        carry = jax.jit(jtr.init_carry)(jax.random.PRNGKey(0))
        carry = carry.replace(algo=_f64(carry.algo))
        _, tmodel = _port(alg, over)
        case = dict(over=over, obs=_np(carry.obs), last_hid=_np(carry.last_hid),
                    env_state={f.name: np.array(getattr(carry.env_state, f.name))
                               for f in dataclasses.fields(EnvState)},
                    algo=_port_algo(tmodel, carry.algo), chunk_draws=[])
        rng, jout, jstats = carry.rng, carry, []
        for _ in range(chunks):
            rng, steps = step_draws(rng, chunk)
            draws = {"steps": steps}
            if not episodic:
                rng, k_upd = jax.random.split(rng)
                draws.update(update_draws(alg, jcfg, k_upd, False, 0))
            case["chunk_draws"].append(draws)
            jout, st = jtr._jit_chunk(jout)
            jstats.append(st)
        if episodic:
            case["update_draws"] = update_draws(alg, jcfg, jax.random.PRNGKey(7), True,
                                                int(jout.replay.size))
            jout, st = jtr._jit_episodic_update(jout, jax.random.PRNGKey(7))
            jstats.append(st)
        runs[name] = (case, jout, jstats, tmodel)
    return runs


def _held(case, name):
    """Per epoch, the lanes of its batch that each rank holds."""
    episodic = PROFILES[name][4]
    per_rank = L // WORLD
    draws = case["update_draws"] if episodic else case["chunk_draws"][-1]
    picks = [lanes for which in ("value", "policy") for lanes in (
        [e[1] for e in draws[f"{which}_episodes"]] if episodic else draws[f"{which}_lanes"])]
    return [[int(((np.asarray(p) // per_rank) == r).sum()) for r in range(WORLD)]
            for p in picks]


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    runs = _jax_runs()
    tmp = tmp_path_factory.mktemp("witness")
    torch.save({name: case for name, (case, *_) in runs.items()}, tmp / "in.pt")
    port = _free_port()
    _spawn(lambda r: [sys.executable, os.path.abspath(__file__), "--worker", str(r),
                      str(port), str(tmp / "in.pt"), str(tmp / f"rank{r}.pt")])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return runs, ranks


@pytest.mark.parametrize("name", list(PROFILES))
def test_sharded_run_matches_jax(witness, name):
    """Each rank's env state, observations, GRU state and ring are its
    lanes of the JAX run's, its learner is the JAX learner, and every
    stat is the JAX run's; the ranks' learners are bitwise equal.  The
    draws give an epoch whose batch one rank holds alone and one that
    both ranks share."""
    import jax

    from mapdn_torch import convert
    from test_torch_trainer_algos import _np

    runs, ranks = witness
    case, jout, jstats, tmodel = runs[name]
    held = _held(case, name)
    assert any(0 in h for h in held) and any(0 not in h for h in held), held
    episodic = PROFILES[name][4]
    per_rank = L // WORLD
    for rank in range(WORLD):
        tensors, (ptr, size, steps), stats = ranks[rank][name]
        lo, hi = rank * per_rank, (rank + 1) * per_rank
        assert (ptr, size, steps) == (int(jout.replay.ptr), int(jout.replay.size),
                                      int(jout.steps))
        lanes = lambda x: _np(x)[lo:hi]
        for f in dataclasses.fields(EnvState):
            np.testing.assert_allclose(tensors[f"env_state.{f.name}"].numpy(),
                                       lanes(getattr(jout.env_state, f.name)),
                                       rtol=0, atol=1e-9, err_msg=f"rank {rank} {f.name}")
        np.testing.assert_allclose(tensors["obs"].numpy(), lanes(jout.obs), rtol=0, atol=1e-9)
        np.testing.assert_allclose(tensors["last_hid"].numpy(), lanes(jout.last_hid),
                                   rtol=0, atol=1e-9)
        # the ring (capacity, lanes, ...) or the pool (slots, T, lanes, ...)
        ring = (lambda x: _np(x)[:, :, lo:hi]) if episodic else (lambda x: _np(x)[:, lo:hi])
        for f in ("state", "action", "log_prob_a", "reward", "value", "next_value", "done"):
            np.testing.assert_allclose(tensors[f"replay.{f}"].numpy(),
                                       ring(getattr(jout.replay.data, f)),
                                       rtol=0, atol=1e-9, err_msg=f"rank {rank} {f}")
        assert len(stats) == len(jstats)
        for got, want in zip(stats, jstats):
            assert set(got) == set(want)
            for k in want:
                assert math.isclose(got[k], float(want[k]), rel_tol=1e-8, abs_tol=1e-9), (
                    rank, k, got[k], float(want[k]))
        algo = jout.algo
        for which, tree, make, load in (
                ("policy", algo.policy_params, tmodel.make_policy_module,
                 convert.load_flax_policy),
                ("value", algo.value_params, tmodel.make_value_module,
                 convert.load_flax_critic)):
            want = load(make(), jax.tree_util.tree_map(_np, tree)).state_dict()
            for k, v in want.items():
                np.testing.assert_allclose(tensors[f"algo.{which}.{k}"].numpy(), v.numpy(),
                                           rtol=0, atol=1e-8, err_msg=f"rank {rank} {k}")
        for which, tree, make, load in (
                ("value_opt", algo.value_opt[1][0].nu, tmodel.make_value_module,
                 convert.load_flax_critic),
                ("policy_opt", algo.policy_opt[1][0].nu, tmodel.make_policy_module,
                 convert.load_flax_policy)):
            want = load(make(), jax.tree_util.tree_map(_np, tree)).parameters()
            for i, v in enumerate(want):
                np.testing.assert_allclose(tensors[f"algo.{which}.{i}"].numpy(),
                                           v.detach().numpy(), rtol=0, atol=1e-8,
                                           err_msg=f"rank {rank} {which} {i}")
    for k in (k for k in ranks[0][name][0] if k.startswith("algo.")):
        assert torch.equal(ranks[0][name][0][k], ranks[1][name][0][k]), k


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
