"""Where the zoo's first evals come from, in both packages, on the CPU.

The zoo's case33 runs (``mapdn_torch.scripts.train_zoo`` and
scripts/train_zoo.py: distributed mode, l1 barrier, 40 synthetic days,
seed 7) each evaluate the policy first after one training episode.  Three
facts hold that first eval to the initial weights:

* every case33 algorithm of a package draws its policy first from the
  seed, so all ten runs of one package start from one initial policy (MAAC
  adds a log-std head after the mean head's draw);
* the port draws each parameter from flax's distribution, but not flax's
  values: its seed-7 draw is another sample than the JAX package's
  ``PRNGKey(7)`` one;
* on the same eval episodes the JAX package's seed-7 policy scores far
  below the port's.

Run as a script, ``python tests/test_torch_first_eval.py`` prints the
numbers behind these (a few minutes on the CPU): each draw's eval before
training, the spread of that eval over 32 weight seeds in each package,
and the port's trainer trained one 512-lane episode from each seed-7 draw.

So the zoo's reruns start from the JAX draw itself:
``python tests/test_torch_first_eval.py jax_init`` writes each
``train_zoo.JAX_INIT`` algorithm's seed-7 initial parameters (policy,
value and mixer trees) to ``artifacts/learning_torch/jax_init/<alg>.npz``
(:func:`write_jax_init`, a few seconds); the tests below hold the
committed files to the draw made live and the port's model loaded from one
to the JAX model's eval.
"""
import hashlib
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mapdn_torch import convert  # noqa: E402
from mapdn_torch.algos import make_model  # noqa: E402
from mapdn_torch.scripts.train_zoo import ALGS, ART, JAX_INIT, SEED  # noqa: E402
from mapdn_torch.train import build_trainer, parse_args  # noqa: E402
from mapdn_torch.utils.config import load_config  # noqa: E402
from mapdn_tpu.algos import make_model as jax_make_model  # noqa: E402
from mapdn_tpu.utils.config import load_config as jax_load_config  # noqa: E402

torch.set_num_threads(1)

# case33 distributed: 6 agents, 38 observations, one action each
WIDTHS = dict(agent_num=6, obs_size=38, action_dim=1)
EVAL_SEED = 1000


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other
    with threadpool_limits(1, user_api="blas"):
        yield


def _models(alg):
    jcfg, _ = jax_load_config(alg, scenario="case33_3min_final", overrides=WIDTHS)
    tcfg, _ = load_config(alg, scenario="case33_3min_final", overrides=WIDTHS)
    return jax_make_model(alg, jcfg), make_model(alg, tcfg, device="cpu")


def jax_seed_state(jmodel, seed=SEED):
    """The JAX trainer's initial AlgoState for ``seed``: ``init_carry``
    hands the first of three splits of ``PRNGKey(seed)`` to the model."""
    return jmodel.init_state(jax.random.split(jax.random.PRNGKey(seed), 3)[0])


def jax_init_arrays(alg):
    """{``<tree>/<flax path>``: array} of ``alg``'s seed-7 initial policy,
    value and (where there is one) mixer parameters in the JAX package."""
    from flax.traverse_util import flatten_dict

    jmodel, _ = _models(alg)
    state = jax_seed_state(jmodel)
    trees = {"policy": state.policy_params, "value": state.value_params}
    if jmodel.uses_mixer:
        trees["mixer"] = state.mixer_params
    return {f"{tree}/{path}": np.asarray(leaf) for tree, params in trees.items()
            for path, leaf in flatten_dict(jax.device_get(params), sep="/").items()}


def write_jax_init(dest=os.path.join(ART, "jax_init")):
    """Write ``jax_init_arrays(alg)`` to ``dest/<alg>.npz`` for each
    algorithm of ``train_zoo.JAX_INIT``."""
    os.makedirs(dest, exist_ok=True)
    for alg in JAX_INIT:
        path = os.path.join(dest, f"{alg}.npz")
        np.savez(path, **jax_init_arrays(alg))
        print(f"wrote {os.path.relpath(path, ROOT)}", flush=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_modules(tmodel, jstate):
    """The port's policy, value (and mixer) modules holding ``jstate``'s
    flax parameters."""
    policy, value = convert.from_flax(_np(jstate.policy_params), _np(jstate.value_params),
                                      tmodel.make_policy_module(),
                                      tmodel.make_value_module())
    mixer = (convert.load_flax_mixer(tmodel.make_mixer_module(), _np(jstate.mixer_params))
             if tmodel.uses_mixer else None)
    return policy, value, mixer


def _policy_arrays(package, alg):
    """{name: array} of ``alg``'s seed-7 initial policy in ``package``."""
    jmodel, tmodel = _models(alg)
    if package == "jax":
        flat = jax.tree_util.tree_flatten_with_path(jax_seed_state(jmodel).policy_params)[0]
        return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}
    state = tmodel.init_state(torch.Generator().manual_seed(SEED))
    return {name: p.detach().numpy() for name, p in state.policy.named_parameters()}


def fingerprint(arrays):
    return hashlib.md5(b"".join(a.tobytes() for _, a in sorted(arrays.items()))).hexdigest()[:8]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_case33_runs_share_one_initial_policy(package):
    want = _policy_arrays(package, "mappo")
    for alg in ALGS:
        got = _policy_arrays(package, alg)
        shared = set(got) & set(want)
        assert shared == set(want), (alg, sorted(set(want) - shared))
        for name in shared:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{alg} {name}")


@pytest.mark.parametrize("alg", ALGS)
def test_initial_weights_follow_flax(alg):
    """Each parameter of the port's fresh policy, value (and mixer) modules
    against the same parameter of the JAX package's, flax's draw carried
    across, pooled over 8 seeds: equal means and standard deviations
    within 5 standard errors of the pooled sample; a constant parameter
    (zero bias, LayerNorm scale, the mixer's gate) equal exactly."""
    jmodel, tmodel = _models(alg)
    init = jax.jit(jmodel.init_state)
    pooled = {"jax": {}, "port": {}}
    for seed in range(8):
        port = tmodel.init_state(torch.Generator().manual_seed(seed))
        for package, trio in (("jax", _port_modules(tmodel, init(jax.random.PRNGKey(seed)))),
                              ("port", (port.policy, port.value, port.mixer))):
            for which, mod in zip(("policy", "value", "mixer"), trio):
                if mod is None:
                    continue
                for name, p in mod.named_parameters():
                    pooled[package].setdefault(f"{which}.{name}", []).append(
                        p.detach().double().numpy().ravel())
    assert set(pooled["jax"]) == set(pooled["port"])
    for name in pooled["jax"]:
        j, t = np.concatenate(pooled["jax"][name]), np.concatenate(pooled["port"][name])
        if j.std() == 0.0 or t.std() == 0.0:
            np.testing.assert_array_equal(t, j, err_msg=name)
            continue
        se = max(j.std(), t.std()) / np.sqrt(j.size)
        assert abs(j.mean() - t.mean()) <= 5 * np.sqrt(2) * se, (name, j.mean(), t.mean())
        assert abs(j.std() - t.std()) <= 5 * se, (name, j.std(), t.std())


def _port_trainer(alg, n_envs):
    """The port's zoo trainer for ``alg`` (case33 distributed, seed 7) at
    ``n_envs`` lanes on the CPU."""
    return build_trainer(parse_args([
        "--platform", "cpu", "--alg", alg, "--n-envs", str(n_envs),
        "--seed", str(SEED), "--scenario", "case33_3min_final",
        "--voltage-barrier-type", "l1", "--days", "40"]))[2]


def _with_jax_draw(trainer, alg):
    """``trainer``'s algorithm state replaced by the JAX package's seed-7
    initial weights."""
    jmodel, _ = _models(alg)
    policy, value, mixer = _port_modules(trainer.model, jax_seed_state(jmodel))
    return trainer.model.state_from_modules(policy, value, mixer)


def _eval(trainer, algo, seed=EVAL_SEED):
    stats = trainer._eval_rollout(algo, torch.Generator().manual_seed(seed))
    return (float(stats["mean_test_reward"]),
            float(stats["mean_test_totally_controllable_ratio"]))


def test_seed7_draws_differ_on_the_same_episodes():
    """The port's eval, on one set of 10 episodes, of the port's seed-7
    initial policy and of the JAX package's: the JAX draw scores lower by
    more than 0.03 reward (the case33 distributed zoos' first evals differ
    by 0.02-0.07)."""
    trainer = _port_trainer("mappo", 4)
    port_r, _ = _eval(trainer, trainer.carry.algo)
    jax_r, _ = _eval(trainer, _with_jax_draw(trainer, "mappo"))
    assert np.isfinite(port_r) and np.isfinite(jax_r)
    assert jax_r < port_r - 0.03, (jax_r, port_r)


def report():
    """The numbers behind the tests, one JSON line each."""
    from mapdn_tpu.envs import make_env as jax_make_env
    from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
    from train import build_env_cfg

    torch.set_num_threads(os.cpu_count() or 1)
    for package in ("port", "jax"):
        prints = {alg: fingerprint(_policy_arrays(package, alg)) for alg in ALGS}
        print(json.dumps({"seed7_policy_fingerprints": package, **prints}), flush=True)

    # each package's own eval of its initial policy, over 32 weight seeds
    jcfg, env_dict = jax_load_config("mappo", scenario="case33_3min_final",
                                     voltage_barrier_type="l1",
                                     overrides={"seed": SEED, "n_envs": 4})
    jenv = jax_make_env("case33_3min_final", build_env_cfg(env_dict), days=40, seed=SEED)
    info = jenv.get_env_info()
    jcfg = jcfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                        action_dim=info["n_actions"],
                        max_steps=min(jcfg.max_steps, info["episode_limit"]))
    jmodel = jax_make_model("mappo", jcfg)
    jeval = jax.jit(JaxPGTrainer(jcfg, jmodel, jenv)._eval_rollout)
    jstat = lambda state: tuple(float(jeval(state, jax.random.PRNGKey(EVAL_SEED))[k]) for k in (
        "mean_test_reward", "mean_test_totally_controllable_ratio"))
    trainer = _port_trainer("mappo", 4)
    draws = {
        "jax": [jstat(jmodel.init_state(jax.random.PRNGKey(s))) for s in range(100, 132)],
        "port": [_eval(trainer, trainer.model.init_state(torch.Generator().manual_seed(s)))
                 for s in range(100, 132)]}
    seed7 = {"jax": jstat(jax_seed_state(jmodel)), "port": _eval(trainer, trainer.carry.algo)}
    for package, rows in draws.items():
        r = np.array(rows)
        print(json.dumps({
            "initial_policy_eval_over_32_seeds": package,
            "mean": r.mean(0).tolist(), "sd": r.std(0).tolist(),
            "min": r.min(0).tolist(), "max": r.max(0).tolist(),
            "seed7_draw": seed7[package],
            "seed7_draw_rank_by_reward": int((r[:, 0] < seed7[package][0]).sum())}), flush=True)

    # the port's trainer from each seed-7 draw, one 512-lane episode
    for alg in ("mappo", "ippo", "maddpg"):
        for draw in ("port", "jax"):
            trainer = _port_trainer(alg, 512)
            if draw == "jax":
                trainer.carry.algo = _with_jax_draw(trainer, alg)
            before = _eval(trainer, trainer.carry.algo)
            trainer.run_episode()
            print(json.dumps({"alg": alg, "initial_weights": draw, "eval_before": before,
                              "eval_after_one_episode": _eval(trainer, trainer.carry.algo)}),
                  flush=True)


@pytest.mark.parametrize("alg", JAX_INIT)
def test_committed_jax_init_is_the_jax_draw(alg):
    """The committed ``jax_init/<alg>.npz`` holds exactly the JAX package's
    seed-7 initial parameters as drawn now: same names, dtypes, values."""
    want = jax_init_arrays(alg)
    with np.load(os.path.join(ART, "jax_init", f"{alg}.npz")) as saved:
        assert sorted(saved.files) == sorted(want)
        for key, array in want.items():
            assert saved[key].dtype == array.dtype, key
            np.testing.assert_array_equal(saved[key], array, err_msg=key)


@pytest.mark.parametrize("alg", ["mappo", "maac"])
def test_model_from_jax_init_evaluates_as_jax(alg):
    """The port's ``alg`` loaded from the committed ``jax_init/<alg>.npz``
    (``convert.state_from_npz``, as ``train_zoo`` loads it) against the JAX
    package's seed-7 draw on one greedy 240-step eval episode of the zoo's
    env (case33 distributed, l1, 40 days of seed 7), float64 on both sides
    with the eval's draws replayed: every stat within 1e-9 (the
    tolerance of tests/test_torch_trainer.py's eval check).  mappo's
    policy is every case33 run's but maac's, whose Gaussian agent adds a
    log-std head."""
    from mapdn_tpu.envs import make_env as jax_make_env
    from mapdn_tpu.learn.trainer import PGTrainer as JaxPGTrainer
    from test_torch_trainer import _eval_draws, _f64
    from train import build_env_cfg as jax_env_cfg

    from mapdn_torch.convert import state_from_npz
    from mapdn_torch.envs import make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.train import build_env_cfg

    over = dict(WIDTHS, num_eval_episodes=1)
    jcfg, jenv_dict = jax_load_config(alg, scenario="case33_3min_final",
                                      voltage_barrier_type="l1", overrides=over)
    tcfg, tenv_dict = load_config(alg, scenario="case33_3min_final",
                                  voltage_barrier_type="l1", overrides=over)
    jenv = jax_make_env("case33_3min_final", jax_env_cfg(jenv_dict), days=40, seed=SEED,
                        dtype=jax.numpy.float64)
    tenv = make_env("case33_3min_final", build_env_cfg(tenv_dict), days=40, seed=SEED,
                    dtype=torch.float64, device="cpu")
    jtr = JaxPGTrainer(jcfg, jax_make_model(alg, jcfg), jenv)
    key = jax.random.PRNGKey(EVAL_SEED)
    jstats = jax.jit(jtr._eval_rollout)(_f64(jax_seed_state(jtr.model)), key)

    tmodel = make_model(alg, tcfg, device="cpu", param_dtype=torch.float64)
    algo = state_from_npz(tmodel, os.path.join(ART, "jax_init", f"{alg}.npz"))
    tstats = PGTrainer(tcfg, tmodel, tenv)._eval_rollout(
        algo, torch.Generator(), _eval_draws(key, jenv, jcfg))
    assert set(tstats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(tstats[k]), float(v), rtol=1e-9, atol=1e-10,
                                   err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["jax_init"]:
        write_jax_init()
    else:
        report()
