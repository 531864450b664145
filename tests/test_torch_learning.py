"""Learning evidence of the port: its zoo's curves against the JAX package's margins.

artifacts/learning_torch/ holds the curves of 400-episode runs of the
port on one H100 (``python -m mapdn_torch.scripts.train_zoo``: case33,
512 lanes, seed 7, l1 barrier, 40 synthetic days, the reference's
cadences), and ``summary.json`` (``python -m
mapdn_torch.scripts.learning_report``) with each curve's milestones and the
port's own 256-episode uniform-random-action baseline and its standard
errors.

The counterpart of tests/test_learning.py over those files: each run's late
(last-3-evals) reward and totally-controllable ratio must beat the port's
random baseline by the JAX package's margins, unchanged, and improve over
its first eval; each raw curve must match its summary and log each episode
once.

Improvement is asserted on the reward, as tests/test_learning.py does for
every run but case69's, and on the totally-controllable ratio for the two
case69 runs, as it does for them.  The coma, iac, ippo, maac, mappo and
facmaddpg runs start from the JAX package's seed-7 initial weights
(``jax_init/<alg>.npz``; the port's own seed-7 draw evaluates at -0.049
before training where the JAX package's evaluates at -0.105,
tests/test_torch_first_eval.py), so their curves start where the JAX
curves start; the other case33 runs start from the port's own draw.
mappo_case322 misses the improvement check (a strict xfail, ROADMAP
Queue C).  The bf16-ring A/B runs (``bf16_ab/``) are summarized in
``bf16_ab/summary.json`` and not held here.

The port's random baseline must agree with the JAX package's
(artifacts/learning/summary.json) within 4·√2 standard errors: a
statistical check of the env's semantics over whole days of random
control.  The port's droop and OPF baselines (``engineering_baselines``,
computed on the card over the report's 256 rows) must be there and agree
with the JAX package's committed ones, and the droop baseline with the
JAX script's droop half computed live on the CPU (the committed JAX droop
q_loss is not what that script gives, ROADMAP C-O1).  Reads only JSON but
for that live computation.
"""
import json
import math
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "learning_torch")

# run -> (reward margin over random, ratio margin over random), copied from
# tests/test_learning.py:38-60 for the runs committed here
MARGINS = {
    "iddpg": (0.02, 0.20),
    "maddpg": (0.02, 0.20),
    "matd3": (0.02, 0.20),
    "ippo": (0.02, 0.30),
    "mappo": (0.02, 0.30),
    "iac": (0.02, 0.30),
    "coma": (0.02, 0.30),
    "sqddpg": (0.02, 0.30),
    "maac": (0.02, 0.30),
    "facmaddpg": (0.02, 0.20),
    "maddpg_decentralised": (0.02, 0.20),
    # case322's synthetic feeder is near-controllable even untrained
    # (random baseline ratio 0.977): the reward gap is where learning shows
    "mappo_case322": (0.02, 0.01),
    # case69 (Baran & Wu's published feeder): small reward margins, since
    # its zero-action point is reward-benign; control shows in the ratio
    "maddpg_case69": (0.005, 0.20),
    "mappo_case69": (0.005, 0.15),
}
# runs whose improvement is asserted on the totally-controllable ratio
# (+0.1 over the first eval) rather than the reward, as
# tests/test_learning.py:62-68 does for case69
RATIO_IMPROVEMENT_RUNS = {"maddpg_case69", "mappo_case69"}
REQUIRED = ("mappo", "maddpg")
# checks that the committed curves fail, with their numbers (ROADMAP Queue C)
XFAIL = {
    ("mappo_case322", "improves"): (
        "mappo_case322's curve is flat within the eval's noise from the first eval "
        "on (every bus controlled): late reward -0.0190 against first -0.0186"),
}


def _runs(check):
    return [pytest.param(run, marks=pytest.mark.xfail(strict=True, reason=XFAIL[run, check]))
            if (run, check) in XFAIL else run for run in sorted(MARGINS)]
STATS = ("mean_test_reward", "mean_test_totally_controllable_ratio")


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def summary():
    path = os.path.join(ART, "summary.json")
    assert os.path.exists(path), (
        "artifacts/learning_torch/summary.json missing: run python -m "
        "mapdn_torch.scripts.train_zoo, then python -m "
        "mapdn_torch.scripts.learning_report")
    return _load(path)


def _baseline_for(summary, run):
    for case in ("case322", "case69"):
        if run.endswith("_" + case):
            return summary["random_baseline_" + case]
    return summary["random_baseline"]


def test_required_runs_committed(summary):
    missing = [r for r in set(REQUIRED) | set(MARGINS) if r not in summary]
    assert not missing, f"no committed curves for {missing}"


@pytest.mark.parametrize("run", _runs("beats_random"))
def test_trained_beats_random_baseline(summary, run):
    reward_margin, ratio_margin = MARGINS[run]
    rnd = _baseline_for(summary, run)
    late_r = summary[run]["late_mean_test_reward"]
    late_c = summary[run]["late_mean_test_totally_controllable_ratio"]
    assert late_r > rnd["mean_test_reward"] + reward_margin, (
        f"{run}: late eval reward {late_r:.4f} does not beat random "
        f"{rnd['mean_test_reward']:.4f} by {reward_margin}")
    assert late_c > rnd["mean_test_totally_controllable_ratio"] + ratio_margin, (
        f"{run}: late controllable ratio {late_c:.3f} vs random "
        f"{rnd['mean_test_totally_controllable_ratio']:.3f} margin {ratio_margin}")


@pytest.mark.parametrize("run", _runs("improves"))
def test_curve_improves_over_training(summary, run):
    s = summary[run]
    if run in RATIO_IMPROVEMENT_RUNS:
        assert (s["late_mean_test_totally_controllable_ratio"]
                > s["first"]["mean_test_totally_controllable_ratio"] + 0.1), (
            f"{run}: no controllability improvement over training")
        return
    assert s["late_mean_test_reward"] > s["first"]["mean_test_reward"], (
        f"{run}: no improvement over training")


@pytest.mark.parametrize("run", sorted(MARGINS))
def test_curve_matches_its_summary(summary, run):
    s = summary[run]
    assert s["n_episodes"] >= 400
    path = os.path.join(ROOT, s["metrics_path"])
    assert os.path.exists(path), s["metrics_path"]
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    steps = [r["step"] for r in recs]
    assert steps == list(range(1, len(recs) + 1)) and steps[-1] == s["n_episodes"]
    evals = [r for r in recs if "mean_test_reward" in r]
    assert len(evals) == s["n_evals"]
    assert evals[0]["mean_test_reward"] == s["first"]["mean_test_reward"]
    assert evals[-1]["mean_test_reward"] == s["final"]["mean_test_reward"]
    late = sum(r["mean_test_reward"] for r in evals[-3:]) / len(evals[-3:])
    assert abs(late - s["late_mean_test_reward"]) < 1e-12


@pytest.mark.parametrize("stat", STATS)
def test_random_baseline_agrees_with_jax(summary, stat):
    """The two packages' 256-episode baselines, each a mean over
    independent episodes with different generators: their difference has a
    standard error of about √2 times the port's."""
    jax_rnd = _load(os.path.join(ROOT, "artifacts", "learning", "summary.json"))
    port, sem = summary["random_baseline"][stat], summary["random_baseline_sem"][stat]
    want = jax_rnd["random_baseline"][stat]
    assert math.isfinite(port) and 0.0 < sem < 0.05
    assert abs(port - want) <= 4 * math.sqrt(2) * sem, (stat, port, want, sem)


@pytest.mark.parametrize("stat", STATS)
def test_random_baseline_case69_agrees_with_jax(summary, stat):
    """case69's 256-episode random baselines, as
    test_random_baseline_agrees_with_jax holds case33's."""
    jax_rnd = _load(os.path.join(ROOT, "artifacts", "learning", "summary.json"))
    port = summary["random_baseline_case69"][stat]
    sem = summary["random_baseline_case69_sem"][stat]
    want = jax_rnd["random_baseline_case69"][stat]
    assert math.isfinite(port) and 0.0 < sem < 0.05
    assert abs(port - want) <= 4 * math.sqrt(2) * sem, (stat, port, want, sem)


def test_engineering_baselines_present(summary):
    """tests/test_learning.py's check on the port's summary: droop and OPF
    context (the reference's traditional_control/*.m role), so a
    controller is judged against engineering baselines and not only
    against random actions; here over all 256 rows the report draws."""
    for key in ("droop_baseline", "opf_baseline"):
        assert key in summary, key
        assert "mean_test_totally_controllable_ratio" in summary[key]
        assert summary[key]["n_samples"] == 256
        assert all(math.isfinite(v) for v in summary[key].values()), summary[key]


# The card's engineering baselines (float32, the learning report's 256 rows)
# against the JAX package's committed ones (artifacts/learning/summary.json,
# float32 on a CPU).  Float32 against float64 of the same code on the CPU
# over those rows (``engineering_baselines`` at each dtype): droop every
# stat within 3.5e-6, OPF's reward within 7.4e-8 and its ratio equal (a lane
# crossing the band's edge moves the ratio by 1/256 = 0.0039; OPF's penalty
# leaves voltages on that edge).  Limits: droop 1e-4 on every stat, OPF's
# reward 1e-3 and ratio 0.05, and the sample counts equal.
ENGINEERING_STATS = (
    "average_voltage", "average_voltage_deviation", "destroy",
    "max_voltage_drop_deviation", "max_voltage_rise_deviation",
    "percentage_of_higher_than_upper_v", "percentage_of_lower_than_lower_v",
    "percentage_of_v_out_of_control", "q_loss", "reward", "total_line_loss",
    "totally_controllable_ratio")
ENGINEERING_LIMITS = (
    [("droop_baseline", "mean_test_" + k, 1e-4) for k in ENGINEERING_STATS]
    + [("opf_baseline", "mean_test_reward", 1e-3),
       ("opf_baseline", "mean_test_totally_controllable_ratio", 0.05)]
    + [(key, "n_samples", 0) for key in ("droop_baseline", "opf_baseline")])
# checks that the committed values fail, with their numbers (ROADMAP Queue C)
ENGINEERING_XFAIL = {
    ("droop_baseline", "mean_test_q_loss"): (
        "droop q_loss: the card's 0.280894 against JAX's committed 0.281293 (4.0e-4). "
        "The committed value is not what the JAX script gives: its droop half run on "
        "the CPU at float32 (256 rows of default_rng(7), jax.vmap(droop_solve), "
        "scripts/learning_report.py:86-110) gives 0.28089413 on every committed tree "
        "of mapdn_tpu/ (2a4c99a, its parent and today's), and the file held exactly "
        "0.28089413 before 2a4c99a (git show 2a4c99a -- "
        "artifacts/learning/summary.json); "
        "test_droop_baseline_agrees_with_jax_script_live holds the port to the live "
        "value"),
}


@pytest.mark.parametrize("key,stat,limit", [
    pytest.param(*case, marks=pytest.mark.xfail(strict=True, reason=ENGINEERING_XFAIL[case[:2]]))
    if case[:2] in ENGINEERING_XFAIL else case for case in ENGINEERING_LIMITS])
def test_engineering_baselines_agree_with_jax(summary, key, stat, limit):
    jax_summary = _load(os.path.join(ROOT, "artifacts", "learning", "summary.json"))
    port, want = summary[key][stat], jax_summary[key][stat]
    assert abs(port - want) <= limit, (key, stat, port, want)


def _jax_script_droop():
    """The droop half of scripts/learning_report.py's
    ``engineering_baselines`` (:86-110), computed now on the CPU: its env
    build (float32, 40 synthetic days of seed 7), 256 rows of
    ``default_rng(7)``, ``jax.jit(jax.vmap(...))`` of ``droop_solve``, the
    converged lanes' means."""
    import importlib.util

    import jax
    import numpy as np
    from mapdn_tpu.traditional.droop import droop_solve

    spec = importlib.util.spec_from_file_location(
        "jax_learning_report", os.path.join(ROOT, "scripts", "learning_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    env = report._build_env("case33")
    rows = np.random.default_rng(7).integers(0, env.ts.n_steps, size=256)

    def one(lp, lq, pv):
        q, res, _ = droop_solve(env, lp, lq, pv)
        reward, info = env._calc_reward(res.vm, res.pl_mw, q)
        info["reward"] = reward
        info["converged"] = res.converged.astype(res.vm.dtype)
        return info

    info = jax.jit(jax.vmap(one))(env.ts.load_p[rows], env.ts.load_q[rows], env.ts.pv[rows])
    ok = np.asarray(info.pop("converged")) > 0
    out = {"mean_test_" + k: float(np.mean(np.asarray(v)[ok])) for k, v in info.items()}
    out["n_samples"] = int(ok.sum())
    return out


def test_droop_baseline_agrees_with_jax_script_live(summary):
    """The port's committed droop baseline (the card's, float32) against the
    JAX script's droop half computed live, every stat within 1e-4 (the
    limit of test_engineering_baselines_agree_with_jax), the sample count
    equal: the check that the committed JAX droop q_loss cannot make
    (ENGINEERING_XFAIL)."""
    live = _jax_script_droop()
    port = summary["droop_baseline"]
    assert port["n_samples"] == live["n_samples"] == 256
    for stat in ENGINEERING_STATS:
        key = "mean_test_" + stat
        assert abs(port[key] - live[key]) <= 1e-4, (key, port[key], live[key])
