"""The tester's eval step as CUDA graphs (mapdn_torch/learn/eval_graph.py).

On the CPU: which steps run uncaptured and why (``PGTester._eager_reason``,
tallied by ``PGTester.step_counts`` and the ``eval.eager_steps`` counter);
wrappers on the calls into the graphs (``tester._act``, ``env.step``, as
the benchmark's eval kind installs them) leave the steps replaying, and
wrappers on a callable inside them send the steps uncaptured until they go;
``run``, ``run_days`` and ``batch_run`` through the graph path's code bit
for bit the uncaptured loops, with each "capture" standing in for a graph
whose replay runs the captured code again and no host read inside it;
every step's outputs keep their values after later steps; a state handed
back unchanged is honoured; one capture a half over days, a rebuild on a
new lane count or new parameters; the trainer never engages the tester's
graphs.

On a GPU (``cuda``, skipped elsewhere): graphed against eager from one
seed, bit for bit: a case33 ``run`` day, a case322 one-lane ``run``
(``nr_large``), a 7-day ``run_days``, and a day under the benchmark's eval
wrappers installed through ``perfbench.tracing.installed``.  This file
imports neither JAX nor mapdn_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eval_graph.py -q
"""
import numpy as np
import pytest
import torch

from mapdn_torch.algos import make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.learn import eval_graph, rollout_graph
from mapdn_torch.learn.tester import PGTester
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.pf import fused_nr
from mapdn_torch.utils import profiling
from mapdn_torch.utils.config import load_config
from test_torch_rollout_graph import _NoHostReads

torch.set_num_threads(1)

EPISODE = 7
DAYS = (0, 1, 3)


def _build(alg="mappo", *, episode_limit=EPISODE, case="case33", device="cpu", seed=3,
           pf_backend="auto", history=1):
    """A tester of freshly drawn weights whose days end after
    ``episode_limit - 1`` steps."""
    env = make_env(case, EnvConfig(episode_limit=episode_limit, pf_backend=pf_backend,
                                   history=history),
                   days=10, dtype=torch.float32, device=device)
    cfg, _ = load_config(alg, overrides=dict(hid_size=16))
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"], max_steps=episode_limit)
    model = make_model(alg, cfg, device=device)
    return PGTester(cfg, model, env, model.init_state(torch.Generator().manual_seed(seed)))


class _Direct:
    """Stands in for a captured graph where there is no card: its replay
    runs the captured code again."""

    def __init__(self, region):
        self.replay = region


@pytest.fixture
def direct(monkeypatch):
    """The graph path on the CPU, each capture standing in for a graph."""
    monkeypatch.setattr(eval_graph.EvalGraph, "supports", staticmethod(lambda device: True))
    monkeypatch.setattr(eval_graph.EvalGraph, "_capture",
                        lambda self, region: (_Direct(region), (0, 0)))


def _pass_through(fn):
    def run(*args, **kwargs):
        run.calls += 1
        return fn(*args, **kwargs)
    run.calls = 0
    return run


def _eager(fn):
    """``fn()`` with a tracer active, which keeps every step uncaptured."""
    with profiling.tracing(profiling.Tracer(device="cpu")):
        return fn()


def _day(tester, day=1):
    return tester.run(day, 10, 1, a0=torch.linspace(-0.5, 0.7, tester.env.grid.n_sgen))


def _same_record(a, b):
    assert set(a) == set(b)
    for k in a:
        assert len(a[k]) == len(b[k]) > 1
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def _kept(tester):
    """A keeper, installed on ``env.step`` as the benchmark's eval kind
    installs its own, of every step's output."""
    step, kept = tester.env.step, []

    def kept_step(*a, **kw):
        out = step(*a, **kw)
        kept.append(out)
        return out
    tester.env.step = kept_step
    return kept


def _same_values(a, b):
    """Every output of each step of ``a`` equal to ``b``'s."""
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        xs, ys = eval_graph._outputs(x), eval_graph._outputs(y)
        assert [n for n, _ in xs] == [n for n, _ in ys]
        for (name, u), (_, v) in zip(xs, ys):
            assert u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v), name


# ----------------------------------------------------------------- the rule
def test_cpu_steps_run_eager_and_are_tallied():
    tester = _build()
    rec = _day(tester)
    steps = len(rec["bus_voltage"]) - 1
    assert steps == EPISODE - 1
    counts = tester.step_counts()
    assert counts["eager"] == dict(cpu=steps, tracer=0, algorithm=0, solver=0, wrapped=0)
    assert counts["captures"] == counts["replays"] == {"act": 0, "step": 0}
    assert tester._graphs[1].graphs == {}


@pytest.mark.parametrize("reason", ["tracer", "algorithm", "solver", "wrapped"])
def test_eager_reasons_are_tallied(direct, monkeypatch, reason):
    """Each reason keeps every step uncaptured, tallied under it and by the
    ``eval.eager_steps`` counter (recorded here by a stand-in for
    ``profiling.count``; with a tracer, by the tracer)."""
    tester = _build("iddpg" if reason == "algorithm" else "mappo",
                    pf_backend="torch" if reason == "solver" else "auto")
    counted = []
    if reason == "tracer":
        tracer = profiling.Tracer(device="cpu")
        with profiling.tracing(tracer):
            rec = _day(tester)
        counted.append(tracer.summary()["counters"]["eval.eager_steps"])
    else:
        count = profiling.count
        monkeypatch.setattr(profiling, "count", lambda name, value: (
            counted.append(value) if name == "eval.eager_steps" else count(name, value)))
        if reason == "wrapped":
            tester.env._solver = _pass_through(tester.env._solver)
        rec = _day(tester)
    steps = len(rec["bus_voltage"]) - 1
    counts = tester.step_counts()
    assert counts["eager"][reason] == steps == sum(counts["eager"].values()) == sum(counted)
    assert counts["captures"] == counts["replays"] == {"act": 0, "step": 0}


@pytest.mark.parametrize("where,uncaptured", [
    ("tester._act", False), ("env.step", False), ("env._solver", True),
    ("model.get_actions", True), ("model.policy", True), ("env._calc_reward", True),
    ("env.translate_actions", True), ("policy.forward_hook", True)])
def test_wrappers_outside_replay_and_inside_run_eager(direct, where, uncaptured):
    """Three days: the second with a pass-through wrapper at ``where``.  On
    the calls into the graphs (``tester._act``, ``env.step``, which the
    benchmark wraps) its steps still replay; on a callable inside them they
    run uncaptured, seen by the wrapper, and once it is gone the graphs
    replay again with no new capture.  The days are bit for bit the
    uncaptured ones."""
    ref = _build()
    want = _eager(lambda: [_day(ref, d) for d in DAYS])

    tester = _build()
    got = [_day(tester, DAYS[0])]
    before = tester.step_counts()
    obj_name, attr = where.split(".")
    if obj_name == "policy":
        calls = [0]
        handle = tester.algo.policy.register_forward_hook(
            lambda *a: calls.__setitem__(0, calls[0] + 1))
    else:
        obj = {"model": tester.model, "env": tester.env, "tester": tester}[obj_name]
        own = attr in vars(obj)
        original = getattr(obj, attr)
        wrapper = _pass_through(original)
        setattr(obj, attr, wrapper)
    got.append(_day(tester, DAYS[1]))
    steps = len(got[1]["bus_voltage"]) - 1
    mid = tester.step_counts()
    if obj_name == "policy":
        assert calls[0] == steps
        handle.remove()
    else:
        assert wrapper.calls == (steps + 1 if attr == "_solver" else steps)
        if own:
            setattr(obj, attr, original)
        else:
            delattr(obj, attr)
    got.append(_day(tester, DAYS[2]))
    after = tester.step_counts()
    if uncaptured:
        assert mid["eager"]["wrapped"] == steps and mid["replays"] == before["replays"]
    else:
        assert sum(mid["eager"].values()) == 0
        assert mid["replays"]["step"] == before["replays"]["step"] + steps
    assert after["captures"] == before["captures"] == {"act": 1, "step": 1}
    assert after["replays"]["act"] == after["replays"]["step"] == mid["replays"]["step"] + steps
    for a, b in zip(want, got):
        _same_record(a, b)


# ------------------------------------------------ the graph path's logic
LOOPS = {
    "run": lambda t, d: _day(t, d),
    "run_days": lambda t, d: t.run_days([d, d + 2, d + 5], 6, 2),
    "batch_run": lambda t, d: t.batch_run(4),
}


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("history", [1, 3])
def test_graphed_loops_are_bit_identical_to_eager(direct, monkeypatch, loop, history):
    """Two calls of each loop through the graph path's code, run as each
    graph's replay would run it, with no host read inside it: the results,
    and every step's outputs as kept by a wrapper on ``env.step``, read
    after both calls, bit for bit the uncaptured loop's."""
    run = LOOPS[loop]
    ref = _build(history=history)
    kept_ref = _kept(ref)
    want = _eager(lambda: [run(ref, d) for d in (1, 2)])
    trap = _NoHostReads(monkeypatch)
    # the solver's plain version, which the CPU runs, reads one early-exit
    # flag an iteration; the card's kernel reads none
    monkeypatch.setattr(fused_nr, "nr_small_plain", trap.paused(fused_nr.nr_small_plain))
    for name in ("_act_region", "_step_region"):
        monkeypatch.setattr(eval_graph.EvalGraph, name,
                            trap.around(getattr(eval_graph.EvalGraph, name)))
    tester = _build(history=history)
    kept = _kept(tester)
    got = [run(tester, d) for d in (1, 2)]
    if loop == "run":
        for a, b in zip(want, got):
            _same_record(a, b)
    else:
        assert want == got
    _same_values(kept_ref, kept)
    counts = tester.step_counts()
    assert counts["captures"] == {"act": 1, "step": 1}
    assert counts["replays"]["act"] == counts["replays"]["step"] == len(kept) - 1
    assert sum(counts["eager"].values()) == 0


def test_outputs_keep_their_values_and_states_hand_back(direct):
    """Every step's returned state and reward hold that step's values after
    the day ends, and each state handed back, including one from two steps
    back, gives the uncaptured step's output."""
    ref, tester = _build(), _build()
    state, obs, _ = tester.env.manual_reset(torch.tensor([1]), 10, 1)
    outs, inputs = [], [state]
    with tester._engaged(1) as graph:
        hid = tester.model.init_hidden(1, obs.dtype)
        for t in range(5):
            tester._begin_step(graph)
            actions, hid = tester._act(obs, hid)
            # the third and fifth steps start from the state of two steps back
            state = inputs[-2] if t in (2, 4) else inputs[-1]
            out = tester.env.step(state, actions, add_noise=False)
            outs.append((state, actions.clone(), out))
            inputs.append(out.state)
            obs = out.obs
    assert tester.step_counts()["replays"]["step"] == 4
    _same_values([ref.env.step(state, actions, add_noise=False) for state, actions, _ in outs],
                 [out for _, _, out in outs])


def test_a_state_handed_back_unchanged_is_honoured(direct):
    """A wrapper on ``env.step`` that returns the state it was given (the
    benchmark's ``frozen_step`` fault): each step starts from the reset
    state again, as the uncaptured steps do."""
    def frozen(tester):
        step = tester.env.step

        def run(state, *a, **kw):
            out = step(state, *a, **kw)
            out.state = state
            return out
        tester.env.step = run

    ref, tester = _build(), _build()
    kept_ref, kept = _kept(ref), _kept(tester)
    frozen(ref)
    frozen(tester)
    want = _eager(lambda: _day(ref))
    got = _day(tester)
    _same_record(want, got)
    _same_values(kept_ref, kept)
    assert len(kept) == EPISODE   # the step counter stays at the reset's
    assert tester.step_counts()["captures"] == {"act": 1, "step": 1}


def test_one_capture_a_half_over_days_and_rebuilds(direct):
    """Three days at one lane: one capture a half, the rest replays; a
    second lane count builds graphs of its own; parameters loaded in place
    keep the graphs, a parameter moved to new storage or a new policy
    module rebuilds them."""
    tester = _build()
    steps = sum(len(_day(tester, d)["bus_voltage"]) - 1 for d in DAYS)
    counts = tester.step_counts()
    assert counts["captures"] == {"act": 1, "step": 1}
    assert counts["replays"] == {"act": steps - 1, "step": steps - 1}
    first = tester._graphs[1]
    tester.run_days([0, 1], 6, 2)
    assert set(tester._graphs) == {1, 2} and tester._graphs[1] is first
    assert tester.step_counts()["captures"] == {"act": 2, "step": 2}

    fresh = tester.model.init_state(torch.Generator().manual_seed(11))
    with torch.no_grad():
        tester.algo.policy.load_state_dict(fresh.policy.state_dict())
    _day(tester)
    assert tester._graphs[1] is first
    param = next(tester.algo.policy.parameters())
    param.data = param.data.clone()
    _day(tester)
    second = tester._graphs[1]
    assert second is not first
    tester.algo = fresh
    _day(tester)
    assert tester._graphs[1] is not second
    assert tester.step_counts()["captures"] == {"act": 4, "step": 4}


def test_the_trainer_never_engages_the_testers_graphs(direct, monkeypatch):
    """A tester and a trainer on one env: the trainer's chunks (through its
    own rollout graphs, each capture standing in for a graph) and its eval
    never go through the tester's step."""
    monkeypatch.setattr(rollout_graph.RolloutGraph, "supports",
                        staticmethod(lambda device: True))
    monkeypatch.setattr(rollout_graph.RolloutGraph, "_capture",
                        lambda self, region: (_Direct(region), (0, 0)))
    env = make_env("case33", EnvConfig(episode_limit=5), days=2, dtype=torch.float32,
                   device="cpu")
    cfg, _ = load_config("mappo", overrides=dict(
        n_envs=4, behaviour_update_freq=6, batch_size=4, replay_buffer_size=16,
        update_lanes=None, value_update_epochs=1, policy_update_epochs=1, hid_size=16,
        num_eval_episodes=2))
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"], max_steps=6)
    trainer = PGTrainer(cfg, make_model("mappo", cfg, device="cpu"), env).setup(seed=3)
    tester = PGTester(cfg, trainer.model, env, trainer.carry.algo)
    _day(tester)
    counts = tester.step_counts()
    monkeypatch.setattr(eval_graph.EvalGraph, "step", lambda *a: pytest.fail("engaged"))
    trainer.run_episode()
    trainer.evaluate()
    assert env._eval_graph is None
    assert trainer.rollout_counts()["replays"]["step"] == 5
    assert tester.step_counts() == counts


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the eval graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _launches():
    return fused_nr.nr_solve_small.launches, fused_nr.nr_solve_large.launches


def _graphed_against_eager(run, **kw):
    """``run(tester)`` on a graphed tester and on one whose steps a
    pass-through wrapper on ``get_actions`` keeps uncaptured, from one
    seed: (both results, the graphed tester), after checking the solve
    kernels' launch tallies agree."""
    eager = _build(device="cuda", **kw)
    eager.model.get_actions = _pass_through(eager.model.get_actions)
    before = _launches()
    want = run(eager)
    torch.cuda.synchronize()
    want_launches = tuple(b - a for a, b in zip(before, _launches()))
    graphed = _build(device="cuda", **kw)
    before = _launches()
    got = run(graphed)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _launches())) == want_launches
    assert sum(want_launches) > 0
    assert sum(eager.step_counts()["eager"].values()) == eager.step_counts()["eager"]["wrapped"]
    return want, got, graphed


def _only_replays(tester, steps):
    counts = tester.step_counts()
    assert counts["captures"] == {"act": 1, "step": 1}
    assert counts["replays"] == {"act": steps - 1, "step": steps - 1}
    assert sum(counts["eager"].values()) == 0


@pytest.mark.cuda
def test_graphed_case33_day_matches_eager(cuda):
    want, got, tester = _graphed_against_eager(lambda t: [_day(t, d) for d in (2, 5)],
                                               episode_limit=480)
    for a, b in zip(want, got):
        _same_record(a, b)
    _only_replays(tester, sum(len(r["bus_voltage"]) - 1 for r in got))


@pytest.mark.cuda
def test_graphed_case322_day_matches_eager(cuda):
    want, got, tester = _graphed_against_eager(_day, case="case322", episode_limit=480)
    _same_record(want, got)
    _only_replays(tester, len(got["bus_voltage"]) - 1)


@pytest.mark.cuda
def test_graphed_run_days_matches_eager(cuda):
    want, got, tester = _graphed_against_eager(
        lambda t: t.run_days(list(range(7)), 23, 2), episode_limit=480)
    assert want == got
    _only_replays(tester, 480)


@pytest.mark.cuda
def test_graphed_day_under_the_benchmarks_wrappers_matches_eager(cuda):
    """A day under the eval kind's own wrappers (a time stamp on
    ``tester._act``, a keeper of each reward on ``env.step``, installed
    through ``perfbench.tracing.installed``): the steps replay, and the day
    and every kept reward are bit for bit the uncaptured day's."""
    from perfbench import tracing

    def day(tester):
        stamps, rewards = [], []
        act, step = tester._act, tester.env.step

        def timed_act(*a, **kw):
            stamps.append(0)
            return act(*a, **kw)

        def kept_step(*a, **kw):
            out = step(*a, **kw)
            rewards.append(out.reward)
            return out
        with tracing.installed([(tester, "_act", lambda fn: timed_act),
                                (tester.env, "step", lambda fn: kept_step)]):
            rec = _day(tester, 4)
        assert len(stamps) == len(rewards) == len(rec["bus_voltage"]) - 1
        return rec, torch.stack([r.reshape(()) for r in rewards]).cpu()

    (want, want_r), (got, got_r), tester = _graphed_against_eager(day, episode_limit=480)
    _same_record(want, got)
    assert torch.equal(want_r, got_r)
    _only_replays(tester, len(got_r))
