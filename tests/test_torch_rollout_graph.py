"""The trainer's rollout step as CUDA graphs (mapdn_torch/learn/rollout_graph.py).

On the CPU: which steps run uncaptured and why (``PGTrainer._eager_reason``,
tallied by ``PGTrainer.rollout_counts`` and, under a tracer, by the
``train.eager_steps`` counter); the uncaptured chunk bit for bit the code
path it had before the graphs (its eager chunk, carried here), in both ring
modes; and the graph path's own logic (static buffers, ring rows, stats
columns, the reset branch and its patch of ``next_state``) bit for bit the
uncaptured chunk, with each "capture" standing in for a graph whose replay
runs the captured code again, and with host reads trapped in it for the
algorithms that declare their rollout capturable.

On a GPU (``cuda``, skipped elsewhere): graphed against eager from one seed,
bit for bit: case33 MAPPO at 512 lanes in both ring modes, case33 MADDPG
at 512 lanes on a ring that wraps inside a chunk, case33 in episodic mode,
case322 at 64 lanes; and a wrapper installed between chunks
sends its steps eager, after which the graph resumes.  This file imports
neither JAX nor mapdn_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rollout_graph.py -q
"""
import collections
import dataclasses
import types

import pytest
import torch
import torch.distributed as dist

from mapdn_torch.algos import make_model
from mapdn_torch.algos.registry import MODEL_REGISTRY
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.envs.voltage_control import _lane_where, select_state
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn import rollout_graph
from mapdn_torch.learn.trainer import PGTrainer, _mean_stats
from mapdn_torch.parallel import ShardedPGTrainer
from mapdn_torch.pf import fused_nr
from mapdn_torch.utils import lanes, profiling
from mapdn_torch.utils.config import load_config

torch.set_num_threads(1)

L, CHUNK, EPISODE = 16, 12, 5


def _build(alg="mappo", *, lanes_=L, chunk=CHUNK, ring_steps=4, batch_size=4,
           episode_limit=EPISODE, history=1, device="cpu", case="case33", episodic=False,
           trainer_cls=PGTrainer, seed=3, pf_backend="auto", pf_fixed_iter=None, **over):
    """A set-up trainer whose lanes' episodes end inside its chunks;
    ``ring_steps`` of ring a lane against ``chunk``-step chunks (a pool of
    as many episodes a lane in episodic mode)."""
    env = make_env(case, EnvConfig(episode_limit=episode_limit, history=history,
                                   pf_backend=pf_backend, pf_fixed_iter=pf_fixed_iter),
                   days=2, dtype=torch.float32, device=device)
    overrides = dict(n_envs=lanes_, behaviour_update_freq=chunk, batch_size=batch_size,
                     replay_buffer_size=lanes_ * ring_steps, update_lanes=None,
                     value_update_epochs=2, policy_update_epochs=1, replay_bf16=False,
                     hid_size=16)
    overrides.update(over)
    if episodic:
        overrides.update(behaviour_update_freq=1, batch_size=batch_size)
    cfg, _ = load_config(alg, overrides=overrides)
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"], max_steps=chunk, episodic=episodic)
    return trainer_cls(cfg, make_model(alg, cfg, device=device), env).setup(seed=seed)


def _tensors(x):
    """Every tensor of a carry or a stats dict, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return [p.detach() for p in x.parameters()]
    if isinstance(x, torch.Generator):
        return [x.get_state()]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _tensors(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [torch.tensor(x)] if isinstance(x, (int, float)) else []


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())


def _snapshot(trainer):
    """The carry's tensors and the ring's pointer and fill, copied."""
    c = trainer.carry
    return ([t.clone() for t in _tensors(c)], c.replay.ptr, c.replay.size, c.steps)


def _run(trainer, chunks):
    """``run_episode`` ``chunks`` times; each episode's stats, then the
    carry's snapshot."""
    stats = [trainer.run_episode() for _ in range(chunks)]
    return stats, _snapshot(trainer)


def _same_runs(a, b):
    (sa, (ta, pa, za, na)), (sb, (tb, pb, zb, nb)) = a, b
    assert sa == sb
    assert (pa, za, na) == (pb, zb, nb)
    _assert_same(ta, tb)


class _Direct:
    """Stands in for a captured graph where there is no card: its replay
    runs the captured code again."""

    def __init__(self, region):
        self.replay = region


@pytest.fixture
def direct(monkeypatch):
    """The graph path on the CPU, each capture standing in for a graph."""
    monkeypatch.setattr(rollout_graph.RolloutGraph, "supports",
                        staticmethod(lambda device: True))
    monkeypatch.setattr(rollout_graph.RolloutGraph, "_capture",
                        lambda self, region: (_Direct(region), (0, 0)))


def _pass_through(fn):
    def run(*args, **kwargs):
        run.calls += 1
        return fn(*args, **kwargs)
    run.calls = 0
    return run


# ----------------------------------------------------------------- the rule
def test_only_ppo_declares_its_rollout_capturable():
    """The PPO pair, MADDPG and MAAC (a Gaussian head), whose rollout runs
    the base class's get_actions as MAPPO's does; the other algorithms step
    eagerly."""
    assert {alg for alg, cls in MODEL_REGISTRY.items() if cls.rollout_capturable} == {
        "mappo", "ippo", "maddpg", "maac"}


def test_cpu_steps_run_eager_and_are_tallied():
    tr = _build()
    tr.run_episode()
    tr.run_episode()
    counts = tr.rollout_counts()
    assert counts["eager"] == dict(cpu=2 * CHUNK, draws=0, shard=0, tracer=0, algorithm=0,
                                   solver=0, wrapped=0)
    assert counts["captures"] == counts["replays"] == {"step": 0, "reset": 0}
    assert tr._graph.graphs == {}


def test_graph_path_tallies_captures_and_replays(direct):
    tr = _build()
    _run(tr, 3)
    counts = tr.rollout_counts()
    assert sum(counts["eager"].values()) == 0
    assert counts["captures"] == {"step": 1, "reset": 1}
    assert counts["replays"]["step"] == 3 * CHUNK - 1
    # EPISODE-step episodes: lanes terminate on 2 of every 5 steps at least
    assert counts["replays"]["reset"] >= 3 * CHUNK // EPISODE - 1


def test_steps_with_draws_run_uncaptured_and_the_rest_replay(direct):
    """Chunks in which only some steps carry explicit draws (their action
    noise): those steps run uncaptured, tallied under ``draws``, and the
    others replay the graphs; three such chunks give the stats, the carry,
    the ring and the generator of a run with no graph (a tracer keeps
    every step of it uncaptured)."""
    with_draws = (0, 5, 6, CHUNK - 1)
    noise = torch.Generator().manual_seed(5)
    shape = (L, _build().model.n, 1)
    draws = [{"steps": [{"action_noise": torch.randn(shape, generator=noise)}
                        if t in with_draws else None for t in range(CHUNK)]}
             for _ in range(3)]

    def run(trainer):
        stats = []
        for chunk in draws:
            trainer.carry, st = trainer._train_chunk(trainer.carry, chunk)
            stats.append({k: float(v) for k, v in st.items()})
        return stats, _snapshot(trainer)

    ref = _build()
    with profiling.tracing(profiling.Tracer(device="cpu")):
        want = run(ref)
    assert ref.rollout_counts()["eager"]["tracer"] == 3 * (CHUNK - len(with_draws))
    tr = _build()
    _same_runs(want, run(tr))
    counts = tr.rollout_counts()
    n = 3 * len(with_draws)
    assert counts["eager"] == dict(cpu=0, draws=n, shard=0, tracer=0, algorithm=0, solver=0,
                                   wrapped=0)
    assert counts["captures"]["step"] == 1 and counts["replays"]["step"] == 3 * CHUNK - n - 1


@pytest.mark.parametrize("reason", ["draws", "tracer", "algorithm", "solver"])
def test_eager_reasons_are_tallied(direct, reason):
    # the torch-op solver reads its early-exit flag back every iteration
    tr = _build("iddpg" if reason == "algorithm" else "mappo",
                pf_backend="torch" if reason == "solver" else "auto")
    if reason == "draws":
        # explicit (here empty) step draws, as the parity tests give them
        tr.carry, _ = tr._train_chunk(tr.carry, {"steps": [{} for _ in range(CHUNK)]})
    elif reason == "tracer":
        tracer = profiling.Tracer(device="cpu")
        with profiling.tracing(tracer):
            tr.carry, _ = tr._train_chunk(tr.carry)
        assert tracer.summary()["counters"]["train.eager_steps"] == CHUNK
    else:
        tr.carry, _ = tr._train_chunk(tr.carry)
    counts = tr.rollout_counts()
    assert counts["eager"][reason] == CHUNK
    assert sum(counts["eager"].values()) == CHUNK
    assert counts["captures"] == counts["replays"] == {"step": 0, "reset": 0}


def test_eager_steps_counter_counts_every_eager_step():
    tr = _build()
    tracer = profiling.Tracer(device="cpu")
    with profiling.tracing(tracer):
        tr.run_episode()
    counters = tracer.summary()["counters"]
    # MAPPO's episode crosses no target_update_freq boundary (no soft
    # update), and runs no tester; the fused policy runs on the card alone
    assert set(counters) == set(profiling.COUNTERS) - {"train.target_updates",
                                                       "eval.eager_steps",
                                                       "update.attend_logits",
                                                       "policy.fused_rows"}
    assert counters["train.eager_steps"] == CHUNK == tr.rollout_counts()["eager"]["cpu"]


def test_shard_steps_run_eager(direct, tmp_path):
    """A one-rank process group: the sharded trainer's steps stay eager."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        tr = _build(trainer_cls=ShardedPGTrainer)
        tr.run_episode()
    finally:
        dist.destroy_process_group()
    counts = tr.rollout_counts()
    assert counts["eager"]["shard"] == CHUNK == sum(counts["eager"].values())
    assert counts["captures"]["step"] == 0


@pytest.mark.parametrize("where", ["model.get_actions", "env._solver", "env.step",
                                   "env._attempt_reset", "trainer._rollout_step",
                                   "policy.forward_hook"])
def test_wrapped_steps_run_eager_and_the_graph_resumes(direct, where):
    """A wrapper installed between chunks sees every step of its chunk (no
    replay), and once removed the graph replays again, without a new
    capture; the three chunks are bit for bit the eager ones."""
    ref = _build()
    with profiling.tracing(profiling.Tracer(device="cpu")):
        want = _run(ref, 3)

    tr = _build()
    stats = [tr.run_episode()]
    before = tr.rollout_counts()
    obj_name, attr = where.split(".")
    if obj_name == "policy":
        calls = [0]
        handle = tr.carry.algo.policy.register_forward_hook(
            lambda *a: calls.__setitem__(0, calls[0] + 1))
    else:
        obj = {"model": tr.model, "env": tr.env, "trainer": tr}[obj_name]
        own = attr in vars(obj)
        original = getattr(obj, attr)
        wrapper = _pass_through(original)
        setattr(obj, attr, wrapper)
    stats.append(tr.run_episode())
    mid = tr.rollout_counts()
    assert mid["eager"]["wrapped"] == CHUNK
    assert mid["replays"] == before["replays"]
    if obj_name == "policy":
        assert calls[0] >= CHUNK   # and the update's forwards
        handle.remove()
    else:
        assert wrapper.calls >= (1 if attr == "_attempt_reset" else CHUNK)
        if own:
            setattr(obj, attr, original)
        else:
            delattr(obj, attr)
    stats.append(tr.run_episode())
    after = tr.rollout_counts()
    assert after["eager"]["wrapped"] == CHUNK
    assert after["replays"]["step"] == before["replays"]["step"] + CHUNK
    assert after["captures"] == before["captures"]
    _same_runs(want, (stats, _snapshot(tr)))


def test_the_env_tells_whether_its_solver_reads_the_host():
    assert _build().env.solver_capturable
    assert not _build(pf_backend="torch").env.solver_capturable
    assert _build(pf_backend="torch", pf_fixed_iter=8).env.solver_capturable


def test_torch_solver_with_fixed_iterations_replays_the_graph(direct, monkeypatch):
    """The torch-op solver with a fixed iteration count reads nothing back,
    so its steps take the graph path, bit for bit the eager ones."""
    kw = dict(ring_steps=8, batch_size=8, pf_backend="torch", pf_fixed_iter=8)
    ref = _build(**kw)
    with profiling.tracing(profiling.Tracer(device="cpu")):
        want = _run(ref, 2)
    trap = _NoHostReads(monkeypatch)
    for name in ("_step_region", "_reset_region"):
        monkeypatch.setattr(rollout_graph.RolloutGraph, name,
                            trap.around(getattr(rollout_graph.RolloutGraph, name)))
    tr = _build(**kw)
    _same_runs(want, _run(tr, 2))
    counts = tr.rollout_counts()
    assert counts["captures"]["step"] == 1 and sum(counts["eager"].values()) == 0


def test_a_step_past_the_chunk_raises(direct):
    """The device-held step index would write past the chunk's stats
    columns: the host refuses the step until the next chunk begins."""
    tr = _build()
    tr.run_episode()
    graph = tr._graph
    with pytest.raises(RuntimeError, match="begin_chunk"):
        graph.step(tr.carry)
    graph.begin_chunk(tr.carry)
    tr.carry = graph.step(tr.carry)


def test_a_new_carry_or_new_parameters_rebuild_the_graph(direct):
    tr = _build()
    tr.run_episode()
    first = tr._graph
    tr.run_episode()
    assert tr._graph is first
    tr.setup(seed=4)   # a new carry: new modules, generator and ring
    tr.run_episode()
    assert tr._graph is not first and tr.rollout_counts()["captures"]["step"] == 2


# --------------------------------------------- the eager path is unchanged
def _parent_rollout_step_body(self, carry, draws):
    """``PGTrainer._rollout_step_body`` as it was before the rollout graphs."""
    model = self.model
    gen = carry.generator
    with profiling.span("train.policy"):
        _, action_pol, log_prob, _, hid = model.get_actions(
            carry.algo.policy, carry.obs, carry.last_hid, status="train",
            exploration=True, avail=self.avail, generator=gen,
            noise=draws.get("action_noise"))
    env_actions = self.env.translate_actions(action_pol)
    out = self.env.batched_auto_reset_step(
        carry.env_state, env_actions, gen, draws=draws.get("env"))

    value = torch.zeros((self.n_envs, model.n), dtype=carry.obs.dtype,
                        device=carry.obs.device)
    done = out.terminated.to(carry.obs.dtype)
    trans = type(self._example_transition(carry.obs))(
        state=carry.obs, action=action_pol, log_prob_a=log_prob,
        value=value, next_value=torch.zeros_like(value),
        reward=out.reward[:, None].expand(self.n_envs, model.n),
        next_state=out.obs, done=done, last_step=done,
        last_hid=carry.last_hid,
        hid=hid if model.stores_next_hidden else hid[..., :0])
    if self.cfg.replay_bf16:
        b = torch.bfloat16
        trans = trans.replace(state=trans.state.to(b),
                              next_state=trans.next_state.to(b),
                              last_hid=trans.last_hid.to(b),
                              hid=trans.hid.to(b))
    next_hid = torch.where(out.terminated[:, None, None],
                           torch.zeros_like(hid), hid)
    stats = {"mean_train_reward": out.reward.mean()}
    for k, v in out.info.items():
        stats["mean_train_" + k] = v.mean()
    carry = dataclasses.replace(carry, env_state=out.state, obs=out.obs,
                                last_hid=next_hid, steps=carry.steps + 1)
    return carry, trans, stats


def _parent_auto_reset_step(self, states, sgen_actions, generator=None, add_noise=True,
                            draws=None, always_reset=False):
    """``VoltageControlEnv.batched_auto_reset_step`` as it was before the
    rollout graphs."""
    draws = draws or {}
    out = self.step(states, sgen_actions, generator, add_noise,
                    noise=draws.get("step_noise"))
    if not always_reset and not lanes.any_lane(out.terminated):
        return out
    n_lanes = out.reward.shape[0]
    t0 = draws.get("t0")
    t0 = self._sample_start(n_lanes, generator) if t0 is None else lanes.given(t0)
    fresh, ok = self._attempt_reset(
        t0, add_noise, generator, vm0=states.vm, va0=states.va,
        noise=draws.get("reset_noise"), a0=draws.get("a0"))
    fresh = fresh.replace(terminated=~ok)
    obs_f, fresh = self._obs_and_push_hist(fresh)
    sel = out.terminated
    return dataclasses.replace(
        out, state=select_state(sel, fresh, out.state),
        obs=_lane_where(sel, obs_f, out.obs),
        global_state=_lane_where(sel, self.get_state(fresh), out.global_state))


def _parent_eager_chunk(self, carry, step_draws):
    """``PGTrainer._eager_chunk`` as it was before the rollout graphs, less
    its tally and spans: the tail of the chunk's transitions stacked and
    written once where the chunk refills the ring, else each step's
    written as it comes."""
    tail = collections.deque(maxlen=carry.replay.capacity)
    roll_stats = []
    for t in range(self._chunk_len):
        carry, trans, stats = self._rollout_step(carry, step_draws[t])
        roll_stats.append(stats)
        if self._stack_emit:
            tail.append(trans)
        else:
            carry.replay = rb.add(carry.replay, trans)
    if self._stack_emit:
        stacked = tail[0].map(lambda *xs: torch.stack(xs), *list(tail)[1:])
        carry.replay = rb.add_many(carry.replay, stacked)
    return carry, _mean_stats(roll_stats)


@pytest.mark.parametrize("ring_steps", [8, 16], ids=["stacked_ring_write",
                                                     "per_step_ring_write"])
def test_eager_chunk_is_bit_identical_to_the_code_path_before_graphs(monkeypatch,
                                                                     ring_steps):
    old = _build(ring_steps=ring_steps, batch_size=8)
    monkeypatch.setattr(old, "_rollout_chunk", types.MethodType(_parent_eager_chunk, old))
    monkeypatch.setattr(old, "_rollout_step_body",
                        types.MethodType(_parent_rollout_step_body, old))
    monkeypatch.setattr(old.env, "batched_auto_reset_step",
                        types.MethodType(_parent_auto_reset_step, old.env))
    new = _build(ring_steps=ring_steps, batch_size=8)
    assert new._stack_emit == (ring_steps <= CHUNK)
    _same_runs(_run(old, 3), _run(new, 3))
    assert new.rollout_counts()["eager"]["cpu"] == 3 * CHUNK


# ------------------------------------------------ the graph path's logic
class _NoHostReads:
    """Tensor methods that read a value to the host raise while active."""
    NAMES = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "numpy")

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.on = False

        def trap(name, fn):
            def run(x, *a, **kw):
                if self.on:
                    raise AssertionError(f"host read {name} inside the rollout graph")
                return fn(x, *a, **kw)
            return run
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name, trap(name, getattr(torch.Tensor, name)))

    def _with(self, on, fn):
        def run(*a, **kw):
            saved, self.on = self.on, on
            try:
                return fn(*a, **kw)
            finally:
                self.on = saved
        return run

    def around(self, fn):
        return self._with(True, fn)

    def paused(self, fn):
        return self._with(False, fn)


@pytest.mark.parametrize("alg,ring_steps,episodic,bf16,history", [
    ("mappo", 8, False, False, 1), ("mappo", 16, False, False, 1), ("mappo", 8, False, True, 1),
    ("mappo", 2, True, False, 1), ("ippo", 8, False, False, 1), ("mappo", 8, False, False, 3),
    ("maddpg", 15, False, False, 1), ("maac", 15, False, False, 1)],
    ids=["stacked_ring_write", "per_step_ring_write", "bf16_ring", "episodic", "ippo",
         "history3", "maddpg_ring_wraps", "maac_ring_wraps"])
def test_graph_logic_is_bit_identical_to_eager(direct, monkeypatch, alg, ring_steps,
                                               episodic, bf16, history):
    """Three chunks (episodes in episodic mode) through the graph path's
    code, run as each graph's replay would run it, with no host read inside
    it: the stats, the carry, the ring and the generator as the eager
    path's.  MADDPG keeps its 15-step ring across the 12-step chunks, so
    the per-step writes wrap at its end inside the second and third chunks,
    and a soft target update follows the second."""
    kw = dict(ring_steps=ring_steps, batch_size=2 if episodic else 8, episodic=episodic,
              replay_bf16=bf16, history=history)
    if alg in ("maddpg", "maac"):
        kw.update(target_update_freq=2 * CHUNK)
    ref = _build(alg, **kw)
    with profiling.tracing(profiling.Tracer(device="cpu")):
        want = _run(ref, 3)
    trap = _NoHostReads(monkeypatch)
    # the solver's plain version, which the CPU runs, reads one early-exit
    # flag an iteration; the card's kernel reads none (the tests below)
    monkeypatch.setattr(fused_nr, "nr_small_plain", trap.paused(fused_nr.nr_small_plain))
    for name in ("_step_region", "_reset_region"):
        monkeypatch.setattr(rollout_graph.RolloutGraph, name,
                            trap.around(getattr(rollout_graph.RolloutGraph, name)))
    tr = _build(alg, **kw)
    got = _run(tr, 3)
    _same_runs(want, got)
    counts = tr.rollout_counts()
    assert counts["captures"] == {"step": 1, "reset": 1}
    assert counts["replays"]["step"] == 3 * CHUNK - 1
    assert sum(counts["eager"].values()) == 0


def test_graph_ring_replaces_the_carrys_in_the_stack_mode(direct):
    tr = _build(ring_steps=8)
    ring = tr.carry.replay.data
    tr.run_episode()
    assert tr.carry.replay.data is tr._graph.ring is not ring
    tr.run_episode()
    assert tr.carry.replay.data is tr._graph.ring


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _launch_delta(fn):
    before = (fused_nr.nr_solve_small.launches, fused_nr.nr_solve_large.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, (fused_nr.nr_solve_small.launches - before[0],
                 fused_nr.nr_solve_large.launches - before[1])


def _graphed_against_eager(chunks, kernel=True, **kw):
    """The same trainer run graphed and eagerly (a pass-through wrapper on
    ``get_actions`` keeps every step eager) from one seed: both runs'
    results, launch tallies (none without a ``kernel`` solver) and the
    generator's offsets."""
    eager = _build(device="cuda", **kw)
    eager.model.get_actions = _pass_through(eager.model.get_actions)
    want, want_launches = _launch_delta(lambda: _run(eager, chunks))
    graphed = _build(device="cuda", **kw)
    got, got_launches = _launch_delta(lambda: _run(graphed, chunks))
    _same_runs(want, got)
    assert want_launches == got_launches
    assert sum(got_launches) >= chunks * kw["chunk"] if kernel else sum(got_launches) == 0
    assert eager.carry.generator.get_offset() == graphed.carry.generator.get_offset()
    assert eager.rollout_counts()["eager"]["wrapped"] == chunks * kw["chunk"]
    return graphed


@pytest.mark.cuda
@pytest.mark.parametrize("ring_steps,batch_size", [(8, 8), (32, 24)],
                         ids=["stacked_ring_write", "per_step_ring_write"])
def test_graphed_case33_matches_eager(cuda, ring_steps, batch_size):
    tr = _graphed_against_eager(3, lanes_=512, chunk=20, episode_limit=25,
                                ring_steps=ring_steps, batch_size=batch_size)
    counts = tr.rollout_counts()
    assert counts["captures"] == {"step": 1, "reset": 1}
    assert counts["replays"]["step"] == 3 * 20 - 1 and counts["replays"]["reset"] >= 1
    assert sum(counts["eager"].values()) == 0


@pytest.mark.cuda
def test_graphed_maddpg_case33_matches_eager(cuda):
    """MADDPG's off-policy ring of 45 steps a lane against 20-step chunks:
    the graph writes a row a step and wraps at the ring's end inside the
    third chunk; a soft target update follows the second."""
    tr = _graphed_against_eager(3, alg="maddpg", lanes_=512, chunk=20, episode_limit=25,
                                ring_steps=45, batch_size=8, target_update_freq=40)
    counts = tr.rollout_counts()
    assert tr._graph.mode == "ring" and tr.carry.replay.size == 45
    assert tr.carry.replay.ptr == 3 * 20 - 45
    assert counts["captures"] == {"step": 1, "reset": 1}
    assert counts["replays"]["step"] == 3 * 20 - 1 and sum(counts["eager"].values()) == 0


@pytest.mark.cuda
def test_graphed_episodic_case33_matches_eager(cuda):
    tr = _graphed_against_eager(3, lanes_=64, chunk=20, episode_limit=15, ring_steps=2,
                                batch_size=16, episodic=True)
    assert tr.rollout_counts()["captures"] == {"step": 1, "reset": 1}


@pytest.mark.cuda
def test_graphed_case322_matches_eager(cuda):
    tr = _graphed_against_eager(2, lanes_=64, chunk=20, episode_limit=25, ring_steps=8,
                                batch_size=8, case="case322")
    assert tr.rollout_counts()["replays"]["step"] == 2 * 20 - 1


@pytest.mark.cuda
def test_graph_is_not_replayed_under_a_wrapper_on_the_card(cuda):
    kw = dict(lanes_=512, chunk=20, episode_limit=25, ring_steps=8, batch_size=8)
    eager = _build(device="cuda", **kw)
    eager.model.get_actions = _pass_through(eager.model.get_actions)
    want = _run(eager, 3)
    tr = _build(device="cuda", **kw)
    stats = [tr.run_episode()]
    before = tr.rollout_counts()
    solver = tr.env._solver
    tr.env._solver = _pass_through(solver)
    stats.append(tr.run_episode())
    assert tr.env._solver.calls >= 20
    mid = tr.rollout_counts()
    assert mid["replays"] == before["replays"] and mid["eager"]["wrapped"] == 20
    tr.env._solver = solver
    stats.append(tr.run_episode())
    after = tr.rollout_counts()
    assert after["replays"]["step"] == before["replays"]["step"] + 20
    # no new step graph (the first reset, at step 25, may come after the wrapper)
    assert after["captures"]["step"] == before["captures"]["step"] == 1
    assert after["captures"]["reset"] == 1
    _same_runs(want, (stats, _snapshot(tr)))


@pytest.mark.cuda
def test_torch_solver_trains_eagerly_on_the_card(cuda):
    """MAPPO with the torch-op solver, whose early exit reads the host every
    iteration: every step runs eagerly, and no graph is captured."""
    tr = _build(device="cuda", lanes_=512, chunk=20, episode_limit=25, ring_steps=8,
                batch_size=8, pf_backend="torch")
    stats = [tr.run_episode() for _ in range(2)]
    torch.cuda.synchronize()
    counts = tr.rollout_counts()
    assert counts["eager"]["solver"] == 2 * 20 == sum(counts["eager"].values())
    assert counts["captures"] == {"step": 0, "reset": 0} and tr._graph.graphs == {}
    assert all(torch.isfinite(torch.as_tensor(v)).all() for st in stats for v in st.values())


@pytest.mark.cuda
def test_graphed_torch_solver_with_fixed_iterations_matches_eager(cuda):
    tr = _graphed_against_eager(2, kernel=False, lanes_=512, chunk=20, episode_limit=25,
                                ring_steps=8, batch_size=8, pf_backend="torch",
                                pf_fixed_iter=10)
    counts = tr.rollout_counts()
    assert counts["captures"]["step"] == 1 and sum(counts["eager"].values()) == 0
