"""The program's spans and counters (mapdn_torch.utils.profiling) on the
main path, on the CPU.  A 16-lane case33 MAPPO chunk whose lanes terminate
and reset inside it, in both ring modes (the stacked write of a chunk that
refills the ring, and a write a step), run from one seed with the tracer
off and on: the outputs are bit for bit the same, and the span tree and
the counters match counts taken independently by wrappers installed in
the test.  Also one ``PGTester.run`` day, the off path, and a span's self
time.  Imports no JAX."""
import dataclasses

import pytest
import torch

from mapdn_torch.algos import make_model
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn.tester import PGTester
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils import lanes, profiling
from mapdn_torch.utils.config import load_config

torch.set_num_threads(1)

L, CHUNK, EPISODE = 16, 12, 5
# the spans each span may open in (None: at the top)
PARENTS = {
    "train.chunk": {None}, "train.rollout_step": {"train.chunk"},
    "train.policy": {"train.rollout_step"}, "env.step": {"train.rollout_step", "eval.step"},
    "env.reset": {"train.rollout_step", None}, "pf.solve": {"env.step", "env.reset"},
    "host.sync": {"train.rollout_step", "eval.step", None},
    "train.ring_write": {"train.chunk"}, "train.value_fill": {"train.chunk"},
    "train.update": {"train.chunk"}, "update.sample": {"train.update"},
    "update.loss": {"train.update"}, "update.backward": {"train.update"},
    "update.optimizer": {"train.update"}, "eval.step": {None}, "eval.act": {"eval.step"},
    "update.target": {"update.loss"}, "train.target_update": {None},
    "replay.gather": {"update.sample"},
    "update.critic": {"update.loss", "update.target"}, "update.attend": {"update.critic"},
}


def _build(ring_steps, alg="mappo", max_steps=CHUNK, **over):
    """A set-up trainer (MAPPO by default) on 16 case33 lanes whose
    episodes end after 5 steps; ``ring_steps`` of ring a lane, against
    12-step chunks."""
    env = make_env("case33", EnvConfig(episode_limit=EPISODE), days=2,
                   dtype=torch.float32, device="cpu")
    cfg, _ = load_config(alg, overrides=dict(
        n_envs=L, behaviour_update_freq=CHUNK, batch_size=4,
        replay_buffer_size=L * ring_steps, update_lanes=8, value_update_epochs=2,
        policy_update_epochs=1, replay_bf16=False, hid_size=16, **over))
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"], max_steps=max_steps)
    return PGTrainer(cfg, make_model(alg, cfg, device="cpu"), env).setup(seed=3)


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


class _Counted:
    """Wrappers that count the program's host reads and, apart from them,
    its window starts (drawn on the device, read by nothing), and sum each
    solve's Newton iterations and each step's terminated lanes, on their
    own."""

    def __init__(self, monkeypatch, env):
        self.reads = self.starts = self.solves = self.lane_solves = 0
        self.nr_iters = self.terminated = 0
        any_lane, window_start, solver, step = (lanes.any_lane, rb.window_start,
                                                env._solver, env.step)

        def counted_read(fn):
            def run(*a, **kw):
                self.reads += 1
                return fn(*a, **kw)
            return run

        def counted_start(*a, **kw):
            self.starts += 1
            start = window_start(*a, **kw)
            assert isinstance(start, torch.Tensor) and start.dim() == 0
            return start

        def counted_solver(*a, **kw):
            res = solver(*a, **kw)
            self.solves += 1
            self.lane_solves += res.n_iter.shape[0]
            self.nr_iters += int(res.n_iter.sum())
            return res

        def counted_step(*a, **kw):
            out = step(*a, **kw)
            self.terminated += int(out.terminated.sum())
            return out

        monkeypatch.setattr(lanes, "any_lane", counted_read(any_lane))
        monkeypatch.setattr(rb, "window_start", counted_start)
        monkeypatch.setattr(env, "_solver", counted_solver)
        monkeypatch.setattr(env, "step", counted_step)


def _check_tree(tracer):
    """Every span is named in SPANS, opens inside a span it may open in,
    and lies inside its parent on the host clock."""
    recs = tracer.records()
    assert recs
    for name, parent, t0, t1 in recs:
        assert name in profiling.SPANS
        assert t0 <= t1
        assert (recs[parent][0] if parent >= 0 else None) in PARENTS[name], (name, parent)
        if parent >= 0:
            assert recs[parent][2] <= t0 and t1 <= recs[parent][3]


@pytest.mark.parametrize("ring_steps", [8, 16], ids=["stacked_ring_write", "per_step_ring_write"])
def test_chunk_traced_is_bit_identical_and_counts_match(monkeypatch, ring_steps):
    off = _build(ring_steps)
    carry_off, stats_off = off._train_chunk(off.carry)

    on = _build(ring_steps)
    assert on._stack_emit == (ring_steps <= CHUNK)
    counted = _Counted(monkeypatch, on.env)
    tracer = profiling.Tracer()
    with profiling.tracing(tracer) as active:
        assert active is tracer and profiling.span("train.chunk") is not profiling.span("x")
        carry_on, stats_on = on._train_chunk(on.carry)
    assert profiling.span("train.chunk") is profiling.span("x")   # none active after

    a, b = _tensors(carry_off) + _tensors(stats_off), _tensors(carry_on) + _tensors(stats_on)
    assert len(a) == len(b) > 50
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert (carry_off.replay.ptr, carry_off.replay.size) == (carry_on.replay.ptr,
                                                            carry_on.replay.size)

    _check_tree(tracer)
    out = tracer.summary()
    spans, counters = out["spans"], out["counters"]
    # a chunk alone fires no soft target update (PGTrainer._train_episode
    # does) and runs no tester; the fused policy runs on the card alone
    assert set(counters) == set(profiling.COUNTERS) - {"train.target_updates",
                                                       "eval.eager_steps",
                                                       "update.attend_logits",
                                                       "policy.fused_rows"}
    calls = lambda name: spans.get(name, {"calls": 0})["calls"]
    assert calls("train.chunk") == 1
    assert calls("train.rollout_step") == calls("train.policy") == CHUNK
    assert calls("env.step") == CHUNK
    assert calls("env.reset") >= 1          # the lanes' episodes end inside the chunk
    assert calls("pf.solve") == calls("env.step") + calls("env.reset") == counted.solves
    assert calls("host.sync") == counted.reads
    assert counted.reads >= CHUNK           # each step's auto-reset gate
    assert counted.starts == 3              # each window start, on the device
    assert calls("train.ring_write") == CHUNK   # each step's row, in both modes
    assert calls("train.value_fill") == calls("train.update") == 1
    assert calls("update.sample") == 3
    assert calls("update.loss") == calls("update.backward") == calls("update.optimizer") == 3
    assert counters["pf.lane_solves"] == counted.lane_solves == L * counted.solves
    assert counters["pf.nr_iters"] == counted.nr_iters > counted.lane_solves
    assert counters["env.terminated_lanes"] == counted.terminated >= L
    for s in spans.values():
        assert s["stream_s"] is None and s["stream_self_s"] is None
        assert 0.0 <= s["host_self_s"] <= s["host_s"] + 1e-12


def test_target_and_gather_spans_of_an_off_policy_ring():
    """MADDPG on a 30-step ring a lane (longer than its 4-step windows),
    over a 24-step target_update_freq boundary: each value step's bootstrap
    opens ``update.target`` in ``update.loss``, each epoch's window gather
    ``replay.gather`` in ``update.sample``, the soft update
    ``train.target_update`` at the top and counts ``train.target_updates``;
    an episode run while no tracer is active records nothing."""
    tr = _build(30, alg="maddpg", max_steps=2 * CHUNK, target_update_freq=2 * CHUNK)
    assert tr.carry.replay.capacity == 30 > tr.cfg.batch_size
    tracer = profiling.Tracer()
    with profiling.tracing(tracer):
        tr.run_episode()
    _check_tree(tracer)
    out = tracer.summary()
    spans, counters = out["spans"], out["counters"]
    assert set(counters) == set(profiling.COUNTERS) - {"eval.eager_steps",
                                                       "update.attend_logits",
                                                       "policy.fused_rows"}
    assert spans["train.chunk"]["calls"] == 2
    assert spans["update.target"]["calls"] == 2 * tr.cfg.value_update_epochs
    assert spans["replay.gather"]["calls"] == spans["update.sample"]["calls"] == 2 * 3
    assert spans["train.target_update"]["calls"] == counters["train.target_updates"] == 1

    idle = profiling.Tracer()
    tr.run_episode()
    assert profiling.active() is None
    assert idle.summary() == {"spans": {}, "counters": {}}
    assert tracer.summary()["spans"]["train.chunk"]["calls"] == 2


def test_tester_day_traced(monkeypatch):
    """One ``PGTester.run`` day: an eval.step (and an eval.act) a step, a
    host read a step (the terminated flag) and one for the record."""
    tr = _build(8)
    tester = PGTester(tr.cfg, tr.model, tr.env, tr.carry.algo)
    counted = _Counted(monkeypatch, tr.env)
    tracer = profiling.Tracer()
    with profiling.tracing(tracer):
        rec = tester.run(3, 10, 1)
    steps = len(rec["bus_voltage"]) - 1
    assert steps == EPISODE - 1
    _check_tree(tracer)
    out = tracer.summary()
    spans = out["spans"]
    assert spans["eval.step"]["calls"] == spans["eval.act"]["calls"] == steps
    assert out["counters"]["eval.eager_steps"] == steps == tester.step_counts()["eager"]["cpu"]
    assert spans["env.step"]["calls"] == steps
    assert spans["env.reset"]["calls"] == 1       # manual_reset's attempt, at the top
    assert spans["host.sync"]["calls"] == steps + 1
    assert spans["pf.solve"]["calls"] == counted.solves == steps + 1


def test_off_path_does_nothing():
    """With no tracer active, span hands out one shared no-op context and
    count does not touch its value."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"count read .{name} with no tracer active")

    assert profiling.span("env.step") is profiling.span("pf.solve")
    with profiling.span("env.step") as inside:
        assert inside is None
    profiling.count("pf.nr_iters", Untouchable())


def test_self_time_is_less_the_children():
    """A span's self time is its interval less its children's; a span
    outside any tracing block is not recorded; counters add host numbers
    and device sums."""
    tracer = profiling.Tracer(device="cpu")
    with profiling.tracing(tracer):
        with profiling.span("train.update"):
            for _ in range(3):
                with profiling.span("update.loss"):
                    torch.ones(64, 64).matmul(torch.ones(64, 64))
            profiling.count("pf.lane_solves", 7)
            profiling.count("pf.lane_solves", torch.tensor([True, False, True]))
    with profiling.span("train.chunk"):
        pass
    out = tracer.summary()
    upd, loss = out["spans"]["train.update"], out["spans"]["update.loss"]
    assert set(out["spans"]) == {"train.update", "update.loss"}
    assert loss["calls"] == 3 and loss["host_self_s"] == pytest.approx(loss["host_s"], abs=1e-12)
    assert upd["host_self_s"] == pytest.approx(upd["host_s"] - loss["host_s"], abs=1e-9)
    assert out["counters"] == {"pf.lane_solves": 9}
