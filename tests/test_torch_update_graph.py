"""The trainer's update steps as CUDA graphs (mapdn_torch/learn/update_graph.py).

On the CPU: which update steps run uncaptured and why
(``PGTrainer._update_eager_reason``, tallied by ``PGTrainer.update_counts``
and, under a tracer, by the ``train.eager_updates`` counter); the window
start a 0-d device tensor, the same number the host read gave; the
uncaptured update bit for bit the code path it had before the graphs (its
eager loop and sampling, carried here); and the graph path's own logic
(static draws, the gather from them, the stats columns) bit for bit the
uncaptured update, with each "capture" standing in for a graph whose
replay runs the captured code again, and with host reads trapped in it.

On a GPU (``cuda``, skipped elsewhere): the update phase graphed against
eager from one seed, bit for bit (parameters, optimizer ``nu``, every
epoch's stats): case33 MAPPO on a fixed batch, MAPPO with lane
subsampling and the bf16 ring, MADDPG on a ring longer than its window
that wraps, with the same window starts; and a wrapper on ``_update_step``
that sees every epoch eagerly, after which the graphs resume.  This file
imports neither JAX nor mapdn_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_update_graph.py -q
"""
import types

import pytest
import torch
import torch.distributed as dist

from mapdn_torch.algos.registry import MODEL_REGISTRY
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn import update_graph
from mapdn_torch.learn.trainer import _mean_stats
from mapdn_torch.parallel import ShardedPGTrainer
from mapdn_torch.utils import profiling

from test_torch_rollout_graph import (CHUNK, _build, _Direct, _NoHostReads, _pass_through,
                                      _run, _same_runs, _snapshot)

torch.set_num_threads(1)

# (value, policy) epochs of _build's trainers
EPOCHS = {"value": 2, "policy": 1}


@pytest.fixture
def direct(monkeypatch):
    """The update graphs on the CPU, each capture standing in for a graph."""
    monkeypatch.setattr(update_graph.UpdateGraph, "supports",
                        staticmethod(lambda device: True))
    monkeypatch.setattr(update_graph.UpdateGraph, "_capture",
                        lambda self, region: _Direct(region))


def _no_graph(counts):
    return (counts["captures"] == counts["replays"] == {"value": 0, "policy": 0, "mixer": 0})


# ----------------------------------------------------------------- the rule
def test_only_mappo_and_maddpg_declare_their_update_capturable():
    assert {alg for alg, cls in MODEL_REGISTRY.items() if cls.update_capturable} == {
        "mappo", "maddpg"}


def test_cpu_update_steps_run_eager_and_are_tallied():
    """Tallied by reason, and under a tracer by its counter."""
    tr = _build()
    tr.run_episode()
    tracer = profiling.Tracer(device="cpu")
    with profiling.tracing(tracer):
        tr.run_episode()
    assert tracer.summary()["counters"]["train.eager_updates"] == 3
    counts = tr.update_counts()
    assert counts["eager"] == dict(cpu=2 * 3, draws=0, shard=0, tracer=0, algorithm=0,
                                   wrapped=0)
    assert _no_graph(counts) and tr._update_graph.graphs == {}


@pytest.mark.parametrize("reason", ["draws", "tracer", "algorithm"])
def test_update_eager_reasons_are_tallied(direct, reason):
    tr = _build("iddpg" if reason == "algorithm" else "mappo", ring_steps=8, batch_size=8)
    if reason == "draws":
        # explicit (here empty) loss draws, as the parity tests give them
        draws = {w + "_loss": [{}] * e for w, e in EPOCHS.items()}
        tr.carry, _ = tr._train_chunk(tr.carry, draws)
    elif reason == "tracer":
        tracer = profiling.Tracer(device="cpu")
        with profiling.tracing(tracer):
            tr.carry, _ = tr._train_chunk(tr.carry)
        assert tracer.summary()["counters"]["train.eager_updates"] == 3
    else:
        tr.carry, _ = tr._train_chunk(tr.carry)
    counts = tr.update_counts()
    assert counts["eager"][reason] == 3 == sum(counts["eager"].values())
    assert _no_graph(counts)


def test_shard_update_steps_run_eager(direct, tmp_path):
    """A one-rank process group: the sharded trainer's update steps stay
    eager, and its window starts stay on the device."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        tr = _build(trainer_cls=ShardedPGTrainer, ring_steps=16, batch_size=8)
        starts = []
        window_start = rb.window_start

        def logged(*a, **kw):
            starts.append(window_start(*a, **kw))
            return starts[-1]
        rb.window_start = logged
        try:
            tr.run_episode()
        finally:
            rb.window_start = window_start
    finally:
        dist.destroy_process_group()
    counts = tr.update_counts()
    assert counts["eager"]["shard"] == 3 == sum(counts["eager"].values())
    assert _no_graph(counts)
    assert len(starts) == 3 and all(isinstance(s, torch.Tensor) and s.dim() == 0
                                    for s in starts)


@pytest.mark.parametrize("where", ["trainer._update_step", "trainer._upcast",
                                   "trainer._update_epochs", "model.get_loss",
                                   "model.policy", "value.forward_hook"])
def test_wrapped_update_steps_run_eager_and_the_graphs_resume(direct, where):
    """A wrapper installed between chunks sees every update step of its
    chunk (no replay), and once removed the graphs replay again, without a
    new capture; the three chunks are bit for bit the eager ones."""
    kw = dict(ring_steps=16, batch_size=8)
    with profiling.tracing(profiling.Tracer(device="cpu")):
        want = _run(_build(**kw), 3)

    tr = _build(**kw)
    stats = [tr.run_episode()]
    before = tr.update_counts()
    assert before["captures"] == {"value": 1, "policy": 1, "mixer": 0}
    obj_name, attr = where.split(".")
    if obj_name == "value":
        calls = [0]
        handle = tr.carry.algo.value.register_forward_hook(
            lambda *a: calls.__setitem__(0, calls[0] + 1))
    else:
        obj = {"model": tr.model, "trainer": tr}[obj_name]
        original = getattr(obj, attr)
        wrapper = _pass_through(original)
        setattr(obj, attr, wrapper)
    stats.append(tr.run_episode())
    mid = tr.update_counts()
    assert mid["eager"]["wrapped"] == 3
    assert mid["replays"] == before["replays"]
    if obj_name == "value":
        assert calls[0] >= EPOCHS["value"]
        handle.remove()
    else:
        # _update_epochs runs once a `which`; the rest once an epoch at least
        assert wrapper.calls >= (2 if attr == "_update_epochs" else 3)
        delattr(obj, attr)
    stats.append(tr.run_episode())
    after = tr.update_counts()
    assert after["eager"]["wrapped"] == 3
    assert after["replays"]["value"] == before["replays"]["value"] + EPOCHS["value"]
    assert after["replays"]["policy"] == before["replays"]["policy"] + EPOCHS["policy"]
    assert after["captures"] == before["captures"]
    _same_runs(want, (stats, _snapshot(tr)))


def test_a_new_carry_rebuilds_the_update_graphs(direct):
    tr = _build(ring_steps=16, batch_size=8)
    tr.run_episode()
    first = tr._update_graph
    tr.run_episode()
    assert tr._update_graph is first
    tr.setup(seed=4)   # a new carry: new modules, optimizer state, generator and ring
    tr.run_episode()
    assert tr._update_graph is not first
    assert tr.update_counts()["captures"] == {"value": 2, "policy": 2, "mixer": 0}


# ------------------------------------------------------- the window start
@pytest.mark.parametrize("size", [5, 40])
def test_window_start_is_a_device_tensor_of_the_old_host_int(size):
    """The same number from the same generator state as the host read it
    replaced gave, a new 0-d int64 tensor at every call, no host.sync."""
    example = _build().carry.replay.data.map(lambda x: x[0])
    state = rb.init_replay(40, example).replace(size=size, ptr=size % 40)
    gen = torch.Generator().manual_seed(11)
    old = [int(torch.randint(0, max(size - 4, 0) + 1, (), generator=gen)) for _ in range(6)]
    gen.manual_seed(11)
    tracer = profiling.Tracer(device="cpu")
    with profiling.tracing(tracer):
        new = [rb.window_start(state, 4, gen) for _ in range(6)]
    assert all(isinstance(s, torch.Tensor) and s.dim() == 0 and s.dtype == torch.int64
               and s.device == state.data.reward.device for s in new)
    assert len({id(s) for s in new}) == 6
    assert [int(s) for s in new] == old
    assert "host.sync" not in tracer.summary()["spans"]


# --------------------------------------------- the eager path is unchanged
def _parent_add_many(state, stacked):
    """``replay.add_many`` as it was before the update graphs."""
    cap = state.capacity
    t = stacked.reward.shape[0]
    if t >= cap:
        tail = stacked.map(lambda x, buf: x[t - cap:].to(buf.dtype), state.data)
        return rb.ReplayState(data=tail, ptr=0, size=cap)
    idx = (state.ptr + torch.arange(t)) % cap

    def write(buf, x):
        buf[idx.to(buf.device)] = x.to(buf.dtype)
        return buf
    state.data.map(write, stacked)
    return state.replace(ptr=(state.ptr + t) % cap, size=min(state.size + t, cap))


def _parent_sample_window(state, batch_size, lanes=None, generator=None, lane_idx=None,
                          start=None):
    """``replay.sample_window`` as it was before the update graphs, with
    the host read of its window start."""
    cap = state.capacity
    n_env = state.data.reward.shape[1]
    device = state.data.reward.device
    oldest = 0 if state.size < cap else state.ptr
    subsample = lanes is not None and lanes < n_env
    if subsample and lane_idx is None:
        lane_idx = rb._lane_choice(n_env, lanes, generator, device)
    if cap == batch_size:
        if subsample:
            lane_idx = torch.as_tensor(lane_idx, device=device).long()
            return state.data.map(lambda buf: torch.roll(buf[:, lane_idx], -oldest, 0))
        return state.data.map(lambda buf: torch.roll(buf, -oldest, 0))
    if start is None:
        start = int(torch.randint(0, max(state.size - batch_size, 0) + 1, (),
                                  generator=generator, device=device))
    idx = (oldest + start + torch.arange(batch_size, device=device)) % cap
    window = state.data.map(lambda buf: buf[idx])
    return rb.subsample_lanes(window, lanes, lane_idx=lane_idx) if subsample else window


def _parent_sample_batch(self, replay, generator, which, e, draws):
    """``PGTrainer._sample_batch`` as it was before the update graphs."""
    cfg = self.cfg
    epoch_draws = lambda key: None if draws.get(key) is None else draws[key][e]
    if cfg.episodic:
        return rb.sample_episodes(replay, cfg.batch_size, generator,
                                  draws=epoch_draws(which + "_episodes")), None
    return rb.sample_window(replay, cfg.batch_size, cfg.update_lanes,
                            generator=generator, lane_idx=epoch_draws(which + "_lanes"),
                            start=epoch_draws(which + "_starts")), None


def _parent_update_epochs(self, algo, replay, generator, *, which, epochs, draws):
    """``PGTrainer._update_epochs`` as it was before the update graphs."""
    cfg = self.cfg
    if epochs <= 0:
        return {}
    subsampling = cfg.update_lanes is not None and cfg.update_lanes < cfg.n_envs
    fixed = (not cfg.episodic and replay.capacity == cfg.batch_size and not subsampling)
    sample = lambda e: _parent_sample_batch(self, replay, generator, which, e, draws)
    fixed_batch = sample(0) if fixed else None
    epoch_draws = lambda key, e: None if draws.get(key) is None else draws[key][e]
    stats = []
    for e in range(epochs):
        batch, shard = fixed_batch or sample(e)
        stats.append(self._update_step(algo, batch.map(self._upcast), which, shard, generator,
                                       epoch_draws(which + "_loss", e)))
    return _mean_stats(stats)


@pytest.mark.parametrize("alg,ring_steps,batch_size,lanes_,bf16", [
    ("mappo", 8, 8, None, False), ("mappo", 8, 8, 6, True), ("mappo", 16, 8, None, False),
    ("maddpg", 15, 4, None, False)],
    ids=["fixed_batch", "lane_subsample_bf16", "window", "maddpg_ring_wraps"])
def test_eager_update_is_bit_identical_to_the_code_path_before_graphs(monkeypatch, alg,
                                                                      ring_steps, batch_size,
                                                                      lanes_, bf16):
    kw = dict(ring_steps=ring_steps, batch_size=batch_size, update_lanes=lanes_,
              replay_bf16=bf16)
    old = _build(alg, **kw)
    monkeypatch.setattr(old, "_update_epochs", types.MethodType(_parent_update_epochs, old))
    with monkeypatch.context() as m:
        m.setattr(rb, "add_many", _parent_add_many)
        m.setattr(rb, "sample_window", _parent_sample_window)
        want = _run(old, 3)
    new = _build(alg, **kw)
    _same_runs(want, _run(new, 3))
    assert new.update_counts()["eager"]["cpu"] == 3 * 3


# ------------------------------------------------ the graph path's logic
@pytest.mark.parametrize("alg,ring_steps,batch_size,lanes_,bf16,episodic,shared", [
    ("mappo", 8, 8, None, False, False, True), ("mappo", 8, 8, 6, True, False, True),
    ("mappo", 16, 8, None, False, False, True), ("mappo", 16, 8, 6, False, False, True),
    ("mappo", 2, 2, None, False, True, True), ("mappo", 8, 8, None, False, False, False),
    ("maddpg", 15, 4, None, False, False, True)],
    ids=["fixed_batch", "lane_subsample_bf16", "window", "window_lane_subsample", "episodic",
         "per_agent_params", "maddpg_ring_wraps"])
def test_graph_logic_is_bit_identical_to_eager(direct, monkeypatch, alg, ring_steps,
                                               batch_size, lanes_, bf16, episodic, shared):
    """Three chunks (episodes in episodic mode) with their update steps
    through the graph path's code, run as each graph's replay would run it,
    with no host read inside it: the stats, the carry (parameters,
    optimizer state, ring, generator) and the window starts drawn as the
    eager update's.  MADDPG keeps its 15-step ring across the 12-step
    chunks, so its oldest row moves and the windows wrap at its end, and a
    soft target update follows the second chunk."""
    kw = dict(ring_steps=ring_steps, batch_size=batch_size, update_lanes=lanes_,
              replay_bf16=bf16, episodic=episodic, shared_params=shared)
    if alg == "maddpg":
        kw.update(target_update_freq=2 * CHUNK)

    window_start = rb.window_start

    def logging_starts():
        starts = []

        def logged(*a, **k):
            starts.append(window_start(*a, **k))
            return starts[-1]
        monkeypatch.setattr(rb, "window_start", logged)
        return starts

    ref = _build(alg, **kw)
    with profiling.tracing(profiling.Tracer(device="cpu")):
        want_starts = logging_starts()
        want = _run(ref, 3)
    assert sum(ref.update_counts()["eager"].values()) == ref.update_counts()["eager"]["tracer"]
    trap = _NoHostReads(monkeypatch)
    monkeypatch.setattr(update_graph.UpdateGraph, "_region",
                        trap.around(update_graph.UpdateGraph._region))
    tr = _build(alg, **kw)
    got_starts = logging_starts()
    got = _run(tr, 3)
    _same_runs(want, got)
    assert [int(s) for s in got_starts] == [int(s) for s in want_starts]
    assert len(got_starts) == (0 if episodic or ring_steps == batch_size else 3 * 3)
    counts = tr.update_counts()
    assert counts["captures"] == {"value": 1, "policy": 1, "mixer": 0}
    assert counts["replays"] == {"value": 3 * EPOCHS["value"] - 1,
                                 "policy": 3 * EPOCHS["policy"] - 1, "mixer": 0}
    assert sum(counts["eager"].values()) == 0


def test_the_whole_ring_is_read_in_place(direct):
    """Where the window is the whole ring, the graphs read the ring itself
    (no copy of it), which the rollout's ring write keeps in place (its
    first chunk puts the rollout graph's ring in the carry)."""
    tr = _build(ring_steps=8, batch_size=8)
    tr.run_episode()
    ring = tr.carry.replay.data
    tr.run_episode()
    tr.run_episode()
    assert tr.carry.replay.data is ring and tr._update_graph.ring is ring
    assert rb.sample_window(tr.carry.replay, 8).state is ring.state


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the update graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _epoch_stats(trainer):
    """Every update step's stats, as the trainer's own ``_update_step``
    returns them, recorded by a wrapper on the instance (which keeps the
    update eager)."""
    seen = []
    step = trainer._update_step

    def run(algo, batch, which, shard, generator, loss_draws):
        out = step(algo, batch, which, shard, generator, loss_draws)
        seen.append((which, {k: v.clone() for k, v in out.items()}))
        return out
    trainer._update_step = run
    return seen


def _graphed_update_against_eager(chunks, starts=False, **kw):
    """The same trainer run from one seed with its update phase eager (a
    pass-through wrapper on ``_update_step`` records every epoch's stats)
    and graphed; the rollout replays its graphs on both sides.  Both runs'
    results, the last chunk's every epoch stats, and where ``starts`` the
    window starts drawn, must match bit for bit."""
    def run(trainer):
        logged = []
        if starts:
            window_start = rb.window_start

            def logging(*a, **k):
                logged.append(window_start(*a, **k))
                return logged[-1]
            rb.window_start = logging
        try:
            out = _run(trainer, chunks)
        finally:
            if starts:
                rb.window_start = window_start
        torch.cuda.synchronize()
        return out, [int(s) for s in logged]

    eager = _build(device="cuda", **kw)
    seen = _epoch_stats(eager)
    want, want_starts = run(eager)
    graphed = _build(device="cuda", **kw)
    # an autograd graph on the parameters kept alive from the current
    # stream, as a copy of the state taken with grad enabled keeps one
    held = [p * 1.0 for m in update_graph.modules(graphed.carry.algo) for p in m.parameters()
            if p.requires_grad]
    assert all(h.grad_fn is not None for h in held)
    got, got_starts = run(graphed)
    _same_runs(want, got)
    assert want_starts == got_starts and (len(got_starts) > 0) == starts
    assert eager.carry.generator.get_offset() == graphed.carry.generator.get_offset()
    # the last chunk's epochs: the graphs' stats columns against the wrapper's
    cfg = graphed.cfg
    graph = graphed._update_graph
    last = {w: [s for ww, s in seen if ww == w][-e:]
            for w, e in (("value", cfg.value_update_epochs),
                         ("policy", cfg.policy_update_epochs))}
    for which, epochs in last.items():
        for i, key in enumerate(graph.keys[which]):
            cols = graph.stats[which][i, :len(epochs)]
            want_col = torch.stack([s[key] for s in epochs])
            assert torch.equal(cols, want_col), (which, key)
    ec, gc = eager.update_counts(), graphed.update_counts()
    n = chunks * (cfg.value_update_epochs + cfg.policy_update_epochs)
    assert ec["eager"]["wrapped"] == n and _no_graph(ec)
    assert gc["captures"] == {"value": 1, "policy": 1, "mixer": 0}
    assert sum(gc["replays"].values()) == n - 2 and sum(gc["eager"].values()) == 0
    assert graphed.rollout_counts()["captures"]["step"] == 1
    return graphed


@pytest.mark.cuda
def test_graphed_update_fixed_batch_matches_eager(cuda):
    """train512's cadence at 64 lanes: one 20-step chunk an episode, the
    whole 20-step ring as the batch of every epoch, 4 + 3 epochs."""
    _graphed_update_against_eager(3, lanes_=64, chunk=20, episode_limit=25, ring_steps=20,
                                  batch_size=20, value_update_epochs=4,
                                  policy_update_epochs=3)


@pytest.mark.cuda
def test_graphed_update_lane_subsample_bf16_matches_eager(cuda):
    """train8192's cadence at 512 lanes: 20-step chunks, a 16-step ring,
    5 value + 1 policy epochs on 64 random lanes, the bf16 ring."""
    _graphed_update_against_eager(3, lanes_=512, chunk=20, episode_limit=25, ring_steps=16,
                                  batch_size=16, update_lanes=64, replay_bf16=True,
                                  value_update_epochs=5, policy_update_epochs=1)


@pytest.mark.cuda
def test_graphed_maddpg_update_on_a_wrapping_ring_matches_eager(cuda):
    """MADDPG's 45-step ring against 20-step chunks and 8-step windows:
    the ring wraps inside the third chunk, the oldest row moves, and the
    window starts logged through ``replay.window_start`` are the eager
    path's; a soft target update follows the second chunk."""
    tr = _graphed_update_against_eager(4, starts=True, alg="maddpg", lanes_=512, chunk=20,
                                       episode_limit=25, ring_steps=45, batch_size=8,
                                       target_update_freq=40, value_update_epochs=4,
                                       policy_update_epochs=1)
    assert tr.carry.replay.size == 45 and tr.carry.replay.ptr == 4 * 20 - 45


@pytest.mark.cuda
def test_graphed_episodic_and_per_agent_updates_match_eager(cuda):
    """Episodic mode (batches of whole single-lane episodes drawn from the
    pool) and per-agent parameters, each on a fixed batch otherwise."""
    _graphed_update_against_eager(3, lanes_=64, chunk=20, episode_limit=15, ring_steps=2,
                                  batch_size=16, episodic=True, value_update_epochs=3,
                                  policy_update_epochs=2)
    _graphed_update_against_eager(2, lanes_=64, chunk=20, episode_limit=25, ring_steps=20,
                                  batch_size=20, shared_params=False)


@pytest.mark.cuda
def test_update_step_wrapper_runs_eager_on_the_card(cuda):
    """A wrapper on ``_update_step`` installed between chunks sees every
    epoch of its chunk with the call it always saw, no graph replays, and
    once removed the graphs replay again without a new capture."""
    kw = dict(lanes_=64, chunk=20, episode_limit=25, ring_steps=20, batch_size=20)
    eager = _build(device="cuda", **kw)
    _epoch_stats(eager)
    want = _run(eager, 3)
    tr = _build(device="cuda", **kw)
    stats = [tr.run_episode()]
    before = tr.update_counts()
    calls = []
    step = tr._update_step

    def wrapper(algo, batch, which, shard, generator, loss_draws):
        calls.append((which, shard, loss_draws))
        return step(algo, batch, which, shard, generator, loss_draws)
    tr._update_step = wrapper
    stats.append(tr.run_episode())
    mid = tr.update_counts()
    epochs = tr.cfg.value_update_epochs + tr.cfg.policy_update_epochs
    assert calls == ([("value", None, None)] * tr.cfg.value_update_epochs
                     + [("policy", None, None)] * tr.cfg.policy_update_epochs)
    assert mid["replays"] == before["replays"] and mid["eager"]["wrapped"] == epochs
    del tr._update_step
    stats.append(tr.run_episode())
    after = tr.update_counts()
    assert sum(after["replays"].values()) == sum(before["replays"].values()) + epochs
    assert after["captures"] == before["captures"]
    torch.cuda.synchronize()
    _same_runs(want, (stats, _snapshot(tr)))
