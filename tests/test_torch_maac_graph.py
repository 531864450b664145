"""MAAC's rollout and update steps as CUDA graphs, and its spans.

On the CPU: an update phase whose epochs draw the loss's noise into the
update graphs' static buffers (``learn/update_graph.py::loss_noise``, in
the step's order) bit for bit the same phase with that noise, and the
window starts, handed in as explicit draws (``value_loss``,
``policy_loss``); the span tree of a traced MAAC episode with the
critic's spans, the bootstrap's ``update.target`` and the attention's
logit counter against an independent count.

On a GPU (``cuda``, skipped elsewhere): MAAC at case322 on a ring that
wraps inside a chunk, graphed against uncaptured from one seed, bit for
bit (the carry, every epoch's stats, the window starts and the loss noise
drawn); and through the training CLI's ``build_trainer`` and
``run_episode``, a window in which every rollout and update step replays.
This file imports neither JAX nor mapdn_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_maac_graph.py -q
"""
import pytest
import torch

from mapdn_torch.learn import replay as rb
from mapdn_torch.learn import update_graph
from mapdn_torch.utils import profiling

from test_torch_rollout_graph import _build, _run, _same_runs, _snapshot
from test_torch_tracing import _check_tree

torch.set_num_threads(1)

RING = dict(ring_steps=15, batch_size=4, target_update_freq=24)


class _Logged:
    """Every window start and loss noise the update steps draw, kept as the
    program returns them, while installed."""

    def __init__(self, monkeypatch):
        self.starts, self.noise = [], []
        window_start, loss_noise = rb.window_start, update_graph.loss_noise

        def started(*a, **k):
            self.starts.append(window_start(*a, **k))
            return self.starts[-1]

        def drawn(*a, **k):
            self.noise.append(loss_noise(*a, **k))
            return self.noise[-1]
        monkeypatch.setattr(rb, "window_start", started)
        monkeypatch.setattr(update_graph, "loss_noise", drawn)


def test_noise_from_the_static_buffers_is_the_noise_given_as_draws(monkeypatch):
    """Two trainers from one seed through two chunks; then one more update
    phase each: the first draws its windows and loss noise itself (into the
    static buffers), the second is handed the same numbers as explicit
    draws.  Parameters, optimizer state, stats and generator match bit for
    bit, and the noise buffers hold the last epoch's noise."""
    a, b = _build("maac", **RING), _build("maac", **RING)
    for tr in (a, b):
        _run(tr, 2)
    logged = _Logged(monkeypatch)
    before = a.carry.generator.get_state()
    stats_a = a._update_phase(a.carry.algo, a.carry.replay, a.carry.generator)
    epochs = {"value": a.cfg.value_update_epochs, "policy": a.cfg.policy_update_epochs}
    n_v = epochs["value"]
    assert len(logged.starts) == len(logged.noise) == n_v + epochs["policy"]
    assert [tuple(d) for d in logged.noise] == ([("policy_noise", "next_noise")] * n_v
                                                + [("policy_noise",)] * epochs["policy"])
    shape = (a.cfg.batch_size * a.n_envs, a.model.n, a.model.act_dim)
    assert all(v.shape == shape for d in logged.noise for v in d.values())
    graph = a._update_graph
    for which, last in (("value", logged.noise[n_v - 1]), ("policy", logged.noise[-1])):
        assert graph.noise[which].keys() == last.keys()
        assert all(torch.equal(graph.noise[which][k], last[k]) for k in last)

    draws = {"value_starts": logged.starts[:n_v], "value_loss": logged.noise[:n_v],
             "policy_starts": logged.starts[n_v:], "policy_loss": logged.noise[n_v:]}
    stats_b = b._update_phase(b.carry.algo, b.carry.replay, b.carry.generator, draws)
    # handed every draw, the second drew nothing from its generator
    assert len(logged.starts) == len(logged.noise) == n_v + epochs["policy"]
    assert torch.equal(b.carry.generator.get_state(), before)
    b.carry.generator.set_state(a.carry.generator.get_state())
    assert stats_a.keys() == stats_b.keys()
    assert all(torch.equal(stats_a[k], stats_b[k]) for k in stats_a)
    _same_runs(([], _snapshot(a)), ([], _snapshot(b)))


def test_traced_maac_episode_opens_the_critic_spans_and_counts_logits():
    """Each value step: the behaviour critic and, in ``update.target``, the
    target critic; each policy step: the critic on the policy's actions and
    on the stored ones; each forward's attention in ``update.attend`` and
    its b * heads * n * n logits counted."""
    tr = _build("maac", **RING)
    _run(tr, 1)
    tracer = profiling.Tracer(device="cpu")
    with profiling.tracing(tracer):
        tr.run_episode()
    _check_tree(tracer)
    out = tracer.summary()
    spans, counters = out["spans"], out["counters"]
    cfg, n = tr.cfg, tr.model.n
    v, p = cfg.value_update_epochs, cfg.policy_update_epochs
    forwards = 2 * v + 2 * p
    assert spans["update.target"]["calls"] == v
    assert spans["update.critic"]["calls"] == spans["update.attend"]["calls"] == forwards
    rows = cfg.batch_size * tr.n_envs
    assert counters["update.attend_logits"] == forwards * rows * cfg.attend_heads * n * n


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout and update graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_graphed_maac_case322_matches_uncaptured(cuda, monkeypatch):
    """MAAC at case322 on 16 lanes, a 45-step ring against 20-step chunks
    and 8-step windows (it wraps inside the third chunk), a soft update
    after the second: the run with every step uncaptured (pass-through
    wrappers on ``get_actions`` and ``_update_step``) against the graphed
    one, bit for bit, with the same window starts and loss noise."""
    kw = dict(alg="maac", case="case322", lanes_=16, chunk=20, episode_limit=25, ring_steps=45,
              batch_size=8, target_update_freq=40, value_update_epochs=4,
              policy_update_epochs=1)

    def run(trainer, uncaptured):
        if uncaptured:
            get_actions, step = trainer.model.get_actions, trainer._update_step
            trainer.model.get_actions = lambda *a, **k: get_actions(*a, **k)
            trainer._update_step = lambda *a: step(*a)
        with monkeypatch.context() as m:
            logged = _Logged(m)
            out = _run(trainer, 4)
        torch.cuda.synchronize()
        return out, logged

    want, want_log = run(_build(device="cuda", **kw), True)
    tr = _build(device="cuda", **kw)
    got, got_log = run(tr, False)
    _same_runs(want, got)
    assert [int(s) for s in want_log.starts] == [int(s) for s in got_log.starts]
    assert len(got_log.noise) == len(want_log.noise) == 4 * 5
    for w, g in zip(want_log.noise, got_log.noise):
        assert w.keys() == g.keys() and all(torch.equal(w[k], g[k]) for k in w)
    assert tr.carry.replay.size == 45 and tr.carry.replay.ptr == 4 * 20 - 45
    rc, uc = tr.rollout_counts(), tr.update_counts()
    assert rc["captures"] == {"step": 1, "reset": 1} and sum(rc["eager"].values()) == 0
    assert rc["replays"]["step"] == 4 * 20 - 1
    assert uc["captures"] == {"value": 1, "policy": 1, "mixer": 0}
    assert sum(uc["replays"].values()) == 4 * 5 - 2 and sum(uc["eager"].values()) == 0


@pytest.mark.cuda
def test_maac_case322_window_replays_only_through_the_cli_trainer(cuda):
    """``mapdn_torch.train``'s trainer for the case322 MAAC flags at 32
    lanes: after two episodes (the captures), a window of two episodes
    replays every rollout and update step, none uncaptured."""
    from mapdn_torch import train
    args = train.parse_args(["--alg", "maac", "--mode", "distributed", "--scenario",
                             "case322_3min_final", "--voltage-barrier-type", "bowl",
                             "--n-envs", "32", "--days", "2"])
    _, _, tr = train.build_trainer(args, device=torch.device("cuda"),
                                   config={"replay_buffer_size": 32 * 200})
    tr.run_episode()
    tr.run_episode()
    before = (tr.rollout_counts(), tr.update_counts())
    stats = [tr.run_episode() for _ in range(2)]
    torch.cuda.synchronize()
    after = (tr.rollout_counts(), tr.update_counts())
    delta = [{k: {r: a[k][r] - b[k][r] for r in a[k]} for k in a} for a, b in zip(after, before)]
    chunks = 2 * tr._chunks_per_episode
    assert delta[0]["replays"]["step"] == chunks * tr._chunk_len
    assert sum(delta[0]["eager"].values()) == sum(delta[0]["captures"].values()) == 0
    assert delta[1]["replays"] == {"value": chunks * tr.cfg.value_update_epochs,
                                   "policy": chunks * tr.cfg.policy_update_epochs, "mixer": 0}
    assert sum(delta[1]["eager"].values()) == sum(delta[1]["captures"].values()) == 0
    assert all(torch.isfinite(torch.as_tensor(v)).all() for st in stats for v in st.values())
