"""PGTrainer: vectorized rollout + update runtime (PyTorch port of
mapdn_tpu/learn/trainer.py).

Every ``behaviour_update_freq`` env steps of all ``n_envs`` lanes (one
chunk), the trainer writes the chunk's transitions to the device-resident
ring, fills the rollout-time critic values with one whole-ring forward,
runs ``value_update_epochs`` value steps and ``policy_update_epochs`` policy
steps on sampled windows, then, for an algorithm with a mixer,
``mixer_update_epochs`` mixer steps on the value loss, and clears the ring
for on-policy algorithms (reference model.py:39-70).  Soft target updates
fire whenever a chunk crosses a ``target_update_freq`` boundary.  Each env
step is one batched power-flow solve, plus one per reset attempt on steps
where lanes terminated.

Each step's transition is written into its ring row as it is produced.
Where a chunk refills the whole ring (``chunk_len >= capacity``, the
vectorized regime) only the newest ``capacity`` steps are kept: the
earlier ones write the first row, which a later step writes again.

Off-policy algorithms keep the ring across chunks and episodes; on-policy
ones clear it after each update.

Episodic mode (``cfg.episodic``, reference model.py:72-96): one chunk is
one whole episode of ``max_steps`` steps, written step by step into the
next slot of an episode pool of ``ceil(replay_buffer_size / n_envs)``
slots (``replay_buffer_size`` and ``batch_size`` count episodes); the
update phase runs on batches of whole single-lane episodes every
``behaviour_update_freq`` episodes and the soft target update every
``target_update_freq`` episodes, both from :meth:`PGTrainer.run_episode`.

Each phase has one implementation, and whether to capture is its only
switch.  Every rollout step goes through ``learn/rollout_graph.py``: on
the card, where nothing asks to see it, it replays a CUDA graph of the
step, one launch for some hundreds of kernels, with the same work, draws
and results; :meth:`PGTrainer._eager_reason` says why it runs
uncaptured instead.  Likewise every update step goes through
``learn/update_graph.py``, one launch an epoch where
:meth:`PGTrainer._update_eager_reason` finds nothing that asks to see
it.  :meth:`PGTrainer.rollout_counts` and :meth:`PGTrainer.update_counts`
tally them.

Randomness comes from the carry's ``torch.Generator`` on the trainer's
device.  ``_train_chunk`` also takes the draws explicitly (the parity tests
replay the JAX package's key splits): ``draws = {"steps": [{"action_noise":
(L, n, act), "env": {...}} per step], "value_lanes": (E_v, lanes),
"value_starts": (E_v,), "value_loss": [the loss's draws per epoch], and the
same three for "policy" and "mixer"}``; in episodic mode
``"value_episodes": [(slots, lanes) per epoch]`` stands in for the lanes
and starts, and ``_episodic_update`` takes the update's part.  Any part
may be missing (a loss's draws are named by its model, e.g. MATD3's
``target_noise``);
``_train_episode`` takes a list of such dicts, one a chunk; and
``_eval_rollout`` takes ``draws = {"reset": {"t0", "noise", "a0"},
"steps": [{"step_noise": ...} per step]}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict

import torch

from mapdn_torch.algos.base import AlgoState, Transition, soft_update
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn import rollout_graph, update_graph
from mapdn_torch.learn.sampling import global_norm, normal_entropy
from mapdn_torch.utils import lanes, profiling
from mapdn_torch.utils.device import resolve_device

_UPDATE_KEYS = {
    "value": ("mean_train_value_loss", "mean_train_value_grad_norm"),
    "policy": ("mean_train_policy_loss", "mean_train_policy_grad_norm",
               "mean_train_entropy"),
    "mixer": ("mean_train_mixer_loss", "mean_train_mixer_grad_norm"),
}


@dataclasses.dataclass
class TrainerCarry:
    env_state: EnvState        # batched env state (n_envs lanes)
    obs: torch.Tensor          # (n_envs, n_agents, obs_dim)
    last_hid: torch.Tensor     # (n_envs, n_agents, hid)
    algo: AlgoState
    replay: rb.ReplayState
    generator: torch.Generator
    steps: int                 # env steps taken (per lane)


def _grads(loss, params):
    """d loss / d params; zeros where the loss reads no parameter (the
    random baseline's zero losses), as ``jax.grad`` gives."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def _mean_stats(stat_list):
    keys = stat_list[0].keys()
    return {k: torch.stack([torch.as_tensor(s[k]) for s in stat_list]).mean()
            for k in keys}


class PGTrainer:
    # why a rollout step runs uncaptured, in the order they are tested
    # (PGTrainer._eager_reason)
    EAGER_REASONS = ("cpu", "draws", "shard", "tracer", "algorithm", "solver", "wrapped")
    # the trainer's own methods a rollout step runs through, uncaptured or
    # in a graph: a wrapper installed on one of them must see every step
    _STEP_METHODS = ("_rollout_step", "_rollout_step_body", "_step_transition")
    # why an update phase's steps run uncaptured (PGTrainer._update_eager_reason)
    UPDATE_EAGER_REASONS = ("cpu", "draws", "shard", "tracer", "algorithm", "wrapped")
    # the trainer's own methods an update step runs through, uncaptured or
    # in a graph: a wrapper installed on one of them must see every epoch
    _UPDATE_METHODS = ("_update_epochs", "_upcast", "_update_step")

    def __init__(self, cfg, model, env, device=None):
        self.device = resolve_device(device if device is not None else model.device)
        if env.device.type != self.device.type or model.device.type != self.device.type:
            raise ValueError("trainer, model and env must share one device")
        self.cfg = cfg
        self.model = model
        self.env = env
        self.n_envs = cfg.n_envs
        self.avail = env.avail_actions
        self.steps = 0
        self.episodes = 0
        if cfg.episodic:
            self._chunk_len = cfg.max_steps
            self._chunks_per_episode = 1
            self._ring_capacity = None
            self._stack_emit = False
        else:
            self._chunk_len = min(cfg.behaviour_update_freq, cfg.max_steps)
            self._chunks_per_episode = max(cfg.max_steps // self._chunk_len, 1)
            self._ring_capacity = max(
                cfg.batch_size, -(-int(cfg.replay_buffer_size) // cfg.n_envs))
            self._stack_emit = self._chunk_len >= self._ring_capacity
        self._graph = None
        self._rollout_counts = {"captures": {"step": 0, "reset": 0},
                                "replays": {"step": 0, "reset": 0},
                                "eager": dict.fromkeys(self.EAGER_REASONS, 0)}
        self._update_graph = None
        self._update_counts = {"captures": dict.fromkeys(_UPDATE_KEYS, 0),
                               "replays": dict.fromkeys(_UPDATE_KEYS, 0),
                               "eager": dict.fromkeys(self.UPDATE_EAGER_REASONS, 0)}

    # ------------------------------------------------------------------ init
    def init_carry(self, seed=0) -> TrainerCarry:
        """Parameters from a CPU generator seeded ``seed``; env resets and
        every later draw from a generator on the trainer's device."""
        algo = self.model.init_state(torch.Generator().manual_seed(seed))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with self._lane_context():
            env_state, obs, _ = self.env.reset(self.n_envs, gen)
        return self.carry_from(env_state, obs, algo, gen)

    def _lane_context(self):
        """The context the env lanes step in: none in one process (a
        sharded trainer's lane shard)."""
        return contextlib.nullcontext()

    def carry_from(self, env_state, obs, algo, generator, last_hid=None):
        """A fresh carry (empty ring or episode pool, step 0) around given
        state."""
        if last_hid is None:
            last_hid = self.model.init_hidden(self.n_envs, obs.dtype)
        example = self._example_transition(obs)
        if self.cfg.episodic:
            # replay_buffer_size counts episodes, and a rollout stores n_envs
            # of them (mapdn_tpu/learn/trainer.py:103-113)
            slots = max(1, -(-int(self.cfg.replay_buffer_size) // self.cfg.n_envs))
            replay = rb.init_episode_replay(slots, example, self.cfg.max_steps)
        else:
            replay = rb.init_replay(self._ring_capacity, example)
        return TrainerCarry(env_state=env_state, obs=obs, last_hid=last_hid,
                            algo=algo, replay=replay, generator=generator,
                            steps=0)

    def _example_transition(self, obs):
        n, a, h = self.model.n, self.model.act_dim, self.model.hid_dim
        h_next = h if self.model.stores_next_hidden else 0
        z = lambda *shape: torch.zeros((self.n_envs,) + shape, dtype=obs.dtype,
                                       device=obs.device)
        # bulk fields (obs pair, GRU states) optionally stored bf16; scalars,
        # actions and log-probs stay at compute precision (the PPO ratio is
        # sensitive to log-prob rounding)
        bdt = torch.bfloat16 if self.cfg.replay_bf16 else obs.dtype
        zb = lambda *shape: torch.zeros((self.n_envs,) + shape, dtype=bdt,
                                        device=obs.device)
        return Transition(
            state=zb(*obs.shape[1:]), action=z(n, a), log_prob_a=z(n, a),
            value=z(n), next_value=z(n), reward=z(n),
            next_state=zb(*obs.shape[1:]), done=z(), last_step=z(),
            last_hid=zb(n, h), hid=zb(n, h_next))

    def _upcast(self, x):
        """bf16-stored replay fields back to the compute dtype (the env's)
        at sample time.  The JAX package upcasts to float32 and flax then
        promotes to the parameters' dtype; bf16 widens exactly, so the
        networks see the same values in the same dtype whenever the
        parameters are at the compute dtype, float64 too."""
        return x.to(self.env.dtype) if x.dtype == torch.bfloat16 else x

    # --------------------------------------------------------------- rollout
    def _rollout_value(self, algo, obs):
        """Per-agent (b, n) value for the ring: the first output of a
        critic that returns a tuple, the mean over samples of a (b, s, n)
        one (mapdn_tpu/learn/trainer.py:150-157)."""
        v = self.model.value(algo.value, obs, None)
        if isinstance(v, tuple):
            v = v[0]
        if v.dim() == 3:
            v = torch.mean(v, dim=1)
        return v

    def _rollout_values_all(self, algo, states):
        """Rollout values of a whole (T, L, n, o) stack in one critic
        forward (parameters are constant across the chunk); only for
        critics that take no actions."""
        if self.model.rollout_value_needs_act:
            raise ValueError(
                f"{type(self.model).__name__} stores rollout values but its critic "
                "needs actions; the ring value fill evaluates act=None critics only")
        t, l = states.shape[0], states.shape[1]
        v = self._rollout_value(algo, states.reshape((t * l,) + tuple(states.shape[2:])))
        return v.reshape(t, l, -1)

    def _rollout_step(self, carry: TrainerCarry, draws=None):
        """One vectorized env step: act, step every lane (auto-reset), and
        emit the transition and the step's stats."""
        with torch.no_grad(), self._lane_context(), profiling.span("train.rollout_step"):
            return self._rollout_step_body(carry, draws or {})

    def _rollout_step_body(self, carry, draws):
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
        trans, next_hid, stats = self._step_transition(carry.obs, carry.last_hid,
                                                       action_pol, log_prob, hid, out)
        carry = dataclasses.replace(carry, env_state=out.state, obs=out.obs,
                                    last_hid=next_hid, steps=carry.steps + 1)
        return carry, trans, stats

    def _step_transition(self, obs, last_hid, action_pol, log_prob, hid, out):
        """The step's transition (``next_state`` is ``out``'s obs), the GRU
        state the next step starts from and the step's stats, from the obs
        and GRU state the policy read, its outputs and the env's step."""
        model = self.model
        value = torch.zeros((self.n_envs, model.n), dtype=obs.dtype, device=obs.device)
        done = out.terminated.to(obs.dtype)
        trans = Transition(
            state=obs, action=action_pol, log_prob_a=log_prob,
            value=value, next_value=torch.zeros_like(value),
            reward=out.reward[:, None].expand(self.n_envs, model.n),
            next_state=out.obs, done=done, last_step=done,
            last_hid=last_hid,
            hid=hid if model.stores_next_hidden else hid[..., :0])
        if self.cfg.replay_bf16:
            b = torch.bfloat16
            trans = trans.replace(state=trans.state.to(b),
                                  next_state=trans.next_state.to(b),
                                  last_hid=trans.last_hid.to(b),
                                  hid=trans.hid.to(b))
        # terminated lanes restart their GRU state (reference model.py:207)
        next_hid = torch.where(out.terminated[:, None, None],
                               torch.zeros_like(hid), hid)
        stats = {"mean_train_reward": out.reward.mean()}
        for k, v in out.info.items():
            stats["mean_train_" + k] = v.mean()
        return trans, next_hid, stats

    def _eager_reason(self, carry, draws):
        """Why a rollout step runs uncaptured (one of ``EAGER_REASONS``), or
        None where it replays the rollout graphs: not on the card; explicit
        draws of the step's own (the parity tests' replayed ones); under a
        lane shard (its gate is an all-reduce); an active tracer (whose
        spans and counters a replay would not see); an algorithm that does
        not declare its rollout capturable (``rollout_capturable``); an env
        whose solver reads the host (``VoltageControlEnv.solver_capturable``:
        the torch-op solver with its early exit); a callable of the step
        that is not the program's own (:func:`rollout_graph.wrapped`)."""
        if not rollout_graph.RolloutGraph.supports(carry.obs.device):
            return "cpu"
        if draws is not None:
            return "draws"
        with self._lane_context():
            if lanes.current() is not None:
                return "shard"
        if profiling.active() is not None:
            return "tracer"
        if not self.model.rollout_capturable:
            return "algorithm"
        if not getattr(self.env, "solver_capturable", False):
            return "solver"
        if rollout_graph.wrapped(self, carry.algo.policy):
            return "wrapped"
        return None

    def rollout_counts(self):
        """The rollout steps so far: graph captures and replays (``step``
        and ``reset``; a capture's step is its warm-up, run uncaptured),
        and under ``eager`` the steps that ran uncaptured by reason
        (``EAGER_REASONS``)."""
        return {k: dict(v) for k, v in self._rollout_counts.items()}

    def _rollout_chunk(self, carry, step_draws):
        """A chunk's rollout steps through the rollout graphs, (re)built
        where they do not bind the carry: a step that :meth:`_eager_reason`
        gives no reason replays them, any other runs :meth:`_rollout_step`
        (with ``step_draws[t]``) and writes its row where the step graph
        would.  Returns (carry, the rollout stats)."""
        graph = self._graph
        if graph is None or not graph.binds(carry):
            self._graph = None   # the old graphs' memory goes first
            graph = self._graph = rollout_graph.RolloutGraph(self, carry)
        graph.begin_chunk(carry)
        for t in range(self._chunk_len):
            reason = self._eager_reason(carry, step_draws[t])
            if reason is None:
                carry = graph.step(carry)
            else:
                self._rollout_counts["eager"][reason] += 1
                profiling.count("train.eager_steps", 1)
                carry, trans, stats = self._rollout_step(carry, step_draws[t])
                with profiling.span("train.ring_write"):
                    graph.write(t, trans, stats)
        return graph.end_chunk(carry)

    # --------------------------------------------------------------- updates
    def _update_epochs(self, algo, replay, generator, *, which, epochs, draws):
        """``epochs`` optimizer steps of ``which`` on freshly sampled
        windows (reference trainer.py:58-71) through the update graphs,
        (re)built where they do not bind the algorithm, the ring or the
        generator: replayed unless :meth:`_update_eager_reason` gives a
        reason, else their code run uncaptured.  ``draws[which + "_lanes" |
        "_starts" | "_episodes" | "_loss"]`` give each epoch's draws where
        present.  Returns the steps' stats averaged."""
        if epochs <= 0:
            return {}
        reason = self._update_eager_reason(algo, which, draws)
        graph = self._update_graph
        if graph is None or not graph.binds(algo, replay, generator):
            self._update_graph = None   # the old graphs' memory goes first
            graph = self._update_graph = update_graph.UpdateGraph(self, algo, replay, generator)
        return graph.run(which, replay, epochs, draws, reason)

    def _update_eager_reason(self, algo, which, draws):
        """Why the update steps of ``which`` run uncaptured (one of
        ``UPDATE_EAGER_REASONS``), or None where they replay the update
        graphs: not on the card; explicit draws of its own (the parity
        tests' replayed ones); under a lane shard (its sums are
        all-reduces); an active tracer (whose spans a replay would not
        see); an algorithm that does not declare its update step capturable
        (``update_capturable``); a callable of the step that is not the
        program's own (one of ``_UPDATE_METHODS``, a method of the model or
        the env replaced on the instance, a module's forward replaced or
        hooked: :func:`rollout_graph.replaced`)."""
        if not update_graph.UpdateGraph.supports(self.device):
            return "cpu"
        if any(draws.get(which + part) is not None
               for part in ("_lanes", "_starts", "_episodes", "_loss")):
            return "draws"
        with self._lane_context():
            if lanes.current() is not None:
                return "shard"
        if profiling.active() is not None:
            return "tracer"
        if not self.model.update_capturable:
            return "algorithm"
        if rollout_graph.replaced(self, self._UPDATE_METHODS, update_graph.modules(algo)):
            return "wrapped"
        return None

    def update_counts(self):
        """The update steps so far: graph captures and replays by ``which``
        (a capture's step is its warm-up, run uncaptured), and under
        ``eager`` the steps that ran uncaptured by reason
        (``UPDATE_EAGER_REASONS``)."""
        return {k: dict(v) for k, v in self._update_counts.items()}

    def _update_step(self, algo, batch, which, shard, generator, loss_draws):
        """One optimizer step of ``which`` on ``batch``; returns its stats.
        Under a lane shard the losses are this rank's shares of the whole
        batch's, and the gradients and stats are summed over the ranks
        before the clip and the step."""
        cfg = self.cfg
        model = self.model
        loss_kw = dict(generator=generator, draws=loss_draws)
        share = (lambda x: x) if shard is None else shard.share
        if which in ("value", "mixer"):
            # the mixer epochs descend the same value loss, with respect
            # to the mixer's parameters (mapdn_tpu/learn/trainer.py:341-353)
            with profiling.span("update.loss"):
                _, loss, _ = model.get_loss(algo, batch, self.avail, policy=False, **loss_kw)
            loss = share(loss)
            params = list(getattr(algo, which).parameters())
            logged = {f"mean_train_{which}_loss": loss.detach()}
        else:
            with profiling.span("update.loss"):
                pl, _, (means, log_stds) = model.get_loss(
                    algo, batch, self.avail, value=False, **loss_kw)
            ent = share(normal_entropy(means, log_stds))
            loss = share(pl)
            if cfg.entr > 0:
                loss = loss - cfg.entr * ent
            params = list(algo.policy.parameters())
            logged = {"mean_train_policy_loss": loss.detach(),
                      "mean_train_entropy": ent.detach()}
        with profiling.span("update.backward"):
            grads = list(_grads(loss, params))
        if shard is not None:
            summed = self._sum_over_ranks(grads + list(logged.values()))
            grads = summed[:len(params)]
            logged = dict(zip(logged, summed[len(params):]))
        with profiling.span("update.optimizer"):
            gn = global_norm(grads)
            getattr(model, which + "_tx").step(params, grads, getattr(algo, which + "_opt"))
        out = {f"mean_train_{which}_loss": logged.pop(f"mean_train_{which}_loss"),
               f"mean_train_{which}_grad_norm": gn}
        out.update(logged)
        return out

    def _rollout_stats(self, stats):
        """The chunk's rollout stats from this process's lane means averaged
        over the chunk's steps (``RolloutGraph.end_chunk``): the same where
        one process holds every lane."""
        return stats

    def _sum_over_ranks(self, tensors):
        """Each tensor summed over the ranks (one process has none)."""
        raise NotImplementedError("only a sharded trainer sums over ranks")

    def _update_phase(self, algo, replay, generator, draws=None):
        with profiling.span("train.update"):
            cfg = self.cfg
            draws = draws or {}
            stats = self._update_epochs(algo, replay, generator, which="value",
                                        epochs=cfg.value_update_epochs, draws=draws)
            stats.update(self._update_epochs(algo, replay, generator, which="policy",
                                             epochs=cfg.policy_update_epochs, draws=draws))
            stats.update(self._update_epochs(algo, replay, generator, which="mixer",
                                             epochs=self._mixer_epochs(), draws=draws))
            return stats

    def _mixer_epochs(self):
        return (self.cfg.mixer_update_epochs or 0) if self.model.uses_mixer else 0

    def _soft_update(self, algo: AlgoState):
        with profiling.span("train.target_update"):
            tau = self.cfg.target_lr
            soft_update(algo.target_policy, algo.policy, tau)
            soft_update(algo.target_value, algo.value, tau)
            if algo.mixer is not None:
                soft_update(algo.target_mixer, algo.mixer, tau)
        profiling.count("train.target_updates", 1)

    # ----------------------------------------------------------- train chunk
    @torch.no_grad()
    def _fill_ring_values(self, carry: TrainerCarry):
        """value[t] = V(state[t]) and next_value[t] = value[t+1] over the
        ring in one critic forward (+ one on the live obs for the newest
        row's bootstrap), in place."""
        with profiling.span("train.value_fill"):
            replay = carry.replay
            data = replay.data
            values = self._rollout_values_all(carry.algo, self._upcast(data.state))
            v_last = self._rollout_value(carry.algo, carry.obs)
            cap = values.shape[0]
            next_values = torch.roll(values, -1, 0)
            next_values[(replay.ptr - 1) % cap] = v_last
            data.value.copy_(values)
            data.next_value.copy_(next_values)

    @torch.no_grad()
    def _fill_episode_values(self, carry: TrainerCarry, slot):
        """value[t] = V(state[t]) over the stored episode in one critic
        forward, next_value[t] = value[t+1] and V of the live obs after the
        last step (mapdn_tpu/learn/trainer.py:436-445), in place."""
        with profiling.span("train.value_fill"):
            values = self._rollout_values_all(carry.algo, self._upcast(slot.state))
            slot.value.copy_(values)
            slot.next_value[:-1].copy_(values[1:])
            slot.next_value[-1].copy_(self._rollout_value(carry.algo, carry.obs))

    def _collect_episode(self, carry: TrainerCarry, step_draws):
        """Episodic mode's chunk: a whole episode, each step written straight
        into the pool's next slot (so no stacked copy of the episode
        exists), then its rollout values; the update runs on the episode
        cadence (``_episodic_update``)."""
        slot = rb.episode_slot(carry.replay)
        carry, stats = self._rollout_chunk(carry, step_draws)
        if self.model.stores_rollout_value:
            self._fill_episode_values(carry, slot)
        carry.replay = rb.add_episode(carry.replay)
        return carry, stats

    def _episodic_update(self, carry: TrainerCarry, draws=None):
        """The update phase on batches of whole episodes, then the
        on-policy clear (mapdn_tpu/learn/trainer.py:375-382); returns
        (carry, stats)."""
        stats = self._update_phase(carry.algo, carry.replay, carry.generator, draws)
        if self.model.on_policy:
            carry.replay = rb.clear(carry.replay)
        return carry, stats

    def _train_chunk(self, carry: TrainerCarry, draws=None):
        """``chunk_len`` rollout steps, the ring write, the value fill, the
        update phase and the on-policy clear; in episodic mode the episode's
        collection alone.  Returns (carry, stats)."""
        with profiling.span("train.chunk"):
            cfg = self.cfg
            draws = draws or {}
            step_draws = draws.get("steps") or [None] * self._chunk_len
            if cfg.episodic:
                return self._collect_episode(carry, step_draws)
            carry, stats = self._rollout_chunk(carry, step_draws)
            if self.model.stores_rollout_value:
                self._fill_ring_values(carry)

            ready = (carry.replay.size >= cfg.batch_size
                     and carry.steps > cfg.replay_warmup)
            if ready:
                stats.update(self._update_phase(carry.algo, carry.replay,
                                                carry.generator, draws))
                if self.model.on_policy:
                    carry.replay = rb.clear(carry.replay)
            else:
                # zero stats under the keys the update phase would give
                epochs = {"value": cfg.value_update_epochs,
                          "policy": cfg.policy_update_epochs, "mixer": self._mixer_epochs()}
                for which, keys in _UPDATE_KEYS.items():
                    for k in (keys if epochs[which] > 0 else ()):
                        stats[k] = torch.zeros((), device=self.device)
            return carry, stats

    def _train_episode(self, carry: TrainerCarry, draws=None):
        """``_chunks_per_episode`` chunks with a soft target update after
        every chunk that crossed a ``target_update_freq`` boundary;
        ``draws``: one ``_train_chunk`` draws dict a chunk."""
        cfg = self.cfg
        draws = draws or [None] * self._chunks_per_episode
        stats = []
        for c in range(self._chunks_per_episode):
            prev = carry.steps
            carry, st = self._train_chunk(carry, draws[c])
            if not cfg.episodic and cfg.target and (
                    carry.steps // cfg.target_update_freq > prev // cfg.target_update_freq):
                self._soft_update(carry.algo)
            stats.append(st)
        return carry, _mean_stats(stats)

    # ------------------------------------------------------------- eval loop
    @torch.no_grad()
    def _eval_rollout(self, algo, generator, draws=None):
        """``num_eval_episodes`` greedy episodes of ``max_steps`` steps, one
        lane each (reference model.py:265-302).

        Each lane's reward and info are summed over its alive steps (the
        terminal step included) and divided by that lane's own length, then
        averaged over lanes (the reference's mean-of-means,
        model.py:293-301); a flat mean over alive samples would over-weight
        long-surviving episodes."""
        cfg = self.cfg
        draws = draws or {}
        step_draws = draws.get("steps") or [None] * cfg.max_steps
        n_eval = cfg.num_eval_episodes
        env_state, obs, _ = self.env.reset(n_eval, generator, draws=draws.get("reset"))
        hid = self.model.init_hidden(n_eval, obs.dtype)
        alive = torch.ones(n_eval, dtype=obs.dtype, device=obs.device)
        n_alive = torch.zeros_like(alive)
        sums = collections.defaultdict(lambda: torch.zeros_like(alive))
        for t in range(cfg.max_steps):
            _, action_pol, _, _, hid = self.model.get_actions(
                algo.policy, obs, hid, status="test", exploration=False,
                avail=self.avail, generator=generator)
            out = self.env.step(env_state, self.env.translate_actions(action_pol),
                                generator, noise=(step_draws[t] or {}).get("step_noise"))
            sums["mean_test_reward"] += out.reward * alive
            for k, v in out.info.items():
                sums["mean_test_" + k] += v * alive
            n_alive += alive
            alive = alive * (1.0 - out.terminated.to(alive.dtype))
            env_state, obs = out.state, out.obs
        ep_len = torch.clamp(n_alive, min=1.0)
        return {k: torch.mean(v / ep_len) for k, v in sums.items()}

    # -------------------------------------------------------------- user API
    def run_episode(self) -> Dict[str, float]:
        """One training 'episode' = max_steps vectorized env steps with the
        reference's update cadence; returns the mean stats.  In episodic
        mode both cadences count episodes (mapdn_tpu/learn/trainer.py:
        598-615), and an update's stats join the episode's."""
        cfg = self.cfg
        self.carry, stats = self._train_episode(self.carry)
        self.steps += self._chunk_len * self._chunks_per_episode
        self.episodes += 1
        if cfg.episodic:
            if self.episodes % cfg.behaviour_update_freq == 0:
                self.carry, upd = self._episodic_update(self.carry)
                stats.update(upd)
            if cfg.target and self.episodes % cfg.target_update_freq == 0:
                self._soft_update(self.carry.algo)
        with profiling.span("host.sync"):
            return {k: float(v) for k, v in stats.items()}

    def evaluate(self) -> Dict[str, float]:
        """Greedy eval episodes drawn from the carry's generator."""
        stats = self._eval_rollout(self.carry.algo, self.carry.generator)
        with profiling.span("host.sync"):
            return {k: float(v) for k, v in stats.items()}

    def setup(self, seed=0):
        self.carry = self.init_carry(seed)
        return self
