"""PGTrainer: vectorized rollout + update runtime (PyTorch port of
mapdn_tpu/learn/trainer.py, transition mode).

Every ``behaviour_update_freq`` env steps of all ``n_envs`` lanes (one
chunk), the trainer writes the chunk's transitions to the device-resident
ring, fills the rollout-time critic values with one whole-ring forward,
runs ``value_update_epochs`` value steps and ``policy_update_epochs`` policy
steps on sampled windows, and clears the ring for on-policy algorithms
(reference model.py:39-70).  Soft target updates fire whenever a chunk
crosses a ``target_update_freq`` boundary.  Each env step is one batched
power-flow solve, plus one per reset attempt on steps where lanes
terminated.

Transitions are emitted per step and written to the ring once per chunk
when the chunk refills the whole ring (``chunk_len >= capacity``, the
vectorized regime); only the newest ``capacity`` steps are kept.
Otherwise each step is written into the ring as it is produced.

Randomness comes from the carry's ``torch.Generator`` on the trainer's
device.  ``_train_chunk`` also takes the draws explicitly (the parity tests
replay the JAX package's key splits): ``draws = {"steps": [{"action_noise":
(L, n, act), "env": {...}} per step], "value_lanes": (E_v, lanes),
"policy_lanes": (E_p, lanes)}``, any part of which may be missing.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict

import torch

from mapdn_torch.algos.base import AlgoState, Transition, soft_update
from mapdn_torch.envs.voltage_control import EnvState
from mapdn_torch.learn import replay as rb
from mapdn_torch.learn.sampling import global_norm, normal_entropy
from mapdn_torch.utils.device import resolve_device

_UPDATE_KEYS = {
    "value": ("mean_train_value_loss", "mean_train_value_grad_norm"),
    "policy": ("mean_train_policy_loss", "mean_train_policy_grad_norm",
               "mean_train_entropy"),
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


def _mean_stats(stat_list):
    keys = stat_list[0].keys()
    return {k: torch.stack([torch.as_tensor(s[k]) for s in stat_list]).mean()
            for k in keys}


class PGTrainer:
    def __init__(self, cfg, model, env, device=None):
        if cfg.episodic:
            raise NotImplementedError("episodic mode is not ported yet")
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
        self._chunk_len = min(cfg.behaviour_update_freq, cfg.max_steps)
        self._chunks_per_episode = max(cfg.max_steps // self._chunk_len, 1)
        self._ring_capacity = max(
            cfg.batch_size, -(-int(cfg.replay_buffer_size) // cfg.n_envs))
        self._stack_emit = self._chunk_len >= self._ring_capacity

    # ------------------------------------------------------------------ init
    def init_carry(self, seed=0) -> TrainerCarry:
        """Parameters from a CPU generator seeded ``seed``; env resets and
        every later draw from a generator on the trainer's device."""
        algo = self.model.init_state(torch.Generator().manual_seed(seed))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env_state, obs, _ = self.env.reset(self.n_envs, gen)
        return self.carry_from(env_state, obs, algo, gen)

    def carry_from(self, env_state, obs, algo, generator, last_hid=None):
        """A fresh carry (empty ring, step 0) around given state."""
        if last_hid is None:
            last_hid = self.model.init_hidden(self.n_envs, obs.dtype)
        replay = rb.init_replay(self._ring_capacity, self._example_transition(obs))
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

    @staticmethod
    def _upcast(x):
        """bf16-stored replay fields back to float32 at sample time."""
        return x.float() if x.dtype == torch.bfloat16 else x

    # --------------------------------------------------------------- rollout
    def _rollout_value(self, algo, obs):
        return self.model.value(algo.value, obs, None)

    def _rollout_values_all(self, algo, states):
        """Rollout values of a whole (T, L, n, o) stack in one critic
        forward (parameters are constant across the chunk)."""
        t, l = states.shape[0], states.shape[1]
        v = self._rollout_value(algo, states.reshape((t * l,) + tuple(states.shape[2:])))
        return v.reshape(t, l, -1)

    @torch.no_grad()
    def _rollout_step(self, carry: TrainerCarry, draws=None):
        """One vectorized env step: act, step every lane (auto-reset), and
        emit the transition and the step's stats."""
        draws = draws or {}
        model = self.model
        gen = carry.generator
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
        trans = Transition(
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
        # terminated lanes restart their GRU state (reference model.py:207)
        next_hid = torch.where(out.terminated[:, None, None],
                               torch.zeros_like(hid), hid)
        stats = {"mean_train_reward": out.reward.mean()}
        for k, v in out.info.items():
            stats["mean_train_" + k] = v.mean()
        carry = dataclasses.replace(carry, env_state=out.state, obs=out.obs,
                                    last_hid=next_hid, steps=carry.steps + 1)
        return carry, trans, stats

    # --------------------------------------------------------------- updates
    def _update_epochs(self, algo, replay, generator, *, which, epochs,
                       lane_draws=None):
        """``epochs`` optimizer steps on freshly sampled windows (reference
        trainer.py:58-71).  A ring whose capacity equals batch_size without
        lane subsampling gives the same window every epoch: sampled once."""
        cfg = self.cfg
        model = self.model
        if epochs <= 0:
            return {}
        lanes = cfg.update_lanes
        subsampling = lanes is not None and lanes < self.n_envs
        fixed_window = None
        if replay.capacity == cfg.batch_size and not subsampling:
            fixed_window = rb.sample_window(replay, cfg.batch_size, generator=generator)
        stats = []
        for e in range(epochs):
            lane_idx = None if lane_draws is None else lane_draws[e]
            if fixed_window is not None:
                batch = fixed_window
            else:
                batch = rb.sample_window(replay, cfg.batch_size, lanes,
                                         generator=generator, lane_idx=lane_idx)
            batch = batch.map(self._upcast)
            if which == "value":
                _, vl, _ = model.get_loss(algo, batch, self.avail, policy=False)
                params = list(algo.value.parameters())
                grads = torch.autograd.grad(vl, params)
                gn = global_norm(grads)
                model.value_tx.step(params, grads, algo.value_opt)
                stats.append({"mean_train_value_loss": vl.detach(),
                              "mean_train_value_grad_norm": gn})
            else:
                pl, _, (means, log_stds) = model.get_loss(
                    algo, batch, self.avail, value=False)
                ent = normal_entropy(means, log_stds)
                if cfg.entr > 0:
                    pl = pl - cfg.entr * ent
                params = list(algo.policy.parameters())
                grads = torch.autograd.grad(pl, params)
                gn = global_norm(grads)
                model.policy_tx.step(params, grads, algo.policy_opt)
                stats.append({"mean_train_policy_loss": pl.detach(),
                              "mean_train_policy_grad_norm": gn,
                              "mean_train_entropy": ent.detach()})
        return _mean_stats(stats)

    def _update_phase(self, algo, replay, generator, draws=None):
        cfg = self.cfg
        draws = draws or {}
        stats = self._update_epochs(algo, replay, generator, which="value",
                                    epochs=cfg.value_update_epochs,
                                    lane_draws=draws.get("value_lanes"))
        stats.update(self._update_epochs(algo, replay, generator, which="policy",
                                         epochs=cfg.policy_update_epochs,
                                         lane_draws=draws.get("policy_lanes")))
        return stats

    def _soft_update(self, algo: AlgoState):
        tau = self.cfg.target_lr
        soft_update(algo.target_policy, algo.policy, tau)
        soft_update(algo.target_value, algo.value, tau)

    # ----------------------------------------------------------- train chunk
    @torch.no_grad()
    def _fill_ring_values(self, carry: TrainerCarry):
        """value[t] = V(state[t]) and next_value[t] = value[t+1] over the
        ring in one critic forward (+ one on the live obs for the newest
        row's bootstrap), in place."""
        replay = carry.replay
        data = replay.data
        values = self._rollout_values_all(carry.algo, self._upcast(data.state))
        v_last = self._rollout_value(carry.algo, carry.obs)
        cap = values.shape[0]
        next_values = torch.roll(values, -1, 0)
        next_values[(replay.ptr - 1) % cap] = v_last
        data.value.copy_(values)
        data.next_value.copy_(next_values)

    def _train_chunk(self, carry: TrainerCarry, draws=None):
        """``chunk_len`` rollout steps, the ring write, the value fill, the
        update phase and the on-policy clear; returns (carry, stats)."""
        cfg = self.cfg
        draws = draws or {}
        step_draws = draws.get("steps") or [None] * self._chunk_len
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
        stats = _mean_stats(roll_stats)
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
            for which in ("value", "policy"):
                epochs = getattr(cfg, f"{which}_update_epochs")
                for k in (_UPDATE_KEYS[which] if epochs > 0 else ()):
                    stats[k] = torch.zeros((), device=self.device)
        return carry, stats

    def _train_episode(self, carry: TrainerCarry):
        """``_chunks_per_episode`` chunks with a soft target update after
        every chunk that crossed a ``target_update_freq`` boundary."""
        cfg = self.cfg
        stats = []
        for _ in range(self._chunks_per_episode):
            prev = carry.steps
            carry, st = self._train_chunk(carry)
            if cfg.target and (carry.steps // cfg.target_update_freq
                               > prev // cfg.target_update_freq):
                self._soft_update(carry.algo)
            stats.append(st)
        return carry, _mean_stats(stats)

    # -------------------------------------------------------------- user API
    def run_episode(self) -> Dict[str, float]:
        """One training 'episode' = max_steps vectorized env steps with the
        reference's update cadence; returns the mean stats."""
        self.carry, stats = self._train_episode(self.carry)
        self.steps += self._chunk_len * self._chunks_per_episode
        self.episodes += 1
        return {k: float(v) for k, v in stats.items()}

    def setup(self, seed=0):
        self.carry = self.init_carry(seed)
        return self
