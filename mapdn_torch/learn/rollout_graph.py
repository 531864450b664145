"""The trainer's rollout chunk, its steps as CUDA graphs.

One vectorized rollout step (the policy, the actions' translation, the env
step with its power-flow solve, the transition and the step's stats) is a
few hundred small kernels, and on the card the host takes longer to launch
them than the device takes to run them.  :class:`RolloutGraph` drives
every chunk of the trainer: it captures the step once as a CUDA graph and
replays it on every later step, one launch where there were hundreds.  A
step that may not replay (``PGTrainer._eager_reason``: on the CPU too)
runs the trainer's ``_rollout_step`` uncaptured, and :meth:`RolloutGraph.write`
puts its transition and stats where the step graph would.  The work, the
order of the draws and the results are the same either way, bit for bit.

Two graphs, captured each at the first step that needs it:

* the step: everything up to the auto-reset gate.  It reads the carry from
  the graph's static buffers and writes the new env state, obs and GRU
  state back over them, the transition into its ring row (the step's row
  of a FIFO ring, from a step index held on the device), the step's lane
  means into their column of a stats buffer, and the flag that some lane
  terminated;
* the reset, replayed on the steps whose flag holds (one host read a step,
  as the uncaptured step's gate): one reset attempt of every lane, warm-started
  from the voltages before the step, taken by the terminated lanes, and
  the transition's ``next_state`` patched to the fresh episode's obs.

The carry's ``torch.Generator`` is registered with each graph, so a replay
draws the uncaptured step's numbers at its Philox offsets and moves the
generator on as far.  Each capture follows a warm-up: the same code run
uncaptured, as a real step of the run, so that no step is run twice or
skipped.  The warm-up runs on the current stream and the capture on a
stream of its own (the default stream cannot capture): cuBLAS then makes
the capture stream's workspace inside the capture, in the graphs' pool,
and once it is freed (``_release_workspaces``, in :func:`capture`, which
the update graphs of ``learn/update_graph.py`` share) the pool keeps the
memory for the replays without its counting as allocated.  The kernels' launch
tallies (``nr_solve_small.launches``, ``nr_solve_large.launches``) count a
replay's launches as its capture made them.

A replay calls no Python, so a step replays only where every callable it
runs through is the program's own (:func:`wrapped`) and where nothing else
asks to see it (``PGTrainer._eager_reason``).
"""
from __future__ import annotations

import dataclasses

import torch

from mapdn_torch.algos.base import Transition
from mapdn_torch.envs.voltage_control import EnvState, StepOutput
from mapdn_torch.learn import replay as rb
from mapdn_torch.pf import fused_nr

_STATE = tuple(f.name for f in dataclasses.fields(EnvState))
_TRANSITION = tuple(f.name for f in dataclasses.fields(Transition))
# each stat's row of the stats buffer starts a multiple of 128 elements
# in, aligned as a tensor of its own is, so that its mean adds in the
# order a mean of the steps stacked in a tensor of their own does
_ROW_ALIGN = 128


def _launches():
    return fused_nr.nr_solve_small.launches, fused_nr.nr_solve_large.launches


def _credit(small, large):
    fused_nr.nr_solve_small.launches += small
    fused_nr.nr_solve_large.launches += large


def _release_workspaces():
    """Free cuBLAS's workspaces: the capture stream's, made in a capture,
    goes back to the graphs' pool, which keeps it for the replays; the
    current stream's is made anew at its next product."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def _tensors(module):
    return [(t, t.data_ptr()) for t in list(module.parameters()) + list(module.buffers())]


def replaced(trainer, methods, modules):
    """Whether a callable that a captured region runs through is not the
    program's own: one of the trainer's ``methods`` or any method of the
    env or the model replaced on the instance, or one of ``modules`` (or a
    module inside one) whose ``forward`` was replaced or hooked."""
    if any(name in vars(trainer) for name in methods):
        return True
    for obj in (trainer.env, trainer.model):
        cls = type(obj)
        if any(callable(v) and callable(getattr(cls, k, None)) for k, v in vars(obj).items()):
            return True
    hooks = torch.nn.modules.module
    if hooks._global_forward_hooks or hooks._global_forward_pre_hooks:
        return True
    return any("forward" in vars(m) or m._forward_hooks or m._forward_pre_hooks
               for module in modules for m in module.modules())


def wrapped(trainer, policy):
    """Whether a callable the rollout step runs through is not the
    program's own: one of the trainer's step methods
    (``trainer._STEP_METHODS``) or any method of the env or the model
    replaced on the instance, an env solver other than the one the env
    built, or a policy module whose ``forward`` was replaced or hooked."""
    return (trainer.env._solver is not trainer.env._built_solver
            or replaced(trainer, trainer._STEP_METHODS, [policy]))


def capture(region, generator, pool, stream):
    """The CUDA graph of ``region``, captured on ``stream`` into ``pool``
    (None: a new one) with ``generator`` registered.  cuBLAS's workspaces
    are released before it, so that the capture stream's, made in the
    capture (one for each thread that multiplies: a backward's too), take
    the place of the current stream's in the allocated memory rather than
    adding to its peak, and after it, when the capture stream's go back to
    the pool."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    _release_workspaces()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        region()
    _release_workspaces()
    return graph


class _Buffers:
    """The static buffers of the carry's env state, obs and GRU state."""

    def __init__(self, carry):
        like = lambda x: torch.empty(x.shape, dtype=x.dtype, device=x.device)
        self.state = EnvState(**{f: like(getattr(carry.env_state, f)) for f in _STATE})
        self.obs, self.last_hid = like(carry.obs), like(carry.last_hid)

    def of(self, state, obs, last_hid=None):
        return [getattr(state, f) for f in _STATE] + [obs] + ([] if last_hid is None
                                                              else [last_hid])

    def store(self, state, obs, last_hid=None):
        """Copy a state, obs (and GRU state) over the buffers."""
        pairs = [(d, s) for d, s in zip(self.of(self.state, self.obs, self.last_hid),
                                        self.of(state, obs, last_hid)) if d is not s]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class RolloutGraph:
    """The chunk driver of one trainer's rollout and its step and reset
    graphs, bound to its env and model, the carry's policy module and
    parameters, generator and ring (in the stack-emit mode, where each
    chunk writes every row anew, to a ring of its own that replaces the
    carry's)."""

    @staticmethod
    def supports(device):
        return device.type == "cuda"

    def __init__(self, trainer, carry):
        self.trainer, self.env, self.model = trainer, trainer.env, trainer.model
        self.policy, self.params = carry.algo.policy, _tensors(carry.algo.policy)
        self.generator = carry.generator
        self.device = carry.obs.device
        self.chunk_len = trainer._chunk_len
        self.counts = trainer._rollout_counts
        self.mode = ("episode" if trainer.cfg.episodic
                     else "stack" if trainer._stack_emit else "ring")
        self.buf = _Buffers(carry)
        self.prev_vm = torch.empty_like(self.buf.state.vm)
        self.prev_va = torch.empty_like(self.buf.state.va)
        data = carry.replay.data
        if self.mode == "stack":
            self.ring = data.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=x.device))
        else:
            self.ring = data
        # the ring's rows, an episode pool's (slot, step) pairs flattened
        lead = 2 if self.mode == "episode" else 1
        self.rows = self.ring.map(lambda x: x.flatten(0, lead - 1))
        self.n_rows = self.rows.reward.shape[0]
        i64 = dict(dtype=torch.int64, device=self.device)
        self.t, self.base, self.row = (torch.zeros(1, **i64) for _ in range(3))
        self.flag = torch.zeros((), dtype=torch.bool, device=self.device)
        self.keys = self.stats = None
        self.base_host = self.t_host = 0
        self.graphs, self.launches = {}, {}
        self.pool = self.stream = None

    def binds(self, carry):
        """Whether this graph steps ``carry``."""
        tr, data = self.trainer, carry.replay.data
        now = _tensors(carry.algo.policy)
        return (tr.env is self.env and tr.model is self.model
                and carry.algo.policy is self.policy and carry.generator is self.generator
                and len(now) == len(self.params)
                and all(a is b and pa == pb for (a, pa), (b, pb) in zip(now, self.params))
                and (self.mode == "stack"
                     or all(getattr(data, f) is getattr(self.ring, f) for f in _TRANSITION)))

    # --------------------------------------------------------------- chunk
    def begin_chunk(self, carry):
        """Point the step index at the chunk's first row; in the stack-emit
        mode the carry's ring becomes this graph's."""
        replay = carry.replay
        if self.mode == "stack":
            # only the newest ``capacity`` steps are kept: the earlier ones
            # write the first row, which a later step writes again
            self.base_host = replay.capacity - self.chunk_len
            if replay.data is not self.ring:
                carry.replay = replay.replace(data=self.ring)
        elif self.mode == "ring":
            self.base_host = replay.ptr
        else:
            self.base_host = replay.ptr * self.chunk_len
        self.base.fill_(self.base_host)
        self.t.zero_()
        self.t_host = 0

    def end_chunk(self, carry):
        """(carry, the chunk's stats): each step's lane means averaged, as
        the trainer's ``_rollout_stats`` gives them, and outside episodic
        mode the ring's pointer and fill past the chunk's rows, as a FIFO
        ring's writes of them leave them."""
        n = self.chunk_len
        stats = self.trainer._rollout_stats(
            {k: self.stats[i, :n].mean() for i, k in enumerate(self.keys)})
        replay = carry.replay
        cap = replay.capacity
        if self.mode == "stack":
            carry.replay = rb.ReplayState(data=self.ring, ptr=0, size=cap)
        elif self.mode == "ring":
            carry.replay = replay.replace(ptr=(replay.ptr + n) % cap,
                                          size=min(replay.size + n, cap))
        return carry, stats

    @torch.no_grad()
    def step(self, carry):
        """One rollout step of ``carry``: the step graph, the host's read of
        the auto-reset flag and, where it holds, the reset graph.  Returns
        the carry after it, which holds this graph's buffers."""
        self._check_step(self.t_host)
        b = self.buf
        b.store(carry.env_state, carry.obs, carry.last_hid)
        self._run("step", self._step_region)
        self.t_host += 1
        if bool(self.flag):
            self._run("reset", self._reset_region)
        return dataclasses.replace(carry, env_state=b.state, obs=b.obs, last_hid=b.last_hid,
                                   steps=carry.steps + 1)

    @torch.no_grad()
    def write(self, t, trans, stats):
        """Step ``t``'s transition and stats from an uncaptured step, where
        the step graph would have written them."""
        self._check_step(t)
        self.row.fill_(max(t + self.base_host, 0) % self.n_rows)
        self.t.fill_(t)
        self._write(trans, stats)
        self.t.fill_(t + 1)
        self.t_host = t + 1

    def _check_step(self, t):
        # the step index held on the device picks the step's ring row and
        # stats column: a step past the chunk would write over the next
        # chunk's row and, past the stats buffer, out of bounds (on the card
        # a device-side assert, which ends the process)
        if t >= self.chunk_len:
            raise RuntimeError(f"rollout step {t} of a {self.chunk_len}-step chunk: "
                               "begin_chunk starts the next chunk")

    # ------------------------------------------------------------- regions
    def _step_region(self):
        tr, env, b, gen = self.trainer, self.env, self.buf, self.generator
        _, action_pol, log_prob, _, hid = self.model.get_actions(
            self.policy, b.obs, b.last_hid, status="train", exploration=True,
            avail=tr.avail, generator=gen)
        out = env.step(b.state, env.translate_actions(action_pol), gen)
        trans, next_hid, stats = tr._step_transition(b.obs, b.last_hid, action_pol,
                                                     log_prob, hid, out)
        self.row.copy_(torch.remainder(torch.clamp(self.t + self.base, min=0), self.n_rows))
        self._write(trans, stats)
        self.prev_vm.copy_(b.state.vm)
        self.prev_va.copy_(b.state.va)
        b.store(out.state, out.obs, next_hid)
        self.flag.copy_(out.terminated.any())
        self.t.add_(1)

    def _reset_region(self):
        b = self.buf
        out = StepOutput(state=b.state, obs=b.obs, global_state=None, reward=None,
                         terminated=b.state.terminated, info={})
        _, state, obs = self.env._auto_reset(self.prev_vm, self.prev_va, out, self.generator)
        b.store(state, obs)
        nxt = self.rows.next_state
        nxt.index_copy_(0, self.row, obs.to(nxt.dtype).unsqueeze(0))

    def _write(self, trans, stats):
        for f in _TRANSITION:
            buf = getattr(self.rows, f)
            if buf.numel():
                buf.index_copy_(0, self.row, getattr(trans, f).to(buf.dtype).unsqueeze(0))
        if self.keys is None:
            self.keys = list(stats)
        vals = torch.stack([stats[k] for k in self.keys])
        if self.stats is None:
            width = -(-self.chunk_len // _ROW_ALIGN) * _ROW_ALIGN
            self.stats = vals.new_empty((len(self.keys), width))
        self.stats.index_copy_(1, self.t, vals.unsqueeze(1))

    # ------------------------------------------------------ capture/replay
    def _run(self, kind, region):
        graph = self.graphs.get(kind)
        if graph is None:
            region()   # the warm-up: this step, uncaptured
            self.graphs[kind], self.launches[kind] = self._capture(region)
            self.counts["captures"][kind] += 1
        else:
            graph.replay()
            _credit(*self.launches[kind])
            self.counts["replays"][kind] += 1

    def _capture(self, region):
        """(the graph of ``region``, the kernel launches its capture
        counted, taken back from the tallies to be credited at each
        replay)."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        before = _launches()
        graph = capture(region, self.generator, self.pool, self.stream)
        made = tuple(b - a for a, b in zip(before, _launches()))
        _credit(*(-m for m in made))
        self.pool = graph.pool()
        return graph, made
