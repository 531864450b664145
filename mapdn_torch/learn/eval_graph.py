"""The tester's eval step as CUDA graphs.

A greedy evaluation step (``learn/tester.py``) of one lane, or of one lane
a day or an episode, is a few hundred small kernels: the policy, the
actions' translation, and the env step with its power-flow solve.  On the
card the host takes far longer to launch them than the device takes to run
them.  :class:`EvalGraph` captures the two halves of a step once and
replays them at every later step:

* ``act``: ``model.get_actions(status="test", exploration=False)`` and
  ``env.translate_actions``, from a static obs and GRU state into a static
  actions buffer and the GRU state, in place;
* ``step``: the body of ``VoltageControlEnv.step`` without data noise, from
  the static state and actions into one flat static buffer that holds every
  output (the state, obs, global state, reward and info), and the obs also
  into the ``act`` half's input.

``PGTester._act`` and ``VoltageControlEnv.step`` stay one call each a step,
and a caller may wrap either on its instance: the graphs sit beneath them.
The env's step goes through the graph only while a tester loop has engaged
it (:meth:`EvalGraph.engaged`); the trainer, whose rollout graph captures
``env.step`` in a graph of its own, never engages it.

Each call hands out tensors that later replays leave alone: the actions
cloned, and the step's flat buffer cloned once, its outputs views of the
clone.  Where a call's inputs are the tensors last handed out, the static
buffers still hold them and nothing is copied in; other inputs (a reset's
state, a state handed back unchanged) are copied in first.  The GRU state
stays static: it only feeds back.

Each half runs once uncaptured, as a real step, and is then captured
(:func:`rollout_graph.capture`: a side stream, the graphs' own pool,
cuBLAS's workspaces released); every later call replays it.  A step runs
uncaptured where ``PGTester._eager_reason`` gives a reason, and while a
stream is capturing (a replay inside a capture would nest).  Each field of
the flat buffer starts a multiple of 512 bytes in, aligned as a tensor of
its own is, so that a replay's kernels read their inputs as the uncaptured
step's do and the results agree bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from mapdn_torch.envs.voltage_control import EnvState, StepOutput
from mapdn_torch.learn.rollout_graph import _credit, _tensors, capture, replaced

_STATE = tuple(f.name for f in dataclasses.fields(EnvState))
# the caching allocator's block size
_ALIGN = 512
# the env's method that calls into the step graph from outside it
_ENTRY = ("step",)


def wrapped(tester):
    """Whether a callable inside the graphed halves is not the program's
    own: an env solver other than the one the env built, a method of the
    env (``step`` aside) or of the model replaced on the instance, or a
    policy module whose ``forward`` was replaced or hooked."""
    env = tester.env
    return (env._solver is not env._built_solver
            or replaced(tester, (), [tester.algo.policy], entry=_ENTRY))


def _copy(pairs):
    """Copy each (destination, source) pair whose two are not one tensor."""
    pairs = [(d, s) for d, s in pairs if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _outputs(out):
    """(name, tensor) of every output of a step."""
    return ([("state." + f, getattr(out.state, f)) for f in _STATE]
            + [("obs", out.obs), ("global_state", out.global_state), ("reward", out.reward),
               ("terminated", out.terminated)]
            + [("info." + k, v) for k, v in out.info.items()])


class _Flat:
    """A step's outputs in one byte buffer, laid out from one step's: a
    field every ``_ALIGN`` bytes, an output that is another's tensor (the
    state's ``terminated``) on that one's field."""

    def __init__(self, out):
        self.fields, self.alias, seen, size = {}, {}, {}, 0
        for name, x in _outputs(out):
            if id(x) in seen:
                self.alias[name] = seen[id(x)]
                continue
            seen[id(x)] = name
            stride = torch.empty(x.shape, device="meta").stride()
            self.fields[name] = (x.dtype, x.shape, stride, size // x.element_size())
            size += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
        self.dtypes = {dt for dt, _, _, _ in self.fields.values()}
        self.info = list(out.info)
        self.buf = torch.empty(size, dtype=torch.uint8, device=out.reward.device)
        self.views = self._views(self.buf)

    def _views(self, buf):
        typed = {dt: buf.view(dt) for dt in self.dtypes}
        views = {name: typed[dt].as_strided(shape, stride, offset)
                 for name, (dt, shape, stride, offset) in self.fields.items()}
        views.update({a: views[b] for a, b in self.alias.items()})
        return views

    def store(self, out):
        """Copy ``out`` over the buffer."""
        got = dict(_outputs(out))
        _copy([(self.views[name], got[name]) for name in self.fields])

    def issue(self):
        """The buffer's outputs, on a clone of it."""
        v = self._views(self.buf.clone())
        return StepOutput(state=EnvState(**{f: v["state." + f] for f in _STATE}),
                          obs=v["obs"], global_state=v["global_state"], reward=v["reward"],
                          terminated=v["terminated"],
                          info={k: v["info." + k] for k in self.info})


class EvalGraph:
    """The act and step graphs of one tester at one lane count, bound to its
    env, model, ``avail`` mask, policy module and the module's
    parameters."""

    @staticmethod
    def supports(device):
        return device.type == "cuda"

    def __init__(self, tester, n_lanes):
        env, model = tester.env, tester.model
        self.env, self.model, self.avail = env, model, tester.avail
        self.policy, self.params = tester.algo.policy, _tensors(tester.algo.policy)
        self.counts = tester._step_counts
        # why the current step runs uncaptured (PGTester._eager_reason)
        self.reason = None
        like = dict(dtype=env.dtype, device=env.device)
        self.obs = torch.zeros((n_lanes, env.n_agents, env.obs_size), **like)
        self.hid = model.init_hidden(n_lanes, env.dtype)
        self.actions = torch.zeros((n_lanes, env.grid.n_sgen), **like)
        # the step's outputs and its static state, laid out at its first step
        self.flat = self.state = None
        # the tensors last handed out, whose values the static buffers hold
        self.held_obs = self.held_actions = self.held_state = None
        self.graphs, self.launches = {}, {}
        self.pool = self.stream = None

    def binds(self, tester):
        """Whether these graphs step ``tester``."""
        now = _tensors(tester.algo.policy)
        return (tester.env is self.env and tester.model is self.model
                and tester.avail is self.avail and tester.algo.policy is self.policy
                and len(now) == len(self.params)
                and all(a is b and pa == pb for (a, pa), (b, pb) in zip(now, self.params)))

    @contextlib.contextmanager
    def engaged(self):
        """The env's noiseless steps go through this graph in the block."""
        env = self.env
        held, env._eval_graph = env._eval_graph, self
        try:
            yield self
        finally:
            env._eval_graph = held

    def _uncaptured(self):
        return self.reason is not None or (self.env.device.type == "cuda"
                                           and torch.cuda.is_current_stream_capturing())

    # ------------------------------------------------------------------ act
    @torch.no_grad()
    def act(self, obs, hid):
        """(actions, GRU state) of the greedy policy on ``obs``."""
        if self._uncaptured():
            return self._act_body(obs, hid)
        pairs = [(self.hid, hid)]
        if obs is not self.held_obs:
            pairs.append((self.obs, obs))
            self.held_obs = None
        _copy(pairs)
        self._run("act", self._act_region, self._act_region)
        self.held_actions = self.actions.clone()
        return self.held_actions, self.hid

    def _act_body(self, obs, hid):
        _, action_pol, _, _, hid = self.model.get_actions(
            self.policy, obs, hid, status="test", exploration=False, avail=self.avail)
        return self.env.translate_actions(action_pol), hid

    def _act_region(self):
        actions, hid = self._act_body(self.obs, self.hid)
        _copy([(self.actions, actions), (self.hid, hid)])

    # ----------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, state, actions):
        """The env's noiseless step of ``state`` under ``actions``."""
        if self._uncaptured():
            return self.env._step_body(state, actions, None, False, None)
        if "step" in self.graphs:
            self._load(state, actions)
        self._run("step", self._step_region, lambda: self._lay_out(state, actions))
        out = self.flat.issue()
        self.held_state = (out.state, [getattr(out.state, f) for f in _STATE])
        self.held_obs = out.obs
        return out

    def _load(self, state, actions):
        """Copy into the static buffers the inputs they do not hold."""
        pairs = []
        if actions is not self.held_actions:
            pairs.append((self.actions, torch.as_tensor(actions, device=self.actions.device)))
            self.held_actions = None
        held = self.held_state
        if not (held is not None and state is held[0]
                and all(getattr(state, f) is x for f, x in zip(_STATE, held[1]))):
            pairs += [(getattr(self.state, f), getattr(state, f)) for f in _STATE]
            self.held_state = None
        _copy(pairs)

    def _lay_out(self, state, actions):
        """The first step, uncaptured, laying out the flat buffer from its
        outputs and storing them there."""
        out = self.env._step_body(state, actions, None, False, None)
        self.flat = _Flat(out)
        self.state = EnvState(**{f: self.flat.views["state." + f] for f in _STATE})
        self._store(out)

    def _store(self, out):
        self.flat.store(out)
        _copy([(self.obs, out.obs)])

    def _step_region(self):
        self._store(self.env._step_body(self.state, self.actions, None, False, None))

    # ------------------------------------------------------ capture/replay
    def _run(self, kind, region, warm_up):
        graph = self.graphs.get(kind)
        if graph is None:
            warm_up()   # this step, uncaptured
            self.graphs[kind], self.launches[kind] = self._capture(region)
            self.counts["captures"][kind] += 1
        else:
            graph.replay()
            _credit(*self.launches[kind])
            self.counts["replays"][kind] += 1

    def _capture(self, region):
        """(the graph of ``region``, the kernel launches its capture
        counted)."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.env.device)
        graph, made = capture(region, None, self.pool, self.stream)
        self.pool = graph.pool()
        return graph, made
