"""MADDPG of mapdn_torch against the benchmark's plain float64 reference
(perfbench/reference/ddpg.py), and the benchmark's off-policy ring cell on
the CPU.

The port's MADDPG, at float64 with case33's dims (6 agents, 38 obs, one
action, a 240-feature critic row) and seeded random weights, on an 8-step
window of 4 lanes: the critic's Q, both losses, every leaf's gradient, the
parameters after a value and a policy step of the trainer's update step,
and the targets after its soft update, each against the reference.

The cell ``case33_maddpg.replay512`` through ``perfbench.harness.run`` at a
tiny size (8 lanes, 8-step chunks, 4-step windows on a 20-step ring a lane,
a soft update every 16 steps; a window of one episode, so that the window's
last chunk, whose ring has wrapped, is the same on every machine):
``correct`` under the cell's own limits, and not ``correct`` with each of
its planted faults.  Imports no JAX.
"""
import copy

import numpy as np
import pytest
import torch

from mapdn_torch.algos import make_model
from mapdn_torch.algos.base import Transition
from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.learn.losses import ddpg_loss
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from perfbench import harness, spec, weights
from perfbench.reference import ddpg, ppo

torch.set_num_threads(1)

T, L, SEED = 8, 4, 11
CELL = "case33_maddpg.replay512"


def _alg_cfg():
    config = spec.cell(CELL)["config"]
    return {**config["model"], **config["alg"]}


def _trainer():
    """A float64 MADDPG trainer on case33 with the configuration's
    algorithm settings, its networks loaded with weights drawn from a seed
    (targets equal to them)."""
    alg = _alg_cfg()
    env = make_env("case33", EnvConfig(), days=2, dtype=torch.float64, device="cpu")
    cfg, _ = load_config("maddpg", overrides=dict(alg, replay_buffer_size=T * L, n_envs=L,
                                                  replay_bf16=False))
    info = env.get_env_info()
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"])
    model = make_model("maddpg", cfg, device="cpu", param_dtype=torch.float64)
    tr = PGTrainer(cfg, model, env).setup(seed=SEED)
    dims = {"obs": env.obs_size, "agents": env.n_agents, "hid": cfg.hid_size,
            "act": env.n_actions}
    drawn = spec.alg("maddpg").leaves(dims)
    w = weights.make(drawn, SEED, torch.device("cpu"))
    w = {net: {k: v.double() for k, v in p.items()} for net, p in w.items()}
    spec.alg("maddpg").load_weights(tr.carry.algo, w)
    return tr, w, alg


def _window(tr):
    """A (T, L, ...) window of random transitions, in float64."""
    gen = torch.Generator().manual_seed(SEED)
    n, o, h = tr.model.n, tr.model.obs_dim, tr.model.hid_dim
    r = lambda *s: torch.randn((T, L) + s, generator=gen, dtype=torch.float64)
    done = (torch.rand(T, L, generator=gen) < 0.25).double()
    reward = r().expand(T, L).clone()
    return Transition(state=r(n, o), action=torch.tanh(r(n, 1)), log_prob_a=r(n, 1),
                      value=torch.zeros(T, L, n, dtype=torch.float64),
                      next_value=torch.zeros(T, L, n, dtype=torch.float64),
                      reward=reward[..., None].expand(T, L, n).clone(), next_state=r(n, o),
                      done=done, last_step=done, last_hid=r(n, h), hid=r(n, h))


def _host(batch):
    return {k: getattr(batch, k) for k in ddpg.FIELDS}


def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _close(a, b, tol=1e-10):
    assert set(a) == set(b)
    for k in a:
        assert torch.allclose(a[k], b[k], rtol=tol, atol=tol), k


def test_critic_losses_and_gradients_match_the_reference():
    tr, w, alg = _trainer()
    algo, batch = tr.carry.algo, _window(tr)
    b = ddpg.prepared(_host(batch), alg, torch.float64, "cpu")
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    q = tr.model.value(algo.value, flat(batch.state), flat(batch.action))
    assert torch.allclose(q, ddpg.q_values(w["value"], b["state"], b["action"]), atol=1e-12)

    targets = {"policy": w["policy"], "value": w["value"]}
    for which, net in (("value", algo.value), ("policy", algo.policy)):
        pl, vl, _ = ddpg_loss(tr.model, algo, batch, tr.avail, policy=which == "policy",
                              value=which == "value")
        loss = vl if which == "value" else pl
        names = [k for k, _ in net.named_parameters()]
        grads = torch.autograd.grad(loss, list(net.parameters()))
        ref_loss, ref_grads = ddpg.loss_grads(which, w, targets, b, alg)
        if which == "policy":
            ref_loss += alg["entr"] * ppo.entropy(alg)   # the trainer adds it
        assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-12, abs=1e-12)
        _close(dict(zip(names, grads)), ref_grads)


def test_steps_and_soft_update_match_the_reference():
    """A value step, a policy step (through ``PGTrainer._update_step``, the
    entropy term included) and the soft target update, against the
    reference's follow of the same two steps and soft update."""
    tr, w, alg = _trainer()
    algo, batch = tr.carry.algo, _window(tr)
    stats = {}
    for which in ("value", "policy"):
        stats[which] = tr._update_step(algo, batch, which, None, tr.carry.generator, None)
    tr._soft_update(algo)
    chunk = {"updates": [{"which": "value", "batch": 0}, {"which": "policy", "batch": 0}],
             "soft_update": True}
    ref = ddpg.follow(w, [chunk], [_host(batch)], alg, torch.float64, "cpu")
    for which in ("value", "policy"):
        assert float(stats[which][f"mean_train_{which}_loss"]) == pytest.approx(
            ref["losses"][which], rel=1e-12, abs=1e-12)
    for net in ("policy", "value", "target_policy", "target_value"):
        _close(_params(getattr(algo, net)), ref["after"][net])
    # the step moved the behaviour networks, and the targets a tenth as far
    moved = float((ref["after"]["value"]["fc1.weight"] - w["value"]["fc1.weight"]).norm())
    target_moved = float((ref["after"]["target_value"]["fc1.weight"]
                          - w["value"]["fc1.weight"]).norm())
    assert moved > 1e-4 and target_moved == pytest.approx(0.1 * moved, rel=1e-6)


# ------------------------------------------------------- the cell, on the CPU
def _tiny_cell():
    c = copy.deepcopy(spec.cell(CELL))
    over = dict(c["traffic"]["overrides"], replay_buffer_size=8 * 20, batch_size=4,
                behaviour_update_freq=8, target_update_freq=16)
    c["traffic"] = dict(c["traffic"], lanes=8, max_steps=16, overrides=over)
    c["check"]["check"] = dict(c["check"]["check"], lanes=4, pairs=64)
    return c


def _run(fault_name=None, monkeypatch=None):
    cell = _tiny_cell()
    if fault_name is not None:
        runner_cls = spec.kind(cell["traffic"]["kind"]).Runner
        setup, planted = runner_cls.setup, []

        def plant(self):
            setup(self)
            planted.append(self.fault(fault_name))
            planted[-1].__enter__()
        monkeypatch.setattr(runner_cls, "setup", plant)
    try:
        result, _ = harness.run(CELL, 2 ** 31 + 123, 0.0, 0, device="cpu", cell=cell)
    finally:
        if fault_name is not None:
            for p in planted:
                p.__exit__(None, None, None)
    return result


def test_ring_cell_is_correct_on_the_cpu():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    checks = result["checks"]
    assert {"value", "target", "w_loss", "w_change", "w_target", "w_hid"} <= set(checks)
    assert np.isfinite([row["value"] for row in checks.values()]).all()


@pytest.mark.parametrize("fault_name", ["behaviour_bootstrap", "unchanged", "half_batch",
                                        "solver"])
def test_ring_cell_faults_fail(fault_name, monkeypatch):
    result = _run(fault_name, monkeypatch)
    assert not result["correct"]
    failed = {k for k, row in result["checks"].items() if row["value"] > row["limit"]}
    if fault_name == "behaviour_bootstrap":
        # the first value step's target is the behaviour critic itself: the
        # fault shows from the second step on, and in the window's chunk
        assert {"change", "w_change", "w_loss"} <= failed, failed
