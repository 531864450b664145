"""MAAC of mapdn_torch against the benchmark's plain float64 reference
(perfbench/reference/maac.py), and the benchmark's MAAC ring cell on the
CPU.

The port's MAAC at float64 with small dims (4 agents, 7 obs features, one
action, width 8) and seeded random weights, on 16 window rows (4 steps of
4 lanes) with given loss noise: the attention critic's Q and regulariser
(one and two heads), both losses and every leaf's gradient, and the
parameters after a value and a policy step of the trainer's update step
and the targets after its soft update, each against the reference.

The cell ``case322_maac.replay256`` through ``perfbench.harness.run`` cut
to a size the CPU holds: case33's feeder in place of case322's (the
feeder is the cell's scale; here the kind, the algorithm's adapter and
its faults are tested), 8 lanes, 8-step chunks, 4-step windows on a
20-step ring a lane, a soft update every 16 steps, a window of one
episode: ``correct`` under the cell's own limits, and not ``correct``
with each of its planted faults.  Imports no JAX.
"""
import copy
import types

import numpy as np
import pytest
import torch

from mapdn_torch.algos import make_model
from mapdn_torch.algos.base import Transition, soft_update
from mapdn_torch.learn.sampling import normal_entropy
from mapdn_torch.learn.trainer import PGTrainer
from mapdn_torch.utils.config import load_config
from perfbench import harness, spec, weights
from perfbench.reference import maac as ref

torch.set_num_threads(1)

N, OBS, HID, T, L, SEED = 4, 7, 8, 4, 4, 5
CELL = "case322_maac.replay256"
F64 = torch.float64


def _alg_cfg(heads=1):
    config = spec.cell(CELL)["config"]
    return {**config["model"], **config["alg"], "attend_heads": heads}


def _model(heads=1):
    """A float64 MAAC with the configuration's settings at the small dims,
    its networks (and targets) loaded with weights drawn from a seed."""
    alg = _alg_cfg(heads)
    cfg, _ = load_config("maac", overrides=dict(alg, hid_size=HID, n_envs=L))
    cfg = cfg.replace(agent_num=N, obs_size=OBS, action_dim=1)
    model = make_model("maac", cfg, device="cpu", param_dtype=F64)
    algo = model.init_state(torch.Generator().manual_seed(SEED))
    dims = {"obs": OBS, "agents": N, "hid": HID, "act": 1}
    w = weights.make(spec.alg("maac").leaves(dims), SEED, torch.device("cpu"))
    w = {net: {k: v.double() for k, v in p.items()} for net, p in w.items()}
    spec.alg("maac").load_weights(algo, w)
    return model, algo, w, alg


def _window():
    """A (T, L, ...) window of random transitions and its loss noise, in
    float64."""
    gen = torch.Generator().manual_seed(SEED)
    r = lambda *s: torch.randn((T, L) + s, generator=gen, dtype=F64)
    done = (torch.rand(T, L, generator=gen) < 0.25).double()
    reward = r().expand(T, L).clone()
    batch = Transition(state=r(N, OBS), action=torch.tanh(r(N, 1)), log_prob_a=r(N, 1),
                       value=torch.zeros(T, L, N, dtype=F64),
                       next_value=torch.zeros(T, L, N, dtype=F64),
                       reward=reward[..., None].expand(T, L, N).clone(), next_state=r(N, OBS),
                       done=done, last_step=done, last_hid=r(N, HID), hid=r(N, HID))
    noise = {k: torch.randn(T * L, N, 1, generator=gen, dtype=F64) for k in ref.NOISE}
    return batch, noise


def _host(batch, noise):
    out = {k: getattr(batch, k) for k in spec.alg("maac").BATCH}
    out.update(noise)
    return out


def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _close(a, b, tol=1e-10):
    assert set(a) == set(b)
    for k in a:
        assert torch.allclose(a[k], b[k], rtol=tol, atol=tol), k


@pytest.mark.parametrize("heads", [1, 2])
def test_attention_critic_and_regulariser_match_the_reference(heads):
    model, algo, w, _ = _model(heads)
    batch, _ = _window()
    flat = lambda x: x.reshape((T * L,) + tuple(x.shape[2:]))
    q, reg = model.value(algo.value, flat(batch.state), flat(batch.action))
    q_ref, reg_ref = ref.critic(w["value"], flat(batch.state), flat(batch.action), heads)
    assert q.shape == (T * L, N) and reg.shape == (N,)
    assert torch.allclose(q, q_ref, rtol=1e-12, atol=1e-12)
    assert torch.allclose(reg, reg_ref.mean(0), rtol=1e-12, atol=1e-15)
    assert float(reg.detach().min()) > 0.0


@pytest.mark.parametrize("which", ["value", "policy"])
def test_losses_and_gradients_match_the_reference(which):
    """Each loss (the policy's with the trainer's entropy term) and every
    leaf's gradient, on the same window and noise."""
    model, algo, w, alg = _model()
    batch, noise = _window()
    avail = torch.ones(N, 1, dtype=F64)
    pl, vl, (means, log_stds) = model.get_loss(algo, batch, avail, policy=which == "policy",
                                               value=which == "value", draws=noise)
    if which == "value":
        loss, net = vl, algo.value
    else:
        loss, net = pl - alg["entr"] * normal_entropy(means, log_stds), algo.policy
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    b = ref.prepared(_host(batch, noise), alg, F64, "cpu")
    targets = {"policy": w["policy"], "value": w["value"]}
    ref_loss, ref_grads = ref.loss_grads(which, w, targets, b, alg)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-12, abs=1e-12)
    _close(dict(zip(names, grads)), ref_grads)
    assert all(float(g.norm()) > 0.0 for g in ref_grads.values())


def test_steps_and_soft_update_match_the_reference():
    """A value step and a policy step through ``PGTrainer._update_step``
    (the entropy term included), then the soft target update, against the
    reference's follow of the same two steps and soft update."""
    model, algo, w, alg = _model()
    batch, noise = _window()
    host = types.SimpleNamespace(cfg=model.cfg, model=model, avail=torch.ones(N, 1, dtype=F64))
    stats = {}
    for which in ("value", "policy"):
        draws = noise if which == "value" else {"policy_noise": noise["policy_noise"]}
        stats[which] = PGTrainer._update_step(host, algo, batch, which, None, None, draws)
    for target, net in ((algo.target_policy, algo.policy), (algo.target_value, algo.value)):
        soft_update(target, net, alg["target_lr"])
    chunk = {"updates": [{"which": "value", "batch": 0}, {"which": "policy", "batch": 0}],
             "soft_update": True}
    out = ref.follow(w, [chunk], [_host(batch, noise)], alg, F64, "cpu")
    for which in ("value", "policy"):
        assert float(stats[which][f"mean_train_{which}_loss"]) == pytest.approx(
            out["losses"][which], rel=1e-12, abs=1e-12)
    for net in ("policy", "value", "target_policy", "target_value"):
        _close(_params(getattr(algo, net)), out["after"][net])
    leaf = "critics.fc.weight"
    moved = float((out["after"]["value"][leaf] - w["value"][leaf]).norm())
    target_moved = float((out["after"]["target_value"][leaf] - w["value"][leaf]).norm())
    assert moved > 1e-5 and target_moved == pytest.approx(0.1 * moved, rel=1e-6)


# ------------------------------------------------------- the cell, on the CPU
def _tiny_cell():
    c = copy.deepcopy(spec.cell(CELL))
    case33 = spec.cell("case33_maddpg.replay512")["config"]
    c["config"] = dict(c["config"], grid=case33["grid"], kernel=case33["kernel"],
                       flags=["case33_3min_final" if f == "case322_3min_final" else f
                              for f in c["config"]["flags"]])
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
        result, _ = harness.run(CELL, 2 ** 31 + 77, 0.0, 0, device="cpu", cell=cell)
    finally:
        if fault_name is not None:
            for p in planted:
                p.__exit__(None, None, None)
    return result


def test_maac_ring_cell_is_correct_on_the_cpu():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    checks = result["checks"]
    assert {"value", "loss", "grad", "change", "target", "logp", "w_loss", "w_change",
            "w_target", "w_hid"} <= set(checks)
    assert np.isfinite([row["value"] for row in checks.values()]).all()


@pytest.mark.parametrize("fault_name", ["unchanged", "half_batch", "behaviour_bootstrap",
                                        "no_entropy", "self_attend"])
def test_maac_ring_cell_faults_fail(fault_name, monkeypatch):
    result = _run(fault_name, monkeypatch)
    assert not result["correct"]
    failed = {k for k, row in result["checks"].items() if row["value"] > row["limit"]}
    # each fault shows in the window's chunk, which the reference follows on
    # the program's own windows and noise
    assert {"w_change", "w_loss"} & failed, failed
