"""The fused GRU policy of ``mapdn_torch/nets/policy_gru.py`` on the CPU.

Its plain versions (the forward with its stash, the backward with its
blockwise partial sums) against autograd through ``MARLModel.policy`` at
case33's, case322's and case141's shapes in float64, and at obs widths
128 and 1 (the kernels' widest and narrowest); which calls ``fused_reason``
sends to the kernels; the counters ``policy.fused_rows`` and
``policy.plain_rows``.  The kernels themselves are checked on the card in
tests/test_torch_kernels.py.
"""
import pytest
import torch

from mapdn_torch.algos import make_model
from mapdn_torch.nets import policy_gru
from mapdn_torch.utils import profiling
from mapdn_torch.utils.config import load_config

torch.set_num_threads(1)

# (agents, obs width, lanes): case33, case322 and case141 (distributed mode),
# and the widest and narrowest obs the kernels take
SHAPES = {"case33": (6, 38, 50), "case322": (38, 62, 8), "case141": (22, 66, 12),
          "obs128": (6, 128, 50), "obs1": (6, 1, 50)}


def _model(alg="mappo", n=6, o=38, dtype=torch.float64, seed=0, **over):
    over = dict(dict(hid_size=64), **over)
    cfg, _ = load_config(alg, overrides=over)
    cfg = cfg.replace(agent_num=n, obs_size=o, action_dim=1)
    model = make_model(alg, cfg, device="cpu", param_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    module = model.make_policy_module().reset_parameters(gen)
    with torch.no_grad():   # biases and LayerNorm away from their zero / identity init
        for p in module.parameters():
            if p.dim() == 1:
                p.add_(0.3 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return model, module


def _inputs(lanes, n, o, dtype=torch.float64, seed=1):
    gen = torch.Generator().manual_seed(seed)
    obs = torch.randn((lanes, n, o), generator=gen, dtype=dtype)
    hid = torch.tanh(torch.randn((lanes, n, 64), generator=gen, dtype=dtype))
    dmeans = torch.randn((lanes, n, 1), generator=gen, dtype=dtype)
    return obs, hid, dmeans


@pytest.mark.parametrize("case", sorted(SHAPES) + ["no_ids"])
def test_plain_versions_match_autograd_through_the_policy(case):
    n, o, lanes = SHAPES.get(case, SHAPES["case33"])
    model, module = _model(n=n, o=o, agent_id=case != "no_ids")
    obs, hid, dmeans = _inputs(lanes, n, o)
    params = list(module.parameters())
    means, _, _ = model.policy(module, obs, hid)
    want = torch.autograd.grad(means, params, dmeans)
    rows = lanes * n
    assert rows > 4 * policy_gru.BWD_TILE    # every block of the plain backward has rows
    n_id = model.id_dim()
    with torch.no_grad():
        got_means, stash, rstd = policy_gru.policy_fwd_plain(
            obs.reshape(rows, o), hid.reshape(rows, 64), params, n_id)
        got = policy_gru.policy_bwd_plain(
            obs.reshape(rows, o), hid.reshape(rows, 64), dmeans.reshape(rows), stash, rstd,
            params, n_id, blocks=3)
    torch.testing.assert_close(got_means, means.reshape(rows), rtol=0, atol=1e-12)
    assert [g.shape for g in got] == [p.shape for p in params]
    for name, g, w in zip([k for k, _ in module.named_parameters()], got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


def test_plain_backward_sums_the_same_over_any_blocks():
    n, o, lanes = SHAPES["case33"]
    _, module = _model(n=n, o=o)
    obs, hid, dmeans = _inputs(lanes, n, o)
    rows, params = lanes * n, list(module.parameters())
    with torch.no_grad():
        _, stash, rstd = policy_gru.policy_fwd_plain(
            obs.reshape(rows, o), hid.reshape(rows, 64), params, n)
        args = (obs.reshape(rows, o), hid.reshape(rows, 64), dmeans.reshape(rows), stash, rstd,
                params, n)
        one, five = (policy_gru.policy_bwd_plain(*args, blocks=b) for b in (1, 5))
    for a, b in zip(one, five):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.fixture
def on_card(monkeypatch):
    """Float32 CPU tensors stand for the card's in ``fused_reason``."""
    monkeypatch.setattr(policy_gru, "_on_card", lambda t: t.dtype == torch.float32)


@pytest.mark.parametrize("alg,over,dtype,grad,need_hid,reason", [
    ("mappo", {}, torch.float32, True, False, None),
    ("maddpg", {}, torch.float32, True, False, None),
    ("mappo", {}, torch.float32, False, False, "grad"),
    ("mappo", {"shared_params": False}, torch.float32, True, False, "module"),
    ("maac", {}, torch.float32, True, False, "module"),
    ("mappo", {"hid_activation": "tanh"}, torch.float32, True, False, "layers"),
    ("mappo", {"layernorm": False}, torch.float32, True, False, "layers"),
    ("mappo", {"hid_size": 32}, torch.float32, True, False, "layers"),
    ("mappo", {}, torch.float32, True, True, "hid"),
    ("mappo", {}, torch.float64, True, False, "device"),
])
def test_fused_reason(on_card, alg, over, dtype, grad, need_hid, reason):
    n, o, lanes = 6, 38, 2
    model, module = _model(alg, n, o, dtype=dtype, **over)
    obs, hid, _ = _inputs(lanes, n, o, dtype=dtype)
    hid = hid[..., :module.hid_size]
    with torch.set_grad_enabled(grad):
        assert policy_gru.fused_reason(module, obs, hid, model.id_dim(), need_hid) == reason


@pytest.mark.parametrize("n,o,reason", [
    (22, 66, None), (6, 128, None), (44, 128, None), (64, 64, None), (6, 1, None),
    (6, 129, "layers"), (45, 66, "layers"), (22, 132, "layers")])
def test_fused_reason_by_obs_width(on_card, n, o, reason):
    """One or two 64-column obs tiles: obs up to 128 columns, with up to 64
    agents at 64 or fewer and up to 44 past 64 (case141 at history 2,
    132 columns, keeps the module's ops)."""
    model, module = _model(n=n, o=o, dtype=torch.float32)
    obs, hid, _ = _inputs(2, n, o, dtype=torch.float32)
    assert policy_gru.fused_reason(module, obs, hid, model.id_dim(), False) == reason


def test_fused_reason_wants_float32_on_the_card():
    model, module = _model(n=6, o=38, dtype=torch.float32)
    obs, hid, _ = _inputs(2, 6, 38, dtype=torch.float32)
    assert policy_gru.fused_reason(module, obs, hid, model.id_dim(), False) == "device"
    assert policy_gru.fused_reason(module, obs.requires_grad_(), hid, 6, False) == "inputs"


def _traced_policy(model, module, obs, hid, need_hid=False):
    with profiling.tracing(profiling.Tracer(device="cpu")) as tracer:
        out = model.policy(module, obs, hid, need_hid=need_hid)
    return out, tracer.summary()["counters"]


def test_fused_path_runs_the_function_and_counts_its_rows(monkeypatch):
    """Float64 CPU tensors stand for the card's: the call goes through the
    autograd Function on the plain versions, with the unpatched path's means
    and gradients, and counts its rows as fused."""
    n, o, lanes = SHAPES["case322"]
    model, module = _model(n=n, o=o)
    obs, hid, dmeans = _inputs(lanes, n, o)
    params = list(module.parameters())
    (want, _, _), counts = _traced_policy(model, module, obs, hid)
    assert counts == {"policy.plain_rows": lanes * n}
    want_grads = torch.autograd.grad(want, params, dmeans)
    monkeypatch.setattr(policy_gru, "_on_card", lambda t: t.dtype == torch.float64)
    (got, log_stds, hid_out), counts = _traced_policy(model, module, obs, hid)
    assert counts == {"policy.fused_rows": lanes * n}
    assert hid_out is None and got.shape == (lanes, n, 1) and log_stds.shape == got.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for g, w in zip(torch.autograd.grad(got, params, dmeans), want_grads):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_undifferentiated_calls_count_nothing():
    model, module = _model(n=6, o=38)
    obs, hid, _ = _inputs(2, 6, 38)
    with torch.no_grad():
        (_, _, new_hid), counts = _traced_policy(model, module, obs, hid, need_hid=True)
    assert counts == {} and new_hid.shape == hid.shape
    (_, _, none), counts = _traced_policy(model, module, obs, hid)
    assert none is None and counts == {"policy.plain_rows": 12}
