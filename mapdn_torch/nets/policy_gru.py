"""The shared deterministic GRU policy, differentiated, as two CUDA kernels.

``MARLModel.policy`` hands a differentiated call of a shared
:class:`~mapdn_torch.nets.agents.RNNAgent` (LayerNorm, ReLU, hidden width
64, one action) whose caller does not read the new hidden state to
:func:`fused_policy`: one ``torch.autograd.Function`` whose forward is the
kernel ``policy_gru_forward`` of ``csrc/policy_gru.cu`` and whose backward
is ``policy_gru_backward``.  They compute what ``module(with_ids(obs),
last_hid)`` computes and the gradients of its parameters, in float32 with
FP32 FMAs, without the agent-id one-hot (its product with fc1 is the
column of fc1's kernel of the row's agent) and without the intermediates
that autograd keeps: the forward writes a float32 stash of LayerNorm's
normalised input and 1/std and of the gates (r, z, n and the hidden
path's n, ``hn``), which the backward reads.  No gradient goes to obs or
the hidden state, which are data.

The backward sums each parameter's gradient per block over the block's
row tiles (tile ``t`` of ``BWD_TILE`` rows to block ``t mod blocks``) and
then over the blocks in order, with no float atomics: a run repeats bit
for bit, and a graph replay equals the uncaptured step.

Beside each kernel is its plain PyTorch version with the same layout and
algorithm (:func:`policy_fwd_plain`, :func:`policy_bwd_plain`), which CPU
tensors take; CUDA tensors launch the kernel or raise.
:func:`fused_reason` says why a call keeps the module's own ops (None
where it engages).
"""
from __future__ import annotations

import ctypes

import torch

from mapdn_torch.nets.agents import RNNAgent
from mapdn_torch.utils import cuda_build, profiling

HIDDEN = 64
MAX_OBS = 128         # two 64-column obs tiles
MAX_AGENTS = 64       # fc1's id columns in shared memory
MAX_AGENTS_WIDE = 44  # the same where obs is wider than 64 (the backward's
                      # second obs tile takes the rest of its shared memory)
BWD_TILE = 64         # rows a backward tile
STASH = 5             # xhat, r, z, nn, hn a row, each (HIDDEN,)
LN_EPS = 1e-6


def _params(module):
    """The module's parameters in its own order (fc1 W, b; LayerNorm scale,
    bias; W_ih, W_hh, b_ih, b_hn; head W, b)."""
    return (module.fc1.weight, module.fc1.bias, module.norm.weight, module.norm.bias,
            module.gru.weight_ih, module.gru.weight_hh, module.gru.bias_ih,
            module.gru.bias_hn, module.head.weight, module.head.bias)


def _on_card(t):
    return t.device.type == "cuda" and t.dtype == torch.float32


def fused_reason(module, obs, last_hid, n_id, need_hid):
    """Why the policy call ``module`` on (b, n, o) ``obs`` and ``last_hid``
    (``n_id`` agent-id columns in fc1) keeps the module's own ops, or None
    where the fused kernels compute it:

    * ``grad``: not differentiated (grad mode off, or no parameter of the
      module requires grad): the rollout, eval, bootstrap targets;
    * ``module``: not a shared deterministic ``RNNAgent`` (per-agent
      parameters, a Gaussian head, an MLP);
    * ``layers``: no LayerNorm, another activation, another hidden width,
      more than one action, obs wider than ``MAX_OBS`` or more agents than
      :func:`max_agents` allows;
    * ``hid``: the caller reads the new hidden state;
    * ``inputs``: obs or the hidden state require grad (the kernels give
      the parameters' gradients alone);
    * ``device``: the parameters or the inputs are not float32 on the card.
    """
    if not torch.is_grad_enabled() or not any(p.requires_grad for p in module.parameters()):
        return "grad"
    if type(module) is not RNNAgent or module.per_agent is not None:
        return "module"
    if (module.norm is None or module.hid_activation != "relu"
            or module.hid_size != HIDDEN or module.head.weight.shape[0] != 1
            or obs.shape[-1] > MAX_OBS or not 0 <= n_id <= max_agents(obs.shape[-1])
            or module.fc1.weight.shape[1] != obs.shape[-1] + n_id
            or (n_id and obs.shape[-2] != n_id)):
        return "layers"
    if need_hid:
        return "hid"
    if obs.requires_grad or last_hid.requires_grad:
        return "inputs"
    if not all(_on_card(t) for t in (obs, last_hid, *module.parameters())):
        return "device"
    return None


def max_agents(o):
    """The most agent-id columns the kernels take at obs width ``o``."""
    return MAX_AGENTS if o <= HIDDEN else MAX_AGENTS_WIDE


# ------------------------------------------------------------ plain versions
def policy_fwd_plain(obs, hid, params, n_id):
    """Plain PyTorch version of the forward kernel on (R, o) ``obs`` and
    (R, 64) ``hid``, row r of agent r mod ``n_id``: means (R,), the stash
    (R, 5, 64) of (xhat, r, z, nn, hn) and LayerNorm's 1/std (R,)."""
    w1, b1, lnw, lnb, wih, whh, bih, bhn, whead, bhead = params
    rows, o = obs.shape
    y1 = obs @ w1[:, :o].T + b1
    if n_id:
        agent = torch.arange(rows, device=obs.device) % n_id
        y1 = y1 + w1[:, o:].T[agent]      # the one-hot's product: a column of fc1
    d = y1 - y1.mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt((d * d).mean(-1) + LN_EPS)
    xhat = d * rstd[:, None]
    s = torch.relu(xhat * lnw + lnb)
    gi = s @ wih.T + bih
    gh = hid @ whh.T
    h = HIDDEN
    r = torch.sigmoid(gi[:, :h] + gh[:, :h])
    z = torch.sigmoid(gi[:, h:2 * h] + gh[:, h:2 * h])
    hn = gh[:, 2 * h:] + bhn
    nn_ = torch.tanh(gi[:, 2 * h:] + r * hn)
    hnew = (1.0 - z) * nn_ + z * hid
    means = hnew @ whead[0] + bhead[0]
    return means, torch.stack([xhat, r, z, nn_, hn], 1), rstd


def policy_bwd_plain(obs, hid, dmeans, stash, rstd, params, n_id, blocks):
    """Plain PyTorch version of the backward kernel: the gradient of every
    parameter (in the order of ``params``) from the forward's ``stash`` and
    ``rstd`` and the means' cotangent (R,), each summed per block over its
    ``BWD_TILE``-row tiles (tile t to block t mod ``blocks``) and then over
    the blocks in order."""
    w1, b1, lnw, lnb, wih, whh, bih, bhn, whead, bhead = params
    rows, o = obs.shape
    xhat, r, z, nn_, hn = stash.unbind(1)
    pre = xhat * lnw + lnb
    s = torch.relu(pre)
    hnew = (1.0 - z) * nn_ + z * hid
    dm = dmeans[:, None]
    dh = dm * whead[0]
    dn = dh * (1.0 - z) * (1.0 - nn_ * nn_)
    drp = dn * hn * r * (1.0 - r)
    dzp = dh * (hid - nn_) * z * (1.0 - z)
    dhn = dn * r
    dgi = torch.cat([drp, dzp, dn], 1)
    dgh = torch.cat([drp, dzp, dhn], 1)
    dy = torch.where(pre > 0, dgi @ wih, torch.zeros_like(pre))
    dx = dy * lnw
    dy1 = rstd[:, None] * (dx - dx.mean(-1, keepdim=True)
                           - xhat * (dx * xhat).mean(-1, keepdim=True))
    agent = torch.arange(rows, device=obs.device) % max(n_id, 1)
    block = (torch.arange(rows, device=obs.device) // BWD_TILE) % blocks
    total = None
    for b in range(blocks):
        i = torch.nonzero(block == b)[:, 0]
        g_w1 = torch.zeros_like(w1)
        g_w1[:, :o] = dy1[i].T @ obs[i]
        if n_id:
            g_w1[:, o:] = torch.zeros_like(g_w1[:, o:]).index_add_(1, agent[i], dy1[i].T)
        part = torch.cat([
            g_w1.reshape(-1), dy1[i].sum(0), (dy[i] * xhat[i]).sum(0), dy[i].sum(0),
            (dgi[i].T @ s[i]).reshape(-1), (dgh[i].T @ hid[i]).reshape(-1),
            dgi[i].sum(0), dhn[i].sum(0), (dm[i] * hnew[i]).sum(0), dm[i].sum(0)])
        total = part if total is None else total + part
    return _split(total, params)


def _split(flat, params):
    out, at = [], 0
    for p in params:
        out.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return out


# ------------------------------------------------------------------- kernels
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "policy_gru_forward": ([_P] * 15 + [_L, _I, _I, _I, _P], _I),
    "policy_gru_backward": ([_P] * 17 + [_L, _I, _I, _I, _P], _I),
    "policy_gru_params": ([_I, _I], _I),
    "policy_gru_config": ([_I, _I, _P], _I),
    "policy_gru_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("policy_gru")
    if not getattr(lib, "_typed", False):
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._typed = True
    return lib


def _check(name, tensors, o, n_id):
    """Contiguous float32 CUDA operands; the hidden states (read 16 bytes at
    a time, the second operand) 16-byte aligned."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous float32 CUDA tensors")
    if tensors[1].data_ptr() % 16:
        raise ValueError(f"{name}: the hidden states must be 16-byte aligned")
    if not (1 <= o <= MAX_OBS and 0 <= n_id <= max_agents(o)):
        raise ValueError(f"{name}: obs width {o} (at most {MAX_OBS}) or {n_id} agents "
                         f"(at most {max_agents(o)} at that width)")


def _blocks(device, rows, tile):
    """One persistent block an SM, no more than the row tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms, -(-rows // tile)))


def _shape_check(name, obs, hid, params, n_id):
    rows, o = obs.shape
    w1, whead = params[0], params[8]
    if (hid.shape != (rows, HIDDEN) or w1.shape != (HIDDEN, o + n_id)
            or params[4].shape != (3 * HIDDEN, HIDDEN) or whead.shape != (1, HIDDEN)):
        raise ValueError(f"{name}: shapes do not match obs {tuple(obs.shape)}, "
                         f"hid {tuple(hid.shape)} and {n_id} agents")
    return rows, o


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"policy_gru {what} launch failed: "
                           + lib.policy_gru_error_string(rc).decode())


def policy_fwd_kernel(obs, hid, params, n_id):
    """One launch of ``policy_gru_forward`` (the function of
    :func:`policy_fwd_plain`); raises if the launch fails."""
    rows, o = _shape_check("policy_fwd_kernel", obs, hid, params, n_id)
    _check("policy_fwd_kernel", (obs, hid, *params), o, n_id)
    means = obs.new_empty(rows)
    stash = obs.new_empty((rows, STASH, HIDDEN))
    rstd = obs.new_empty(rows)
    lib = _lib()
    rc = lib.policy_gru_forward(*(p.data_ptr() for p in params), obs.data_ptr(),
                                hid.data_ptr(), means.data_ptr(), stash.data_ptr(),
                                rstd.data_ptr(), rows, o, n_id,
                                _blocks(obs.device, rows, 128), _stream(obs))
    _raise(lib, rc, "forward")
    policy_fwd.launches += 1
    return means, stash, rstd


def policy_bwd_kernel(obs, hid, dmeans, stash, rstd, params, n_id):
    """One launch of ``policy_gru_backward`` (the function of
    :func:`policy_bwd_plain` over the card's blocks); raises if a launch
    fails."""
    rows, o = _shape_check("policy_bwd_kernel", obs, hid, params, n_id)
    _check("policy_bwd_kernel", (obs, hid, dmeans, stash, rstd, *params), o, n_id)
    if dmeans.shape != (rows,) or stash.shape != (rows, STASH, HIDDEN) or rstd.shape != (rows,):
        raise ValueError("policy_bwd_kernel: dmeans, stash or rstd do not match the rows")
    lib = _lib()
    total = lib.policy_gru_params(o, n_id)
    blocks = _blocks(obs.device, rows, BWD_TILE)
    partial = obs.new_empty((blocks, total))
    grads = obs.new_empty(total)
    rc = lib.policy_gru_backward(*(p.data_ptr() for p in params), obs.data_ptr(),
                                 hid.data_ptr(), dmeans.data_ptr(), stash.data_ptr(),
                                 rstd.data_ptr(), partial.data_ptr(), grads.data_ptr(),
                                 rows, o, n_id, blocks, _stream(obs))
    _raise(lib, rc, "backward")
    policy_bwd.launches += 1
    return _split(grads, params)


def policy_fwd(obs, hid, params, n_id):
    """The forward: the plain version on CPU tensors, the kernel on CUDA
    tensors (or its wrapper raises); other devices raise."""
    if obs.device.type == "cpu":
        return policy_fwd_plain(obs, hid, params, n_id)
    if obs.device.type == "cuda":
        return policy_fwd_kernel(obs, hid, params, n_id)
    raise ValueError(f"policy_fwd: unsupported device {obs.device}")


def policy_bwd(obs, hid, dmeans, stash, rstd, params, n_id, blocks=4):
    """The backward, dispatched as :func:`policy_fwd`; ``blocks`` is the
    plain version's (the kernel takes one block an SM)."""
    if obs.device.type == "cpu":
        return policy_bwd_plain(obs, hid, dmeans, stash, rstd, params, n_id, blocks)
    if obs.device.type == "cuda":
        return policy_bwd_kernel(obs, hid, dmeans, stash, rstd, params, n_id)
    raise ValueError(f"policy_bwd: unsupported device {obs.device}")


policy_fwd.launches = 0
policy_bwd.launches = 0


def kernel_config(o, n_id):
    """The resources of the kernels that obs width ``o`` runs (needs the
    card): dynamic shared bytes, registers a thread and local bytes a
    thread, forward then backward."""
    lib = _lib()
    cfg = (ctypes.c_int * 6)()
    _raise(lib, lib.policy_gru_config(o, n_id, ctypes.addressof(cfg)), "config")
    keys = ("dynamic_smem_bytes", "registers", "local_bytes")
    return {"forward": dict(zip(keys, cfg[:3])), "backward": dict(zip(keys, cfg[3:]))}


class _FusedPolicy(torch.autograd.Function):
    """means = the policy on (R, o) obs and (R, 64) hid; gradients to the
    parameters only."""

    @staticmethod
    def forward(ctx, obs, hid, n_id, *params):
        with profiling.span("policy.fused_fwd"):
            means, stash, rstd = policy_fwd(obs, hid, params, n_id)
        ctx.n_id = n_id
        ctx.save_for_backward(obs, hid, stash, rstd, *params)
        return means

    @staticmethod
    def backward(ctx, dmeans):
        obs, hid, stash, rstd, *params = ctx.saved_tensors
        dmeans = dmeans.contiguous()
        with profiling.span("policy.fused_bwd"):
            grads = policy_bwd(obs, hid, dmeans, stash, rstd, params, ctx.n_id)
        return (None, None, None, *grads)


def fused_policy(module, obs, last_hid, n_id):
    """(b, n, 1) means of ``module`` on (b, n, o) ``obs`` and (b, n, 64)
    ``last_hid`` through :class:`_FusedPolicy` (where :func:`fused_reason`
    is None)."""
    b, n, o = obs.shape
    hid = last_hid.reshape(b * n, HIDDEN).contiguous()
    if hid.data_ptr() % 16:
        hid = hid.clone()
    means = _FusedPolicy.apply(obs.reshape(b * n, o).contiguous(), hid, n_id,
                               *_params(module))
    return means.view(b, n, 1)


def flops(rows, o):
    """FLOPs of one forward and one backward over ``rows`` rows of obs width
    ``o``, as the kernels do them (an FMA is two; the id column's add and
    the elementwise work not counted): fc1, the two gate products and the
    head forward; the stem's cotangent through W_ih and the gradients of
    W_ih, W_hh and fc1 backward."""
    fwd = o * HIDDEN + 2 * HIDDEN * 3 * HIDDEN + HIDDEN
    bwd = 3 * HIDDEN * HIDDEN + 2 * 3 * HIDDEN * HIDDEN + o * HIDDEN
    return 2 * rows * (fwd + bwd)

