"""What the kinds of traffic share of the check against the plain reference
in ``perfbench/reference``: the precisions, the reference's env, the env
step judged on recorded (chunk, step, lane) pairs, the gaps, and the
verdict.  Each kind's docstring (perfbench/kinds/) says what its cells
compare; the algorithm's file (perfbench/algs/) holds its update.

The reference runs in float64.  The control runs the same reference code
in float32 with TF32 matmuls in the program's place; perfbench/control.py
reads it.
"""
from __future__ import annotations

import contextlib
import math

import torch

from perfbench import counting
from perfbench.reference import env as ref_env
from perfbench.reference import grids

REFERENCE = (torch.float64, False)
CONTROL = (torch.float32, True)
PAIR_BLOCK = 256


@contextlib.contextmanager
def precision(tf32):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_env(config, dtype, device, **env_over):
    grid = grids.make_grid(config["grid"])
    data = config["data"]
    series = grids.synthetic_series(grid, days=data["days"], time_delta=data["time_delta"],
                                    seed=data["seed"])
    return ref_env.Env(grid, series, dict(config["env"], **env_over), dtype, device)


def grid_counts(config, inner):
    """(n_bus, Y nonzeros, Richardson steps) of the configuration's grid."""
    grid = grids.make_grid(config["grid"])
    return grid.n_bus, counting.y_nonzeros(grid.g, grid.b), inner


def max_gap(a, b, mask=None):
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def rms_rel(cand, ref):
    """sqrt(sum (cand - ref)^2 / sum ref^2) over lists of tensors."""
    num = sum(float(((c.double() - r.double()) ** 2).sum()) for c, r in zip(cand, ref))
    den = sum(float((r.double() ** 2).sum()) for r in ref)
    return math.sqrt(num / den) if den > 0 else 0.0


def draw_pairs(chunks, n_pairs, rng):
    """(chunk, step, lane) triples of recorded rollout steps, and each
    recorded field stacked over them."""
    steps = [(c, k) for c, ch in enumerate(chunks) for k in range(len(ch["steps"]))]
    n_lanes = len(chunks[0]["steps"][0]["reward"])
    pick = rng.choice(len(steps) * n_lanes, size=min(n_pairs, len(steps) * n_lanes),
                      replace=False)
    triples = [steps[i // n_lanes] + (i % n_lanes,) for i in sorted(pick)]

    def field(*path):
        rows = []
        for c, k, s in triples:
            x = chunks[c]["steps"][k]
            for p in path:
                x = x[p]
            rows.append(x[s])
        return torch.stack(rows)

    pairs = {"chunk": torch.tensor([c for c, _, _ in triples])}
    for side in ("before", "after"):
        pairs[side] = {k: field(side, k) for k in chunks[0]["steps"][0][side]}
    for k in ("obs_after", "means", "hid", "action", "log_prob", "reward", "done"):
        pairs[k] = field(k)
    pairs["obs"], pairs["last_hid"] = field("before", "obs"), field("before", "last_hid")
    return pairs


def env_outputs(envr, pairs):
    """The reference's step (and, for a lane that terminated, the fresh
    episode) on each pair: voltages, observations, rewards, convergence."""
    d = lambda x: x.to(envr.device, envr.dtype)
    b, a = pairs["before"], pairs["after"]
    out = {k: [] for k in ("vm", "obs", "reward", "ok", "vm_reset", "obs_reset", "ok_reset")}
    for i in range(0, len(pairs["chunk"]), PAIR_BLOCK):
        sl = slice(i, i + PAIR_BLOCK)
        pv, lp, lq = d(b["pv_p"][sl]), d(b["load_p"][sl]), d(b["load_q"][sl])
        q = envr.q_command(envr.translate(d(pairs["action"][sl])[..., 0]), pv)
        vm, va, ok, pb, qb = envr.solve(lp, lq, pv, q)
        out["vm"].append(vm)
        out["ok"].append(ok)
        out["reward"].append(envr.reward(vm, q))
        out["obs"].append(envr.obs(pb, qb, d(a["pv_p"][sl]), q, vm, va))
        rpv, rq = d(a["pv_p"][sl]), d(a["sgen_q"][sl])
        vm_r, va_r, ok_r, pb_r, qb_r = envr.solve(d(a["load_p"][sl]), d(a["load_q"][sl]), rpv, rq)
        out["vm_reset"].append(vm_r)
        out["ok_reset"].append(ok_r)
        out["obs_reset"].append(envr.obs(pb_r, qb_r, rpv, rq, vm_r, va_r))
    return {k: torch.cat(v).cpu() for k, v in out.items()}


def env_numbers(cand, env_ref, pairs):
    """The env step's widest gaps: voltages and observations where the
    reference converged (the fresh episode's for a lane that terminated),
    rewards where the step's solve converged."""
    done = pairs["done"] > 0
    ok = env_ref["ok"]
    reset_ok = done & ~pairs["after"]["terminated"] & env_ref["ok_reset"]
    rows = (~done & ok) | reset_ok
    vm_ref = torch.where(done[:, None], env_ref["vm_reset"], env_ref["vm"])
    obs_ref = torch.where(done[:, None, None], env_ref["obs_reset"], env_ref["obs"])
    return {"vm": max_gap(cand["vm"], vm_ref, rows),
            "obs": max_gap(cand["obs"], obs_ref, rows),
            "reward": max_gap(cand["reward"], env_ref["reward"], ok)}


def invariants(envr, pairs, episode_limit):
    """The noise of every pending power in units of its scale (max, and how
    far below 0), and the pairs whose step counters or termination differ
    from the configuration's."""
    a, b = pairs["after"], pairs["before"]
    d = lambda x: x.to(envr.device, envr.dtype)
    z = envr.noise_z(a["t"].to(envr.device), d(a["pv_p"]), d(a["load_p"]), d(a["load_q"])).cpu()
    done = pairs["done"] > 0
    bad = (~done & ((a["t"] != b["t"] + 1) | (a["step"] != b["step"] + 1))) | \
          (~b["terminated"] & (b["step"] + 1 >= episode_limit) & ~done)
    return {"noise_z": float(z.max()), "noise_neg": max(0.0, -float(z.min())),
            "rows": int(bad.sum())}


def judge(numbers, limits):
    """(correct, [(name, reading, limit)]): every number with a limit at or
    under it, and finite."""
    rows = [(k, numbers[k], limits.get(k)) for k in numbers]
    ok = all(math.isfinite(v) and (lim is None or v <= lim) for _, v, lim in rows)
    return ok, rows
