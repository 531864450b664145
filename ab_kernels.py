#!/usr/bin/env python
"""Time one of the port's CUDA kernels as built from several source trees,
on the same inputs on one GPU, and hold the trees' outputs to the first
tree's bit for bit.

    python3 ab_kernels.py [--kernel nr_small|nr_large|policy_gru] [--rounds 2] TREE [TREE ...]

Each TREE is a checkout of this repository: ``.`` for this one, and for
another commit a ``git archive`` of it unpacked into a directory that
.gitignore lists (``chip_trees/``).  The inputs are those of chip_smoke.py:
``nr_small`` on 8192 env-like case33 lanes (its ``[kernel]`` phase),
``nr_large`` on 4096 env-like case322 lanes (``[kernel_large]``), made once
from numpy seed 0 by this tree's code; ``policy_gru`` (both kernels, the
forward then the backward) on chip_smoke.py's ``[policy]`` batch named by
``--policy-case`` (case322's 4,980,736 rows by default), drawn in each
child by this tree's ``policy_case`` from seed 0.  Each run is a child process that
imports the tree's own ``mapdn_torch``, builds its kernel from the tree's
csrc/, launches it through the tree's wrapper on the context's
``kernel_tensors`` and times it with chip_smoke.py's timers of this tree,
as chip_smoke.py names them: ``ms`` one call from the host, ``device_ms``
its device time (launches back to back).  The trees run in turns, forward
then backward in each round (A B B A ...).  The last line is one JSON
object: per tree its times and, against the first tree, whether the
outputs (v, err, n_iter) are equal bit for bit on the lanes whose err is
finite in both, and on all lanes (for ``policy_gru``: the means, 1/std,
gradients and the stash's SHA-256; ``ms`` and ``device_ms`` of a forward
and a backward on its stash, and each kernel's device time).  Needs a GPU; fails without one.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

CASES = {"nr_small": ("case33", 8192), "nr_large": ("case322", 4096),
         "policy_gru": ("case322", None)}


def child_policy(args):
    import hashlib
    from chip_smoke import POLICY_CASES, cuda_device_ms, cuda_median_ms, policy_case
    tree = os.path.abspath(args.child)
    sys.path.insert(0, tree)
    from mapdn_torch.nets import policy_gru as pg
    if not pg.__file__.startswith(tree + os.sep):
        raise SystemExit(f"ab_kernels: imported {pg.__file__}, not {tree}'s")
    n, o, rows = POLICY_CASES[args.policy_case]
    module, obs, hid, dmeans = policy_case(n, o, rows, seed=0)
    params = list(module.parameters())
    fwd = lambda: pg.policy_fwd_kernel(obs, hid, params, n)
    means, stash, rstd = fwd()
    bwd = lambda: pg.policy_bwd_kernel(obs, hid, dmeans, stash, rstd, params, n)
    grads = bwd()
    torch.cuda.synchronize()
    digest = hashlib.sha256(stash.cpu().numpy().tobytes()).hexdigest()
    out = {"means": means.cpu(), "rstd": rstd.cpu(), "grads": [g.cpu() for g in grads],
           "stash_sha256": digest}
    kernels = {"forward": cuda_device_ms(fwd)[0], "backward": cuda_device_ms(bwd)[0]}
    del means, grads, bwd
    stash = rstd = None
    step = lambda: pg.policy_bwd_kernel(obs, hid, dmeans, *fwd()[1:], params, n)
    torch.save({"out": out, "ms": cuda_median_ms(step), "device_ms": cuda_device_ms(step)[0],
                "kernels_device_ms": kernels}, args.out)


def compare_policy(a, b):
    same = lambda x, y: bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
    return {"means": same(a["means"], b["means"]), "rstd": same(a["rstd"], b["rstd"]),
            "grads": all(same(x, y) for x, y in zip(a["grads"], b["grads"])),
            "stash": a["stash_sha256"] == b["stash_sha256"]}


def child(args):
    if args.kernel == "policy_gru":
        return child_policy(args)
    # this tree's timers, the other tree's package
    from chip_smoke import cuda_device_ms, cuda_median_ms
    tree = os.path.abspath(args.child)
    sys.path.insert(0, tree)
    from mapdn_torch.grid import make_case
    from mapdn_torch.pf import fused_nr
    if not fused_nr.__file__.startswith(tree + os.sep):
        raise SystemExit(f"ab_kernels: imported {fused_nr.__file__}, not {tree}'s")

    p, q = (t.cuda() for t in torch.load(args.inputs))
    grid, *_ = make_case(CASES[args.kernel][0], dtype=torch.float32, device="cuda")
    ctx = fused_nr.get_ctx_small(grid) if args.kernel == "nr_small" else fused_nr.get_ctx(grid)
    spec, v0 = ctx.pack(p, q, None, None, torch.float32)
    ops = ctx.kernel_tensors(p.device)
    kernel = getattr(fused_nr, f"{args.kernel}_kernel")
    run = lambda: kernel(spec, v0, *ops, tol=1e-7, max_iter=20, inner_iters=3)
    out = [t.cpu() for t in run()]
    torch.save({"out": out, "ms": cuda_median_ms(run),
                "device_ms": cuda_device_ms(run)[0]}, args.out)


def compare(a, b, lane_dim):
    """Bit equality of two kernels' (v, err, n_iter) on the lanes whose err
    is finite in both, and on all lanes; the largest |v| difference there."""
    (av, aerr, ait), (bv, berr, bit) = a, b
    fin = torch.isfinite(aerr) & torch.isfinite(berr)
    same_v = (av.view(torch.int32) == bv.view(torch.int32)).all(1 - lane_dim)
    same = same_v & (aerr.view(torch.int32) == berr.view(torch.int32)) & (ait == bit)
    diff = (av - bv).abs().amax(1 - lane_dim)
    return {"bit_equal_finite_lanes": bool(same[fin].all()),
            "bit_equal_all_lanes": bool(same.all()),
            "lanes_finite": int(fin.sum()), "lanes_differing": int((~same).sum()),
            "max_abs_diff_v_finite_lanes": float(diff[fin].max()) if bool(fin.any()) else 0.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--kernel", choices=sorted(CASES), default="nr_small")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--policy-case", default="case322")
    ap.add_argument("--child")
    ap.add_argument("--inputs")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs a CUDA device")
    if args.child:
        return child(args)
    if not args.trees:
        ap.error("name at least one tree")

    from chip_smoke import env_injections
    from mapdn_torch.grid import make_case
    case, lanes = CASES[args.kernel]
    if args.kernel == "policy_gru":
        case = args.policy_case
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = {t: [] for t in args.trees}
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        if args.kernel != "policy_gru":
            grid, load_p, load_q, pv_max = make_case(case, dtype=torch.float32, device="cpu")
            torch.save(env_injections(grid, pv_max, load_p, load_q, lanes), inputs)
        for rnd in range(args.rounds):
            for tree in args.trees + args.trees[::-1]:
                out = os.path.join(tmp, "out.pt")
                subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                                "--kernel", args.kernel, "--inputs", inputs, "--out", out,
                                "--policy-case", args.policy_case], check=True)
                res = torch.load(out)
                runs[tree].append((res["ms"], res["device_ms"]))
                outs.setdefault(tree, res["out"])
                print(json.dumps({"round": rnd, "tree": tree, "ms": res["ms"],
                                  "device_ms": res["device_ms"],
                                  **({"kernels_device_ms": res["kernels_device_ms"]}
                                     if "kernels_device_ms" in res else {})}), flush=True)
    lane_dim = 1 if args.kernel == "nr_small" else 0
    cmp = ((lambda a, b: compare_policy(a, b)) if args.kernel == "policy_gru"
           else (lambda a, b: compare(a, b, lane_dim)))
    summary = {t: {"vs_first": cmp(outs[t], outs[args.trees[0]]),
                   "ms": [r[0] for r in rs], "device_ms": [r[1] for r in rs],
                   "median_ms": float(np.median([r[0] for r in rs])),
                   "median_device_ms": float(np.median([r[1] for r in rs]))}
               for t, rs in runs.items()}
    print(smi)
    print(json.dumps({"kernel": args.kernel, "case": case, "card": smi, "trees": summary}))


if __name__ == "__main__":
    main()
