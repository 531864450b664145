#!/usr/bin/env python
"""Time one of the port's CUDA kernels as built from several source trees,
on the same inputs on one GPU, and hold the trees' outputs to the first
tree's bit for bit.

    python3 ab_kernels.py [--kernel nr_small|nr_large] [--rounds 2] TREE [TREE ...]

Each TREE is a checkout of this repository: ``.`` for this one, and for
another commit a ``git archive`` of it unpacked into a directory that
.gitignore lists (``chip_trees/``).  The inputs are those of chip_smoke.py:
``nr_small`` on 8192 env-like case33 lanes (its ``[kernel]`` phase),
``nr_large`` on 4096 env-like case322 lanes (``[kernel_large]``), made once
from numpy seed 0 by this tree's code.  Each run is a child process that
imports the tree's own ``mapdn_torch``, builds its kernel from the tree's
csrc/, launches it through the tree's wrapper on the context's
``kernel_tensors`` and times it with chip_smoke.py's timers of this tree,
as chip_smoke.py names them: ``ms`` one call from the host, ``device_ms``
its device time (launches back to back).  The trees run in turns, forward
then backward in each round (A B B A ...).  The last line is one JSON
object: per tree its times and, against the first tree, whether the
outputs (v, err, n_iter) are equal bit for bit on the lanes whose err is
finite in both, and on all lanes.  Needs a GPU; fails without one.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

CASES = {"nr_small": ("case33", 8192), "nr_large": ("case322", 4096)}


def child(args):
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
    grid, load_p, load_q, pv_max = make_case(case, dtype=torch.float32, device="cpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = {t: [] for t in args.trees}
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save(env_injections(grid, pv_max, load_p, load_q, lanes), inputs)
        for rnd in range(args.rounds):
            for tree in args.trees + args.trees[::-1]:
                out = os.path.join(tmp, "out.pt")
                subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                                "--kernel", args.kernel, "--inputs", inputs, "--out", out],
                               check=True)
                res = torch.load(out)
                runs[tree].append((res["ms"], res["device_ms"]))
                outs.setdefault(tree, res["out"])
                print(json.dumps({"round": rnd, "tree": tree, "ms": res["ms"],
                                  "device_ms": res["device_ms"]}), flush=True)
    lane_dim = 1 if args.kernel == "nr_small" else 0
    summary = {t: {"vs_first": compare(outs[t], outs[args.trees[0]], lane_dim),
                   "ms": [r[0] for r in rs], "device_ms": [r[1] for r in rs],
                   "median_ms": float(np.median([r[0] for r in rs])),
                   "median_device_ms": float(np.median([r[1] for r in rs]))}
               for t, rs in runs.items()}
    print(smi)
    print(json.dumps({"kernel": args.kernel, "case": case, "card": smi, "trees": summary}))


if __name__ == "__main__":
    main()
