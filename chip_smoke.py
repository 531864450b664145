#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (mapdn_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:

1. device       - require CUDA; print the card and its power limit; no TF32.
2. build        - build every hand-written kernel from csrc/ with nvcc
                  (sm_90a), one nvcc per source, all started together.
3. kernel       - the small-grid NR kernel (csrc/nr_small.cu) against its
                  plain PyTorch version and the torch-op solver on 8192
                  case33 lanes drawn from a numpy seed: agreement, divergence
                  isolation, warm start, NaN lane, false-divergence shares,
                  times and the bound; the kernel's registers and
                  shared memory, its blocks' iterations and the GFLOP it
                  runs; then against its plain version at the eval's lane
                  counts, 1, 10 and 28.
4. kernel_large - the large-grid NR kernel (csrc/nr_large.cu) against its
                  plain version on the test points of tests/test_pallas.py at
                  case33, case141 and case322, then the same checks as
                  `kernel` on 4096 env-like case322 lanes and on 1 lane (the
                  single-day eval's); the kernel's solver beside the
                  torch-op solver on 4096 env-like case141 lanes.
5. policy       - the fused GRU policy's kernels (csrc/policy_gru.cu) at the
                  update batches of case33 train8192 (196,608 rows, 6
                  agents) and case322 train4096 (4,980,736 rows, 38 agents):
                  the forward's means and stash and every gradient against
                  the plain versions in float64 on the same inputs, two runs
                  bit for bit; each kernel's registers and shared memory, its
                  call and device ms beside its FP32 bound, the plain
                  versions' and the module's own autograd ms (float32).
6. golden       - the committed 48-step golden trajectory replayed through
                  the env on the card (float32 tolerances of tests/test_env.py).
7. train        - the case33 path: MAPPO on case33 at 8192 lanes (the
                  bench.py configuration), one warm-up chunk, then one full
                  training episode with the small kernel's launches counted.
8. train322     - the case322 path through the port's CLI,
                  ``mapdn_torch.train.main``, with the flags of
                  train_case322.sh at 4096 lanes: one training episode, the
                  episode-0 eval and the final save; then ``--resume`` for one
                  more episode.  The large kernel's launches are counted
                  around each run, the eval's apart from the training's,
                  and the fused policy backward's (csrc/policy_gru.cu).
9. algos        - the other algorithms of the case33 sweep (iddpg, maddpg,
                  matd3, ippo, iac, coma, sqddpg, maac, facmaddpg) and the
                  random baseline, one line each: (a) the losses and
                  gradients (the mixer's too) on the card against the CPU,
                  float64, same parameters, batch and draws; (b) one
                  training episode through ``mapdn_torch.train.main`` with
                  the flags of train_case33.sh at the 512 lanes of
                  scripts/train_zoo.py, the episode-0 eval and the final
                  save, the small kernel's launches counted, the eval's
                  apart.
10. eval         - ``mapdn_torch.test.main`` on the model.pt files that
                  `algos` (maac, case33) and `train322` (mappo, case322)
                  saved: case33 in ``single``, ``day_sweep`` (28 days) and
                  ``batch`` (10 episodes), case322 in ``single``, one day of
                  480 steps each, with seconds, steps, launches and the mean
                  reward; each single day's record on the card held to the
                  CPU's for the same model.pt.
11. bench       - ``bench_torch.py`` at its defaults (8192 case33 lanes, one
                  warm-up and 8 timed MAPPO episodes) in a subprocess: its
                  JSON line, with a finite median, at least 240 small-kernel
                  launches an episode and ``vs_baseline`` above 1.
12. zoo         - ``mapdn_torch.scripts.train_zoo`` for its ``maddpg`` run cut
                  to 2 episodes, into a temporary directory, the small
                  kernel's launches counted with the eval's apart; then
                  ``mapdn_torch.scripts.learning_report.main`` over that
                  directory, whose random baseline runs 256 episodes on the
                  card; its reward and ratio beside the JAX package's.
13. examples    - ``mapdn_torch.code_examples``: the wrapper's 24 random
                  steps and the 24 batched steps of 512 lanes, the small
                  kernel's launches counted for each; then the wrapper's
                  first 24 steps from ``manual_reset(0, 0, 0)`` under fixed
                  actions without noise on the card against the CPU (the
                  eval's single-day tolerances).
14. episodic    - coma in episodic mode at 512 case33 lanes through the
                  library (the CLI has no flag for it): a pool of 10
                  episode slots, 2 episodes with the update at the second
                  (32 episodes a batch, 10 value and 1 policy epoch) and
                  the pool cleared after it, then one eval; then one
                  episode of mappo in episodic mode (the rollout values
                  filled over the episode).  Seconds, launches, the pool's
                  bytes and peak memory.
15. nonshared   - ``shared_params: False``: the losses and gradients of
                  the nine algorithms that take it on the card against the
                  CPU, float64, as ``algos`` (a); then one 512-lane case33
                  training episode each of iddpg and mappo, and that every
                  agent's slice of the policy moved.
16. solvers     - ``nr_solve(fixed_iter=1, 10)`` and ``nr_solve_dense`` at
                  case33 and case69 on the card against the CPU (float64);
                  case69 and case141 at 512 and 4096 env-like lanes through
                  the large kernel's solver and the torch-op solver, flat
                  and warm starts (the timings that set
                  ``make_solver("auto")``); the path "auto" picks per case.
17. multigpu    - (a) __graft_entry__.py's five profiles (maddpg as an
                  episode, mappo, facmaddpg, coma episodic, maddpg
                  decentralised) at 8 lanes as 2 gloo ranks sharing the
                  card (worker processes of this script), each against one
                  process on the card: the ranks' learners bitwise equal,
                  their generators where the single process's is, the small
                  kernel's launches per rank, the distance to one process;
                  (b) one 512-lane mappo episode through ``python -m
                  mapdn_torch.train --distributed`` at world size 1 over
                  NCCL against the CLI without it; (c) one NCCL rank a card,
                  run only where there are 2 cards or more.
``phase_multigpu_scaling`` (not in ``main``; for a machine of several cards)
runs the CLI's case33 MAPPO at 4096 lanes as one process on one card and as
one NCCL rank on each card, and compares their speed and policies.
18. profiling   - ``device_trace`` around one 512-lane case33 MAPPO chunk under
                  an active ``Tracer``: the Chrome trace names the small
                  kernel and the program's spans around it; the tracer's
                  pf.solve host and stream times; ``PhaseTimer``'s summary.
19. traditional - ``droop_solve`` and ``opf_solve`` on the card (float32, every
                  droop iteration a small-kernel solve) over the learning
                  report's 256 case33 rows, against the CPU at float64 on
                  the same rows; then ``engineering_baselines`` on the card
                  beside the JAX package's committed baselines.
20. converter   - tests/test_converter.py's five-bus feeder (a 110 kV slack, a
                  transformer with an off-neutral tap) imported through
                  ``from_pandapower`` onto the card and solved through
                  ``make_solver`` (the small kernel): against its plain
                  version and tests/fixtures/golden_feeder.json.
21. render      - ``mapdn_torch.test.main --test-mode single --render`` on the
                  maac model.pt that ``algos`` saved: one day on the card,
                  then its frames (at most 48, PNG) and GIF; where
                  matplotlib is not installed, that ``--render`` raises an
                  ImportError naming it after the day's pickle is written.
22. discrete    - the discrete-action helpers of ``learn/sampling.py`` on
                  (512, 6, 5) float32 logits on the card against the same
                  calls on the CPU with the same explicit draws: every
                  branch of ``select_action_discrete`` (a tie in test mode),
                  the Gumbel rsample's gradient through autograd, zero for
                  the detached sample, each log-prob's; then draws from the
                  card's generator.
23. history     - one 512-lane case33 iddpg episode with ``history=3``
                  (``library_trainer``): the small kernel's launches, every
                  step's stacked obs against a stack of the card's own base
                  frames rolled by hand, across the auto-resets.
24. bf16        - the bench.py configuration (8192 lanes, ``bench_trainer``):
                  one chunk with the bf16 ring and one with a float32 ring
                  from the same carry and generator state: each bf16 field
                  the float32 ring's rounded to bf16 bit for bit, the other
                  fields float32, the update stats within 1e-2 relative; the
                  rings' bytes and the peak memory of each chunk.

The line before the last two is the kernels' JSON record, then the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, "device": ...}``.
"""
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published peaks of one H100 SXM (data sheet, 700 W): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
N_LANES = 8192          # case33 lanes (bench.py)
N_LANES_322 = 4096      # case322 lanes (scripts/bench_cases.py:35)
N_LANES_ALGOS = 512     # case33 sweep lanes (scripts/train_zoo.py N_ENVS)
ALGOS = ("iddpg", "maddpg", "matd3", "ippo", "iac", "coma", "sqddpg", "random", "maac",
         "facmaddpg")
EVAL_LANES = (1, 10, 28)  # the test CLI's single, batch and day_sweep lanes
N_LANES_RANDOM = 256    # the learning report's random baseline (random_episodes)
# [algos] (a): the card's losses against the CPU's to this relative
# tolerance, and each gradient's difference to this share of its global norm
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3

def say(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def cuda_median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_device_ms(fn, launches=20, reps=5):
    """Device and host time of one call of ``fn``, whose work all runs on
    the card without a host synchronization: ``launches`` calls enqueued
    back to back behind a sleeping kernel, so that the host's own time per
    call (the wrapper's checks and allocations, the launch) stays hidden
    from the device.  Returns the medians over ``reps`` such runs of the
    device time per call (CUDA events from the first launch to the last)
    and of the host's wall time to enqueue one call."""
    fn()
    device, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)   # about 25 ms: longer than the enqueue
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / launches)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / launches)
    return float(np.median(device)), float(np.median(host))


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        sys.exit(2)
    from bench_torch import card

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from mapdn_torch.utils import cuda_build
    t0 = time.perf_counter()
    cuda_build.build(*cuda_build.KERNELS)
    ptxas = {name: [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in cuda_build.BUILD_LOG.items()}
    say("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def env_injections(grid, pv_max, load_p, load_q, lanes, seed=0):
    """Operating points like the env's: loads at 50-130 % of base, PV at
    0-80 % of nameplate, reactive set-points a * sqrt(s_max^2 - p^2)."""
    rng = np.random.RandomState(seed)
    lp = load_p[None] * rng.uniform(0.5, 1.3, (lanes, len(load_p)))
    lq = load_q[None] * rng.uniform(0.5, 1.3, (lanes, len(load_q)))
    pv = pv_max[None] * rng.uniform(0.0, 0.8, (lanes, len(pv_max)))
    s_max = 1.2 * pv_max[None]
    qg = rng.uniform(-0.8, 0.8, pv.shape) * np.sqrt(s_max**2 - pv**2)
    load_inc = grid.load_inc.double().cpu().numpy()
    sgen_inc = grid.sgen_inc.double().cpu().numpy()
    p = pv @ sgen_inc.T - lp @ load_inc.T
    q = qg @ sgen_inc.T - lq @ load_inc.T
    dev = grid.device
    return (torch.as_tensor(p, dtype=torch.float32, device=dev),
            torch.as_tensor(q, dtype=torch.float32, device=dev))


def test_point_injections(grid, load_p, load_q, lanes):
    """The operating points of tests/test_pallas.py: base loads scaled 0.6 ..
    1.2 across the lanes."""
    inc = grid.load_inc.double().cpu().numpy()
    scale = np.linspace(0.6, 1.2, lanes)[:, None]
    p = -(np.asarray(load_p) @ inc.T)[None] * scale
    q = -(np.asarray(load_q) @ inc.T)[None] * scale
    return (torch.as_tensor(p, dtype=torch.float32, device=grid.device),
            torch.as_tensor(q, dtype=torch.float32, device=grid.device))


def compare_packed(ctx, a, b, tol):
    """Kernel ``a`` against plain ``b``, each ``(v, err, n_iter)`` on the
    same packed operands of context ``ctx`` (either layout): converged
    flags, n_iter, the largest vm/va difference over lanes that ran the
    same iterations and over all converged lanes, and the largest
    difference of the packed state (e, f) over converged lanes."""
    (av, aerr, ait), (bv, berr, bit) = a, b
    conv_a = (aerr < tol) & torch.isfinite(aerr)
    conv_b = (berr < tol) & torch.isfinite(berr)
    (ae, af), (be, bf) = ctx.unpack(av), ctx.unpack(bv)
    ok = conv_a & conv_b
    same = ok & (ait == bit)
    lane_err = torch.maximum(
        (torch.sqrt(ae * ae + af * af) - torch.sqrt(be * be + bf * bf)).abs().amax(1),
        (torch.atan2(af, ae) - torch.atan2(bf, be)).abs().amax(1))
    packed_err = torch.maximum((ae - be).abs().amax(1), (af - bf).abs().amax(1))
    worst = lambda x, sel: float(x[sel].max()) if bool(sel.any()) else 0.0
    return dict(
        converged_equal=bool((conv_a == conv_b).all()),
        n_converged=int(conv_a.sum()),
        max_n_iter_diff=int((ait - bit).abs().max()),
        max_abs_err_same_iters=worst(lane_err, same),
        max_abs_err_all=worst(lane_err, ok),
        lanes_one_iter_apart=int((ok & ~same).sum()),
        packed_max_abs_err_same_iters=worst(packed_err, same),
        packed_max_abs_err=worst(packed_err, ok))


def few_lanes_check(solve, plain, grid, load_p, load_q, pv_max, lanes, all_tol):
    """``solve`` (a kernel's solver) against ``plain`` (its plain version)
    on ``lanes`` lanes of the test points (every lane converges) and of
    env-like points: the same converged flags, n_iter within 1, vm/va
    within 2e-5 on converged lanes that ran the same iterations and
    ``all_tol`` on all converged lanes.  Returns the largest differences."""
    out = {}
    for name, (p, q) in (("test_points", test_point_injections(grid, load_p, load_q, lanes)),
                         ("env", env_injections(grid, pv_max, load_p, load_q, lanes, seed=lanes))):
        k, r = solve(grid, p, q), plain(grid, p, q)
        assert k.vm.shape == (lanes, grid.n_bus), (name, lanes, k.vm.shape)
        ok = k.converged
        assert bool((ok == r.converged).all()), (name, lanes)
        assert name == "env" or bool(ok.all()), (name, lanes)
        assert int((k.n_iter - r.n_iter).abs().max()) <= 1, (name, lanes)
        same = ok & (k.n_iter == r.n_iter)
        err = torch.maximum((k.vm - r.vm).abs().amax(1), (k.va - r.va).abs().amax(1))
        worst = lambda sel: float(err[sel].max()) if bool(sel.any()) else 0.0
        assert worst(same) <= 2e-5 and worst(ok) <= all_tol, (name, lanes, err)
        out[name] = {"n_converged": int(ok.sum()), "max_abs_err_same_iters": worst(same),
                     "max_abs_err_all": worst(ok)}
    return out


def phase_kernel():
    from mapdn_torch.grid import make_case
    from mapdn_torch.pf import fused_nr
    from mapdn_torch.pf.fused_nr import (
        get_ctx_small, make_solver, nr_solve_small, nr_solve_small_ref)
    from mapdn_torch.pf.newton import nr_solve, packed_operators

    grid, load_p, load_q, pv_max = make_case("case33", dtype=torch.float32)
    n = grid.n_bus

    # (a) the tolerance of tests/test_pallas.py on its own operating points
    # (base load scaled 0.6 .. 1.2 across the lanes): every lane within
    # 2e-5 of the plain version, same converged flags, n_iter within 1
    pa, qa = test_point_injections(grid, load_p, load_q, N_LANES)
    ka, ra = nr_solve_small(grid, pa, qa), nr_solve_small_ref(grid, pa, qa)
    err_a = max(float((ka.vm - ra.vm).abs().max()), float((ka.va - ra.va).abs().max()))
    assert bool(ka.converged.all()) and bool((ka.converged == ra.converged).all())
    assert err_a <= 2e-5, err_a
    assert int((ka.n_iter - ra.n_iter).abs().max()) <= 1

    # (b) env-like operating points.  A lane whose error lands next to tol
    # can stop one Newton iteration apart in the two versions; its voltages
    # then differ by that last step, which is below the float32 solver's
    # own accuracy against float64 (~5e-5 here, the same for both).  So:
    # 2e-5 on lanes with equal n_iter, 1e-4 on all lanes, both versions
    # held to 1e-4 of a float64 solve at tol 1e-12.
    p, q = env_injections(grid, pv_max, load_p, load_q, N_LANES)
    out = nr_solve_small(grid, p, q)
    ref = nr_solve_small_ref(grid, p, q)
    ops = packed_operators(grid)
    tor = nr_solve(grid, p, q, ops=ops)
    g64, *_ = make_case("case33", dtype=torch.float64)
    tru = nr_solve_small_ref(g64, p.double(), q.double(), tol=1e-12)
    torch.cuda.synchronize()
    for name, res in (("kernel", out), ("plain", ref), ("torch", tor)):
        assert res.vm.shape == (N_LANES, n) and res.n_iter.shape == (N_LANES,), name
    assert bool((out.converged == ref.converged).all()), "converged differs"
    d_it = int((out.n_iter - ref.n_iter).abs().max())
    assert d_it <= 1, f"n_iter differs by {d_it}"
    ok = out.converged
    same = ok & (out.n_iter == ref.n_iter)
    lane_err = torch.maximum((out.vm - ref.vm).abs().amax(1), (out.va - ref.va).abs().amax(1))
    err_same = float(lane_err[same].max())
    err_all = float(lane_err[ok].max())
    assert err_same <= 2e-5 and err_all <= 1e-4, (err_same, err_all)
    vs64 = {name: float((res.vm.double() - tru.vm).abs()[res.converged & tru.converged].max())
            for name, res in (("kernel", out), ("plain", ref), ("torch", tor))}
    assert vs64["kernel"] <= 1e-4, vs64
    assert bool(torch.isfinite(out.vm[ok]).all())
    assert bool(torch.isfinite(out.pl_mw[ok]).all())

    # on the test points: divergence isolation within one block, a warm
    # start from the solution taking no iteration, a NaN lane that never
    # reads as converged and stays in its lane
    pb = pa[:64].clone()
    pb[2:4] *= 500.0
    bad = nr_solve_small(grid, pb, qa[:64])
    assert bool(bad.converged[:2].all()) and not bool(bad.converged[2:4].any())
    assert bool(bad.converged[4:].all())
    assert bool(torch.isfinite(bad.vm[:2]).all())
    # tol 1e-7 is the float32 mismatch's rounding floor: re-rounding a
    # solution through (vm, va) -> (e, f) lands its error on either side of
    # it, so the zero-iteration check holds the warm solve to tol 1e-6, and
    # the share of lanes that need no iteration at 1e-7 is reported
    warm = nr_solve_small(grid, pa, qa, vm0=ka.vm, va0=ka.va, tol=1e-6)
    assert bool(warm.converged.all()) and int(warm.n_iter.max()) == 0
    assert float((warm.vm - ka.vm).abs().max()) <= 1e-6
    pn = pa[:64].clone()
    pn[5, 7] = float("nan")
    nan = nr_solve_small(grid, pn, qa[:64])
    assert not bool(nan.converged[5]) and bool(nan.converged[:5].all())
    assert bool(nan.converged[6:].all())
    warm_b = nr_solve_small(grid, p, q, vm0=out.vm, va0=out.va)
    warm_r = nr_solve_small_ref(grid, p, q, vm0=ref.vm, va0=ref.va)
    assert bool(warm_b.converged[ok].all())
    zero_iter = {"kernel": float((warm_b.n_iter[ok] == 0).double().mean()),
                 "plain": float((warm_r.n_iter[ref.converged] == 0).double().mean()),
                 "kernel_max_n_iter": int(warm_b.n_iter[ok].max()),
                 "plain_max_n_iter": int(warm_r.n_iter[ref.converged].max())}

    # timing: the solvers from injections to PFResult (pack, solve, unpack,
    # bus and branch results) as the env calls them, each with its operands
    # resolved once; then the kernel alone against its plain version on the
    # same packed operands: `ms` one call from the host (the wrapper's
    # checks and launch included), `device_ms` and `host_ms` the call's
    # device and host time apart (cuda_device_ms)
    ctx = get_ctx_small(grid)
    solve_kernel = make_solver(grid, backend="auto")
    solver_ms = {"kernel": cuda_median_ms(lambda: solve_kernel(p, q)),
                 "plain": cuda_median_ms(lambda: nr_solve_small_ref(grid, p, q, ctx=ctx)),
                 "torch": cuda_median_ms(lambda: nr_solve(grid, p, q, ops=ops))}
    spec, v0 = ctx.pack(p, q, None, None, torch.float32)
    kops = ctx.kernel_tensors(p.device)
    pops = ctx.tensors(torch.float32, p.device)
    kw = dict(tol=1e-7, max_iter=20, inner_iters=3)
    kres = fused_nr.nr_small_kernel(spec, v0, *kops, **kw)
    cmp = compare_packed(ctx, kres, fused_nr.nr_small_plain(spec, v0, *pops, **kw),
                         kw["tol"])
    assert cmp["converged_equal"], cmp
    assert cmp["packed_max_abs_err_same_iters"] <= 2e-5 and cmp["packed_max_abs_err"] <= 1e-4, cmp
    kit = kres[2]
    ms = cuda_median_ms(lambda: fused_nr.nr_small_kernel(spec, v0, *kops, **kw))
    device_ms, host_ms = cuda_device_ms(
        lambda: fused_nr.nr_small_kernel(spec, v0, *kops, **kw))
    plain_ms = cuda_median_ms(lambda: fused_nr.nr_small_plain(spec, v0, *pops, **kw))
    inner = kw["inner_iters"]
    cfg = fused_nr.nr_small_config(ctx)
    counts = small_kernel_counts(ctx, kit, inner)

    # bound of the kernel's function on these inputs.  Operations: per lane
    # one mismatch product with Y, then per Newton iteration it ran, one W
    # product for the first direction, inner_iters pairs of Y and W products
    # for the Richardson sweeps, and the next mismatch's Y product; each
    # product counted at 2 flops per nonzero of its operator (case33 is a
    # radial feeder: Y is about a tenth full, W's padding rows are zero),
    # at the FP32 peak.  Bytes: spec and v0 read, the two operators, rowsum
    # and mask read once, v, err and n_iter written.  What the kernel runs
    # is `gflop_run` (small_kernel_counts)
    m = 2 * n
    nnz_y, nnz_w = int(np.count_nonzero(ctx.ymat)), int(np.count_nonzero(ctx.wmat))
    lane_iters = float(kit.double().sum())
    flops = 2.0 * (nnz_y * (N_LANES + (inner + 1) * lane_iters)
                   + nnz_w * (inner + 1) * lane_iters)
    nbytes = 4 * (3 * m * N_LANES + 2 * m * m + 2 * m + 2 * N_LANES)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops > t_bytes else "bytes"
    fdiv = {name: float((~res.converged).double().mean())
            for name, res in (("kernel", out), ("plain", ref), ("torch", tor))}
    # lanes the kernel reports diverged that the torch-op solver solved
    fdiv["kernel_vs_torch"] = float((~out.converged & tor.converged).double().mean())
    # the other lane counts the main path gives the kernel: the eval's, one
    # block of 32 lanes with 31, 22 or 4 dead ones (1 lane is the corner
    # case of the lane-pair split, and the wrapper's), the random
    # baseline's 256 and the 512 of the sweep, the examples, episodic and
    # per-agent training
    eval_lanes = {n_l: few_lanes_check(nr_solve_small, nr_solve_small_ref, grid, load_p,
                                       load_q, pv_max, n_l, 1e-4)
                  for n_l in EVAL_LANES + (N_LANES_RANDOM, N_LANES_ALGOS)}
    say("kernel", lanes=N_LANES, max_abs_err_test_points=err_a,
        max_abs_err_same_iters=err_same, max_abs_err_all=err_all,
        packed=cmp, lanes_one_iter_apart=int((ok & ~same).sum()), vm_err_vs_float64=vs64,
        warm_start_zero_iter_share_tol_1e_7=zero_iter,
        max_n_iter_diff=d_it, mean_n_iter=float(kit.double().mean()),
        config=cfg, **counts,
        false_divergence=fdiv, ms=ms, device_ms=device_ms, host_ms=host_ms,
        plain_ms=plain_ms, solver_ms=solver_ms, bound_ms=bound_ms,
        bound_by=bound_by, gflop=flops / 1e9, nnz_y=nnz_y, nnz_w=nnz_w,
        mbytes=nbytes / 1e6, eval_lanes=eval_lanes)
    return dict(name="nr_small", route="cuda", source="mapdn_torch/csrc/nr_small.cu",
                replaces="mapdn_tpu/pf/pallas_nr.py:404",
                max_abs_err=cmp["packed_max_abs_err"], ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def large_vs_plain(out, ref, all_tol, what):
    """The large kernel's solve ``out`` held against its plain version's
    ``ref`` on the same inputs: the converged flags equal, n_iter within 1,
    vm and va within 2e-5 on the lanes that ran the same iterations and
    within ``all_tol`` on every converged lane; raises otherwise."""
    flags_equal = bool((out.converged == ref.converged).all())
    d_it = int((out.n_iter - ref.n_iter).abs().max())
    ok = out.converged
    same = ok & (out.n_iter == ref.n_iter)
    lane_err = torch.maximum((out.vm - ref.vm).abs().amax(1), (out.va - ref.va).abs().amax(1))
    err_same = float(lane_err[same].max()) if bool(same.any()) else 0.0
    err_all = float(lane_err[ok].max()) if bool(ok.any()) else 0.0
    if not (flags_equal and d_it <= 1 and err_same <= 2e-5 and err_all <= all_tol):
        raise AssertionError(f"{what}: large kernel against its plain version: converged "
                             f"equal {flags_equal}, n_iter apart {d_it}, vm/va {err_same:.3e} "
                             f"on equal iterations, {err_all:.3e} on all lanes")
    return {"max_abs_err_same_iters": err_same, "max_abs_err_all": err_all,
            "max_n_iter_diff": d_it, "lanes_one_iter_apart": int((ok & ~same).sum())}


def phase_kernel_large():
    from mapdn_torch.grid import make_case
    from mapdn_torch.pf import fused_nr
    from mapdn_torch.pf.fused_nr import (
        get_ctx, make_solver, nr_solve_large, nr_solve_large_ref)
    from mapdn_torch.pf.newton import nr_solve, packed_operators

    kw = dict(tol=1e-7, max_iter=20, inner_iters=3)
    lanes = N_LANES_322

    # (a) the test points of tests/test_pallas.py at every npad the kernel
    # holds: every lane converges, in both versions, n_iter within 1, vm/va
    # within 2e-5 on lanes that ran the same iterations (the tolerance of
    # the TPU kernels' tests against the XLA solver)
    test_points = {}
    for case in ("case33", "case141", "case322"):
        grid, load_p, load_q, _ = make_case(case, dtype=torch.float32, device="cuda")
        ctx = get_ctx(grid)
        p, q = test_point_injections(grid, load_p, load_q, lanes)
        spec, v0 = ctx.pack(p, q, None, None, torch.float32)
        kres = fused_nr.nr_large_kernel(spec, v0, *ctx.kernel_tensors(p.device), **kw)
        plain = fused_nr.nr_large_plain(spec, v0, *ctx.tensors(torch.float32, p.device), **kw)
        cmp = compare_packed(ctx, kres, plain, kw["tol"])
        assert cmp["converged_equal"] and cmp["n_converged"] == lanes, (case, cmp)
        assert cmp["max_n_iter_diff"] <= 1 and cmp["max_abs_err_same_iters"] <= 2e-5, (case, cmp)
        test_points[case] = dict(npad=ctx.npad, **cmp)

    # (b) env-like case322 operating points.  At case322 the convergence test
    # max|F| / s_ref < 1e-7 is loose: it is taken in Y-normalized units
    # (inv_c = 1.07e-5), and a lane that meets it after one Newton iteration
    # still lies up to 4.8e-4 from the fully converged solution (float64,
    # tests/test_pallas.py points, CPU).  A lane whose error lands next to
    # tol can stop one iteration apart in the two versions, and its voltages
    # then differ by up to that much.  So: 2e-5 on lanes with equal n_iter,
    # 1e-3 on all lanes; each float32 solver's distance from a float64 solve
    # at tol 1e-12 is reported, the kernel's held to 1e-3 and to the
    # torch-op solver's plus 2e-5.
    grid, load_p, load_q, pv_max = make_case("case322", dtype=torch.float32, device="cuda")
    n = grid.n_bus
    ctx = get_ctx(grid)
    p, q = env_injections(grid, pv_max, load_p, load_q, lanes)
    out = nr_solve_large(grid, p, q)
    ref = nr_solve_large_ref(grid, p, q)
    ops = packed_operators(grid)
    tor = nr_solve(grid, p, q, ops=ops)
    g64, *_ = make_case("case322", dtype=torch.float64, device="cuda")
    tru = nr_solve_large_ref(g64, p.double(), q.double(), tol=1e-12)
    torch.cuda.synchronize()
    for name, res in (("kernel", out), ("plain", ref), ("torch", tor)):
        assert res.vm.shape == (lanes, n) and res.n_iter.shape == (lanes,), name
    held = large_vs_plain(out, ref, 1e-3, "case322")
    err_same, err_all, d_it = (held[k] for k in ("max_abs_err_same_iters",
                                                 "max_abs_err_all", "max_n_iter_diff"))
    ok = out.converged
    same = ok & (out.n_iter == ref.n_iter)
    vs64 = {name: float((res.vm.double() - tru.vm).abs()[res.converged & tru.converged].max())
            for name, res in (("kernel", out), ("plain", ref), ("torch", tor))}
    assert vs64["kernel"] <= min(1e-3, vs64["torch"] + 2e-5), vs64
    assert bool(torch.isfinite(out.vm[ok]).all()) and bool(torch.isfinite(out.pl_mw[ok]).all())

    # divergence isolation within one block (8 lanes), a warm start taking
    # no iteration (tol 1e-6: 1e-7 is the float32 rounding floor, ROADMAP
    # Queue C), a NaN lane that never reads as converged and stays in its
    # lane
    pa, qa = test_point_injections(grid, load_p, load_q, 64)
    pb = pa.clone()
    pb[2:4] *= 500.0
    bad = nr_solve_large(grid, pb, qa)
    assert bool(bad.converged[:2].all()) and not bool(bad.converged[2:4].any())
    assert bool(bad.converged[4:].all()) and bool(torch.isfinite(bad.vm[:2]).all())
    cold = nr_solve_large(grid, pa, qa)
    warm = nr_solve_large(grid, pa, qa, vm0=cold.vm, va0=cold.va, tol=1e-6)
    assert bool(warm.converged.all()) and int(warm.n_iter.max()) == 0
    assert float((warm.vm - cold.vm).abs().max()) <= 1e-6
    pn = pa.clone()
    pn[5, 7] = float("nan")
    nan = nr_solve_large(grid, pn, qa)
    assert not bool(nan.converged[5]) and bool(nan.converged[:5].all())
    assert bool(nan.converged[6:].all())
    torch.testing.assert_close(nan.vm[:5], cold.vm[:5], rtol=0, atol=0)
    warm_b = nr_solve_large(grid, p, q, vm0=out.vm, va0=out.va)
    warm_r = nr_solve_large_ref(grid, p, q, vm0=ref.vm, va0=ref.va)
    zero_iter = {"kernel": float((warm_b.n_iter[ok] == 0).double().mean()),
                 "plain": float((warm_r.n_iter[ref.converged] == 0).double().mean())}

    # timing: the solvers from injections to PFResult as the env calls them
    # (each with its operands resolved once), then the kernel alone against
    # its plain version on the same packed operands (`ms`, `device_ms` and
    # `host_ms` as for the small kernel)
    solve_auto = make_solver(grid, backend="auto")
    solver_ms = {"kernel": cuda_median_ms(lambda: solve_auto(p, q)),
                 "plain": cuda_median_ms(lambda: nr_solve_large_ref(grid, p, q, ctx=ctx)),
                 "torch": cuda_median_ms(lambda: nr_solve(grid, p, q, ops=ops))}
    spec, v0 = ctx.pack(p, q, None, None, torch.float32)
    kops = ctx.kernel_tensors(p.device)
    pops = ctx.tensors(torch.float32, p.device)
    plain = fused_nr.nr_large_plain(spec, v0, *pops, **kw)
    kres = fused_nr.nr_large_kernel(spec, v0, *kops, **kw)
    cmp = compare_packed(ctx, kres, plain, kw["tol"])
    assert cmp["converged_equal"] and cmp["max_abs_err_same_iters"] <= 2e-5, cmp
    ms = cuda_median_ms(lambda: fused_nr.nr_large_kernel(spec, v0, *kops, **kw))
    device_ms, host_ms = cuda_device_ms(
        lambda: fused_nr.nr_large_kernel(spec, v0, *kops, **kw))
    plain_ms = cuda_median_ms(lambda: fused_nr.nr_large_plain(spec, v0, *pops, **kw))

    kit = kres[2]
    inner = kw["inner_iters"]
    cfg = fused_nr.nr_large_config(ctx)
    counts = large_kernel_counts(ctx, kit, inner)

    # bound of the kernel's function on these inputs, counted as for the
    # small kernel: per lane one mismatch product with Y, per Newton
    # iteration it ran (inner_iters + 1) products with Y and with W, each at
    # 2 flops per nonzero of its operator (case322's packed Y is 0.65 %
    # full, W 70 %: dense on its live block), at the FP32 peak; bytes: spec
    # and v0 read, the operators, rowsum and mask read once, v, err and
    # n_iter written.  What the kernel runs is `gflop_run`
    # (large_kernel_counts)
    m = 2 * ctx.npad
    nnz_y, nnz_w = int(np.count_nonzero(ctx.ypack)), int(np.count_nonzero(ctx.wpack))
    lane_iters = float(kit.double().sum())
    flops = 2.0 * (nnz_y * (lanes + (inner + 1) * lane_iters)
                   + nnz_w * (inner + 1) * lane_iters)
    nbytes = 4 * (3 * m * lanes + 2 * m * m + 2 * m + 2 * lanes)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops > t_bytes else "bytes"
    fdiv = {name: float((~res.converged).double().mean())
            for name, res in (("kernel", out), ("plain", ref), ("torch", tor))}
    fdiv["kernel_vs_torch"] = float((~out.converged & tor.converged).double().mean())

    # case141 (npad 256), env-like lanes: the large kernel's solver beside
    # the torch-op solver (the timings that set "auto" are in [solvers])
    g141, lp141, lq141, pv141 = make_case("case141", dtype=torch.float32, device="cuda")
    p141, q141 = env_injections(g141, pv141, lp141, lq141, lanes)
    k141 = make_solver(g141, backend="auto")
    ops141 = packed_operators(g141)
    r141, t141 = k141(p141, q141), nr_solve(g141, p141, q141, ops=ops141)
    assert bool((r141.converged == t141.converged).all())
    case141 = {"lanes": lanes, "n_converged": int(r141.converged.sum()),
               "mean_n_iter": float(r141.n_iter.double().mean()),
               "kernel_solver_ms": cuda_median_ms(lambda: k141(p141, q141)),
               "torch_solver_ms": cuda_median_ms(lambda: nr_solve(g141, p141, q141, ops=ops141))}
    # the single-day eval's one lane: one block of 8 lanes, 7 of them dead
    one_lane = few_lanes_check(nr_solve_large, nr_solve_large_ref, grid, load_p, load_q,
                               pv_max, 1, 1e-3)

    say("kernel_large", lanes=lanes, test_points=test_points,
        max_abs_err_same_iters=err_same, max_abs_err_all=err_all,
        lanes_one_iter_apart=int((ok & ~same).sum()), max_n_iter_diff=d_it,
        packed=cmp, vm_err_vs_float64=vs64,
        warm_start_zero_iter_share_tol_1e_7=zero_iter,
        mean_n_iter=float(kit.double().mean()),
        config=cfg, **counts,
        false_divergence=fdiv, ms=ms, device_ms=device_ms, host_ms=host_ms,
        plain_ms=plain_ms, solver_ms=solver_ms, bound_ms=bound_ms,
        bound_by=bound_by, gflop=flops / 1e9, nnz_y=nnz_y, nnz_w=nnz_w,
        mbytes=nbytes / 1e6, case141=case141, eval_lanes={1: one_lane})
    return dict(name="nr_large", route="cuda", source="mapdn_torch/csrc/nr_large.cu",
                replaces="mapdn_tpu/pf/pallas_nr.py:158",
                max_abs_err=cmp["packed_max_abs_err"], ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# [policy]: the update batches of case33 train8192 (1024 lanes x 32 steps x 6
# agents) and case322 train4096 (4096 x 32 x 38), as (agents, obs width, rows)
POLICY_CASES = {"case33": (6, 38, 196_608), "case322": (38, 62, 4_980_736)}
# the kernels (float32) against the plain versions in float64 on the same
# inputs: the forward's means, stash and 1/std to this share of their
# largest magnitude; each gradient, from the kernels' own stash, to this
# share of its norm (float32 sums over up to 5M rows, each thread's chain
# up to 38k rows long).  From the float64 stash instead, the gradients of
# fc1 and LayerNorm's bias move by up to 3e-4 of their norm on random
# cotangents, as much as the module's own float32 ops move them: ReLU's
# mask flips where LayerNorm's output lies within float32 rounding of 0,
# and each flip moves a whole row's term (PERF.md); that error is reported
# beside the module's, not held to a limit.
POLICY_MEANS_TOL = 1e-5
POLICY_GRAD_TOL = 2e-5


def policy_case(n, o, rows, seed=0, device="cuda"):
    """A shared GRU policy of hidden width 64 with every parameter drawn
    away from its init, and float32 obs, hidden states and means'
    cotangents of ``rows`` rows (``n`` agents, obs width ``o``)."""
    from mapdn_torch.nets.agents import RNNAgent
    gen = torch.Generator().manual_seed(seed)
    module = RNNAgent(o + n, hid_size=64).reset_parameters(gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    module = module.to(device)
    obs = torch.randn((rows, o), generator=gen).to(device)
    hid = torch.tanh(torch.randn((rows, 64), generator=gen)).to(device)
    dmeans = (torch.randn(rows, generator=gen) / rows).to(device)
    return module, obs, hid, dmeans


@torch.no_grad()
def policy_reference(obs, hid, dmeans, params, n, stash=None, rstd=None, chunk=1 << 19):
    """The plain versions in float64 over chunks of whole agent groups of
    rows: means, stash and 1/std (as float32) and the gradients, these from
    ``stash`` and ``rstd`` where given (the kernels' own) and from the
    float64 forward's otherwise."""
    from mapdn_torch.nets import policy_gru as pg
    p64 = [p.double() for p in params]
    chunk -= chunk % max(n, 1)
    means, stashes, rstds, grads = [], [], [], None
    for a in range(0, obs.shape[0], chunk):
        x, h, d = (t[a:a + chunk].double() for t in (obs, hid, dmeans))
        m, st, rs = pg.policy_fwd_plain(x, h, p64, n)
        if stash is not None:
            st, rs = stash[a:a + chunk].double(), rstd[a:a + chunk].double()
        g = pg.policy_bwd_plain(x, h, d, st, rs, p64, n, blocks=1)
        grads = g if grads is None else [u + v for u, v in zip(grads, g)]
        means.append(m.float())
        stashes.append(st.float())
        rstds.append(rs.float())
    return torch.cat(means), torch.cat(stashes), torch.cat(rstds), grads


def grad_errors(got, want):
    """Each gradient's error norm over its norm."""
    return [float((a.double() - b.double()).norm() / b.double().norm())
            for a, b in zip(got, want)]


def policy_errors(obs, hid, dmeans, params, n, got):
    """The kernels' (means, stash, rstd, grads) against the float64 plain
    versions: the forward's largest errors over the largest magnitudes, the
    gradients from the kernels' stash and, reported only, from the float64
    stash (``grads_end_to_end``)."""
    m, st, rs, g = got
    wm, wst, wrs, wg = policy_reference(obs, hid, dmeans, params, n)
    same = policy_reference(obs, hid, dmeans, params, n, st, rs)[3]
    rel = lambda a, b: float((a.double() - b.double()).abs().max() / b.double().abs().max())
    return {"means": rel(m, wm), "stash": rel(st, wst), "rstd": rel(rs, wrs),
            "grads": grad_errors(g, same), "grads_end_to_end": grad_errors(g, wg)}, wg


def check_policy_errors(errs):
    assert max(errs["means"], errs["stash"], errs["rstd"]) <= POLICY_MEANS_TOL, errs
    assert max(errs["grads"]) <= POLICY_GRAD_TOL, errs


def phase_policy(smi):
    from mapdn_torch.nets import policy_gru as pg

    out = {}
    for name, (n, o, rows) in POLICY_CASES.items():
        module, obs, hid, dmeans = policy_case(n, o, rows)
        params = list(module.parameters())
        fwd = lambda: pg.policy_fwd_kernel(obs, hid, params, n)
        m, st, rs = fwd()
        bwd = lambda: pg.policy_bwd_kernel(obs, hid, dmeans, st, rs, params, n)
        g = bwd()
        m2, st2, rs2 = fwd()
        g2 = bwd()
        torch.cuda.synchronize()
        repeat = (torch.equal(m, m2) and torch.equal(st, st2) and torch.equal(rs, rs2)
                  and all(torch.equal(a, b) for a, b in zip(g, g2)))
        assert repeat, f"{name}: two runs differ"
        del m2, st2, rs2, g2
        errs, want_grads = policy_errors(obs, hid, dmeans, params, n, (m, st, rs, g))
        check_policy_errors(errs)
        fwd_dev, fwd_host = cuda_device_ms(fwd, launches=5, reps=3)
        bwd_dev, bwd_host = cuda_device_ms(bwd, launches=5, reps=3)
        fwd_call = cuda_median_ms(fwd, reps=5, warmup=1)
        bwd_call = cuda_median_ms(bwd, reps=5, warmup=1)
        del m, st, rs, g
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        plain_fwd = lambda: pg.policy_fwd_plain(obs, hid, params, n)
        with torch.no_grad():
            pm, pst, prs = plain_fwd()
            plain_fwd_ms = cuda_median_ms(plain_fwd, reps=3, warmup=1)
            plain_bwd_ms = cuda_median_ms(lambda: pg.policy_bwd_plain(
                obs, hid, dmeans, pst, prs, params, n, blocks), reps=3, warmup=1)
        del pm, pst, prs
        # the module's own ops with autograd (the path the kernels replace)
        ids = torch.eye(n, device=obs.device).repeat(rows // n, 1)

        def module_step():
            means, _, _ = module(torch.cat([obs, ids], -1), hid)
            return torch.autograd.grad(means[:, 0], params, dmeans)
        errs["module_grads_end_to_end"] = grad_errors(module_step(), want_grads)
        module_ms = cuda_median_ms(module_step, reps=3, warmup=1)
        del ids, want_grads
        flops = pg.flops(rows, o)
        # obs and h read by both kernels, the stash and 1/std written and
        # read back, the means written and their cotangents read
        nbytes = 4 * rows * (2 * (o + 64) + 2 * (pg.STASH * 64 + 1) + 2)
        bound_ms = 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
        out[name] = dict(
            rows=rows, agents=n, obs=o, errors=errs, repeat_bitwise=repeat,
            forward_ms=dict(call=fwd_call, device=fwd_dev, host=fwd_host),
            backward_ms=dict(call=bwd_call, device=bwd_dev, host=bwd_host),
            bound_ms=bound_ms, gflop=flops / 1e9, gbytes=nbytes / 1e9,
            roofline_share=bound_ms / (fwd_dev + bwd_dev),
            plain_ms=dict(forward=plain_fwd_ms, backward=plain_bwd_ms),
            module_autograd_ms=module_ms, config=pg.kernel_config(n))
        del module, obs, hid, dmeans
        free_memory()
        torch.cuda.empty_cache()
    say("policy", launches=dict(forward=pg.policy_fwd.launches,
                                backward=pg.policy_bwd.launches),
        means_tol=POLICY_MEANS_TOL, grad_tol=POLICY_GRAD_TOL, card=smi, **out)


def small_kernel_counts(ctx, n_iter, inner):
    """What the small kernel runs on these lanes, computed from the counts
    (not measured): the iterations of each block (its 32 lanes' largest
    n_iter: a block iterates while any of its lanes does) and the GFLOP it
    runs (32 lanes a block, Y on its bus rows, two FMAs an entry, W on its
    live block with rows padded to 4 floats)."""
    lanes = n_iter.shape[0]
    iters = torch.nn.functional.pad(n_iter, (0, -lanes % 32)).view(-1, 32).amax(1).double()
    lr = ctx.w_live.shape[0]
    products = float(((inner + 1) * iters).sum())
    y_fmas = 2 * len(ctx.y_cols)
    flops = 2.0 * 32 * (y_fmas * (len(iters) + products)
                        + lr * (-(-lr // 4) * 4) * products)
    return {"mean_block_iters": float(iters.mean()), "gflop_run": flops / 1e9}


def large_kernel_counts(ctx, n_iter, inner):
    """What the large kernel runs on these lanes, computed from the counts
    (not measured): the iterations of each block (its 8 lanes' largest
    n_iter: a block iterates while any of its lanes does), the GFLOP it runs
    (8 lanes a block, Y on its nonzeros, W on its live block), and the
    operator bytes read from L2 per solve: W's live block once a block for
    each W product, and Y's compressed arrays once a block."""
    lanes, npad = n_iter.shape[0], ctx.npad
    iters = torch.nn.functional.pad(n_iter, (0, -lanes % 8)).view(-1, 8).amax(1).double()
    lr = ctx.w_live.shape[0]
    nnz_y = len(ctx.y_vals)
    w_products = float(((inner + 1) * iters).sum())
    flops = 2.0 * 8 * (nnz_y * (len(iters) + w_products) + lr * lr * w_products)
    y_bytes = 4 * (2 * npad + 1) + 8 * nnz_y
    w_bytes = 4 * lr * lr * w_products
    return {"mean_block_iters": float(iters.mean()), "gflop_run": flops / 1e9,
            "l2_operator_gbytes_computed": (w_bytes + len(iters) * y_bytes) / 1e9}


SOLVER_CASES = ("case69", "case141")
SOLVER_LANES = (512, 4096)   # the zoo's and the CLI sweep's width; the case322 width
SOLVER_F64_TOL = 1e-9        # [solvers] (a): the card's float64 solves against the CPU's
SOLVER_ALL_TOL = 1e-4        # [solvers] (b): the large kernel against its plain version on
                             # every lane (2e-5 on lanes that ran the same iterations)


def solver_surfaces_vs_cpu():
    """``nr_solve(fixed_iter=1 and 10)`` and ``nr_solve_dense`` at case33
    and case69 on the card against the CPU, float64, 64 env-like lanes:
    the largest vm/va difference, and verdicts and counts equal."""
    from mapdn_torch.grid import make_case
    from mapdn_torch.pf import nr_solve, nr_solve_dense

    out = {}
    for case in ("case33", "case69"):
        gc_, lp, lq, pv = make_case(case, dtype=torch.float64, device="cuda")
        gh, *_ = make_case(case, dtype=torch.float64, device="cpu")
        p, q = (x.double() for x in env_injections(gc_, pv, lp, lq, 64))
        runs = {"fixed_iter_1": lambda g, a, b: nr_solve(g, a, b, tol=1e-9, fixed_iter=1),
                "fixed_iter_10": lambda g, a, b: nr_solve(g, a, b, tol=1e-9, fixed_iter=10),
                "dense": lambda g, a, b: nr_solve_dense(g, a, b)}
        for name, run in runs.items():
            card, host = run(gc_, p, q), run(gh, p.cpu(), q.cpu())
            err = max(float((card.vm.cpu() - host.vm).abs().max()),
                      float((card.va.cpu() - host.va).abs().max()))
            if not (torch.equal(card.converged.cpu(), host.converged)
                    and torch.equal(card.n_iter.cpu(), host.n_iter) and err <= SOLVER_F64_TOL):
                raise AssertionError(f"[solvers] {case} {name}: card against CPU {err:.3e}")
            out[f"{case}/{name}"] = {"max_abs_err": err,
                                     "n_converged": int(card.converged.sum()),
                                     "max_n_iter": int(card.n_iter.max())}
    return out


def solver_timings():
    """Each grid of ``SOLVER_CASES`` at each of ``SOLVER_LANES`` env-like
    float32 lanes through ``make_solver(backend="auto")`` (the large
    kernel) and ``backend="torch"``: the median of 20 calls between CUDA
    events, each call the whole solve as the env pays it (pack, solve,
    unpack, the bus and branch results); a flat start (a reset) and a warm
    start from the flat solution of injections 5 % away (a step).  Both
    kernel solves are held against the plain version on the same inputs
    (``large_vs_plain``, ``SOLVER_ALL_TOL`` on every lane)."""
    from mapdn_torch.grid import make_case
    from mapdn_torch.pf import make_solver
    from mapdn_torch.pf.fused_nr import get_ctx, nr_solve_large, nr_solve_large_ref, solver_path

    table = {}
    for case in SOLVER_CASES:
        grid, lp, lq, pv = make_case(case, dtype=torch.float32, device="cuda")
        row = {"n_bus": grid.n_bus, "auto": solver_path(grid.n_bus, "auto")}
        for lanes in SOLVER_LANES:
            p, q = env_injections(grid, pv, lp, lq, lanes)
            gen = torch.Generator(device="cuda").manual_seed(lanes)
            drift = 1.0 + 0.05 * (2 * torch.rand(p.shape, generator=gen, device="cuda") - 1)
            p2, q2 = p * drift, q * drift
            for backend in ("auto", "torch"):
                solve = make_solver(grid, backend=backend)
                nr_solve_large.launches = 0
                flat = solve(p, q)
                warm = solve(p2, q2, flat.vm, flat.va)
                if nr_solve_large.launches != (2 if backend == "auto" else 0):
                    raise AssertionError(f"[solvers] {case} {backend}: "
                                         f"{nr_solve_large.launches} large-kernel launches")
                if not (bool(flat.converged.all()) and bool(warm.converged.all())):
                    raise AssertionError(f"[solvers] {case} {backend} {lanes}: "
                                         "a lane did not converge")
                row[f"{backend}_{lanes}"] = {
                    "flat_ms": cuda_median_ms(lambda: solve(p, q)),
                    "warm_ms": cuda_median_ms(lambda: solve(p2, q2, flat.vm, flat.va)),
                    "flat_mean_n_iter": float(flat.n_iter.double().mean()),
                    "warm_mean_n_iter": float(warm.n_iter.double().mean())}
                if backend == "auto":
                    ctx = get_ctx(grid)
                    what = f"[solvers] {case} {lanes}"
                    row[f"{backend}_{lanes}"]["vs_plain"] = {
                        "flat": large_vs_plain(flat, nr_solve_large_ref(grid, p, q, ctx=ctx),
                                               SOLVER_ALL_TOL, what + " flat"),
                        "warm": large_vs_plain(warm, nr_solve_large_ref(
                            grid, p2, q2, vm0=flat.vm, va0=flat.va, ctx=ctx),
                            SOLVER_ALL_TOL, what + " warm")}
            k, t = row[f"auto_{lanes}"], row[f"torch_{lanes}"]
            row[f"faster_{lanes}"] = ("large" if k["warm_ms"] < t["warm_ms"]
                                      and k["flat_ms"] < t["flat_ms"] else
                                      "torch" if k["warm_ms"] > t["warm_ms"]
                                      and k["flat_ms"] > t["flat_ms"] else "split")
        table[case] = row
    return table


def phase_solvers(smi):
    """The solver surfaces on the card against the CPU, the timings that
    set ``make_solver("auto")``, and the path "auto" picks for each case."""
    from mapdn_torch.grid import make_case
    from mapdn_torch.pf.fused_nr import solver_path

    surfaces = solver_surfaces_vs_cpu()
    timings = solver_timings()
    auto = {case: solver_path(make_case(case, device="cpu")[0].n_bus, "auto")
            for case in ("case33", "case69", "case141", "case322")}
    for case, row in timings.items():
        for lanes in SOLVER_LANES:
            if row[f"faster_{lanes}"] not in ("split", row["auto"]):
                raise AssertionError(f"[solvers] {case} at {lanes} lanes: 'auto' takes "
                                     f"{row['auto']}, {row[f'faster_{lanes}']} is faster")
    say("solvers", f64_vs_cpu=surfaces, f64_tol=SOLVER_F64_TOL, timings=timings,
        auto=auto, card=smi)


def phase_golden():
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.pf.fused_nr import nr_solve_small

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "golden_trajectory.json")
    with open(path) as fh:
        gold = json.load(fh)
    env = make_env("case33", EnvConfig(episode_limit=240, reset_action=False),
                   days=8, seed=0, dtype=torch.float32)
    before = nr_solve_small.launches
    state, obs, gs = env.manual_reset(gold["day"], gold["hour"], gold["quarter"])
    worst = 0.0
    for t in range(gold["n_steps"]):
        a = torch.tensor(gold["actions"][t], dtype=torch.float32, device="cuda")
        out = env.step(state, a[None], add_noise=False)
        state = out.state
        assert not bool(out.terminated[0])
        for got, want, atol in ((out.reward[0], gold["rewards"][t], 2e-4),
                                (out.state.vm[0], gold["vm"][t], 2e-4),
                                (out.obs[0], gold["obs"][t], 5e-4)):
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3, atol=atol)
            worst = max(worst, float(np.abs(got.cpu().numpy() - np.asarray(want)).max()))
    assert nr_solve_small.launches - before == gold["n_steps"] + 1
    say("golden", steps=gold["n_steps"], max_abs_err=worst)


def phase_train(smi):
    from bench_torch import bench_trainer
    from mapdn_torch.pf.fused_nr import nr_solve_small

    t0 = time.perf_counter()
    trainer = bench_trainer(N_LANES)
    trainer.carry, _ = trainer._train_chunk(trainer.carry)   # warm-up chunk
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    stats = trainer.run_episode()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = nr_solve_small.launches
    env_steps = trainer._chunk_len * trainer._chunks_per_episode
    for k, v in stats.items():
        assert math.isfinite(v), (k, v)
    assert launches >= env_steps, (launches, env_steps)
    say("train", n_envs=N_LANES, env_steps=env_steps, kernel_launches=launches,
        env_steps_per_s=env_steps * N_LANES / dt, episode_s=dt,
        chunk_ms=dt / trainer._chunks_per_episode * 1e3,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        setup_s=setup_s, reward=stats["mean_train_reward"],
        value_loss=stats["mean_train_value_loss"],
        policy_loss=stats["mean_train_policy_loss"], card=smi)
    return launches


def case322_flags(alg="mappo"):
    """The flags of train_case322.sh at the lane count of
    scripts/bench_cases.py."""
    return ["--alg", alg, "--mode", "distributed",
            "--scenario", "case322_3min_final", "--voltage-barrier-type", "bowl",
            "--n-envs", str(N_LANES_322)]


def case33_flags(alg):
    """The flags of train_case33.sh at the lane count of
    scripts/train_zoo.py."""
    return ["--alg", alg, "--mode", "distributed",
            "--scenario", "case33_3min_final", "--voltage-barrier-type", "bowl",
            "--n-envs", str(N_LANES_ALGOS)]


def phase_train322(smi, save_path):
    """The case322 path through the CLI, with the flags of train_case322.sh
    at the lane count of scripts/bench_cases.py: one training episode, the
    episode-0 eval and the final save; then a second process-like run that
    restores the checkpoint and trains one more episode.  Its model.pt stays
    under ``save_path`` for ``phase_eval``.

    The large kernel's count is set to 0 before each run and read after it.
    The eval's share is read around each ``PGTrainer.evaluate`` call (the
    eval runs 10 lanes, not 4096), so each run's training launches are its
    count less its eval's.  Returns the resumed run's training launches."""
    from mapdn_torch import train
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.nets.policy_gru import policy_bwd
    from mapdn_torch.pf.fused_nr import nr_solve_large

    evaluate, eval_launches = PGTrainer.evaluate, []

    def counted_evaluate(self):
        before = nr_solve_large.launches
        out = evaluate(self)
        eval_launches.append(nr_solve_large.launches - before)
        return out

    PGTrainer.evaluate = counted_evaluate
    try:
        flags = case322_flags() + ["--save-path", save_path]
        runs = []
        for extra in (["--episodes", "1"], ["--episodes", "2", "--resume"]):
            torch.cuda.reset_peak_memory_stats()
            eval_launches.clear()
            nr_solve_large.launches = policy_bwd.launches = 0
            t0 = time.perf_counter()
            summary = train.main(flags + extra)
            wall = time.perf_counter() - t0
            launches, in_eval = nr_solve_large.launches, sum(eval_launches)
            # the policy epochs' backward through the fused kernels: the
            # warm-up epoch and the graph's capture (its replays launch
            # from the graph)
            assert policy_bwd.launches >= 1, policy_bwd.launches
            trained = len(summary["episode_s"])
            assert trained == 1, summary["episode_s"]
            assert launches - in_eval >= 240 * trained, (launches, in_eval)
            assert in_eval >= 240 * len(summary["eval_s"]), (in_eval, summary["eval_s"])
            for stat in summary["stats"]:
                for k, v in stat.items():
                    assert math.isfinite(v), (k, v)
            runs.append(dict(summary, launches=launches - in_eval,
                             eval_launches=in_eval, policy_launches=policy_bwd.launches,
                             wall_s=wall,
                             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))
        first, second = runs
        assert any(k.startswith("mean_test_") for k in first["stats"][0])
        assert second["start_episode"] == 1 and second["episodes"] == 2
        model_dir = first["model_dir"]
        assert os.path.isfile(os.path.join(model_dir, "model.pt"))
        ckpts = sorted(os.listdir(os.path.join(model_dir, "checkpoint")))
        assert ckpts == ["ckpt_00000001", "ckpt_00000002"], ckpts
        with open(os.path.join(first["tb_dir"], "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        assert [r["step"] for r in logged] == [1, 2], logged
    finally:
        PGTrainer.evaluate = evaluate

    env_steps = first["max_steps"]
    stat0 = first["stats"][0]
    say("train322", n_envs=N_LANES_322, env_steps=env_steps,
        kernel_launches_train=[r["launches"] for r in runs],
        kernel_launches_eval=[r["eval_launches"] for r in runs],
        policy_backward_launches=[r["policy_launches"] for r in runs],
        env_steps_per_s=[env_steps * N_LANES_322 / r["episode_s"][0] for r in runs],
        episode_s=[r["episode_s"][0] for r in runs], eval_s=first["eval_s"],
        save_s=[r["save_s"] for r in runs], restore_s=second["restore_s"],
        wall_s=[r["wall_s"] for r in runs],
        peak_mem_gib=[r["peak_mem_gib"] for r in runs],
        reward=[r["stats"][0]["mean_train_reward"] for r in runs],
        test_reward=stat0["mean_test_reward"],
        value_loss=[r["stats"][0]["mean_train_value_loss"] for r in runs],
        policy_loss=[r["stats"][0]["mean_train_policy_loss"] for r in runs],
        card=smi)
    return second["launches"]


def loss_check(alg, info, **over):
    """[algos] (a): one algorithm's losses and gradients on the card against
    the CPU, both float64 from the same parameters, on one batch (numpy seed
    0, 4 steps x 64 lanes, case33's widths) with the same explicit draws;
    ``over`` overrides the configuration.  Returns the largest relative
    errors of the losses and the gradients (the policy's, the critic's and
    a mixer's)."""
    import copy

    from mapdn_torch.algos import Transition, make_model
    from mapdn_torch.utils.config import load_config

    cfg, _ = load_config(alg, scenario="case33_3min_final", overrides=dict(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], **over))
    n, o, h = cfg.agent_num, cfg.obs_size, cfg.hid_size
    models = {d: make_model(alg, cfg, device=d, param_dtype=torch.float64)
              for d in ("cpu", "cuda")}
    cpu_state = models["cpu"].init_state(torch.Generator().manual_seed(0))
    states = {"cpu": cpu_state, "cuda": models["cuda"].state_from_modules(
        copy.deepcopy(cpu_state.policy), copy.deepcopy(cpu_state.value),
        copy.deepcopy(cpu_state.mixer))}

    rng = np.random.RandomState(0)
    t, l = 4, 64
    b, s = t * l, cfg.sample_size or 1
    done = (rng.rand(t, l) < 0.1).astype(np.float64)
    h_next = h if models["cpu"].stores_next_hidden else 0
    raw = dict(
        state=rng.randn(t, l, n, o), action=rng.uniform(-0.99, 0.99, (t, l, n, 1)),
        log_prob_a=rng.randn(t, l, n, 1) - 1.0, value=rng.randn(t, l, n),
        next_value=rng.randn(t, l, n), reward=np.repeat(rng.randn(t, l, 1), n, -1),
        next_state=rng.randn(t, l, n, o), done=done, last_step=done,
        last_hid=0.3 * rng.randn(t, l, n, h), hid=0.3 * rng.randn(t, l, n, h_next))
    draws = {"target_noise": rng.randn(b, n, 1), "sample_noise": rng.randn(s, b, n, 1),
             "policy_noise": rng.randn(b, n, 1), "next_noise": rng.randn(b, n, 1)}
    for name in ("policy_positions", "value_positions", "next_positions"):
        draws[name] = rng.rand(b, s, n).argsort(-1)

    out = {}
    for d, model in models.items():
        batch = Transition(**{k: torch.tensor(v, device=d) for k, v in raw.items()})
        avail = torch.ones((n, 1), dtype=torch.float64, device=d)
        pl, vl, _ = model.get_loss(states[d], batch, avail, draws=draws)
        grads = []
        parts = [(pl, states[d].policy), (vl, states[d].value)]
        if states[d].mixer is not None:
            parts.append((vl, states[d].mixer))
        for loss, module in parts:
            params = list(module.parameters())
            g = (torch.autograd.grad(loss, params, retain_graph=True) if loss.requires_grad
                 else [torch.zeros_like(p) for p in params])
            grads.append([x.cpu() for x in g])
        out[d] = ([float(pl.detach()), float(vl.detach())], grads)
    (cpu_losses, cpu_grads), (gpu_losses, gpu_grads) = out["cpu"], out["cuda"]
    loss_err = max(abs(a - c) / max(abs(c), 1e-300) for a, c in zip(gpu_losses, cpu_losses))
    for a, c in zip(gpu_losses, cpu_losses):
        assert abs(a - c) <= LOSS_RTOL * abs(c), (alg, gpu_losses, cpu_losses)
    grad_err = 0.0
    for ga, gc in zip(gpu_grads, cpu_grads):
        diff = math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(ga, gc)))
        norm = math.sqrt(sum(float((y ** 2).sum()) for y in gc))
        assert diff <= GRAD_TOL * norm, (alg, diff, norm)
        grad_err = max(grad_err, diff / norm if norm > 0 else 0.0)
    return loss_err, grad_err


def phase_algos(smi, save_root):
    """The case33 sweep's other algorithms, each checked on the card against
    the CPU (``loss_check``) and trained for one episode through the CLI
    with the flags of train_case33.sh at 512 lanes, the episode-0 eval and
    the final save included; the small kernel's count set to 0 before each
    run and read after it, the eval's share read around ``evaluate`` as in
    ``phase_train322``.  Each run saves under ``save_root/<alg>``, where
    ``phase_eval`` finds maac's model.pt.  Every algorithm runs; any
    failure fails the phase after the last."""
    import traceback

    from mapdn_torch import train
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.pf.fused_nr import nr_solve_small

    info = make_env("case33", EnvConfig(), days=8, device="cpu").get_env_info()
    evaluate, eval_launches = PGTrainer.evaluate, []

    def counted_evaluate(self):
        before = nr_solve_small.launches
        out = evaluate(self)
        eval_launches.append(nr_solve_small.launches - before)
        return out

    failed = []
    PGTrainer.evaluate = counted_evaluate
    try:
        for alg in ALGOS:
            t0 = time.perf_counter()
            try:
                loss_err, grad_err = loss_check(alg, info)
                torch.cuda.reset_peak_memory_stats()
                eval_launches.clear()
                nr_solve_small.launches = 0
                summary = train.main(case33_flags(alg) + [
                    "--episodes", "1", "--save-path", os.path.join(save_root, alg)])
                launches, in_eval = nr_solve_small.launches, sum(eval_launches)
                assert len(summary["episode_s"]) == 1, summary["episode_s"]
                assert launches - in_eval >= 240, (launches, in_eval)
                (stat,) = summary["stats"]
                for k, v in stat.items():
                    assert math.isfinite(v), (k, v)
                episode_s = summary["episode_s"][0]
                say("algos", alg=alg, n_envs=N_LANES_ALGOS, env_steps=summary["max_steps"],
                    env_steps_per_s=summary["max_steps"] * N_LANES_ALGOS / episode_s,
                    episode_s=episode_s, eval_s=summary["eval_s"], save_s=summary["save_s"],
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                    kernel_launches_train=launches - in_eval, kernel_launches_eval=in_eval,
                    loss_max_rel_err=loss_err, grad_max_rel_err=grad_err,
                    reward=stat["mean_train_reward"], test_reward=stat["mean_test_reward"],
                    value_loss=stat["mean_train_value_loss"],
                    policy_loss=stat["mean_train_policy_loss"],
                    mixer_loss=stat.get("mean_train_mixer_loss"),
                    wall_s=time.perf_counter() - t0, card=smi)
            except Exception:
                traceback.print_exc()
                say("algos", alg=alg, failed=True)
                failed.append(alg)
    finally:
        PGTrainer.evaluate = evaluate
    if failed:
        raise SystemExit(f"chip_smoke: [algos] failed for {failed}")


def eval_flags(alg, scenario):
    """test.py's flags for a model trained with ``case33_flags`` or
    ``case322_flags`` (the same log name: distributed mode, bowl barrier)."""
    return ["--alg", alg, "--mode", "distributed", "--scenario", scenario,
            "--voltage-barrier-type", "bowl"]


def record_iterations(env):
    """Wrap ``env``'s solver so that each solve's Newton iterations (a
    tensor, one per lane) are appended to the returned list."""
    solve, its = env._solver, []

    def counted(p, q, vm0=None, va0=None):
        res = solve(p, q, vm0, va0)
        its.append(res.n_iter)
        return res

    env._solver = counted
    return its


def vm_against_cpu(vms, iters):
    """One lane's vm, step by step, on the card (``vms["cuda"]``) against
    the CPU: within 1e-4 where both solves of a step took the same
    iterations (``iters``, as ``record_iterations`` gives them), else
    1e-3.  Returns the largest vm differences and the number of steps
    whose iterations differ."""
    its = {d: [int(x) for x in torch.cat(v).cpu()] for d, v in iters.items()}
    gpu, cpu = vms["cuda"], vms["cpu"]
    assert len(gpu) == len(cpu) == len(its["cuda"]) == len(its["cpu"]), (
        len(gpu), len(cpu))
    err = {True: 0.0, False: 0.0}
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        same = its["cuda"][t] == its["cpu"][t]
        d = float(np.abs(g - c).max())
        assert d <= (1e-4 if same else 1e-3), (t, same, d)
        err[same] = max(err[same], d)
    return {"vm_max_abs_err_same_iters": err[True], "vm_max_abs_err_other": err[False],
            "steps_iters_differ": sum(a != b for a, b in zip(its["cuda"], its["cpu"]))}


def single_day_vs_cpu(flags):
    """The single-day record of one model.pt on the card and on the CPU,
    held by ``vm_against_cpu``."""
    from mapdn_torch import test as test_cli

    vms, iters = {}, {}
    for platform in ("cuda", "cpu"):
        args = test_cli.parse_args(flags + ["--platform", platform])
        tester, _, loaded = test_cli.build_tester(args)
        assert loaded
        iters[platform] = record_iterations(tester.env)
        vms[platform] = tester.run(args.test_day, 23, 2)["bus_voltage"]
    return vm_against_cpu(vms, iters)


def phase_eval(smi, work):
    """The eval path: ``mapdn_torch.test.main`` on the model.pt that
    ``phase_algos`` saved for maac (case33) in its three modes and the one
    ``phase_train322`` saved (mappo, case322) in ``single``, run in
    ``work`` (test.py writes its pickle to the working directory).  Each
    mode's kernel count is set to 0 before it and read after it; the env's
    steps and the reward of the lanes still alive are read around
    ``VoltageControlEnv.step``.  Then each single day on the card against
    the CPU (``single_day_vs_cpu``)."""
    from mapdn_torch import test as test_cli
    from mapdn_torch.envs.voltage_control import VoltageControlEnv
    from mapdn_torch.pf.fused_nr import nr_solve_large, nr_solve_small

    step, meter = VoltageControlEnv.step, {}

    def metered_step(self, state, *args, **kw):
        out = step(self, state, *args, **kw)
        alive = (~state.terminated).to(out.reward.dtype)
        meter["steps"] += 1
        meter["lane_steps"] = meter["lane_steps"] + alive.sum()
        meter["reward"] = meter["reward"] + (out.reward * alive).sum()
        return out

    runs = [("case33", "maac", mode, os.path.join(work, "algos", "maac"), nr_solve_small)
            for mode in ("single", "day_sweep", "batch")]
    runs.append(("case322", "mappo", "single", os.path.join(work, "case322"), nr_solve_large))
    cwd = os.getcwd()
    VoltageControlEnv.step = metered_step
    os.chdir(work)
    try:
        for case, alg, mode, save, kernel in runs:
            flags = eval_flags(alg, f"{case}_3min_final") + ["--save-path", save]
            meter.update(steps=0, lane_steps=0.0, reward=0.0)
            kernel.launches = 0
            t0 = time.perf_counter()
            out = test_cli.main(flags + ["--test-mode", mode])
            wall = time.perf_counter() - t0
            launches, steps = kernel.launches, meter["steps"]
            mean_reward = float(meter["reward"] / meter["lane_steps"])
            lane_steps = float(meter["lane_steps"])
            record = out["record"]
            assert out["loaded"] and os.path.isfile(out["out"]), out["out"]
            lanes = {"single": 1, "day_sweep": 28, "batch": 10}[mode]
            # one solve a step and one for the reset (a random reset may retry)
            assert launches == steps + 1 or (mode == "batch" and launches > steps), (
                launches, steps)
            assert math.isfinite(mean_reward)
            extra = {}
            if mode == "single":
                assert len(record["bus_voltage"]) == 480 == steps + 1
                assert all(np.isfinite(x).all() for v in record.values() for x in v)
                extra = single_day_vs_cpu(flags)
            else:
                assert steps == 480
                assert all(math.isfinite(x) for v in record.values() for x in v), record
                if mode == "day_sweep":
                    assert len(record["reward"]) == lanes
                    extra = {"mean_of_day_rewards": float(np.mean(record["reward"]))}
                else:
                    extra = {"q_loss": record["mean_test_q_loss"],
                             "v_out_of_control": record["mean_test_percentage_of_v_out_of_control"]}
            say("eval", case=case, alg=alg, mode=mode, lanes=lanes, seconds=out["seconds"],
                wall_s=wall, steps=steps, lane_steps=lane_steps,
                kernel=kernel.__name__, kernel_launches=launches, mean_reward=mean_reward,
                **extra, card=smi)
    finally:
        VoltageControlEnv.step = step
        os.chdir(cwd)


def phase_bench(smi):
    """``bench_torch.py`` at its defaults, in a process of its own as a user
    runs it; its JSON line held to a finite median, the small kernel on
    every step and ``vs_baseline`` above 1."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py")], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert math.isfinite(line["value"]) and line["value"] > 0, line
    assert line["kernel_launches_per_episode"] >= 240, line
    assert line["vs_baseline"] > 1, line
    assert len(line["episode_s"]) == 8 and line["n_envs"] == N_LANES, line
    say("bench", wall_s=time.perf_counter() - t0, **line)


# the JAX package's 256-episode random baseline on case33
# (artifacts/learning/summary.json)
JAX_RANDOM_REWARD, JAX_RANDOM_RATIO = -0.0814, 0.386


def phase_zoo(smi, work):
    """The zoo's ``maddpg`` run cut to 2 episodes and the learning
    report over its output, in ``work``: the small kernel's count set to 0
    before each and read after it, the training's eval launches read around
    ``PGTrainer.evaluate`` as in ``phase_algos``."""
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.pf.fused_nr import nr_solve_small
    from mapdn_torch.scripts import learning_report, train_zoo

    out, episodes = os.path.join(work, "learning_torch"), 2
    evaluate, eval_launches = PGTrainer.evaluate, []

    def counted_evaluate(self):
        before = nr_solve_small.launches
        res = evaluate(self)
        eval_launches.append(nr_solve_small.launches - before)
        return res

    PGTrainer.evaluate = counted_evaluate
    try:
        nr_solve_small.launches = 0
        t0 = time.perf_counter()
        train_zoo.main(["maddpg", "--episodes", str(episodes), "--out", out,
                        "--work", os.path.join(work, "zoo")])
        zoo_s = time.perf_counter() - t0
        launches, in_eval = nr_solve_small.launches, sum(eval_launches)
    finally:
        PGTrainer.evaluate = evaluate
    with open(os.path.join(out, "maddpg", "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs] == [1, 2], recs
    assert sum("mean_test_reward" in r for r in recs) == 1, recs
    assert (launches - in_eval) / episodes >= 240, (launches, in_eval)

    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    summary = learning_report.main(["--art", out])
    report_s = time.perf_counter() - t0
    report_launches = nr_solve_small.launches
    rnd = summary["random_baseline"]
    assert all(math.isfinite(v) for v in rnd.values()), rnd
    assert report_launches >= 240, report_launches
    assert summary["maddpg"]["n_evals"] == 1
    say("zoo", run="maddpg", episodes=episodes, zoo_s=zoo_s,
        kernel_launches_train_per_episode=(launches - in_eval) / episodes,
        kernel_launches_eval=in_eval, report_s=report_s,
        report_kernel_launches=report_launches,
        random_reward=rnd["mean_test_reward"],
        random_ratio=rnd["mean_test_totally_controllable_ratio"],
        random_sem=summary["random_baseline_sem"],
        jax_random_reward=JAX_RANDOM_REWARD, jax_random_ratio=JAX_RANDOM_RATIO, card=smi)


def phase_examples(smi):
    """``code_examples`` on the card with the small kernel's launches
    counted for each example, then the wrapper's first 24 steps from
    ``manual_reset(0, 0, 0)`` under fixed actions without noise on the card
    against the CPU: vm within 1e-4 where both solves of a step took the
    same iterations, else 1e-3 (``vm_against_cpu``)."""
    from mapdn_torch import code_examples
    from mapdn_torch.envs import EnvConfig, VoltageControlWrapper
    from mapdn_torch.pf.fused_nr import nr_solve_small

    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    total, oo_steps = code_examples.oo_example()
    oo_s = time.perf_counter() - t0
    oo_launches = nr_solve_small.launches
    assert math.isfinite(total) and oo_launches >= oo_steps + 1, (total, oo_launches)

    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    rewards = code_examples.vectorized_example(N_LANES_ALGOS)
    torch.cuda.synchronize()
    vec_s = time.perf_counter() - t0
    vec_launches = nr_solve_small.launches
    assert tuple(rewards.shape) == (code_examples.STEPS, N_LANES_ALGOS)
    assert bool(torch.isfinite(rewards).all()) and vec_launches >= code_examples.STEPS + 1

    vms, iters = {}, {}
    for dev in ("cuda", "cpu"):
        env = VoltageControlWrapper("case33", EnvConfig(episode_limit=240), days=8,
                                    device=dev)
        iters[dev] = record_iterations(env.env)
        actions = np.random.RandomState(0).uniform(
            env.action_space.low, env.action_space.high,
            (code_examples.STEPS, env.env.grid.n_sgen))
        nr_solve_small.launches = 0
        t0 = time.perf_counter()
        env.manual_reset(0, 0, 0)
        vms[dev] = [env._get_res_bus_v()]
        for a in actions:
            reward, _, info = env.step(a, add_noise=False)
            assert math.isfinite(reward) and all(math.isfinite(v) for v in info.values())
            vms[dev].append(env._get_res_bus_v())
        if dev == "cuda":
            wrapper_step_ms = (time.perf_counter() - t0) * 1e3 / (len(actions) + 1)
            launches = nr_solve_small.launches
    assert launches == code_examples.STEPS + 1, launches
    say("examples", oo_steps=oo_steps, oo_kernel_launches=oo_launches, oo_s=oo_s,
        oo_return=total, vectorized_lanes=N_LANES_ALGOS, vectorized_steps=code_examples.STEPS,
        vectorized_kernel_launches=vec_launches, vectorized_s=vec_s,
        vectorized_mean_reward=float(rewards.mean()),
        wrapper_steps=code_examples.STEPS, wrapper_kernel_launches=launches,
        wrapper_ms_per_step=wrapper_step_ms, **vm_against_cpu(vms, iters), card=smi)


def library_trainer(alg, history=1, **over):
    """A case33 trainer at the sweep's 512 lanes built through the library,
    as ``phase_train`` builds bench.py's (neither this port's CLI nor
    train.py has a flag for ``episodic`` or ``shared_params``): the
    algorithm's configuration with ``over``, l1 barrier, 40 synthetic
    days, ``history`` frames an observation, float32, seed 0."""
    from mapdn_torch.algos import make_model
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.utils.config import load_config

    env = make_env("case33", EnvConfig(episode_limit=240, history=history), days=40,
                   dtype=torch.float32)
    info = env.get_env_info()
    cfg, _ = load_config(alg)
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"], n_envs=N_LANES_ALGOS, **over)
    return PGTrainer(cfg, make_model(alg, cfg), env).setup(seed=0)


def counted_episode(trainer, kernel):
    """One ``run_episode`` closed by a synchronize, with ``kernel``'s count
    set to 0 before it: (stats, seconds, launches)."""
    kernel.launches = 0
    t0 = time.perf_counter()
    stats = trainer.run_episode()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, v in stats.items():
        assert math.isfinite(v), (k, v)
    return stats, dt, kernel.launches


def free_memory():
    """Collect what earlier runs left unreachable (a trainer can sit in a
    reference cycle) and restart the peak-memory count from here."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def pool_bytes(replay):
    return sum(getattr(replay.data, name).nbytes for name in vars(replay.data))


KEPT_STEPS = (0, 120, 239)   # steps of the first episode held against the pool


def episode_pool_check(replay, kept):
    """The card's episode pool after two episodes (slots 0 and 1; the clear
    moves the pointer only): the first episode's ``kept`` transitions are in
    slot 0 exactly as the rollout gave them, and ``sample_episodes`` on the
    card gives exactly what it gives on a CPU copy of the two slots for the
    same 32 (slot, lane) draws, as a (T, batch, ...) Transition."""
    from mapdn_torch.learn import replay as rb

    pool = replay.data
    assert sorted(kept) == list(KEPT_STEPS), sorted(kept)
    for t, trans in kept.items():
        for name, x in vars(trans).items():
            buf = getattr(pool, name)
            assert torch.equal(buf[0, t], x.to(buf.dtype)), ("pool write", t, name)
    rng = np.random.RandomState(0)
    draws = (torch.as_tensor(rng.randint(0, 2, 32)),
             torch.as_tensor(rng.randint(0, N_LANES_ALGOS, 32)))
    card = rb.sample_episodes(replay, 32, draws=draws)
    host = rb.sample_episodes(rb.ReplayState(data=pool.map(lambda b: b[:2].cpu()), ptr=0,
                                             size=2), 32, draws=draws)
    assert tuple(card.reward.shape[:2]) == (240, 32), card.reward.shape
    for name, x in vars(card).items():
        assert torch.equal(x.cpu(), getattr(host, name)), ("sample_episodes", name)
    return {"steps_held": list(KEPT_STEPS), "sampled_episodes": 32, "equal": True}


def phase_episodic(smi):
    """coma in episodic mode at 512 lanes (episodes counted by both
    cadences, tests/test_algos.py:171): 2 episodes, the update at the
    second, timed apart around ``_episodic_update``, and the pool cleared
    after it (coma is on-policy); the pool's writes and ``sample_episodes``
    held exactly (``episode_pool_check``); then one eval.  Then one episode of mappo
    in episodic mode, whose pool holds the filled rollout values."""
    from mapdn_torch.pf.fused_nr import nr_solve_small

    over = dict(episodic=True, behaviour_update_freq=2, target_update_freq=4)
    free_memory()
    t0 = time.perf_counter()
    trainer = library_trainer("coma", **over)
    setup_s = time.perf_counter() - t0
    cfg = trainer.cfg
    assert (cfg.max_steps, cfg.replay_buffer_size, cfg.batch_size) == (240, 5000, 32)
    assert (cfg.value_update_epochs, cfg.policy_update_epochs) == (10, 1)
    replay = trainer.carry.replay
    assert tuple(replay.data.reward.shape[:3]) == (10, 240, N_LANES_ALGOS)
    coma_bytes = pool_bytes(replay)

    update = trainer._episodic_update
    update_s = []

    def timed_update(carry, draws=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(carry, draws)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t)
        return out

    # keep copies of a few of the first episode's transitions as the
    # rollout gives them, to hold the pool's step-by-step writes against
    step, calls, kept = trainer._rollout_step, [0], {}

    def kept_step(carry, draws=None):
        out = step(carry, draws)
        if calls[0] in KEPT_STEPS:
            kept[calls[0]] = out[1].map(torch.clone)
        calls[0] += 1
        return out

    trainer._episodic_update, trainer._rollout_step = timed_update, kept_step
    runs = [counted_episode(trainer, nr_solve_small) for _ in range(2)]
    del trainer._episodic_update, trainer._rollout_step
    assert "mean_train_value_loss" not in runs[0][0]
    assert "mean_train_value_loss" in runs[1][0] and len(update_s) == 1
    assert trainer.carry.replay.size == 0 and trainer.carry.replay.ptr == 0
    pool_check = episode_pool_check(trainer.carry.replay, kept)
    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    test = trainer.evaluate()
    eval_s, eval_launches = time.perf_counter() - t0, nr_solve_small.launches
    assert math.isfinite(test["mean_test_reward"])
    coma_peak = torch.cuda.max_memory_allocated() / 2**30
    for _, _, launches in runs:
        assert launches >= 240, launches
    del trainer, replay, update, step, kept

    free_memory()
    mappo = library_trainer("mappo", **over)
    mappo_stats, mappo_s, mappo_launches = counted_episode(mappo, nr_solve_small)
    slot = mappo.carry.replay.data
    assert mappo.carry.replay.size == 1 and mappo_launches >= 240
    assert bool(torch.isfinite(slot.value[0]).all()) and float(slot.value[0].abs().max()) > 0
    assert bool(torch.isfinite(slot.next_value[0]).all())
    say("episodic", alg="coma", n_envs=N_LANES_ALGOS, env_steps=240, setup_s=setup_s,
        episode_s=[r[1] for r in runs], update_s=update_s[0],
        env_steps_per_s=[240 * N_LANES_ALGOS / r[1] for r in runs],
        kernel_launches=[r[2] for r in runs], eval_s=eval_s,
        kernel_launches_eval=eval_launches, pool_slots=10, pool_bytes=coma_bytes,
        pool_check=pool_check,
        peak_mem_gib=coma_peak, reward=[r[0]["mean_train_reward"] for r in runs],
        value_loss=runs[1][0]["mean_train_value_loss"],
        policy_loss=runs[1][0]["mean_train_policy_loss"],
        test_reward=test["mean_test_reward"], mappo_episode_s=mappo_s,
        mappo_kernel_launches=mappo_launches, mappo_pool_bytes=pool_bytes(mappo.carry.replay),
        mappo_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        mappo_reward=mappo_stats["mean_train_reward"], card=smi)


NONSHARED_ALGS = ("coma", "facmaddpg", "iac", "iddpg", "ippo", "maddpg", "mappo", "matd3",
                  "sqddpg")


def phase_nonshared(smi):
    """``shared_params: False``: ``loss_check`` of the nine algorithms that
    take it (tests/test_nonshared.py:21), then one training episode of
    iddpg and mappo at 512 lanes, each agent's largest policy change."""
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.pf.fused_nr import nr_solve_small

    info = make_env("case33", EnvConfig(), days=8, device="cpu").get_env_info()
    errs = {alg: loss_check(alg, info, shared_params=False) for alg in NONSHARED_ALGS}
    train = {}
    for alg in ("iddpg", "mappo"):
        free_memory()
        trainer = library_trainer(alg, shared_params=False)
        before = [p.detach().clone() for p in trainer.carry.algo.policy.parameters()]
        stats, dt, launches = counted_episode(trainer, nr_solve_small)
        moved = torch.stack([(p.detach() - q).flatten(1).abs().amax(1) for p, q in
                             zip(trainer.carry.algo.policy.parameters(), before)]).amax(0)
        assert moved.shape == (info["n_agents"],) and bool((moved > 0).all()), moved
        assert launches >= 240, launches
        train[alg] = dict(episode_s=dt, env_steps_per_s=240 * N_LANES_ALGOS / dt,
                          kernel_launches=launches,
                          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                          policy_moved_min=float(moved.min()),
                          reward=stats["mean_train_reward"],
                          value_loss=stats["mean_train_value_loss"])
    say("nonshared", loss_max_rel_err=max(e[0] for e in errs.values()),
        grad_max_rel_err=max(e[1] for e in errs.values()),
        errs={alg: list(e) for alg, e in errs.items()}, n_envs=N_LANES_ALGOS,
        train=train, card=smi)


# [multigpu] (a): __graft_entry__.py:76-82's five profiles at 8 lanes; the
# sharded runs against one process on the card in float32.  Ranks in step
# with the single process leave its generator exactly where it leaves it and
# launch the small kernel as often; the all-reduce and the smaller per-rank
# products round differently, which RMSprop's first steps (g / sqrt(v))
# carry into the parameters.  So the parameters' change over the run (final
# less initial) is held to the single process's, as the relative L2 of the
# difference of the two changes, to MULTIGPU_PARAM_TOL; the stats to
# MULTIGPU_STAT_RTOL (ranks out of step draw other lanes and move every
# number).  A planted fault, mappo sharded with batchnorm's statistics
# taken over each rank's own rows (an update that is wrong, yet the same on
# both ranks), must read above MULTIGPU_PARAM_TOL, or the check is blind
MULTIGPU_PROFILES = (("maddpg", {}, "episode"), ("mappo", {}, "chunks"),
                     ("facmaddpg", {}, "chunks"), ("coma", {"episodic": True}, "chunks"),
                     ("maddpg", {"mode": "decentralised"}, "chunks"))
MULTIGPU_LANES = 8
MULTIGPU_WORLD = 2
MULTIGPU_PARAM_TOL = 2e-2
MULTIGPU_STAT_RTOL = 1e-2


def multigpu_trainer(alg, sharded, mode="distributed", episodic=False):
    """__graft_entry__.py's ``_build`` on the card (case33, episodes of 16
    steps, chunks of 4, replay 32), set up on seed 0: a
    ``ShardedPGTrainer`` over the process group, or one process's
    ``PGTrainer``."""
    from mapdn_torch.algos import make_model
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.parallel import ShardedPGTrainer
    from mapdn_torch.utils.config import load_config

    env = make_env("case33", EnvConfig(episode_limit=16, mode=mode), days=4,
                   dtype=torch.float32, device="cuda")
    info = env.get_env_info()
    cfg, _ = load_config(alg)
    cfg = cfg.replace(agent_num=info["n_agents"], obs_size=info["obs_shape"],
                      action_dim=info["n_actions"], max_steps=8, behaviour_update_freq=4,
                      batch_size=4, value_update_epochs=2, policy_update_epochs=1,
                      replay_buffer_size=32, n_envs=MULTIGPU_LANES, num_eval_episodes=2,
                      episodic=episodic)
    cls = ShardedPGTrainer if sharded else PGTrainer
    return cls(cfg, make_model(alg, cfg, device="cuda"), env).setup(seed=0)


def learner_params(algo):
    """The learner's parameters (policy, critic, mixer), flattened."""
    modules = [algo.policy, algo.value] + ([algo.mixer] if algo.mixer is not None else [])
    return torch.cat([p.detach().reshape(-1) for m in modules for p in m.parameters()]).cpu()


def multigpu_profile(alg, opts, program, sharded):
    """One profile (two chunks or an episode of two, coma's episodic update,
    an eval): the learner's parameters flattened before and after, the
    stats, and the small kernel's launches in training and in the eval."""
    from mapdn_torch.pf.fused_nr import nr_solve_small

    trainer = multigpu_trainer(alg, sharded, **opts)
    nr_solve_small.launches = 0
    carry = trainer.carry
    init = learner_params(carry.algo)
    if program == "episode":
        carry, stats = trainer._train_episode(carry)
    else:
        carry, _ = trainer._train_chunk(carry)
        carry, stats = trainer._train_chunk(carry)
    if trainer.cfg.episodic:
        carry, upd = trainer._episodic_update(carry)
        stats = {**stats, **upd}
    trainer.carry = carry
    torch.cuda.synchronize()
    train_launches = nr_solve_small.launches
    stats.update(trainer.evaluate())
    return dict(init=init, params=learner_params(carry.algo),
                stats={k: float(v) for k, v in stats.items()},
                generator=carry.generator.get_state(), train_launches=train_launches,
                eval_launches=nr_solve_small.launches - train_launches)


def multigpu_worker(rank, port, out):
    """One gloo rank on the card: every profile, saved to ``out``."""
    from mapdn_torch.parallel import init_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    from mapdn_torch.utils import lanes

    init_process_group(f"localhost:{port}", MULTIGPU_WORLD, rank, "gloo")
    try:
        runs = [multigpu_profile(alg, opts, program, True)
                for alg, opts, program in MULTIGPU_PROFILES]
        # the planted fault: batchnorm sees no shard, so it standardizes over
        # this rank's rows alone
        current, lanes.current = lanes.current, lambda: None
        try:
            runs.append(multigpu_profile("mappo", {}, "chunks", True))
        finally:
            lanes.current = current
        torch.save(runs, out)
    finally:
        torch.distributed.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(argv_of, world, timeout=600):
    """Start ``world`` processes (``argv_of(rank)``) and wait for all; as
    soon as one fails, stop the others (a rank left alone waits in a
    collective until its timeout) and raise with its output; returns the
    outputs."""
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(argv_of(r), stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p in procs) and time.monotonic() < deadline
               and not any(p.returncode for p in procs)):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def cli_rank(argv):
    """``mapdn_torch.train.main(argv)`` in this process (one rank of
    ``nccl_ranks``): one ``RESULT`` line with its episode seconds, final
    policy L1 and world size."""
    from mapdn_torch import train

    out = train.main(argv)
    print("RESULT " + json.dumps({k: out[k] for k in (
        "episode_s", "final_policy_param_l1", "world_size")}), flush=True)


def nccl_ranks(flags, world, work, tag):
    """``world`` ranks of the training CLI over NCCL, one card each, as
    worker processes of this script: each rank's ``RESULT``."""
    port = free_port()
    outs = run_ranks(lambda r: [sys.executable, os.path.abspath(__file__), "--cli-rank",
                                *flags, "--distributed", "--coordinator", f"localhost:{port}",
                                "--num-processes", str(world), "--process-id", str(r),
                                "--save-path", os.path.join(work, f"{tag}_r{r}")], world)
    return [json.loads(line.split(" ", 1)[1]) for out in outs
            for line in out.splitlines() if line.startswith("RESULT ")]


def final_l1(out):
    lines = [l for l in out.splitlines() if l.startswith("final_policy_param_l1")]
    assert len(lines) == 1, out[-2000:]
    return float(lines[0].split()[-1])


def change_rel_err(run, ref):
    """The relative L2 distance of ``run``'s parameter change (final less
    initial) from ``ref``'s."""
    change = ref["params"] - ref["init"]
    return float(((run["params"] - run["init"]) - change).norm() / change.norm())


def phase_multigpu(smi, work):
    """(a) the five profiles as 2 gloo ranks sharing the card, against one
    process on the card; (b) one 512-lane mappo episode through
    ``python -m mapdn_torch.train --distributed`` at world size 1 over NCCL,
    against the CLI without it; (c) 2 NCCL ranks where there are 2 cards."""
    from mapdn_torch import train

    t0 = time.perf_counter()
    outs = [os.path.join(work, f"multigpu_rank{r}.pt") for r in range(MULTIGPU_WORLD)]
    port = free_port()
    procs_argv = lambda r: [sys.executable, os.path.abspath(__file__), "--multigpu-worker",
                            str(r), str(port), outs[r]]
    single = [multigpu_profile(alg, opts, program, False)
              for alg, opts, program in MULTIGPU_PROFILES]
    run_ranks(procs_argv, MULTIGPU_WORLD)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    profiles = {}
    for i, (alg, opts, program) in enumerate(MULTIGPU_PROFILES):
        name = "+".join([alg] + [f"{k}={v}" for k, v in opts.items()]
                        + ([program] if program == "episode" else []))
        ref, r0, r1 = single[i], ranks[0][i], ranks[1][i]
        if not torch.equal(r0["params"], r1["params"]):
            raise AssertionError(f"[multigpu] {name}: the ranks' parameters differ")
        param_err = float((r0["params"] - ref["params"]).abs().max())
        param_rel = change_rel_err(r0, ref)
        stat_err = max(abs(r0["stats"][k] - v) / max(abs(v), 1e-6)
                       for k, v in ref["stats"].items())
        if r0["stats"] != r1["stats"] or set(r0["stats"]) != set(ref["stats"]):
            raise AssertionError(f"[multigpu] {name}: the ranks' stats differ")
        launches = [r["train_launches"] for r in (r0, r1)]
        in_step = all(torch.equal(r["generator"], ref["generator"]) for r in (r0, r1))
        if not in_step or param_rel > MULTIGPU_PARAM_TOL or stat_err > MULTIGPU_STAT_RTOL or any(
                n != ref["train_launches"] for n in launches):
            raise AssertionError(f"[multigpu] {name}: generators in step {in_step}, params "
                                 f"{param_rel:.3e}, stats {stat_err:.3e}, launches "
                                 f"{launches} against {ref['train_launches']}")
        change = ref["params"] - ref["init"]
        profiles[name] = dict(param_max_abs_err=param_err, param_change_rel_l2=param_rel,
                              param_change_l2=float(change.norm()),
                              param_change_share=float(change.norm() / ref["params"].norm()),
                              stat_max_rel_err=stat_err,
                              nr_small_launches_per_rank=launches,
                              nr_small_launches_single=ref["train_launches"],
                              eval_launches_per_rank=[r0["eval_launches"], r1["eval_launches"]],
                              reward=ref["stats"]["mean_train_reward"])
    planted = change_rel_err(ranks[0][len(MULTIGPU_PROFILES)],
                             single[[a for a, *_ in MULTIGPU_PROFILES].index("mappo")])
    if planted <= MULTIGPU_PARAM_TOL:
        raise AssertionError(f"[multigpu] a planted fault (batchnorm over each rank's "
                             f"rows) reads {planted:.3e}, within {MULTIGPU_PARAM_TOL}")
    gloo_s = time.perf_counter() - t0

    # (b) the NCCL code on the card: world size 1
    t0 = time.perf_counter()
    flags = ["--alg", "mappo", "--n-envs", str(N_LANES_ALGOS), "--episodes", "1"]
    port = free_port()
    nccl_out = run_ranks(lambda r: [sys.executable, "-m", "mapdn_torch.train", *flags,
                                    "--distributed", "--coordinator", f"localhost:{port}",
                                    "--num-processes", "1", "--process-id", "0",
                                    "--save-path", os.path.join(work, "nccl1")], 1)[0]
    plain = train.main(flags + ["--save-path", os.path.join(work, "nccl1_plain")])
    nccl_l1, plain_l1 = final_l1(nccl_out), plain["final_policy_param_l1"]
    if "ranks=1" not in nccl_out or abs(nccl_l1 - plain_l1) > 1e-5 * abs(plain_l1):
        raise AssertionError(f"[multigpu] NCCL world 1: {nccl_l1} against {plain_l1}")
    nccl = dict(world_size=1, final_policy_param_l1=nccl_l1, plain_l1=plain_l1,
                seconds=time.perf_counter() - t0)

    # (c) NCCL ranks on several cards, one a card
    cards = torch.cuda.device_count()
    if cards >= 2:
        l1s = [r["final_policy_param_l1"] for r in nccl_ranks(flags, cards, work, "ncclN")]
        if len(set(l1s)) != 1:
            raise AssertionError(f"[multigpu] NCCL {cards} ranks: {l1s}")
        nccl2 = dict(world_size=cards, final_policy_param_l1=l1s)
    else:
        nccl2 = f"not run: {cards} card (NCCL takes one card a rank)"
    say("multigpu", world_size=MULTIGPU_WORLD, backend="gloo", n_envs=MULTIGPU_LANES,
        param_tol=MULTIGPU_PARAM_TOL, stat_rtol=MULTIGPU_STAT_RTOL, profiles=profiles,
        planted_fault_param_change_rel_l2=planted,
        gloo_s=gloo_s, nccl_world1=nccl, nccl_world2=nccl2, card=smi)


SCALING_LANES = 4096   # [multigpu_scaling]: the case33 lanes, split over the cards


def phase_multigpu_scaling(smi, work, episodes=3):
    """Run alone on a machine of several cards (``main`` needs one): the
    CLI's case33 MAPPO at ``SCALING_LANES`` lanes for ``episodes`` episodes,
    first as one process on one card, then as one NCCL rank on each card
    (the lanes split); the episode seconds, env-steps/s over the episodes
    after the first (the slowest rank's), and the ranks' final policy L1,
    equal to each other, beside one process's."""
    from mapdn_torch import train

    flags = ["--alg", "mappo", "--n-envs", str(SCALING_LANES), "--episodes", str(episodes)]
    single = train.main(flags + ["--save-path", os.path.join(work, "scale1")])
    cards = torch.cuda.device_count()
    ranks = nccl_ranks(flags, cards, work, "scaleN")
    l1s = [r["final_policy_param_l1"] for r in ranks]
    if len(ranks) != cards or len(set(l1s)) != 1:
        raise AssertionError(f"[multigpu_scaling] the ranks' policies differ: {l1s}")
    t1 = float(np.median(single["episode_s"][1:]))
    tn = float(np.median([max(r["episode_s"][e] for r in ranks)
                          for e in range(1, episodes)]))
    say("multigpu_scaling", cards=cards, n_envs=SCALING_LANES, episodes=episodes,
        single_episode_s=single["episode_s"], rank_episode_s=[r["episode_s"] for r in ranks],
        single_env_steps_per_s=240 * SCALING_LANES / t1,
        sharded_env_steps_per_s=240 * SCALING_LANES / tn, speedup=t1 / tn,
        single_l1=single["final_policy_param_l1"], ranks_l1=l1s[0],
        l1_rel_diff=abs(l1s[0] - single["final_policy_param_l1"])
        / abs(single["final_policy_param_l1"]), card=smi)


def phase_profiling(smi, work):
    """``device_trace`` around one 512-lane case33 MAPPO chunk after a
    warm-up chunk, under an active ``Tracer``: the Chrome trace names the
    small kernel, and each kernel inside a ``pf.solve`` range of the
    program's; ``PhaseTimer`` times set-up and both chunks."""
    from mapdn_torch.pf.fused_nr import nr_solve_small
    from mapdn_torch.utils.profiling import PhaseTimer, Tracer, device_trace, tracing

    timer = PhaseTimer()
    with timer.phase("setup"):
        trainer = library_trainer("mappo")
    with timer.phase("chunk", block_on=trainer.carry.obs):
        carry, stats = trainer._train_chunk(trainer.carry)
    nr_solve_small.launches = 0
    tracer = Tracer()
    with tracing(tracer), device_trace(os.path.join(work, "trace")) as prof:
        with timer.phase("chunk_traced", block_on=stats):
            carry, stats = trainer._train_chunk(carry)
    launches = nr_solve_small.launches
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    kernel = [e for e in events if e.get("cat") == "kernel"
              and "nr_small_kernel" in e.get("name", "")]
    if not kernel or not launches:
        raise AssertionError(f"[profiling] the trace names {len(kernel)} nr_small "
                             f"kernels, the wrapper counted {launches} launches")
    # the program's pf.solve ranges on the host, and the launches inside them
    solves = [e for e in events if e.get("name") == "pf.solve" and e.get("cat") == "user_annotation"
              and "dur" in e]
    launch_ops = [e for e in events if e.get("cat") == "cuda_runtime" and "dur" in e
                  and "Launch" in e.get("name", "")]
    in_solve = sum(any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in solves)
                   for e in launch_ops)
    summary = tracer.summary()
    solve = summary["spans"].get("pf.solve", {})
    if len(solves) != launches or solve.get("calls") != launches or not in_solve:
        raise AssertionError(f"[profiling] {len(solves)} pf.solve ranges in the trace, "
                             f"{solve.get('calls')} spans, {launches} launches, "
                             f"{in_solve} launches inside a pf.solve range")
    busy_ms = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3
    say("profiling", trace_mb=os.path.getsize(prof.trace_path) / 1e6,
        nr_small_kernel_events=len(kernel), nr_small_launches=launches,
        nr_small_device_ms=sum(e.get("dur", 0) for e in kernel) / 1e3,
        kernel_events=sum(e.get("cat") == "kernel" for e in events),
        kernel_busy_ms=busy_ms, phases=timer.summary(), pf_solve_ranges=len(solves),
        launches_in_pf_solve=in_solve, pf_solve_host_ms=1e3 * solve["host_s"] / solve["calls"],
        pf_solve_stream_ms=1e3 * solve["stream_s"] / solve["calls"], card=smi)


# [traditional]: the card (float32) against the CPU (float64) on the same
# rows.  Droop: per-lane iterations within 1, vm within the eval's 1e-4, q
# within this share of each inverter's capacity.  OPF: the batch objective
# (opf.py's scalar, the lanes' sum) within 1e-3 relative, and each lane's
# card q, evaluated at float64 on the CPU, within 1e-3 relative of the
# CPU's objective.  A lane's objective evaluated in float32 is not held
# lane by lane: its loss of a few kW is the difference of branch flows of
# MW, which float32 resolves to about a percent on the smallest lanes.
DROOP_Q_TOL = 1e-3
OPF_REL_TOL = 1e-3


def phase_traditional(smi):
    """The droop and OPF baselines over the learning report's 256 case33
    rows on the card against the CPU (float64), the small kernel's launches
    counted around droop (one solve a fixed-point iteration, while any lane
    iterates, and the first); then the report's ``engineering_baselines``
    on the card beside the JAX package's committed values."""
    from mapdn_torch.pf.fused_nr import nr_solve_small
    from mapdn_torch.scripts.learning_report import baseline_points, engineering_baselines
    from mapdn_torch.traditional import droop_solve, opf_solve
    from mapdn_torch.traditional.opf import opf_objective

    runs, seconds, launches = {}, {}, {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        points = baseline_points(n_samples=N_LANES_RANDOM, device=dev, dtype=dtype)
        for name, solver in (("droop", droop_solve), ("opf", opf_solve)):
            nr_solve_small.launches = 0
            t0 = time.perf_counter()
            runs[dev, name] = solver(*points)
            if dev == "cuda":
                torch.cuda.synchronize()
                seconds[name] = time.perf_counter() - t0
                launches[name] = nr_solve_small.launches
        runs[dev] = points
    cpu_env, lp, lq, pv = runs["cpu"]
    cap = torch.sqrt(torch.clamp(cpu_env.ts.s_max**2 - pv**2, min=0.0))
    host = lambda x: x.double().cpu()

    (q, res, it), (q64, res64, it64) = runs["cuda", "droop"], runs["cpu", "droop"]
    assert bool(res.converged.all()) and bool(res64.converged.all())
    iter_diff = int((host(it) - it64).abs().max())
    vm_err = float((host(res.vm) - res64.vm).abs().max())
    q_err = float(((host(q) - q64).abs() / cap).max())
    assert iter_diff <= 1 and vm_err <= 1e-4 and q_err <= DROOP_Q_TOL, (iter_diff, vm_err, q_err)
    assert launches["droop"] == int(it.max()) + 1, (launches["droop"], int(it.max()))

    (oq, ores, trace), (oq64, _, trace64) = runs["cuda", "opf"], runs["cpu", "opf"]
    assert trace.shape == (N_LANES_RANDOM, 150) and bool(ores.converged.all())
    assert bool((oq.abs() <= cap.to(oq) * (1 + 1e-6)).all())
    assert bool((trace[:, -1] <= trace[:, 0]).all())
    batch_rel = float((host(trace[:, -1]).sum() - trace64[:, -1].sum()).abs()
                      / trace64[:, -1].sum())
    at64 = opf_objective(cpu_env, lp, lq, pv, host(oq))
    lane_rel = float(((at64 - trace64[:, -1]).abs() / trace64[:, -1].abs()).max())
    f32_lane_rel = float(((host(trace[:, -1]) - trace64[:, -1]).abs()
                          / trace64[:, -1].abs()).max())
    assert batch_rel <= OPF_REL_TOL and lane_rel <= OPF_REL_TOL, (batch_rel, lane_rel)

    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    base = engineering_baselines(n_samples=N_LANES_RANDOM)
    report_s = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                           "learning", "summary.json")) as fh:
        jax_base = json.load(fh)
    stats = {}
    for key in ("droop_baseline", "opf_baseline"):
        assert base[key]["n_samples"] == N_LANES_RANDOM, base[key]
        assert all(math.isfinite(v) for v in base[key].values()), base[key]
        for stat, short in (("mean_test_reward", "reward"),
                            ("mean_test_totally_controllable_ratio", "ratio")):
            stats[f"{key[:-9]}_{short}"] = base[key][stat]
            stats[f"jax_{key[:-9]}_{short}"] = jax_base[key][stat]
    say("traditional", lanes=N_LANES_RANDOM, droop_s=seconds["droop"],
        droop_kernel_launches=launches["droop"], droop_max_n_iter=int(it.max()),
        droop_min_n_iter=int(it.min()), droop_n_iter_max_diff=iter_diff,
        droop_vm_max_abs_err=vm_err, droop_q_max_err_per_cap=q_err, opf_s=seconds["opf"],
        opf_kernel_launches=launches["opf"], opf_batch_objective_rel_err=batch_rel,
        opf_lane_objective_rel_err_at_f64=lane_rel,
        opf_lane_objective_rel_err_f32=f32_lane_rel,
        report_s=report_s, report_kernel_launches=nr_solve_small.launches, **stats, card=smi)


def feeder_net():
    """tests/test_converter.py's mock pandapower net (``make_mock_net``): a
    5-bus MV feeder, a 110 kV slack at label 7 -> a 25 MVA transformer
    tapped +2 -> 12.66 kV radial lines (one doubled) with zones, loads and
    sgens, as pandas tables with pandapower's columns."""
    from types import SimpleNamespace

    import pandas as pd

    bus = pd.DataFrame(
        {"vn_kv": [110.0, 12.66, 12.66, 12.66, 12.66],
         "zone": ["main", "main", "zone1", "zone1", "zone2"]},
        index=[7, 3, 11, 12, 15])
    ext_grid = pd.DataFrame({"bus": [7], "vm_pu": [1.02]})
    line = pd.DataFrame({
        "from_bus": [3, 11, 11], "to_bus": [11, 12, 15],
        "length_km": [1.2, 0.7, 2.0], "r_ohm_per_km": [0.4, 0.3, 0.5],
        "x_ohm_per_km": [0.35, 0.25, 0.4], "c_nf_per_km": [210.0, 150.0, 100.0],
        "max_i_ka": [0.3, 0.25, 0.2], "parallel": [1, 2, 1]})
    trafo = pd.DataFrame({
        "hv_bus": [7], "lv_bus": [3], "vn_hv_kv": [110.0], "vn_lv_kv": [12.5],
        "sn_mva": [25.0], "vk_percent": [11.0], "vkr_percent": [0.42],
        "tap_pos": [2], "tap_neutral": [0], "tap_step_percent": [1.5]})
    load = pd.DataFrame({"bus": [11, 12, 15], "p_mw": [1.5, 0.8, 1.1],
                         "q_mvar": [0.5, 0.25, 0.3]})
    sgen = pd.DataFrame({"bus": [12, 15], "p_mw": [0.6, 0.9], "name": ["zone1", "zone2"]})
    return SimpleNamespace(sn_mva=1.0, f_hz=50.0, bus=bus, ext_grid=ext_grid,
                           line=line, trafo=trafo, load=load, sgen=sgen)


# [converter]: the feeder's float32 solve on the card against the float64
# oracle of tests/fixtures/golden_feeder.json (vm, va and the total loss of
# every branch, the transformer's included, in MW); on an H100 the kernel
# read 1.5e-6, 6.7e-7 and 8.0e-6 there
FEEDER_GOLDEN_TOL = 1e-5
FEEDER_LANES = 256


def phase_converter(smi):
    """The five-bus feeder imported onto the card and solved through
    ``make_solver`` ("auto": the small kernel, its first grid with a tap
    ratio off 1 and two voltage levels): lane 0 at the feeder's base
    injections against the golden fixture, and every lane (the injections
    scaled 0.5-1.5) against the kernel's plain version on the same inputs
    with ``[kernel]``'s tolerances."""
    from mapdn_torch.grid.converter import from_pandapower
    from mapdn_torch.pf.fused_nr import make_solver, nr_solve_small, nr_solve_small_ref

    t0 = time.perf_counter()
    grid, load_p, load_q, sgen_p = from_pandapower(feeder_net(), name="feeder",
                                                   device="cuda")
    import_s = time.perf_counter() - t0
    assert grid.device.type == "cuda" and grid.n_bus == 5
    tap = grid.tap.cpu().numpy()
    assert abs(tap[3] - 1.0) > 1e-2 and len(set(grid.vn_kv.tolist())) == 2, tap
    n = grid.n_bus
    p, q = np.zeros(n), np.zeros(n)
    np.add.at(p, grid.load_bus.cpu().numpy(), -load_p)
    np.add.at(q, grid.load_bus.cpu().numpy(), -load_q)
    np.add.at(p, grid.sgen_bus.cpu().numpy(), sgen_p)
    scale = np.concatenate([[1.0], np.linspace(0.5, 1.5, FEEDER_LANES - 1)])[:, None]
    as_t = lambda x: torch.as_tensor(x * scale / grid.sn_mva, dtype=torch.float32,
                                     device="cuda")
    p_t, q_t = as_t(p), as_t(q)

    solve = make_solver(grid)
    nr_solve_small.launches = 0
    res = solve(p_t, q_t)
    torch.cuda.synchronize()
    launches = nr_solve_small.launches
    assert launches == 1, launches
    ref = nr_solve_small_ref(grid, p_t, q_t)
    assert bool(res.converged.all()) and bool((res.converged == ref.converged).all())
    same = res.n_iter == ref.n_iter
    assert int((res.n_iter - ref.n_iter).abs().max()) <= 1
    err = torch.maximum((res.vm - ref.vm).abs().amax(1), (res.va - ref.va).abs().amax(1))
    worst_same = float(err[same].max()) if bool(same.any()) else 0.0
    assert worst_same <= 2e-5 and float(err.max()) <= 1e-4, (worst_same, float(err.max()))

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "golden_feeder.json")) as fh:
        gold = json.load(fh)
    vm_err = float(np.abs(res.vm[0].double().cpu().numpy() - gold["vm"]).max())
    va_err = float(np.abs(res.va[0].double().cpu().numpy() - gold["va"]).max())
    loss_err = abs(float(res.pl_mw[0].double().sum()) - gold["total_loss_mw"])
    assert max(vm_err, va_err, loss_err) <= FEEDER_GOLDEN_TOL, (vm_err, va_err, loss_err)
    say("converter", n_bus=n, tap=float(tap[3]), lanes=FEEDER_LANES, import_s=import_s,
        kernel_launches=launches, n_iter=int(res.n_iter[0]),
        max_abs_err_vs_plain_same_iters=worst_same, max_abs_err_vs_plain=float(err.max()),
        golden_vm_err=vm_err, golden_va_err=va_err, golden_total_loss_mw_err=loss_err,
        golden_tol=FEEDER_GOLDEN_TOL, card=smi)


MAX_FRAMES = 48   # render_record's default


def phase_render(smi, work):
    """``mapdn_torch.test.main --test-mode single --render`` in ``work`` on
    the maac model.pt of ``phase_algos``: the day's small-kernel launches
    (a reset and 479 steps), then its frames and GIF, their seconds apart
    from the day's.  Where matplotlib is not installed, ``--render`` must
    raise an ImportError naming it, after the day's pickle is written."""
    import importlib.util

    from mapdn_torch import test as test_cli
    from mapdn_torch.envs import rendering
    from mapdn_torch.pf.fused_nr import nr_solve_small

    flags = eval_flags("maac", "case33_3min_final") + [
        "--save-path", os.path.join(work, "algos", "maac"), "--test-mode", "single",
        "--render"]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    has_pil = importlib.util.find_spec("PIL") is not None
    log_name = "var_voltage_control-case33_3min_final-distributed-maac-bowl"
    pickle_path = os.path.join(work, f"test_record_{log_name}_day10.pickle")
    if os.path.exists(pickle_path):
        os.remove(pickle_path)      # phase_eval wrote the same day's record
    render_record, draw_s = rendering.render_record, []

    def timed_render_record(*args, **kw):
        t0 = time.perf_counter()
        paths = render_record(*args, **kw)
        draw_s.append(time.perf_counter() - t0)
        return paths

    cwd = os.getcwd()
    os.chdir(work)
    rendering.render_record = timed_render_record
    nr_solve_small.launches = 0
    t0 = time.perf_counter()
    try:
        if has_mpl:
            out = test_cli.main(flags)
        else:
            try:
                test_cli.main(flags)
            except ImportError as e:
                assert "matplotlib" in str(e), e
            else:
                raise AssertionError("--render ran without matplotlib")
    finally:
        rendering.render_record = render_record
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    launches = nr_solve_small.launches
    assert launches == 480, launches
    assert os.path.isfile(pickle_path), pickle_path
    if not has_mpl:
        say("render", matplotlib="absent", pillow="present" if has_pil else "absent",
            import_error_after_pickle=True, kernel_launches=launches, wall_s=wall, card=smi)
        return
    frames = [os.path.join(work, path) for path in out["frames"]]
    assert out["loaded"] and 0 < len(frames) <= MAX_FRAMES, len(frames)
    for path in frames:
        with open(path, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n", path
    gif = os.path.join(os.path.dirname(frames[0]), "replay.gif")
    assert os.path.isfile(gif) == has_pil, gif
    say("render", matplotlib="present", frames=len(frames), gif=os.path.isfile(gif),
        day_s=out["seconds"], draw_s=draw_s[0], wall_s=wall, kernel_launches=launches,
        card=smi)


DISCRETE_SHAPE = (512, 6, 5)   # lanes, agents, actions
DISCRETE_TOL = 1e-5            # float32 card against CPU: probabilities, log densities
DISCRETE_GRAD_TOL = 1e-4       # a gradient's difference over its largest entry


class DiscreteCfg:
    """The config fields ``select_action_discrete`` reads."""
    def __init__(self, epsilon_softmax=False, gumbel_softmax=False, softmax_eps=0.1):
        self.epsilon_softmax = epsilon_softmax
        self.gumbel_softmax = gumbel_softmax
        self.softmax_eps = softmax_eps


def _grad(loss, x):
    """d loss / d x; zeros where the loss has no graph (a detached sample),
    as ``jax.grad`` gives."""
    return (torch.autograd.grad(loss, x, retain_graph=True)[0] if loss.requires_grad
            else torch.zeros_like(x))


def discrete_calls(logits, u, index, weights):
    """Every discrete helper on ``logits``'s device with the given draws:
    {name: (output, gradients or None)}; a branch of
    ``select_action_discrete`` gives the gradients by logits of
    sum(weights * actions) and of sum(log_prob)."""
    from mapdn_torch.learn import sampling

    out = {"categorical_entropy": (sampling.categorical_entropy(logits), None),
           "multinomials_log_density": (sampling.multinomials_log_density(
               torch.softmax(weights, -1), logits), None)}
    for t in (0.1, 1.0):
        out[f"gumbel_softmax_sample_T{t}"] = (
            sampling.gumbel_softmax_sample(logits, t, u=u), None)
    tied = logits.clone()
    tied[0, 0, 1] = tied[0, 0, 0] = tied[0, 0].max()      # a tie at the top
    greedy, lp = sampling.select_action_discrete(DiscreteCfg(), tied, status="test")
    assert lp is None and float(greedy[0, 0, :2].sum()) == 2.0
    out["test_greedy"] = (greedy, None)
    for name, cfg, draws, exploration in (
            ("epsilon_softmax", DiscreteCfg(epsilon_softmax=True, softmax_eps=0.1), index, True),
            ("plain", DiscreteCfg(), index, True),
            ("gumbel_rsample", DiscreteCfg(gumbel_softmax=True), u, True),
            ("gumbel_detached", DiscreteCfg(gumbel_softmax=True), u, False)):
        lg = logits.detach().clone().requires_grad_(True)
        a, lp = sampling.select_action_discrete(cfg, lg, exploration=exploration, draws=draws)
        grads = {"actions": _grad(torch.sum(weights * a), lg),
                 "log_prob": _grad(torch.sum(lp), lg)}
        out[name] = (torch.cat([a.detach(), lp.detach()], -1), grads)
    return out


def phase_discrete(smi):
    """The discrete-action helpers on the card against the CPU on the same
    inputs and draws (numpy seed 0); the Gumbel rsample's gradient against
    the CPU's, the detached sample's zero; then the card's own draws."""
    from mapdn_torch.learn import sampling

    rng = np.random.default_rng(0)
    logits = rng.normal(size=DISCRETE_SHAPE).astype(np.float32) * 2.0
    u = rng.uniform(size=DISCRETE_SHAPE).astype(np.float32)
    index = rng.integers(0, DISCRETE_SHAPE[-1], size=DISCRETE_SHAPE[:-1])
    weights = rng.normal(size=DISCRETE_SHAPE).astype(np.float32)
    t0 = time.perf_counter()
    card_out = discrete_calls(*(torch.as_tensor(x, device="cuda") for x in
                                (logits, u, index, weights)))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host_out = discrete_calls(*(torch.as_tensor(x) for x in (logits, u, index, weights)))
    errors = {}
    for name, (value, grad) in host_out.items():
        cvalue, cgrad = card_out[name]
        err = float((cvalue.cpu() - value).abs().max())
        assert err <= DISCRETE_TOL * max(1.0, float(value.abs().max())), (name, err)
        errors[name] = err
        for which, g in (grad or {}).items():
            cg = cgrad[which].cpu()
            if which == "actions" and name != "gumbel_rsample":
                # a one-hot draw or a detached sample: no gradient
                assert not bool(g.any()) and not bool(cg.any()), (name, which)
                continue
            scale, gerr = float(g.abs().max()), float((cg - g).abs().max())
            assert scale > 0 and gerr <= DISCRETE_GRAD_TOL * scale, (name, which, gerr, scale)
            errors[f"{name}_grad_{which}"] = gerr
    gen = torch.Generator(device="cuda").manual_seed(0)
    lg = torch.as_tensor(logits, device="cuda")
    for cfg in (DiscreteCfg(epsilon_softmax=True), DiscreteCfg(),
                DiscreteCfg(gumbel_softmax=True)):
        a, lp = sampling.select_action_discrete(cfg, lg, generator=gen)
        assert a.device.type == "cuda" and tuple(lp.shape) == DISCRETE_SHAPE[:-1] + (1,)
        assert bool(torch.isfinite(lp).all())
        assert bool(torch.allclose(a.sum(-1), torch.ones_like(a[..., 0])))
    say("discrete", shape=list(DISCRETE_SHAPE), dtype="float32", max_abs_err=errors,
        tol=DISCRETE_TOL, grad_tol=DISCRETE_GRAD_TOL, card_calls_s=card_s, card=smi)


HISTORY = 3


def phase_history(smi):
    """One 512-lane case33 iddpg episode with ``history=3``: at least 240
    small-kernel launches, finite stats, and every step's obs equal to the
    card's own base frames stacked by hand (two zero frames and the fresh
    frame on a lane that auto-reset)."""
    from mapdn_torch.pf.fused_nr import nr_solve_small

    free_memory()
    trainer = library_trainer("iddpg", history=HISTORY)
    env = trainer.env
    n, base = env.n_agents, env.obs_base_size
    assert trainer.cfg.obs_size == HISTORY * base
    frames = trainer.carry.obs.reshape(N_LANES_ALGOS, n, HISTORY, base).clone()
    step = env.batched_auto_reset_step
    held = {"steps": 0, "equal": True,
            "resets": torch.zeros((), dtype=torch.int64, device="cuda")}

    def stacked_step(states, *args, **kw):
        out = step(states, *args, **kw)
        newest = env._base_obs(out.state)[:, :, None]
        rolled = torch.cat([frames[:, :, 1:], newest], 2)
        fresh = torch.cat([torch.zeros_like(frames[:, :, 1:]), newest], 2)
        frames.copy_(torch.where(out.terminated[:, None, None, None], fresh, rolled))
        held["equal"] = held["equal"] and torch.equal(out.obs,
                                                      frames.reshape(N_LANES_ALGOS, n, -1))
        held["resets"] += out.terminated.sum()
        held["steps"] += 1
        return out

    env.batched_auto_reset_step = stacked_step
    try:
        stats, dt, launches = counted_episode(trainer, nr_solve_small)
    finally:
        del env.batched_auto_reset_step
    resets = int(held["resets"])
    assert held["steps"] == 240 and held["equal"], held
    assert resets >= 1 and launches >= 240, (resets, launches)
    say("history", alg="iddpg", history=HISTORY, n_envs=N_LANES_ALGOS, obs_size=HISTORY * base,
        env_steps=held["steps"], kernel_launches=launches, auto_reset_lanes=resets,
        stacks_equal=True, episode_s=dt, env_steps_per_s=240 * N_LANES_ALGOS / dt,
        reward=stats["mean_train_reward"], value_loss=stats["mean_train_value_loss"],
        card=smi)


BF16_FIELDS = ("state", "next_state", "last_hid", "hid")
BF16_STAT_RTOL = 1e-2


def phase_bf16(smi):
    """The bench.py configuration's chunk with the bf16 ring and with a
    float32 ring, from one carry and one generator state: the rollouts are
    the same, so each bf16 field equals the float32 ring's rounded to bf16
    and the rollout's float32 fields are equal; the update stats (from
    windows sampled alike) within ``BF16_STAT_RTOL``; the rings' bytes and
    each chunk's peak memory."""
    import copy
    import dataclasses

    from bench_torch import bench_trainer
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.pf.fused_nr import nr_solve_small

    free_memory()
    bf16 = bench_trainer(N_LANES)
    assert bf16.cfg.replay_bf16
    f32 = PGTrainer(bf16.cfg.replace(replay_bf16=False), bf16.model, bf16.env)
    start = bf16.carry
    runs = {}
    for name, trainer in (("bf16", bf16), ("f32", f32)):
        gen = torch.Generator(device="cuda")
        gen.set_state(start.generator.get_state())
        env_state = dataclasses.replace(start.env_state, **{
            k: v.clone() for k, v in vars(start.env_state).items()})
        carry = trainer.carry_from(env_state, start.obs.clone(), copy.deepcopy(start.algo),
                                   gen, start.last_hid.clone())
        ring_bytes = pool_bytes(carry.replay)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nr_solve_small.launches = 0
        t0 = time.perf_counter()
        carry, stats = trainer._train_chunk(carry)
        torch.cuda.synchronize()
        runs[name] = dict(carry=carry, stats={k: float(v) for k, v in stats.items()},
                          chunk_s=time.perf_counter() - t0, ring_bytes=ring_bytes,
                          launches=nr_solve_small.launches,
                          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    half, full = runs["bf16"]["carry"].replay.data, runs["f32"]["carry"].replay.data
    for name in vars(half):
        a, b = getattr(half, name), getattr(full, name)
        if name in BF16_FIELDS:
            assert a.dtype == torch.bfloat16 and b.dtype == torch.float32, name
            assert torch.equal(a, b.to(torch.bfloat16)), name
        else:
            assert a.dtype == b.dtype == torch.float32, name
            if name not in ("value", "next_value"):     # filled from the upcast states
                assert torch.equal(a, b), name
    value_err = float((half.value - full.value).abs().max())
    stat_err = {}
    for k, v in runs["f32"]["stats"].items():
        w = runs["bf16"]["stats"][k]
        assert math.isfinite(w), (k, w)
        stat_err[k] = abs(w - v) / max(abs(v), 1e-12)
        assert abs(w - v) <= BF16_STAT_RTOL * abs(v), (k, w, v)
    for run in runs.values():
        assert run["launches"] >= bf16._chunk_len, run["launches"]
    say("bf16", n_envs=N_LANES, chunk_steps=bf16._chunk_len,
        ring_bytes={k: r["ring_bytes"] for k, r in runs.items()},
        peak_mem_gib={k: r["peak_mem_gib"] for k, r in runs.items()},
        chunk_s={k: r["chunk_s"] for k, r in runs.items()},
        kernel_launches={k: r["launches"] for k, r in runs.items()},
        bf16_fields_equal_rounded=True, value_max_abs_diff=value_err,
        stat_rel_diff=stat_err, stat_rtol=BF16_STAT_RTOL, card=smi)


def main():
    smi = phase_device()
    phase_build()
    small = phase_kernel()
    large = phase_kernel_large()
    phase_policy(smi)
    phase_golden()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        small["launches"] = phase_train(smi)
        large["launches"] = phase_train322(smi, os.path.join(work, "case322"))
        phase_algos(smi, os.path.join(work, "algos"))
        phase_eval(smi, work)
        phase_bench(smi)
        phase_zoo(smi, work)
        phase_examples(smi)
        phase_episodic(smi)
        phase_nonshared(smi)
        phase_solvers(smi)
        phase_multigpu(smi, work)
        phase_profiling(smi, work)
        phase_traditional(smi)
        phase_converter(smi)
        phase_render(smi, work)
        phase_discrete(smi)
        phase_history(smi)
        phase_bf16(smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": [small, large]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multigpu-worker"]:
        multigpu_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--cli-rank"]:
        cli_rank(sys.argv[2:])
    else:
        main()
