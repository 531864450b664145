#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (mapdn_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:

1. device  - require CUDA; print the card and its power limit; no TF32.
2. build   - build every hand-written kernel from csrc/ with nvcc (sm_90a).
3. kernel  - the NR kernel (csrc/nr_small.cu) against its plain PyTorch
             version and the torch-op solver on 8192 case33 lanes drawn from
             a numpy seed: agreement, divergence isolation, warm start, NaN
             lane, false-divergence shares, median times and the bound.
4. golden  - the committed 48-step golden trajectory replayed through the
             env on the card (float32 tolerances of tests/test_env.py).
5. train   - the main path: MAPPO on case33 at 8192 lanes (the bench.py
             configuration), one warm-up chunk, then one full training
             episode with every kernel's launch count read around it.

The line before the last two is the kernels' JSON record, then the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, "device": ...}``.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (data sheet, 700 W): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
N_LANES = 8192


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


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from mapdn_torch.utils import cuda_build
    t0 = time.perf_counter()
    cuda_build.build("nr_small")
    ptxas = {name: [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in cuda_build.BUILD_LOG.items()}
    say("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def case33_injections(grid, pv_max, load_p, load_q, lanes, seed=0):
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
    base_p = -(load_p @ grid.load_inc.double().cpu().numpy().T)
    base_q = -(load_q @ grid.load_inc.double().cpu().numpy().T)
    scale = np.linspace(0.6, 1.2, N_LANES)[:, None]
    pa = torch.as_tensor(base_p[None] * scale, dtype=torch.float32, device="cuda")
    qa = torch.as_tensor(base_q[None] * scale, dtype=torch.float32, device="cuda")
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
    p, q = case33_injections(grid, pv_max, load_p, load_q, N_LANES)
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
    # same packed operands
    ctx = get_ctx_small(grid)
    solve_kernel = make_solver(grid, backend="kernel")
    solver_ms = {"kernel": cuda_median_ms(lambda: solve_kernel(p, q)),
                 "plain": cuda_median_ms(lambda: nr_solve_small_ref(grid, p, q, ctx=ctx)),
                 "torch": cuda_median_ms(lambda: nr_solve(grid, p, q, ops=ops))}
    spec, v0 = fused_nr._pack(ctx, p, q, None, None, torch.float32)
    kops = ctx.tensors(torch.float32, p.device)
    kw = dict(tol=1e-7, max_iter=20, inner_iters=3)
    kv, kerr, kit = fused_nr.nr_small_kernel(spec, v0, *kops, **kw)
    pv, perr, pit = fused_nr.nr_small_plain(spec, v0, *kops, **kw)
    torch.cuda.synchronize()
    assert bool(((kerr < 1e-7) == (perr < 1e-7)).all())
    fin = torch.isfinite(kerr)
    col_err = (kv - pv).abs().amax(0)
    packed_err_same = float(col_err[fin & (kit == pit)].max())
    packed_err = float(col_err[fin].max())
    assert packed_err_same <= 2e-5 and packed_err <= 1e-4, (packed_err_same, packed_err)
    ms = cuda_median_ms(lambda: fused_nr.nr_small_kernel(spec, v0, *kops, **kw))
    plain_ms = cuda_median_ms(lambda: fused_nr.nr_small_plain(spec, v0, *kops, **kw))

    # bound of the kernel's function on these inputs.  Operations: per lane
    # one mismatch product with Y, then per Newton iteration it ran, one W
    # product for the first direction, inner_iters pairs of Y and W products
    # for the Richardson sweeps, and the next mismatch's Y product; each
    # product counted at 2 flops per nonzero of its operator (case33 is a
    # radial feeder: Y is about a tenth full, W's padding rows are zero),
    # at the FP32 peak.  Bytes: spec and v0 read, the two operators, rowsum
    # and mask read once, v, err and n_iter written.  The kernel itself runs
    # the products dense on the padded (2nb x 2nb) operators: flops_padded
    m = 2 * n
    inner = kw["inner_iters"]
    nnz_y, nnz_w = int(np.count_nonzero(ctx.ymat)), int(np.count_nonzero(ctx.wmat))
    lane_iters = float(kit.double().sum())
    flops = 2.0 * (nnz_y * (N_LANES + (inner + 1) * lane_iters)
                   + nnz_w * (inner + 1) * lane_iters)
    flops_padded = 2.0 * (2 * ctx.nb) ** 2 * (N_LANES + 2 * (inner + 1) * lane_iters)
    nbytes = 4 * (3 * m * N_LANES + 2 * m * m + 2 * m + 2 * N_LANES)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops > t_bytes else "bytes"
    fdiv = {name: float((~res.converged).double().mean())
            for name, res in (("kernel", out), ("plain", ref), ("torch", tor))}
    # lanes the kernel reports diverged that the torch-op solver solved
    fdiv["kernel_vs_torch"] = float((~out.converged & tor.converged).double().mean())
    say("kernel", lanes=N_LANES, max_abs_err_test_points=err_a,
        max_abs_err_same_iters=err_same, max_abs_err_all=err_all,
        packed_max_abs_err_same_iters=packed_err_same, packed_max_abs_err=packed_err,
        lanes_one_iter_apart=int((ok & ~same).sum()), vm_err_vs_float64=vs64,
        warm_start_zero_iter_share_tol_1e_7=zero_iter,
        max_n_iter_diff=d_it, mean_n_iter=float(kit.double().mean()),
        false_divergence=fdiv, ms=ms, plain_ms=plain_ms, solver_ms=solver_ms,
        bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
        gflop_padded=flops_padded / 1e9, nnz_y=nnz_y, nnz_w=nnz_w,
        mbytes=nbytes / 1e6)
    return dict(name="nr_small", route="cuda", source="mapdn_torch/csrc/nr_small.cu",
                replaces="mapdn_tpu/pf/pallas_nr.py:404",
                max_abs_err=packed_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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


def bench_trainer():
    """The bench.py configuration: MAPPO on case33 (distributed mode, l1
    barrier, 40 synthetic days), GRU policy and central critic, 60-step
    chunks with 10 value epochs and 1 policy epoch on 32-step windows of
    1024 lanes, bf16 ring."""
    from mapdn_torch.algos import MAPPO
    from mapdn_torch.envs import EnvConfig, make_env
    from mapdn_torch.learn.trainer import PGTrainer
    from mapdn_torch.utils.config import load_config

    env = make_env("case33", EnvConfig(episode_limit=240), days=40,
                   dtype=torch.float32)
    info = env.get_env_info()
    cfg, _ = load_config("mappo")
    cfg = cfg.replace(
        agent_num=info["n_agents"], obs_size=info["obs_shape"],
        action_dim=info["n_actions"], n_envs=N_LANES,
        behaviour_update_freq=60, batch_size=32, value_update_epochs=10,
        policy_update_epochs=1, update_lanes=1024, replay_bf16=True)
    return PGTrainer(cfg, MAPPO(cfg), env).setup(seed=0)


def phase_train(smi):
    from mapdn_torch.pf.fused_nr import nr_solve_small

    t0 = time.perf_counter()
    trainer = bench_trainer()
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


def main():
    smi = phase_device()
    phase_build()
    record = phase_kernel()
    phase_golden()
    record["launches"] = phase_train(smi)
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
