"""The hand-written CUDA kernels (mapdn_torch/csrc/nr_small.cu behind
``nr_solve_small``, mapdn_torch/csrc/nr_large.cu behind ``nr_solve_large``,
mapdn_torch/csrc/policy_gru.cu behind ``nets/policy_gru.py``): their
wrappers' device contract here, and each kernel against its plain
PyTorch version on a GPU.

This file imports neither JAX nor mapdn_tpu, so the GPU tests also run on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from mapdn_torch.grid import make_case
from mapdn_torch.pf import fused_nr
from mapdn_torch.utils import cuda_build
from mapdn_torch.pf.fused_nr import (
    get_ctx, get_ctx_small, nr_solve_large, nr_solve_large_ref, nr_solve_small,
    nr_solve_small_ref)
from test_torch_pf_sparse import RADIAL, radial_grid

torch.set_num_threads(1)


def _injections(case, lanes, dtype, device):
    """Base loads scaled 0.6 .. 1.2 across lanes (tests/test_pallas.py), on
    a case of ``make_case`` or a synthetic radial feeder of ``RADIAL``."""
    grid, load_p, load_q, _ = (radial_grid(case, dtype, device) if case in RADIAL
                               else make_case(case, dtype=dtype, device=device))
    inc = grid.load_inc.double().cpu().numpy()
    scale = np.linspace(0.6, 1.2, lanes)[:, None]
    p = -(np.asarray(load_p) @ inc.T)[None] * scale
    q = -(np.asarray(load_q) @ inc.T)[None] * scale
    return (grid, torch.tensor(p, dtype=dtype, device=device),
            torch.tensor(q, dtype=dtype, device=device))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    grid, p, q = _injections("case33", 4, torch.float64, "cpu")
    launches = nr_solve_small.launches
    out = nr_solve_small(grid, p, q)
    ref = nr_solve_small_ref(grid, p, q)
    assert nr_solve_small.launches == launches
    assert out.vm.dtype == torch.float64 and bool(out.converged.all())
    torch.testing.assert_close(out.vm, ref.vm, rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    grid, p, q = _injections("case33", 2, torch.float64, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        nr_solve_small(grid, p.to("meta"), q.to("meta"))


@pytest.mark.parametrize("case", ["case33", "case322"])
def test_large_wrapper_takes_plain_version_for_cpu_tensors(case):
    grid, p, q = _injections(case, 4, torch.float64, "cpu")
    launches = nr_solve_large.launches
    out = nr_solve_large(grid, p, q)
    ref = nr_solve_large_ref(grid, p, q)
    assert nr_solve_large.launches == launches
    assert out.vm.dtype == torch.float64 and bool(out.converged.all())
    torch.testing.assert_close(out.vm, ref.vm, rtol=0, atol=0)


def test_library_name_hashes_included_files(tmp_path, monkeypatch):
    """The built library's name covers every csrc/ file the source includes,
    recursively, so an edited header is never served a stale binary; files
    outside csrc/ (system headers) and the flags count as before.  Builds
    nothing."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    first = cuda_build._lib_path("k")[1]
    assert cuda_build._lib_path("k")[1] == first
    names = {first}
    for name, text in (("b.cuh", "int b2;\n"), ("a.cuh", '#include "b.cuh"\nint a2;\n'),
                       ("k.cu", '#include "a.cuh"\nint k2;\n')):
        (tmp_path / name).write_text(text)
        names.add(cuda_build._lib_path("k")[1])
    assert len(names) == 4
    monkeypatch.setattr(cuda_build, "FLAGS", cuda_build.FLAGS + ["-DX"])
    assert cuda_build._lib_path("k")[1] not in names


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda):
    grid, p, q = _injections("case33", 256, torch.float32, "cuda")
    launches = nr_solve_small.launches
    out = nr_solve_small(grid, p, q)
    ref = nr_solve_small_ref(grid, p, q)
    torch.cuda.synchronize()
    assert nr_solve_small.launches == launches + 1
    assert get_ctx_small(grid).nb == 40
    assert bool(out.converged.all()) and bool((out.converged == ref.converged).all())
    # float32 against float32, sums in another order: the tolerance of
    # tests/test_pallas.py for the TPU kernel against the XLA solver
    torch.testing.assert_close(out.vm, ref.vm, rtol=0, atol=2e-5)
    torch.testing.assert_close(out.va, ref.va, rtol=0, atol=2e-5)
    assert int((out.n_iter - ref.n_iter).abs().max()) <= 1


@pytest.mark.cuda
def test_kernel_lanes_are_independent(cuda):
    grid, p, q = _injections("case33", 64, torch.float32, "cuda")
    pb = p.clone()
    pb[2:4] *= 500.0
    pb[9, 7] = float("nan")
    out = nr_solve_small(grid, pb, q)
    fine = torch.ones(64, dtype=torch.bool, device="cuda")
    fine[[2, 3, 9]] = False
    assert not bool(out.converged[~fine].any())
    assert bool(out.converged[fine].all()) and bool(torch.isfinite(out.vm[fine]).all())
    alone = nr_solve_small(grid, p[fine], q[fine])
    torch.testing.assert_close(out.vm[fine], alone.vm, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_warm_start_takes_no_iteration(cuda):
    grid, p, q = _injections("case33", 256, torch.float32, "cuda")
    cold = nr_solve_small(grid, p, q)
    # tol 1e-7 is the float32 mismatch's rounding floor: re-rounding the
    # solution through (vm, va) lands its error on either side of it, so
    # the warm solve is held to a tol ten times looser
    warm = nr_solve_small(grid, p, q, vm0=cold.vm, va0=cold.va, tol=1e-6)
    assert bool(warm.converged.all()) and int(warm.n_iter.max()) == 0
    torch.testing.assert_close(warm.vm, cold.vm, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_kernel_casts_back_and_bounds_grid_size(cuda):
    grid, p, q = _injections("case33", 8, torch.float64, "cuda")
    out = nr_solve_small(grid, p, q)
    assert out.vm.dtype == torch.float64 and bool(out.converged.all())
    big, pb, qb = _injections("case141", 2, torch.float32, "cuda")
    with pytest.raises(ValueError, match="nb <= 64"):
        nr_solve_small(big, pb, qb)


def _small_packed(case, lanes, device="cuda"):
    grid, p, q = _injections(case, lanes, torch.float32, device)
    ctx = get_ctx_small(grid)
    spec, v0 = ctx.pack(p, q, None, None, torch.float32)
    return ctx, spec, v0


_KW = dict(tol=1e-7, max_iter=20, inner_iters=3)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 31, 33, 250])
@pytest.mark.parametrize("case,nb", [("radial13", 16), ("case33", 40), ("radial62", 64)])
def test_small_kernel_batches_match_plain_version(cuda, case, nb, lanes):
    """One lane, a block less one lane, a block and one lane, and 250 lanes
    (a ragged last 32-lane block), at nb 16, 40 and 64, against the plain
    version on the same packed float32 operands."""
    ctx, spec, v0 = _small_packed(case, lanes)
    assert ctx.nb == nb
    launches = nr_solve_small.launches
    v, err, it = fused_nr.nr_small_kernel(spec, v0, *ctx.kernel_tensors(spec.device), **_KW)
    rv, rerr, rit = fused_nr.nr_small_plain(
        spec, v0, *ctx.tensors(torch.float32, spec.device), **_KW)
    torch.cuda.synchronize()
    assert nr_solve_small.launches == launches + 1
    assert v.shape == v0.shape and err.shape == it.shape == (lanes,)
    conv = (err < _KW["tol"]) & torch.isfinite(err)
    assert bool(conv.all()) and bool(((rerr < _KW["tol"]) == conv).all())
    assert int((it - rit).abs().max()) <= 1
    # float32 against float32, sums in another order: the tolerance of
    # tests/test_pallas.py, on lanes that ran the same iterations
    same = it == rit
    torch.testing.assert_close(v[:, same], rv[:, same], rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_small_kernel_repeats_bit_for_bit(cuda):
    """Every sum runs over the same terms in the same order, so launch after
    launch on 8192 lanes gives the same bits."""
    ctx, spec, v0 = _small_packed("case33", 8192)
    ops = ctx.kernel_tensors(spec.device)
    outs = [fused_nr.nr_small_kernel(spec, v0, *ops, **_KW) for _ in range(4)]
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_small_kernel_lanes_of_other_blocks_are_independent(cuda):
    """A block whose 32 lanes all diverge or go NaN, and so stop at once,
    leaves the lanes of the blocks around it the same bit for bit; the bad
    lanes never read as converged."""
    ctx, spec, v0 = _small_packed("case33", 32 * 4)
    ops = ctx.kernel_tensors(spec.device)
    good = fused_nr.nr_small_kernel(spec, v0, *ops, **_KW)
    bad_spec = spec.clone()
    bad_spec[:, 32:63] *= 500.0            # block 1
    bad_spec[7, 63] = float("nan")
    bad = fused_nr.nr_small_kernel(bad_spec, v0, *ops, **_KW)
    fine = torch.ones(spec.shape[1], dtype=torch.bool, device="cuda")
    fine[32:64] = False
    conv = (bad[1] < _KW["tol"]) & torch.isfinite(bad[1])
    assert not bool(conv[~fine].any()) and bool(conv[fine].all())
    torch.testing.assert_close(bad[0][:, fine], good[0][:, fine], rtol=0, atol=0)
    for got, want in zip(bad[1:], good[1:]):
        torch.testing.assert_close(got[fine], want[fine], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,npad", [("case33", 128), ("case141", 256),
                                       ("case322", 384)])
def test_large_kernel_matches_plain_version(cuda, case, npad):
    # 250 lanes: the last 8-lane block is ragged
    grid, p, q = _injections(case, 250, torch.float32, "cuda")
    launches = nr_solve_large.launches
    out = nr_solve_large(grid, p, q)
    ref = nr_solve_large_ref(grid, p, q)
    torch.cuda.synchronize()
    assert nr_solve_large.launches == launches + 1
    assert get_ctx(grid).npad == npad
    assert bool(out.converged.all()) and bool((out.converged == ref.converged).all())
    d_it = (out.n_iter - ref.n_iter).abs()
    assert int(d_it.max()) <= 1
    # float32 against float32, sums in another order: the tolerance of
    # tests/test_pallas.py for the TPU kernels, on lanes that ran the same
    # iterations; a lane stopping one iteration apart differs by that step
    same = d_it == 0
    torch.testing.assert_close(out.vm[same], ref.vm[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(out.va[same], ref.va[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(out.vm, ref.vm, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_large_kernel_lanes_are_independent(cuda):
    """A lane's result does not depend on which lanes share its block: a
    permuted batch, and a batch with diverging and NaN lanes, give every
    other lane the same result bit for bit."""
    grid, p, q = _injections("case322", 64, torch.float32, "cuda")
    out = nr_solve_large(grid, p, q)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0)).cuda()
    shuffled = nr_solve_large(grid, p[perm], q[perm])
    for name in ("vm", "va", "converged", "n_iter"):
        torch.testing.assert_close(getattr(shuffled, name), getattr(out, name)[perm],
                                   rtol=0, atol=0)
    pb = p.clone()
    pb[2:4] *= 500.0
    pb[9, 7] = float("nan")
    bad = nr_solve_large(grid, pb, q)
    fine = torch.ones(64, dtype=torch.bool, device="cuda")
    fine[[2, 3, 9]] = False
    assert not bool(bad.converged[~fine].any())
    assert bool(bad.converged[fine].all()) and bool(torch.isfinite(bad.vm[fine]).all())
    torch.testing.assert_close(bad.vm[fine], out.vm[fine], rtol=0, atol=0)


def _large_packed(case, lanes, device="cuda"):
    grid, p, q = _injections(case, lanes, torch.float32, device)
    ctx = get_ctx(grid)
    spec, v0 = ctx.pack(p, q, None, None, torch.float32)
    return ctx, spec, v0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 10, 8 * 8 + 3])
@pytest.mark.parametrize("case", ["case33", "case141", "case322"])
def test_large_kernel_batches_match_plain_version(cuda, case, lanes):
    """One lane, the eval's 10 lanes and 8 k + 3 lanes (a ragged last
    block), at npad 128, 256 and 384, against the plain version."""
    ctx, spec, v0 = _large_packed(case, lanes)
    v, err, it = fused_nr.nr_large_kernel(spec, v0, *ctx.kernel_tensors(spec.device), **_KW)
    rv, rerr, rit = fused_nr.nr_large_plain(
        spec, v0, *ctx.tensors(torch.float32, spec.device), **_KW)
    torch.cuda.synchronize()
    assert v.shape == v0.shape and err.shape == it.shape == (lanes,)
    conv = (err < _KW["tol"]) & torch.isfinite(err)
    assert bool(conv.all()) and bool(((rerr < _KW["tol"]) == conv).all())
    assert int((it - rit).abs().max()) <= 1
    same = it == rit
    torch.testing.assert_close(v[same], rv[same], rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_large_kernel_repeats_bit_for_bit(cuda):
    """Every sum runs over the same terms in the same order, so launch after
    launch on 4096 lanes gives the same bits."""
    ctx, spec, v0 = _large_packed("case322", 4096)
    ops = ctx.kernel_tensors(spec.device)
    outs = [fused_nr.nr_large_kernel(spec, v0, *ops, **_KW) for _ in range(4)]
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_large_kernel_lanes_of_other_blocks_are_independent(cuda):
    """A block whose 8 lanes all diverge or go NaN, and so stop at once,
    leaves the lanes of the blocks around it the same bit for bit; the bad
    lanes never read as converged."""
    ctx, spec, v0 = _large_packed("case322", 8 * 4)
    ops = ctx.kernel_tensors(spec.device)
    good = fused_nr.nr_large_kernel(spec, v0, *ops, **_KW)
    bad_spec = spec.clone()
    bad_spec[8:15] *= 500.0                # block 1
    bad_spec[15, 7] = float("nan")
    bad = fused_nr.nr_large_kernel(bad_spec, v0, *ops, **_KW)
    fine = torch.ones(spec.shape[0], dtype=torch.bool, device="cuda")
    fine[8:16] = False
    conv = (bad[1] < _KW["tol"]) & torch.isfinite(bad[1])
    assert not bool(conv[~fine].any()) and bool(conv[fine].all())
    for got, want in zip(bad, good):
        torch.testing.assert_close(got[fine], want[fine], rtol=0, atol=0)


@pytest.mark.cuda
def test_large_kernel_warm_start_takes_no_iteration(cuda):
    grid, p, q = _injections("case322", 64, torch.float32, "cuda")
    cold = nr_solve_large(grid, p, q)
    # tol 1e-7 is the float32 mismatch's rounding floor (see above)
    warm = nr_solve_large(grid, p, q, vm0=cold.vm, va0=cold.va, tol=1e-6)
    assert bool(warm.converged.all()) and int(warm.n_iter.max()) == 0
    torch.testing.assert_close(warm.vm, cold.vm, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_large_kernel_casts_back_and_bounds_npad(cuda):
    grid, p, q = _injections("case322", 8, torch.float64, "cuda")
    out = nr_solve_large(grid, p, q)
    assert out.vm.dtype == torch.float64 and bool(out.converged.all())
    m = 2 * 512
    ops = [torch.zeros(s, device="cuda") for s in ((4, m), (4, m))]
    ops += [torch.zeros(m + 1, dtype=torch.int32, device="cuda"),
            torch.zeros((8, 2), dtype=torch.int32, device="cuda")]
    ops += [torch.zeros(s, device="cuda") for s in ((m - 4, m - 4), (1, m), (1, m))]
    with pytest.raises(ValueError, match="npad"):
        fused_nr.nr_large_kernel(*ops, tol=1e-7, max_iter=20, inner_iters=3)


# ----------------------------------------------- the fused GRU policy (csrc/policy_gru.cu)
def test_policy_wrappers_take_plain_versions_for_cpu_tensors():
    from mapdn_torch.nets import policy_gru
    from mapdn_torch.nets.agents import RNNAgent
    gen = torch.Generator().manual_seed(0)
    module = RNNAgent(38 + 6, hid_size=64).reset_parameters(gen)
    params = list(module.parameters())
    obs, hid = torch.randn((120, 38), generator=gen), torch.randn((120, 64), generator=gen)
    launches = policy_gru.policy_fwd.launches, policy_gru.policy_bwd.launches
    with torch.no_grad():
        out = policy_gru.policy_fwd(obs, hid, params, 6)
        grads = policy_gru.policy_bwd(obs, hid, torch.ones(120), *out[1:], params, 6)
    want = policy_gru.policy_fwd_plain(obs, hid, params, 6)
    assert (policy_gru.policy_fwd.launches, policy_gru.policy_bwd.launches) == launches
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert [g.shape for g in grads] == [p.shape for p in params]
    with pytest.raises(ValueError, match="unsupported device"):
        policy_gru.policy_fwd(obs.to("meta"), hid.to("meta"), params, 6)


def _smoke():
    """chip_smoke.py's policy helpers (the file sits at the repository
    root, the working directory of the card's test command)."""
    import chip_smoke
    return chip_smoke


# beside the update batches of chip_smoke.py (POLICY_CASES): a row count
# that ends inside a tile, a policy without agent ids, and obs wider than
# 64 (the kernels' second obs tile): case33's and case322's at history 2
# (76 and 124), the widest (128) at the most agents it takes (44), and 128
# without ids
POLICY_EXTRA = {"ragged": (6, 38, 6 * 1001), "no_ids": (0, 38, 3001),
                "obs76": (6, 76, 6 * 5001), "obs124": (38, 124, 38 * 2001),
                "obs128": (44, 128, 44 * 1001), "no_ids_obs128": (0, 128, 3001)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["case33", "case322", "case141", "ragged", "no_ids", "obs76",
                                  "obs124", "obs128", "no_ids_obs128"])
def test_policy_kernels_match_plain_version(cuda, case):
    """Both kernels at the update batch of case33 train8192 (196,608 rows),
    case322 train4096 (4,980,736 rows) and case141 train4096 (2,883,584
    rows, obs 66 wide), at a row count that ends inside a tile, without
    agent ids, and at obs widths 76, 124 and 128, against the plain
    versions in float64 on the same inputs, to chip_smoke.py's tolerances
    and for its reasons: the forward's means, stash and 1/std to 1e-5 of
    their largest magnitude, each gradient from the kernel's own stash to
    2e-5 of its norm; two runs bit for bit."""
    from mapdn_torch.nets import policy_gru
    smoke = _smoke()
    n, o, rows = dict(smoke.POLICY_CASES, **POLICY_EXTRA)[case]
    module, obs, hid, dmeans = smoke.policy_case(n, o, rows, seed=3)
    params = list(module.parameters())
    launches = policy_gru.policy_fwd.launches, policy_gru.policy_bwd.launches
    runs = []
    for _ in range(2):
        m, st, rs = policy_gru.policy_fwd(obs, hid, params, n)
        runs.append((m, st, rs, policy_gru.policy_bwd(obs, hid, dmeans, st, rs, params, n)))
    torch.cuda.synchronize()
    assert (policy_gru.policy_fwd.launches - launches[0],
            policy_gru.policy_bwd.launches - launches[1]) == (2, 2)
    (m, st, rs, g), (m2, st2, rs2, g2) = runs
    assert torch.equal(m, m2) and torch.equal(st, st2) and torch.equal(rs, rs2)
    assert all(torch.equal(a, b) for a, b in zip(g, g2))
    del runs, m2, st2, rs2, g2
    smoke.check_policy_errors(smoke.policy_errors(obs, hid, dmeans, params, n,
                                                   (m, st, rs, g))[0])


@pytest.mark.cuda
def test_policy_kernel_wrappers_check_their_operands(cuda):
    from mapdn_torch.nets import policy_gru
    module, obs, hid, _ = _smoke().policy_case(6, 38, 12)
    params = list(module.parameters())
    with pytest.raises(ValueError, match="float32"):
        policy_gru.policy_fwd_kernel(obs.double(), hid.double(), params, 6)
    with pytest.raises(ValueError, match="shapes"):
        policy_gru.policy_fwd_kernel(obs, hid[:, :32], params, 6)
    # past the second obs tile, and past the agents it leaves room for
    for n, o in ((0, 129), (45, 66)):
        module, obs, hid, _ = _smoke().policy_case(n, o, 90)
        with pytest.raises(ValueError, match=f"obs width {o}"):
            policy_gru.policy_fwd_kernel(obs, hid, list(module.parameters()), n)


@pytest.mark.cuda
def test_graphed_case322_policy_update_matches_uncaptured(cuda):
    """case322 MAPPO at hidden width 64 (38 agents, obs 62): its policy
    epochs run the fused kernels, and the update phase graphed equals the
    uncaptured one bit for bit, every epoch's stats too."""
    from mapdn_torch.nets import policy_gru
    from test_torch_update_graph import _graphed_update_against_eager
    launches = policy_gru.policy_bwd.launches
    _graphed_update_against_eager(2, case="case322", hid_size=64, lanes_=64, chunk=20,
                                  episode_limit=25, ring_steps=20, batch_size=20,
                                  value_update_epochs=2, policy_update_epochs=3)
    # the eager side's 2 x 3 epochs, the graphed side's warm-up and capture
    assert policy_gru.policy_bwd.launches - launches == 2 * 3 + 2


@pytest.mark.cuda
def test_maddpg_policy_step_through_the_kernels_matches_the_module(cuda, monkeypatch):
    """One MADDPG policy loss and its gradients on the card through the
    fused kernels against the module's own ops (float32 both): the loss to
    1e-5 relative, each gradient to 1e-4 of its norm."""
    from mapdn_torch.nets import policy_gru
    from test_torch_rollout_graph import _build
    tr = _build(alg="maddpg", device="cuda", lanes_=256, chunk=20, episode_limit=25,
                ring_steps=20, batch_size=20, hid_size=64)
    tr.run_episode()
    algo, batch = tr.carry.algo, tr.carry.replay.data.map(tr._upcast)
    params = list(algo.policy.parameters())

    def step():
        loss, _, _ = tr.model.get_loss(algo, batch, tr.avail, value=False)
        return loss, torch.autograd.grad(loss, params)
    launches = policy_gru.policy_fwd.launches
    fused = step()
    assert policy_gru.policy_fwd.launches == launches + 1
    monkeypatch.setattr(policy_gru, "_on_card", lambda t: False)
    plain = step()
    assert policy_gru.policy_fwd.launches == launches + 1
    torch.testing.assert_close(fused[0], plain[0], rtol=1e-5, atol=0)
    for a, b in zip(fused[1], plain[1]):
        assert float((a - b).norm() / b.norm()) <= 1e-4
