"""The hand-written CUDA NR kernels (mapdn_torch/csrc/nr_small.cu behind
``nr_solve_small``, mapdn_torch/csrc/nr_large.cu behind ``nr_solve_large``):
their wrappers' device contract here, and each kernel against its plain
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
from mapdn_torch.pf.fused_nr import (
    get_ctx, get_ctx_small, nr_solve_large, nr_solve_large_ref, nr_solve_small,
    nr_solve_small_ref)

torch.set_num_threads(1)


def _injections(case, lanes, dtype, device):
    """Base loads scaled 0.6 .. 1.2 across lanes (tests/test_pallas.py)."""
    grid, load_p, load_q, _ = make_case(case, dtype=dtype, device=device)
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
    ops = [torch.zeros(s, device="cuda") for s in ((4, m), (4, m), (m, m), (m, m), (1, m), (1, m))]
    with pytest.raises(ValueError, match="npad"):
        fused_nr.nr_large_kernel(*ops, tol=1e-7, max_iter=20, inner_iters=3)
