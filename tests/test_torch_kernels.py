"""The hand-written CUDA NR kernel (mapdn_torch/csrc/nr_small.cu) behind
``nr_solve_small``: its wrapper's device contract here, and the kernel
against its plain PyTorch version on a GPU.

This file imports neither JAX nor mapdn_tpu, so the GPU tests also run on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from mapdn_torch.grid import make_case
from mapdn_torch.pf.fused_nr import get_ctx_small, nr_solve_small, nr_solve_small_ref

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
