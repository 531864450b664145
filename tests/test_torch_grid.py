"""mapdn_torch grid build vs the JAX package's, bit for bit in float64."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.grid import make_case as torch_case
from mapdn_torch.pf.fused_nr import NRSmallContext
from mapdn_tpu.grid import make_case as jax_case
from mapdn_tpu.pf.pallas_nr import PallasNRSmallContext

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


CASES = ["case33", "case69", "case141", "case322"]


@pytest.fixture(scope="module", params=CASES)
def grids(request):
    case = request.param
    jg, jlp, jlq, jpv = jax_case(case, dtype=jnp.float64)
    tg, tlp, tlq, tpv = torch_case(case, dtype=torch.float64, device="cpu")
    return case, (jg, jlp, jlq, jpv), (tg, tlp, tlq, tpv)


def test_grid_fields_bitwise(grids):
    case, (jg, jlp, jlq, jpv), (tg, tlp, tlq, tpv) = grids
    for f in dataclasses.fields(tg):
        got = getattr(tg, f.name)
        want = getattr(jg, f.name)
        if isinstance(got, torch.Tensor):
            got = got.numpy()
            want = np.asarray(want)
            assert got.shape == want.shape, f.name
            if np.issubdtype(want.dtype, np.floating):
                assert got.dtype == np.float64, f.name
            np.testing.assert_array_equal(got, want, err_msg=f"{case}.{f.name}")
        else:
            assert got == want, f"{case}.{f.name}"
    for got, want in ((tlp, jlp), (tlq, jlq), (tpv, jpv)):
        np.testing.assert_array_equal(got, want)


def test_small_context_operators_bitwise(grids):
    case, (jg, *_), (tg, *_) = grids
    jctx = PallasNRSmallContext(jg)
    tctx = NRSmallContext(tg)
    assert (tctx.n, tctx.nb, tctx.slack_vm) == (jctx.n, jctx.nb, jctx.slack_vm)
    assert tctx.inv_c == jctx.inv_c
    for name in ("ymat", "wmat", "rowsum", "mask"):
        got = getattr(tctx, name)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got.astype(np.float32), getattr(jctx, name),
                                      err_msg=f"{case}.{name}")


def test_float32_grid_is_the_rounded_float64_build():
    tg32, *_ = torch_case("case33", dtype=torch.float32, device="cpu")
    jg32, *_ = jax_case("case33", dtype=jnp.float32)
    for name in ("g_mat", "b_mat", "j0_inv", "rowsum_g", "ys_b", "sgen_inc"):
        np.testing.assert_array_equal(getattr(tg32, name).numpy(),
                                      np.asarray(getattr(jg32, name)))


def test_entry_point_needs_gpu_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_case("case33")
