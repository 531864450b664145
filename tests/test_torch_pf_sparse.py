"""The large kernel's compressed operands (``NRContext``): Y by compressed
columns and W's live block, against the dense packed operators they are
built from, with their plain products held against ``x @ ypack`` and
``x @ wpack`` in float64.  Imports no JAX."""
import numpy as np
import pytest
import torch

from mapdn_torch.grid import make_case
from mapdn_torch.pf.fused_nr import NRContext

torch.set_num_threads(1)

CASES = ["case33", "case141", "case322"]


@pytest.fixture(scope="module", params=CASES)
def ctx(request):
    grid, *_ = make_case(request.param, dtype=torch.float64, device="cpu")
    return NRContext(grid)


def _x(ctx, lanes=5, seed=0):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.standard_normal((lanes, 2 * ctx.npad)))


def test_compressed_y_holds_every_nonzero(ctx):
    nnz = int(np.count_nonzero(ctx.ypack))
    assert len(ctx.y_vals) == len(ctx.y_rows) == len(ctx.y_cols) == nnz
    assert ctx.y_colptr[0] == 0 and ctx.y_colptr[-1] == nnz
    assert len(ctx.y_colptr) == 2 * ctx.npad + 1
    assert np.all(ctx.y_vals != 0)
    np.testing.assert_array_equal(ctx.ypack[ctx.y_rows, ctx.y_cols], ctx.y_vals)
    # by column, rows ascending inside each: the dense product's order
    for c in range(2 * ctx.npad):
        rows = ctx.y_rows[ctx.y_colptr[c]:ctx.y_colptr[c + 1]]
        assert np.all(ctx.y_cols[ctx.y_colptr[c]:ctx.y_colptr[c + 1]] == c)
        assert np.all(np.diff(rows) > 0)


def test_compressed_y_product_equals_dense(ctx):
    x = _x(ctx)
    want = x @ torch.tensor(ctx.ypack)
    torch.testing.assert_close(ctx.y_product(x), want, rtol=0, atol=1e-12)


def test_wpack_is_zero_outside_live_block(ctx):
    n, npad = ctx.n, ctx.npad
    live = np.zeros(2 * npad, bool)
    live[ctx.w_live_idx] = True
    assert live.sum() == 2 * (n - 1)
    assert not live[0] and not live[npad] and not live[n:npad].any()
    assert np.count_nonzero(ctx.wpack[~live]) == 0
    assert np.count_nonzero(ctx.wpack[:, ~live]) == 0
    np.testing.assert_array_equal(ctx.w_live, ctx.wpack[live][:, live])


def test_live_w_product_equals_dense(ctx):
    # W's entries reach the hundreds (it is J0^-1 in Y-normalized units), so
    # two float64 sums of 2(n-1) terms in other orders agree to 1e-12 of the
    # product's scale, not of 1
    x = _x(ctx, seed=1)
    want = x @ torch.tensor(ctx.wpack)
    scale = float(want.abs().max())
    torch.testing.assert_close(ctx.w_product(x), want, rtol=0, atol=1e-12 * scale)


def test_kernel_operands_layout(ctx):
    """The kernel's arrays carry the float32 casts of the compressed operands:
    Y's values as float32 bits beside their rows; W's live block with each
    bus's real and imaginary output columns side by side, its rows padded to
    a multiple of 4 floats (16 bytes) with zeros."""
    colptr, ent, w_live, rowsum, mask = ctx.kernel_tensors("cpu")
    assert colptr.dtype == ent.dtype == torch.int32
    np.testing.assert_array_equal(colptr.numpy(), ctx.y_colptr)
    np.testing.assert_array_equal(ent[:, 0].numpy(), ctx.y_rows)
    np.testing.assert_array_equal(ent[:, 1].numpy().view(np.float32),
                                  ctx.y_vals.astype(np.float32))
    lr = 2 * (ctx.n - 1)
    assert w_live.dtype == torch.float32 and w_live.shape[0] == lr
    assert w_live.shape[1] % 4 == 0 and lr <= w_live.shape[1] < lr + 4
    m = lr // 2
    np.testing.assert_array_equal(w_live[:, 0:lr:2].numpy(), ctx.w_live[:, :m].astype(np.float32))
    np.testing.assert_array_equal(w_live[:, 1:lr:2].numpy(), ctx.w_live[:, m:].astype(np.float32))
    assert not bool(w_live[:, lr:].any())
    assert rowsum.shape == mask.shape == (1, 2 * ctx.npad)
