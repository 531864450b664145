"""The kernels' compressed operands against the dense packed operators they
are built from: ``NRSmallContext`` (Y's rows paired by bus, ``ymat @ x``) at
case33 and at synthetic radial feeders of nb 16 and 64, and ``NRContext``
(Y by compressed columns, ``x @ ypack``) at case33, case141 and case322.
Each holds every nonzero of Y, W is zero outside its live block, both plain
products equal the dense ones in float64, and the kernel's arrays carry the
float32 casts in the kernel's layout.  Imports no JAX."""
import numpy as np
import pytest
import torch

from mapdn_torch.grid import make_case
from mapdn_torch.grid.cases import _synthetic_radial
from mapdn_torch.pf.fused_nr import NRContext, NRSmallContext

torch.set_num_threads(1)

# synthetic radial feeders for the small kernel: (n_bus, n_load, n_sgen,
# n_zone) -> nb 16 (2(n-1) = 24 live rows of W) and nb 64 (122 live rows,
# not a multiple of 4: the kernel's W rows are padded)
RADIAL = {"radial13": (13, 8, 3, 2), "radial62": (62, 40, 8, 4)}


def radial_args(name):
    """The arguments of ``_synthetic_radial`` (the same in both packages)
    that build feeder ``name``."""
    n_bus, n_load, n_sgen, n_zone = RADIAL[name]
    return (name, n_bus, n_load, n_sgen, n_zone), dict(
        vn_kv=12.5, total_load_mw=0.09 * n_bus, pv_penetration=2.0,
        seed=1000 + n_bus)


def radial_grid(name, dtype=torch.float64, device="cpu"):
    """Feeder ``name``: (grid, load_p, load_q, pv_max) as ``make_case``."""
    args, kw = radial_args(name)
    return _synthetic_radial(*args, **kw, dtype=dtype, device=device)


SMALL = ["small-case33", "small-radial13", "small-radial62"]
LARGE = ["case33", "case141", "case322"]


@pytest.fixture(scope="module", params=SMALL + LARGE)
def ctx(request):
    name = request.param
    if name.startswith("small-"):
        case = name[len("small-"):]
        grid, *_ = (radial_grid(case) if case in RADIAL
                    else make_case(case, dtype=torch.float64, device="cpu"))
        return NRSmallContext(grid)
    grid, *_ = make_case(name, dtype=torch.float64, device="cpu")
    return NRContext(grid)


def _small(ctx):
    return isinstance(ctx, NRSmallContext)


def _w(ctx):
    return ctx.wmat if _small(ctx) else ctx.wpack


def _pad(ctx):
    return ctx.nb if _small(ctx) else ctx.npad


def _x(ctx, lanes=5, seed=0):
    """A state-shaped input: (2nb, lanes) for the small kernel, (lanes,
    2npad) for the large."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((lanes, 2 * _pad(ctx)))
    return torch.tensor(x.T.copy() if _small(ctx) else x)


def _dense(ctx, op, x):
    return torch.tensor(op) @ x if _small(ctx) else x @ torch.tensor(op)


def _check_small_y(ctx):
    """Y's rows paired by bus: bus b's entries are the union of the columns
    of rows b and nb + b, ascending, with both rows' values (zero where a
    row lacks the column), so every nonzero is held once."""
    nb, ptr = ctx.nb, ctx.y_busptr
    assert len(ptr) == nb + 1 and ptr[0] == 0 and ptr[-1] == len(ctx.y_cols)
    assert ctx.y_vals.shape == (len(ctx.y_cols), 2)
    held = np.zeros_like(ctx.ymat)
    for b in range(nb):
        cols, vals = ctx.y_cols[ptr[b]:ptr[b + 1]], ctx.y_vals[ptr[b]:ptr[b + 1]]
        want = np.union1d(np.nonzero(ctx.ymat[b])[0], np.nonzero(ctx.ymat[nb + b])[0])
        np.testing.assert_array_equal(cols, want)
        held[b, cols], held[nb + b, cols] = vals[:, 0], vals[:, 1]
    np.testing.assert_array_equal(held, ctx.ymat)


def _check_large_y(ctx):
    """Y's nonzeros by output column, rows ascending inside each."""
    y, ptr = ctx.ypack.T, ctx.y_colptr
    nnz = int(np.count_nonzero(y))
    assert len(ctx.y_vals) == len(ctx.y_rows) == len(ctx.y_cols) == nnz
    assert ptr[0] == 0 and ptr[-1] == nnz
    assert len(ptr) == 2 * ctx.npad + 1
    assert np.all(ctx.y_vals != 0)
    np.testing.assert_array_equal(y[ctx.y_cols, ctx.y_rows], ctx.y_vals)
    for o in range(2 * ctx.npad):
        assert np.all(ctx.y_cols[ptr[o]:ptr[o + 1]] == o)
        assert np.all(np.diff(ctx.y_rows[ptr[o]:ptr[o + 1]]) > 0)


def test_compressed_y_holds_every_nonzero(ctx):
    # by output index, inputs ascending inside each: the dense product's order
    (_check_small_y if _small(ctx) else _check_large_y)(ctx)


def test_compressed_y_product_equals_dense(ctx):
    x = _x(ctx)
    want = _dense(ctx, ctx.ymat if _small(ctx) else ctx.ypack, x)
    torch.testing.assert_close(ctx.y_product(x), want, rtol=0, atol=1e-12)


def test_wpack_is_zero_outside_live_block(ctx):
    n, pad, w = ctx.n, _pad(ctx), _w(ctx)
    live = np.zeros(2 * pad, bool)
    live[ctx.w_live_idx] = True
    assert live.sum() == 2 * (n - 1)
    assert not live[0] and not live[pad] and not live[n:pad].any()
    assert np.count_nonzero(w[~live]) == 0
    assert np.count_nonzero(w[:, ~live]) == 0
    np.testing.assert_array_equal(ctx.w_live, w[live][:, live])


def test_live_w_product_equals_dense(ctx):
    # W's entries reach the hundreds (it is J0^-1 in Y-normalized units), so
    # two float64 sums of 2(n-1) terms in other orders agree to 1e-12 of the
    # product's scale, not of 1
    x = _x(ctx, seed=1)
    want = _dense(ctx, _w(ctx), x)
    scale = float(want.abs().max())
    torch.testing.assert_close(ctx.w_product(x), want, rtol=0, atol=1e-12 * scale)


def _check_small_layout(ctx):
    """Y's bus pointers, and its entries as {column, float32 bits of both
    rows' values, 0}; W's live block row-major, rows padded to a multiple
    of 4 floats (16 bytes) with zeros; rowsum and mask as (2nb, 1)
    columns."""
    busptr, ent, w_live, rowsum, mask = ctx.kernel_tensors("cpu")
    nb = ctx.nb
    np.testing.assert_array_equal(busptr.numpy(), ctx.y_busptr)
    ent = ent.numpy()
    assert ent.shape == (len(ctx.y_cols), 4)
    np.testing.assert_array_equal(ent[:, 0], ctx.y_cols)
    np.testing.assert_array_equal(ent[:, 1:3].view(np.float32),
                                  ctx.y_vals.astype(np.float32))
    assert not ent[:, 3].any()
    lr = 2 * (ctx.n - 1)
    np.testing.assert_array_equal(w_live[:, :lr].numpy(), ctx.w_live.astype(np.float32))
    assert rowsum.shape == mask.shape == (2 * nb, 1)
    return w_live


def _check_large_layout(ctx):
    """Y's values as float32 bits beside their rows; W's live block with
    each bus's real and imaginary output columns side by side, rows padded
    to a multiple of 4 floats (16 bytes) with zeros."""
    colptr, ent, w_live, rowsum, mask = ctx.kernel_tensors("cpu")
    np.testing.assert_array_equal(colptr.numpy(), ctx.y_colptr)
    np.testing.assert_array_equal(ent[:, 0].numpy(), ctx.y_rows)
    np.testing.assert_array_equal(ent[:, 1].numpy().view(np.float32),
                                  ctx.y_vals.astype(np.float32))
    lr = 2 * (ctx.n - 1)
    m = lr // 2
    np.testing.assert_array_equal(w_live[:, 0:lr:2].numpy(), ctx.w_live[:, :m].astype(np.float32))
    np.testing.assert_array_equal(w_live[:, 1:lr:2].numpy(), ctx.w_live[:, m:].astype(np.float32))
    assert rowsum.shape == mask.shape == (1, 2 * ctx.npad)
    return w_live


def test_kernel_operands_layout(ctx):
    """The kernel's arrays carry the float32 casts of the compressed
    operands in each kernel's layout, its integer arrays int32, and W's
    live block rows padded to 16 bytes with zeros."""
    w_live = (_check_small_layout if _small(ctx) else _check_large_layout)(ctx)
    assert all(t.dtype == torch.int32 for t in ctx.kernel_tensors("cpu")[:2])
    lr = 2 * (ctx.n - 1)
    assert w_live.dtype == torch.float32 and w_live.shape[0] == lr
    assert w_live.shape[1] % 4 == 0 and lr <= w_live.shape[1] < lr + 4
    assert not bool(w_live[:, lr:].any())
