"""Whole-solve batched Newton-Raphson: the two CUDA kernels and their plain twins.

Port of ``mapdn_tpu/pf/pallas_nr.py``.  Each Pallas kernel becomes a CUDA
kernel beside a plain PyTorch version on the same packed operands:

* small grids (n_bus <= 64): ``NRSmallContext`` (from
  ``PallasNRSmallContext``), the kernel ``csrc/nr_small.cu`` (from
  ``_nr_kernel_small``) launched by :func:`nr_small_kernel`, its plain
  version :func:`nr_small_plain`, and the solvers :func:`nr_solve_small`
  (from ``nr_solve_pallas_small``) and :func:`nr_solve_small_ref`.  Buses on
  rows (padded to ``nb = round_up(n, 8)``), lanes on columns: every state
  array is ``(2nb, lanes)`` of [real-half; imag-half] and the operators act
  by left-multiplication.  The kernel takes Y's rows paired by bus and W
  on its live block (:meth:`NRSmallContext.kernel_tensors`);
  their plain products are :meth:`NRSmallContext.y_product` and
  :meth:`NRSmallContext.w_product`.
* large grids: ``NRContext`` (from ``PallasNRContext``), the kernel
  ``csrc/nr_large.cu`` (from ``_nr_kernel``) launched by
  :func:`nr_large_kernel`, its plain version :func:`nr_large_plain`, and the
  solvers :func:`nr_solve_large` (from ``nr_solve_pallas``) and
  :func:`nr_solve_large_ref`.  Lanes on rows, buses on columns (padded to
  ``npad = round_up(max(n, 128), 128)``): every state array is
  ``(lanes, 2npad)`` of [real-half | imag-half] and the operators act by
  right-multiplication.  The kernel takes Y by compressed columns and W on
  its live block (:meth:`NRContext.kernel_tensors`); their plain products
  are :meth:`NRContext.y_product` and :meth:`NRContext.w_product`.

Both compute the algorithm of :func:`mapdn_torch.pf.newton.nr_solve`; the
kernels carry the mismatch between iterations, so each iteration evaluates
it once.  :func:`make_solver` (in place of ``make_auto_solver``) picks the
solver of a grid by configuration.

The wrappers launch the kernels for CUDA tensors and take the plain versions
only for CPU tensors: there is no fall-back from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from mapdn_torch.pf.newton import _result, nr_solve, packed_operators
from mapdn_torch.utils import cuda_build


SMALL_NB = 64   # the small kernel's (and pallas_nr.py's `small`) bus-count bound
LARGE_NPADS = (128, 256, 384)   # the padded bus counts the large kernel holds


def _round_up(x, m):
    return -(-x // m) * m


def _npad(n_bus):
    """The large kernel's padded bus count (pallas_nr.py's npad)."""
    return _round_up(max(n_bus, 128), 128)


def _np64(t):
    return t.detach().cpu().double().numpy()


class _PackedOperands:
    """The operands of one grid's kernel, cached as tensors per dtype and
    device.  Subclasses set ``_OPERANDS`` and define ``pack``/``unpack``,
    ``kernel_tensors`` and ``_y_entries`` (Y's compressed entries: their
    index arrays and values, as the plain Y product takes them)."""

    _OPERANDS = ()

    def _cached(self, key, make):
        if key not in self._tensors:
            self._tensors[key] = make()
        return self._tensors[key]

    def tensors(self, dtype, device):
        """The operators, rowsum and mask as contiguous tensors, cached: the
        plain version's operands."""
        return self._cached((dtype, str(device)), lambda: tuple(
            torch.as_tensor(getattr(self, a), device=device).to(dtype).contiguous()
            for a in self._OPERANDS))

    def _live_block(self, w, pad):
        """W's live block from the dense float64 ``w``: ``w_live``, the rows
        and columns ``w_live_idx`` = [1, n) u [pad + 1, pad + n), outside
        which W is zero (the slack bus and the padding)."""
        n = self.n
        self.w_live_idx = np.concatenate([np.arange(1, n), pad + np.arange(1, n)])
        self.w_live = w[np.ix_(self.w_live_idx, self.w_live_idx)]

    def _sparse(self, dtype, device):
        """The plain products' operands as tensors, cached: Y's entries
        (``_y_entries``; indices int64, values ``dtype``), then W's live
        rows and columns and its live block."""
        def make():
            as_t = lambda a: torch.as_tensor(a, device=device).to(
                dtype if a.dtype.kind == "f" else torch.long)
            return tuple(map(as_t, (*self._y_entries(), self.w_live_idx, self.w_live)))
        return self._cached(("sparse", dtype, str(device)), make)


def _start(ctx, lanes, vm0, va0, kw):
    """(vm0, va0) as (lanes, n): a flat start where not given."""
    n = ctx.n
    if vm0 is None:
        vm0 = torch.ones((lanes, n), **kw)
        vm0[:, 0] = ctx.slack_vm
    vm0 = vm0.reshape(-1, n).to(kw["dtype"])
    va0 = (torch.zeros((lanes, n), **kw) if va0 is None
           else va0.reshape(-1, n).to(kw["dtype"]))
    return vm0, va0


class NRSmallContext(_PackedOperands):
    """Y-normalized, padded, packed operands of one grid (numpy float64).

    ``ymat``/``wmat`` are ``(2nb, 2nb)``, ``rowsum``/``mask`` ``(2nb, 1)``;
    the float32 casts of these arrays are the JAX package's
    ``PallasNRSmallContext`` operands bit for bit.  The kernel's compressed
    copies are built from the same float64 arrays: Y's rows paired by bus
    (``y_busptr``, ``y_cols``, ``y_vals``: bus b's entries are the union of
    the columns of rows b and nb + b, ascending, each with both rows'
    values) and W's live block ``w_live``, the rows and columns
    ``w_live_idx`` (all but the slack bus and the padding), outside which W
    is zero."""

    _OPERANDS = ("ymat", "wmat", "rowsum", "mask")

    def __init__(self, grid):
        n = grid.n_bus
        nb = _round_up(n, 8)
        g64, b64 = _np64(grid.g_mat), _np64(grid.b_mat)
        y_diag = np.sqrt(np.diag(g64) ** 2 + np.diag(b64) ** 2)
        inv_c = 1.0 / float(np.max(y_diag))
        gs, bs = g64 * inv_c, b64 * inv_c

        def pad(m):
            out = np.zeros((nb, nb), np.float64)
            out[:n, :n] = m
            return out

        # column-vector operator: [Ir; Ii] = ymat @ [e-1; f]
        self.ymat = np.block([[pad(gs), pad(-bs)], [pad(bs), pad(gs)]])
        # preconditioner: [dth; dnu] = wmat @ [fP; fQ]
        w = _np64(grid.j0_inv) / inv_c
        m = n - 1
        wmat = np.zeros((2 * nb, 2 * nb), np.float64)
        for (r, c), (ro, co) in {(0, 0): (1, 1), (0, 1): (1, nb + 1),
                                 (1, 0): (nb + 1, 1),
                                 (1, 1): (nb + 1, nb + 1)}.items():
            wmat[ro:ro + m, co:co + m] = w[r * m:(r + 1) * m, c * m:(c + 1) * m]
        self.wmat = wmat
        rs = np.zeros((2 * nb, 1), np.float64)
        rs[:n, 0] = _np64(grid.rowsum_g) * inv_c
        rs[nb:nb + n, 0] = _np64(grid.rowsum_b) * inv_c
        self.rowsum = rs
        mask = np.zeros((2 * nb, 1), np.float64)
        mask[1:n, 0] = 1.0
        mask[nb + 1:nb + n, 0] = 1.0
        self.mask = mask

        self.n = n
        self.nb = nb
        self.inv_c = inv_c
        self.slack_vm = float(grid.slack_vm)
        self._tensors = {}
        # Y's rows paired by bus: ymat @ x = sum over bus b's entries of
        # y_vals[:, 0] * x[y_cols] into row b, y_vals[:, 1] * x[y_cols]
        # into row nb + b (an exact zero where one row lacks the column)
        bus, self.y_cols = np.nonzero((self.ymat[:nb] != 0) | (self.ymat[nb:] != 0))
        self.y_vals = np.stack([self.ymat[bus, self.y_cols],
                                self.ymat[nb + bus, self.y_cols]], 1)
        self.y_busptr = np.concatenate([[0], np.cumsum(np.bincount(bus, minlength=nb))])
        self._live_block(self.wmat, nb)

    def _y_entries(self):
        return (np.repeat(np.arange(self.nb), np.diff(self.y_busptr)),
                self.y_cols, self.y_vals)

    def kernel_tensors(self, device):
        """The small kernel's operands on ``device``: Y's bus pointers
        (int32) and entries as int32 {column, float32 bits of both rows'
        values, 0}, W's live block (float32) row-major with its rows padded
        to a multiple of 4 floats (16 bytes) with zeros, rowsum and mask
        (float32)."""
        def make():
            lr = self.w_live.shape[0]
            w_live = np.zeros((lr, _round_up(lr, 4)), np.float32)
            w_live[:, :lr] = self.w_live
            bits = self.y_vals.astype(np.float32).view(np.int32)
            ent = np.concatenate([self.y_cols.astype(np.int32)[:, None], bits,
                                  np.zeros((len(bits), 1), np.int32)], 1)
            *_, rowsum, mask = self.tensors(torch.float32, device)
            as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
            return (as_t(self.y_busptr.astype(np.int32)), as_t(ent), as_t(w_live),
                    rowsum, mask)
        return self._cached(("kernel", str(device)), make)

    def y_product(self, x):
        """``ymat @ x`` for ``(2nb, lanes)`` x, from Y's bus rows: the plain
        version of the kernel's Y products."""
        bus, cols, vals, _, _ = self._sparse(x.dtype, x.device)
        out = torch.zeros_like(x)
        xs = x[cols]
        out[:self.nb].index_add_(0, bus, xs * vals[:, :1])
        out[self.nb:].index_add_(0, bus, xs * vals[:, 1:])
        return out

    def w_product(self, x):
        """``wmat @ x`` for ``(2nb, lanes)`` x, on W's live block only: the
        plain version of the kernel's W products."""
        *_, live, w_live = self._sparse(x.dtype, x.device)
        out = torch.zeros_like(x)
        out[live] = w_live @ x[live]
        return out

    def pack(self, p_inj, q_inj, vm0, va0, dtype):
        """Injections and start voltages -> (2nb, lanes) spec and v0
        (padded buses at flat 1+0j)."""
        n, nb = self.n, self.nb
        p = p_inj.reshape(-1, n).to(dtype)
        q = q_inj.reshape(-1, n).to(dtype)
        lanes = p.shape[0]
        kw = dict(dtype=dtype, device=p.device)
        spec = torch.zeros((2 * nb, lanes), **kw)
        spec[:n] = (p * self.inv_c).T
        spec[nb:nb + n] = (q * self.inv_c).T
        vm0, va0 = _start(self, lanes, vm0, va0, kw)
        v0 = torch.zeros((2 * nb, lanes), **kw)
        v0[:nb] = 1.0
        v0[:n] = (vm0 * torch.cos(va0)).T
        v0[nb:nb + n] = (vm0 * torch.sin(va0)).T
        return spec, v0

    def unpack(self, v):
        """(2nb, lanes) solved state -> (e, f), each (lanes, n)."""
        return v[:self.n].T, v[self.nb:self.nb + self.n].T


def _grid_fingerprint(grid):
    """Content key of a grid's solver operands: the exact inputs they are
    built from, never ``id(grid)`` (a recycled id must not alias another
    grid's operators)."""
    h = hashlib.sha1()
    for t in (grid.g_mat, grid.b_mat, grid.j0_inv, grid.rowsum_g, grid.rowsum_b):
        a = np.ascontiguousarray(_np64(t))
        h.update(a.tobytes())
        h.update(repr(a.shape).encode())
    h.update(repr((grid.name, int(grid.n_bus), float(grid.slack_vm))).encode())
    return h.hexdigest()


_CTX_CACHE = {}


def _ctx(cls, grid):
    """The grid's context of class ``cls``, cached by the grid's content."""
    key = (cls, _grid_fingerprint(grid))
    if key not in _CTX_CACHE:
        _CTX_CACHE[key] = cls(grid)
    return _CTX_CACHE[key]


def get_ctx_small(grid) -> NRSmallContext:
    return _ctx(NRSmallContext, grid)


class NRContext(_PackedOperands):
    """Y-normalized, padded, packed operands of one grid for the large
    kernel (numpy float64), lanes-major: ``[e-1, f] @ ypack -> [Ir, Ii]``
    and ``[fP, fQ] @ wpack -> [dtheta, dnu]``.  ``ypack``/``wpack`` are
    ``(2npad, 2npad)``, ``rowsum``/``mask`` ``(1, 2npad)``; the float32
    casts of these arrays are the JAX package's ``PallasNRContext``
    operands bit for bit.  The kernel's compressed copies are built from
    the same float64 arrays: Y's nonzeros by column (``y_colptr``,
    ``y_rows``, ``y_cols``, ``y_vals``) and W's live block ``w_live``, the
    rows and columns ``w_live_idx`` (all but the slack bus and the
    padding), outside which W is zero."""

    _OPERANDS = ("ypack", "wpack", "rowsum", "mask")

    def __init__(self, grid):
        n = grid.n_bus
        npad = _npad(n)
        g64, b64 = _np64(grid.g_mat), _np64(grid.b_mat)
        y_diag = np.sqrt(np.diag(g64) ** 2 + np.diag(b64) ** 2)
        inv_c = 1.0 / float(np.max(y_diag))
        gs, bs = g64 * inv_c, b64 * inv_c

        def pad(m):
            out = np.zeros((npad, npad), np.float64)
            out[:n, :n] = m
            return out

        # pre-transposed blocks: (x @ G^T)_i = sum_j G[i, j] x_j
        self.ypack = np.block([[pad(gs.T), pad(bs.T)],
                               [pad(-bs.T), pad(gs.T)]])
        w = _np64(grid.j0_inv) / inv_c
        m = n - 1
        blk = {}
        for name, (r, c) in {"tp": (0, 0), "tq": (0, 1),
                             "np": (1, 0), "nq": (1, 1)}.items():
            full = np.zeros((npad, npad), np.float64)
            full[1:n, 1:n] = w[r * m:(r + 1) * m, c * m:(c + 1) * m]
            blk[name] = full.T
        self.wpack = np.block([[blk["tp"], blk["np"]],
                               [blk["tq"], blk["nq"]]])
        rs = np.zeros((1, 2 * npad), np.float64)
        rs[0, :n] = _np64(grid.rowsum_g) * inv_c
        rs[0, npad:npad + n] = _np64(grid.rowsum_b) * inv_c
        self.rowsum = rs
        mask = np.zeros((1, 2 * npad), np.float64)
        mask[0, 1:n] = 1.0
        mask[0, npad + 1:npad + n] = 1.0
        self.mask = mask

        self.n = n
        self.npad = npad
        self.inv_c = inv_c
        self.slack_vm = float(grid.slack_vm)
        self._tensors = {}
        # the kernel's compressed operands, from the same float64 operators.
        # Y by output column (CSC, rows ascending in each column):
        # x @ ypack = sum over nonzeros of x[:, y_rows] * y_vals into y_cols
        self.y_cols, self.y_rows = np.nonzero(self.ypack.T)
        self.y_vals = self.ypack[self.y_rows, self.y_cols]
        self.y_colptr = np.concatenate(
            [[0], np.cumsum(np.bincount(self.y_cols, minlength=2 * npad))])
        self._live_block(self.wpack, npad)

    def _y_entries(self):
        return self.y_rows, self.y_cols, self.y_vals

    def kernel_tensors(self, device):
        """The large kernel's operands on ``device``: Y's column pointers
        (int32) and nonzeros as int32 pairs {row, float32 bits of the
        value}, W's live block (float32) with each bus's two output columns
        side by side (column 2j the real half of live bus j, 2j + 1 its
        imaginary half) and its rows padded to 16 bytes, rowsum and mask
        (float32)."""
        def make():
            lr = self.w_live.shape[0]
            w_live = np.zeros((lr, _round_up(lr, 4)), np.float32)
            w_live[:, 0:lr:2] = self.w_live[:, :lr // 2]
            w_live[:, 1:lr:2] = self.w_live[:, lr // 2:]
            ent = np.stack([self.y_rows.astype(np.int32),
                            self.y_vals.astype(np.float32).view(np.int32)], 1)
            *_, rowsum, mask = self.tensors(torch.float32, device)
            as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
            return (as_t(self.y_colptr.astype(np.int32)), as_t(ent),
                    as_t(w_live), rowsum, mask)
        return self._cached(("kernel", str(device)), make)

    def y_product(self, x):
        """``x @ ypack`` for ``(lanes, 2npad)`` x, from Y's compressed
        columns: the plain version of the kernel's Y products."""
        rows, cols, vals, _, _ = self._sparse(x.dtype, x.device)
        out = torch.zeros_like(x)
        return out.index_add_(1, cols, x[:, rows] * vals)

    def w_product(self, x):
        """``x @ wpack`` for ``(lanes, 2npad)`` x, on W's live block only:
        the plain version of the kernel's W products."""
        *_, live, w_live = self._sparse(x.dtype, x.device)
        out = torch.zeros_like(x)
        out[:, live] = x[:, live] @ w_live
        return out

    def pack(self, p_inj, q_inj, vm0, va0, dtype):
        """Injections and start voltages -> (lanes, 2npad) spec and v0
        (padded buses at flat 1+0j).  Lanes are not padded: the kernel
        masks its ragged last block itself."""
        n, npad = self.n, self.npad
        p = p_inj.reshape(-1, n).to(dtype)
        q = q_inj.reshape(-1, n).to(dtype)
        lanes = p.shape[0]
        kw = dict(dtype=dtype, device=p.device)
        spec = torch.zeros((lanes, 2 * npad), **kw)
        spec[:, :n] = p * self.inv_c
        spec[:, npad:npad + n] = q * self.inv_c
        vm0, va0 = _start(self, lanes, vm0, va0, kw)
        v0 = torch.zeros((lanes, 2 * npad), **kw)
        v0[:, :npad] = 1.0
        v0[:, :n] = vm0 * torch.cos(va0)
        v0[:, npad:npad + n] = vm0 * torch.sin(va0)
        return spec, v0

    def unpack(self, v):
        """(lanes, 2npad) solved state -> (e, f), each (lanes, n)."""
        return v[:, :self.n], v[:, self.npad:self.npad + self.n]


def get_ctx(grid) -> NRContext:
    return _ctx(NRContext, grid)


def nr_small_plain(spec, v0, ymat, wmat, rowsum, mask, *, tol, max_iter,
                   inner_iters):
    """Plain PyTorch version of the kernel, on the kernel's own operands:
    packed ``(2nb, lanes)`` ``spec``/``v0`` and the context's operators, in
    their dtype (float64 on the CPU in the tests, float32 on the card when
    it is compared with the kernel).  Returns ``(v, err, n_iter)`` as the
    kernel does.  Reads one flag per iteration back to the host for the
    early exit."""
    nb = spec.shape[0] // 2
    dtype = spec.dtype
    spec = spec * mask
    s_ref = torch.clamp(spec.abs().amax(0), min=1.0)

    def mismatch(v):
        e, f = v[:nb], v[nb:]
        cur = ymat @ torch.cat([e - 1.0, f]) + rowsum
        ir, ii = cur[:nb], cur[nb:]
        pq = torch.cat([e * ir + f * ii, f * ir - e * ii])
        return (spec - pq) * mask, cur

    def newton_dir(fvec, v, cur):
        e, f = v[:nb], v[nb:]
        ir, ii = cur[:nb], cur[nb:]
        d = wmat @ fvec
        for _ in range(inner_iters):
            dth, dnu = d[:nb], d[nb:]
            de = -f * dth + e * dnu
            df = e * dth + f * dnu
            dcur = ymat @ torch.cat([de, df])
            dir_, dii = dcur[:nb], dcur[nb:]
            jv = torch.cat([de * ir + e * dir_ + df * ii + f * dii,
                            df * ir + f * dir_ - de * ii - e * dii]) * mask
            d = d + wmat @ (fvec - jv)
        return d

    v = v0
    fvec, cur = mismatch(v)
    # amax propagates NaN like jnp.max: a NaN lane never reads as done
    err = fvec.abs().amax(0) / s_ref
    done = err < tol
    n_iter = torch.zeros_like(err, dtype=torch.int32)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        d = newton_dir(fvec, v, cur)
        gate = 1.0 - done.to(dtype)
        n_iter = n_iter + (~done).to(torch.int32)
        e, f = v[:nb], v[nb:]
        cos_d = torch.cos(gate * d[:nb])
        sin_d = torch.sin(gate * d[:nb])
        scale = 1.0 + gate * d[nb:]
        e2 = scale * (e * cos_d - f * sin_d)
        f2 = scale * (f * cos_d + e * sin_d)
        v = torch.cat([e2, f2])
        fvec, cur = mismatch(v)
        err = fvec.abs().amax(0) / s_ref
        vm2 = (e2 * e2 + f2 * f2).amax(0)
        done = done | ~torch.isfinite(err) | (err < tol) | (vm2 > 100.0)
    return v, err, n_iter


def _check_operands(name, floats, ints):
    for a, dtype in [(a, torch.float32) for a in floats] + [(a, torch.int32) for a in ints]:
        if a.device.type != "cuda" or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous CUDA tensors, "
                             "float32 (Y's compressed arrays int32)")


def nr_small_kernel(spec, v0, y_busptr, y_ent, w_live, rowsum, mask, *, tol,
                    max_iter, inner_iters):
    """One launch of the CUDA kernel ``csrc/nr_small.cu`` on packed float32
    ``(2nb, lanes)`` ``spec``/``v0`` and the context's
    :meth:`NRSmallContext.kernel_tensors` on the card (the function of
    :func:`nr_small_plain`); raises if the launch fails.  This is the
    kernel's only launch site, and it counts each launch in
    ``nr_solve_small.launches``."""
    nb, lanes = spec.shape[0] // 2, spec.shape[1]
    if nb > SMALL_NB or nb % 8:
        raise ValueError(f"nr_small_kernel: nb={nb}; the kernel holds "
                         f"nb <= {SMALL_NB}, a multiple of 8")
    n = w_live.shape[0] // 2 + 1
    _check_operands("nr_small_kernel", (spec, v0, w_live, rowsum, mask),
                    (y_busptr, y_ent))
    if (y_busptr.shape != (nb + 1,) or y_ent.shape[1:] != (4,)
            or w_live.shape[1] % 4 or not 2 <= n <= nb):
        raise ValueError(f"nr_small_kernel: operand shapes do not match nb={nb}")
    v = torch.empty_like(v0)
    err = torch.empty(lanes, dtype=torch.float32, device=v0.device)
    n_iter = torch.empty(lanes, dtype=torch.int32, device=v0.device)
    lib = _kernel_lib("nr_small")
    rc = lib.nr_small_launch(
        spec.data_ptr(), v0.data_ptr(), y_busptr.data_ptr(), y_ent.data_ptr(),
        w_live.data_ptr(), rowsum.data_ptr(), mask.data_ptr(), v.data_ptr(),
        err.data_ptr(), n_iter.data_ptr(), lanes, nb, n, y_ent.shape[0],
        w_live.shape[1], float(tol), int(max_iter), int(inner_iters),
        torch.cuda.current_stream(v0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("nr_small kernel launch failed: "
                           + lib.nr_small_error_string(rc).decode())
    nr_solve_small.launches += 1
    return v, err, n_iter


def _kernel_config(name, *args):
    """A kernel instance's resources (needs the card): dynamic and static
    shared memory per block in bytes, registers a thread and local memory
    (stack frame and spills) a thread in bytes."""
    cfg = (ctypes.c_int * 4)()
    lib = _kernel_lib(name)
    rc = getattr(lib, f"{name}_config")(*args, ctypes.addressof(cfg))
    if rc != 0:
        raise RuntimeError(f"{name}_config failed: "
                           + getattr(lib, f"{name}_error_string")(rc).decode())
    return dict(zip(("dynamic_smem_bytes", "static_smem_bytes", "registers",
                     "local_bytes"), cfg))


def nr_small_config(ctx):
    """The small kernel's instance for the grid of ``ctx`` (needs the card),
    as :func:`_kernel_config` gives it."""
    w_stride = _round_up(ctx.w_live.shape[0], 4)
    return _kernel_config("nr_small", ctx.nb, ctx.n, len(ctx.y_cols), w_stride)


def _solve(core, dtype, grid, ctx, p_inj, q_inj, tol, max_iter, inner_iters,
           vm0, va0, operands=None):
    """Pack, run ``core`` on ``operands`` (the context's plain operands in
    ``dtype`` when not given), unpack to a PFResult in the input's dtype."""
    spec, v0 = ctx.pack(p_inj, q_inj, vm0, va0, dtype)
    if operands is None:
        operands = ctx.tensors(dtype, p_inj.device)
    v, err, n_iter = core(spec, v0, *operands, tol=tol,
                          max_iter=max_iter, inner_iters=inner_iters)
    e, f = (x.to(p_inj.dtype) for x in ctx.unpack(v))
    vm = torch.sqrt(e * e + f * f)
    va = torch.atan2(f, e)
    converged = (err < tol) & torch.isfinite(err)
    return _result(grid, vm, va, converged, n_iter.to(torch.int32),
                   p_inj.shape[:-1])


def _dispatch(name, kernel, plain, ctx_of, grid, p_inj, q_inj, tol, max_iter,
              inner_iters, vm0, va0, ctx):
    """CPU tensors take the plain version in their dtype; CUDA tensors the
    kernel in float32 on its own operands (or its wrapper raises); other
    devices raise."""
    ctx = ctx_of(grid) if ctx is None else ctx
    dev = p_inj.device.type
    if dev == "cpu":
        core, dtype, operands = plain, p_inj.dtype, None
    elif dev == "cuda":
        core, dtype = kernel, torch.float32
        operands = ctx.kernel_tensors(p_inj.device)
    else:
        raise ValueError(f"{name}: unsupported device {p_inj.device}")
    return _solve(core, dtype, grid, ctx, p_inj, q_inj, tol, max_iter,
                  inner_iters, vm0, va0, operands)


def nr_solve_small_ref(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20,
                       inner_iters=3, vm0=None, va0=None, ctx=None):
    """Batched NR solve of ``(..., n_bus)`` injections through the plain
    version :func:`nr_small_plain`, in the input's dtype.  ``ctx`` is the
    grid's :class:`NRSmallContext`, looked up by content when not given."""
    ctx = get_ctx_small(grid) if ctx is None else ctx
    return _solve(nr_small_plain, p_inj.dtype, grid, ctx, p_inj, q_inj, tol,
                  max_iter, inner_iters, vm0, va0)


def nr_solve_small(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20,
                   inner_iters=3, vm0=None, va0=None, ctx=None):
    """Batched NR solve of ``(..., n_bus)`` injections through the CUDA
    kernel (float32 inside, result cast back to the input's dtype).  CPU
    tensors take :func:`nr_small_plain`; CUDA tensors launch the kernel or
    raise.  ``ctx`` as in :func:`nr_solve_small_ref`."""
    return _dispatch("nr_solve_small", nr_small_kernel, nr_small_plain,
                     get_ctx_small, grid, p_inj, q_inj, tol, max_iter,
                     inner_iters, vm0, va0, ctx)


nr_solve_small.launches = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each kernel library's C functions: name -> (argument types, result type)
_SIGNATURES = {
    "nr_small": {"nr_small_launch": ([_P] * 10 + [_I] * 5 + [_F, _I, _I, _P], _I),
                 "nr_small_config": ([_I] * 4 + [_P], _I),
                 "nr_small_error_string": ([_I], ctypes.c_char_p)},
    "nr_large": {"nr_large_launch": ([_P] * 10 + [_I] * 5 + [_F, _I, _I, _P], _I),
                 "nr_large_config": ([_I, _I, _P], _I),
                 "nr_large_error_string": ([_I], ctypes.c_char_p)},
}


def _kernel_lib(name):
    lib = cuda_build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._typed = True
    return lib


def nr_large_plain(spec, v0, ypack, wpack, rowsum, mask, *, tol, max_iter,
                   inner_iters):
    """Plain PyTorch version of the large kernel, on the kernel's own
    operands: packed ``(lanes, 2npad)`` ``spec``/``v0``, the context's
    ``(2npad, 2npad)`` operators and ``(1, 2npad)`` rowsum and mask.
    Returns ``(v, err, n_iter)`` as the kernel does.

    ``_nr_kernel`` computes the function of ``_nr_kernel_small`` in the
    transposed layout (``ypack`` is the small kernel's operator transposed,
    with other padding), so this runs :func:`nr_small_plain` on transposed
    views."""
    v, err, n_iter = nr_small_plain(spec.T, v0.T, ypack.T, wpack.T, rowsum.T,
                                    mask.T, tol=tol, max_iter=max_iter,
                                    inner_iters=inner_iters)
    return v.T, err, n_iter


def _check_npad(name, npad):
    if npad not in LARGE_NPADS:
        raise ValueError(f"{name}: npad={npad}; the large kernel holds "
                         f"npad in {LARGE_NPADS}")


def nr_large_kernel(spec, v0, y_colptr, y_ent, w_live, rowsum, mask, *, tol,
                    max_iter, inner_iters):
    """One launch of the CUDA kernel ``csrc/nr_large.cu`` on packed float32
    ``(lanes, 2npad)`` ``spec``/``v0`` and the context's
    :meth:`NRContext.kernel_tensors` on the card (the function of
    :func:`nr_large_plain`); raises if the launch fails.  This is the
    kernel's only launch site, and it counts each launch in
    ``nr_solve_large.launches``."""
    lanes, npad = spec.shape[0], spec.shape[1] // 2
    _check_npad("nr_large_kernel", npad)
    n = w_live.shape[0] // 2 + 1
    _check_operands("nr_large_kernel", (spec, v0, w_live, rowsum, mask),
                    (y_colptr, y_ent))
    if (y_colptr.shape != (2 * npad + 1,) or y_ent.shape[1:] != (2,)
            or w_live.shape[1] % 4 or not 2 <= n <= npad):
        raise ValueError("nr_large_kernel: operand shapes do not match npad="
                         f"{npad}")
    v = torch.empty_like(v0)
    err = torch.empty(lanes, dtype=torch.float32, device=v0.device)
    n_iter = torch.empty(lanes, dtype=torch.int32, device=v0.device)
    lib = _kernel_lib("nr_large")
    rc = lib.nr_large_launch(
        spec.data_ptr(), v0.data_ptr(), y_colptr.data_ptr(), y_ent.data_ptr(),
        w_live.data_ptr(), rowsum.data_ptr(), mask.data_ptr(), v.data_ptr(),
        err.data_ptr(), n_iter.data_ptr(), lanes, npad, n, y_ent.shape[0],
        w_live.shape[1], float(tol), int(max_iter), int(inner_iters),
        torch.cuda.current_stream(v0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("nr_large kernel launch failed: "
                           + lib.nr_large_error_string(rc).decode())
    nr_solve_large.launches += 1
    return v, err, n_iter


def nr_large_config(ctx):
    """The large kernel's instance for the grid of ``ctx`` (needs the card),
    as :func:`_kernel_config` gives it."""
    return _kernel_config("nr_large", ctx.npad, len(ctx.y_vals))


def nr_solve_large_ref(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20,
                       inner_iters=3, vm0=None, va0=None, ctx=None):
    """Batched NR solve of ``(..., n_bus)`` injections through the plain
    version :func:`nr_large_plain`, in the input's dtype.  ``ctx`` is the
    grid's :class:`NRContext`, looked up by content when not given."""
    ctx = get_ctx(grid) if ctx is None else ctx
    return _solve(nr_large_plain, p_inj.dtype, grid, ctx, p_inj, q_inj, tol,
                  max_iter, inner_iters, vm0, va0)


def nr_solve_large(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20,
                   inner_iters=3, vm0=None, va0=None, ctx=None):
    """Batched NR solve of ``(..., n_bus)`` injections through the large
    CUDA kernel (float32 inside, result cast back to the input's dtype).
    CPU tensors take :func:`nr_large_plain`; CUDA tensors launch the kernel
    or raise.  ``ctx`` as in :func:`nr_solve_large_ref`."""
    return _dispatch("nr_solve_large", nr_large_kernel, nr_large_plain,
                     get_ctx, grid, p_inj, q_inj, tol, max_iter, inner_iters,
                     vm0, va0, ctx)


nr_solve_large.launches = 0


def solver_path(n_bus, backend="auto"):
    """The solver :func:`make_solver` builds for a grid of ``n_bus`` buses:
    ``"small"`` (:func:`nr_solve_small`), ``"large"``
    (:func:`nr_solve_large`) or ``"torch"`` (:func:`nr_solve`)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown pf backend '{backend}'")
    if backend == "torch":
        return "torch"
    if n_bus <= SMALL_NB:
        return "small"
    return "large"


def make_solver(grid, *, backend="auto", tol=1e-7, max_iter=20, inner_iters=3,
                fixed_iter=None):
    """Batched solver ``solve(p, q, vm0, va0) -> PFResult`` for one grid,
    chosen by configuration, never by failure:

    * ``"auto"``: the small kernel's path (:func:`nr_solve_small`) for
      grids with n_bus <= 64, the large kernel's (:func:`nr_solve_large`)
      above;
    * ``"torch"``: always :func:`nr_solve`, the reference path.

    "auto" is set by measurement on one NVIDIA H100 80GB HBM3 at its
    700.00 W limit (``chip_smoke.py [solvers]``; PERF.md, PR 9): the whole
    solve as the env pays it, median of 20 calls, flat / warm start, ms,

    ======== ===== ================= =================
    grid     lanes large kernel     torch-op solver
    ======== ===== ================= =================
    case69   512   1.1998 / 1.8530  3.5267 / 2.4938
    case69   4096  1.7929 / 1.6909  4.0622 / 2.7471
    case141  512   1.3091 / 1.5201  5.5853 / 5.7816
    case141  4096  1.6183 / 1.6026  4.2033 / 5.3631
    ======== ===== ================= =================

    so every grid above 64 buses takes the large kernel.  The JAX
    package's rule (its XLA solver up to 200 buses, measured on a TPU)
    does not carry over.

    The kernel paths take their plain versions for CPU tensors.
    A grid off the CPU that the large kernel cannot hold (npad above
    ``LARGE_NPADS``) raises here, when the solver is built, not at its
    first solve.

    ``fixed_iter`` goes to the torch-op :func:`nr_solve` only; the kernels
    run their loops on the card, where the early exit costs no host
    read-back, and ignore it (as pallas_nr.py:590-599 says of the Pallas
    kernels).
    """
    kw = dict(tol=tol, max_iter=max_iter, inner_iters=inner_iters)
    path = solver_path(grid.n_bus, backend)
    # each context is resolved here, once: its content key reads the grid's
    # operators back to the host, which must not happen per solve
    if path == "small":
        ctx = get_ctx_small(grid)
        return lambda p, q, vm0=None, va0=None: nr_solve_small(
            grid, p, q, vm0=vm0, va0=va0, ctx=ctx, **kw)
    if path == "large":
        if grid.device.type != "cpu":
            _check_npad("make_solver", _npad(grid.n_bus))
        ctx = get_ctx(grid)
        return lambda p, q, vm0=None, va0=None: nr_solve_large(
            grid, p, q, vm0=vm0, va0=va0, ctx=ctx, **kw)
    ops = packed_operators(grid)
    return lambda p, q, vm0=None, va0=None: nr_solve(
        grid, p, q, vm0=vm0, va0=va0, ops=ops, fixed_iter=fixed_iter, **kw)
