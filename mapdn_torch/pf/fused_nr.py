"""Whole-solve batched Newton-Raphson for small grids: CUDA kernel + plain twin.

Port of the small-grid half of ``mapdn_tpu/pf/pallas_nr.py``: the packed,
transposed operands (``NRSmallContext``, from ``PallasNRSmallContext``); the
Pallas kernel ``_nr_kernel_small``, which becomes the CUDA kernel
``csrc/nr_small.cu`` launched by :func:`nr_small_kernel`, beside its plain
PyTorch version :func:`nr_small_plain` on the same packed operands; the
solvers around each, :func:`nr_solve_small` (from ``nr_solve_pallas_small``)
and :func:`nr_solve_small_ref`; and the dispatcher :func:`make_solver` (in
place of ``make_auto_solver``).

Layout: buses on rows (padded to ``nb = round_up(n, 8)``), lanes on
columns; every state array is ``(2nb, lanes)`` of [real-half; imag-half] and
the operators act by left-multiplication.  The algorithm is that of
:func:`mapdn_torch.pf.newton.nr_solve`; the kernel carries the mismatch
between iterations, so each iteration evaluates it once.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors: there is no fall-back from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from mapdn_torch.pf.newton import _result, nr_solve, packed_operators
from mapdn_torch.utils import cuda_build


SMALL_NB = 64   # the kernel's (and pallas_nr.py's `small`) bus-count bound


def _round_up(x, m):
    return -(-x // m) * m


class NRSmallContext:
    """Y-normalized, padded, packed operands of one grid (numpy float64).

    ``ymat``/``wmat`` are ``(2nb, 2nb)``, ``rowsum``/``mask`` ``(2nb, 1)``;
    the float32 casts of these arrays are the JAX package's
    ``PallasNRSmallContext`` operands bit for bit."""

    def __init__(self, grid):
        n = grid.n_bus
        nb = _round_up(n, 8)
        g64 = grid.g_mat.detach().cpu().double().numpy()
        b64 = grid.b_mat.detach().cpu().double().numpy()
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
        w = grid.j0_inv.detach().cpu().double().numpy() / inv_c
        m = n - 1
        wmat = np.zeros((2 * nb, 2 * nb), np.float64)
        for (r, c), (ro, co) in {(0, 0): (1, 1), (0, 1): (1, nb + 1),
                                 (1, 0): (nb + 1, 1),
                                 (1, 1): (nb + 1, nb + 1)}.items():
            wmat[ro:ro + m, co:co + m] = w[r * m:(r + 1) * m, c * m:(c + 1) * m]
        self.wmat = wmat
        rs = np.zeros((2 * nb, 1), np.float64)
        rs[:n, 0] = grid.rowsum_g.detach().cpu().double().numpy() * inv_c
        rs[nb:nb + n, 0] = grid.rowsum_b.detach().cpu().double().numpy() * inv_c
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

    def tensors(self, dtype, device):
        """(ymat, wmat, rowsum, mask) as contiguous tensors, cached."""
        key = (dtype, str(device))
        if key not in self._tensors:
            self._tensors[key] = tuple(
                torch.as_tensor(a, device=device).to(dtype).contiguous()
                for a in (self.ymat, self.wmat, self.rowsum, self.mask))
        return self._tensors[key]


def _grid_fingerprint(grid):
    """Content key of a grid's solver operands: the exact inputs they are
    built from, never ``id(grid)`` (a recycled id must not alias another
    grid's operators)."""
    h = hashlib.sha1()
    for t in (grid.g_mat, grid.b_mat, grid.j0_inv, grid.rowsum_g, grid.rowsum_b):
        a = np.ascontiguousarray(t.detach().cpu().double().numpy())
        h.update(a.tobytes())
        h.update(repr(a.shape).encode())
    h.update(repr((grid.name, int(grid.n_bus), float(grid.slack_vm))).encode())
    return h.hexdigest()


_CTX_SMALL_CACHE = {}


def get_ctx_small(grid) -> NRSmallContext:
    key = _grid_fingerprint(grid)
    if key not in _CTX_SMALL_CACHE:
        _CTX_SMALL_CACHE[key] = NRSmallContext(grid)
    return _CTX_SMALL_CACHE[key]


def _pack(ctx, p_inj, q_inj, vm0, va0, dtype):
    """Injections and start voltages -> (2nb, lanes) spec and v0 (padded
    buses at flat 1+0j)."""
    n, nb = ctx.n, ctx.nb
    p = p_inj.reshape(-1, n).to(dtype)
    q = q_inj.reshape(-1, n).to(dtype)
    lanes = p.shape[0]
    kw = dict(dtype=dtype, device=p.device)
    spec = torch.zeros((2 * nb, lanes), **kw)
    spec[:n] = (p * ctx.inv_c).T
    spec[nb:nb + n] = (q * ctx.inv_c).T
    if vm0 is None:
        vm0 = torch.ones((lanes, n), **kw)
        vm0[:, 0] = ctx.slack_vm
    vm0 = vm0.reshape(-1, n).to(dtype)
    va0 = (torch.zeros((lanes, n), **kw) if va0 is None
           else va0.reshape(-1, n).to(dtype))
    v0 = torch.zeros((2 * nb, lanes), **kw)
    v0[:nb] = 1.0
    v0[:n] = (vm0 * torch.cos(va0)).T
    v0[nb:nb + n] = (vm0 * torch.sin(va0)).T
    return spec, v0


def _unpack(grid, ctx, v, err, n_iter, tol, batch_shape, dtype):
    n, nb = ctx.n, ctx.nb
    e = v[:n].T.to(dtype)
    f = v[nb:nb + n].T.to(dtype)
    vm = torch.sqrt(e * e + f * f)
    va = torch.atan2(f, e)
    converged = (err < tol) & torch.isfinite(err)
    return _result(grid, vm, va, converged, n_iter.to(torch.int32), batch_shape)


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


def nr_small_kernel(spec, v0, ymat, wmat, rowsum, mask, *, tol, max_iter,
                    inner_iters):
    """One launch of the CUDA kernel ``csrc/nr_small.cu`` on packed float32
    operands on the card (see :func:`nr_small_plain`); raises if the launch
    fails.  This is the kernel's only launch site, and it counts each
    launch in ``nr_solve_small.launches``."""
    nb, lanes = spec.shape[0] // 2, spec.shape[1]
    args = (spec, v0, ymat, wmat, rowsum, mask)
    if nb > SMALL_NB or nb % 8:
        raise ValueError(f"nr_small_kernel: nb={nb}; the kernel holds "
                         f"nb <= {SMALL_NB}, a multiple of 8")
    for a in args:
        if a.device.type != "cuda" or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("nr_small_kernel: operands must be contiguous "
                             "float32 CUDA tensors")
    v = torch.empty_like(v0)
    err = torch.empty(lanes, dtype=torch.float32, device=v0.device)
    n_iter = torch.empty(lanes, dtype=torch.int32, device=v0.device)
    lib = _kernel_lib()
    rc = lib.nr_small_launch(
        *(a.data_ptr() for a in args), v.data_ptr(), err.data_ptr(),
        n_iter.data_ptr(), lanes, nb, float(tol), int(max_iter),
        int(inner_iters), torch.cuda.current_stream(v0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("nr_small kernel launch failed: "
                           + lib.nr_small_error_string(rc).decode())
    nr_solve_small.launches += 1
    return v, err, n_iter


def _solve(core, dtype, grid, ctx, p_inj, q_inj, tol, max_iter, inner_iters,
           vm0, va0):
    ctx = get_ctx_small(grid) if ctx is None else ctx
    spec, v0 = _pack(ctx, p_inj, q_inj, vm0, va0, dtype)
    v, err, n_iter = core(spec, v0, *ctx.tensors(dtype, p_inj.device), tol=tol,
                          max_iter=max_iter, inner_iters=inner_iters)
    return _unpack(grid, ctx, v, err, n_iter, tol, p_inj.shape[:-1], p_inj.dtype)


def nr_solve_small_ref(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20,
                       inner_iters=3, vm0=None, va0=None, ctx=None):
    """Batched NR solve of ``(..., n_bus)`` injections through the plain
    version :func:`nr_small_plain`, in the input's dtype.  ``ctx`` is the
    grid's :class:`NRSmallContext`, looked up by content when not given."""
    return _solve(nr_small_plain, p_inj.dtype, grid, ctx, p_inj, q_inj, tol,
                  max_iter, inner_iters, vm0, va0)


def nr_solve_small(grid, p_inj, q_inj, *, tol=1e-7, max_iter=20,
                   inner_iters=3, vm0=None, va0=None, ctx=None):
    """Batched NR solve of ``(..., n_bus)`` injections through the CUDA
    kernel (float32 inside, result cast back to the input's dtype).  CPU
    tensors take :func:`nr_solve_small_ref`; CUDA tensors launch the kernel
    or raise.  ``ctx`` as in :func:`nr_solve_small_ref`."""
    if p_inj.device.type == "cpu":
        return nr_solve_small_ref(grid, p_inj, q_inj, tol=tol,
                                  max_iter=max_iter, inner_iters=inner_iters,
                                  vm0=vm0, va0=va0, ctx=ctx)
    if p_inj.device.type != "cuda":
        raise ValueError(f"nr_solve_small: unsupported device {p_inj.device}")
    return _solve(nr_small_kernel, torch.float32, grid, ctx, p_inj, q_inj, tol,
                  max_iter, inner_iters, vm0, va0)


nr_solve_small.launches = 0


def _kernel_lib():
    lib = cuda_build.load("nr_small")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.nr_small_launch.argtypes = [P] * 9 + [I, I, ctypes.c_float, I, I, P]
        lib.nr_small_launch.restype = I
        lib.nr_small_error_string.argtypes = [I]
        lib.nr_small_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def make_solver(grid, *, backend="auto", tol=1e-7, max_iter=20, inner_iters=3):
    """Batched solver ``solve(p, q, vm0, va0) -> PFResult`` for one grid,
    chosen by configuration, never by failure:

    * ``"auto"``: the kernel path (:func:`nr_solve_small`) for grids with
      n_bus <= 64, the torch-op :func:`nr_solve` above that (the large-grid
      kernel is not ported yet);
    * ``"kernel"``: always :func:`nr_solve_small`;
    * ``"torch"``: always :func:`nr_solve`.

    The kernel path takes its plain version for CPU tensors.  Unlike the
    JAX package's ``"auto"`` (XLA for n_bus <= 200), case33 runs the kernel.
    """
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown pf backend '{backend}'")
    kw = dict(tol=tol, max_iter=max_iter, inner_iters=inner_iters)
    if backend == "kernel" or (backend == "auto" and grid.n_bus <= SMALL_NB):
        # the context is resolved here, once: its content key reads the
        # grid's operators back to the host, which must not happen per solve
        ctx = get_ctx_small(grid)
        return lambda p, q, vm0=None, va0=None: nr_solve_small(
            grid, p, q, vm0=vm0, va0=va0, ctx=ctx, **kw)
    ops = packed_operators(grid)
    return lambda p, q, vm0=None, va0=None: nr_solve(
        grid, p, q, vm0=vm0, va0=va0, ops=ops, **kw)
