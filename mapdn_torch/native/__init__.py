"""The float64 C++ Newton-Raphson power-flow oracle, bound with ctypes.

``src/pf_oracle.cpp`` (the port's own copy of the JAX package's oracle)
solves each lane with the MATPOWER polar Jacobian and a partial-pivot LU,
lanes farmed over OpenMP threads: an implementation independent of the
batched solvers of :mod:`mapdn_torch.pf`, for parity checks and baselines.

The library is built with ``g++`` at first use into ``build/mapdn_torch_native/``
at the repository root, named by a hash of the flags and the source, so an
edited source is never served a stale binary.  A failed build raises when
the oracle is called; nothing stands in for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from mapdn_torch.utils import cuda_build

ABI_VERSION = 1
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "pf_oracle.cpp")
# beside the kernels' build directory, under the repository root's build/
BUILD_DIR = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "mapdn_torch_native")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]

_lock = threading.Lock()
_lib = None


def _lib_path():
    h = hashlib.sha1(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libmapdn_native-{h.hexdigest()[:12]}.so")


def _build(out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("native oracle build failed: g++ not found") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"native oracle build failed (g++ exit {proc.returncode})\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib():
    """The loaded oracle library, built on first use; raises if the build
    or the load fails, or if its ABI is not the one bound here."""
    global _lib
    with _lock:
        if _lib is None:
            out = _lib_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.mapdn_nr_solve_batch.argtypes = [
                dp, dp, ctypes.c_int, dp, dp, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, dp, dp, ip, ip]
            lib.mapdn_nr_solve_batch.restype = None
            lib.mapdn_native_abi_version.argtypes = []
            lib.mapdn_native_abi_version.restype = ctypes.c_int
            if lib.mapdn_native_abi_version() != ABI_VERSION:
                raise RuntimeError(f"native oracle ABI {lib.mapdn_native_abi_version()}, "
                                   f"expected {ABI_VERSION}")
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the oracle builds and loads here (``get_lib`` raises why
    not)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f64(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float64)


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def nr_solve_batch(g_mat, b_mat, p_inj, q_inj, *, slack_vm=1.0, tol=1e-8,
                   max_iter=30):
    """Batched float64 NR oracle: ``(n, n)`` Ybus parts and ``(..., n)``
    injections [pu] (generation positive, bus 0 slack; numpy arrays or CPU
    tensors), as :func:`mapdn_torch.pf.reference.nr_solve_ref` takes them.
    Returns numpy ``(vm, va, converged, n_iter)`` with the batch shape
    kept."""
    g, b = _f64(g_mat), _f64(b_mat)
    n = g.shape[0]
    if g.shape != (n, n) or b.shape != (n, n):
        raise ValueError(f"nr_solve_batch: Ybus parts {g.shape}, {b.shape}")
    p, q = _f64(p_inj), _f64(q_inj)
    if p.shape != q.shape or p.shape[-1] != n:
        raise ValueError(f"nr_solve_batch: injections {p.shape}, {q.shape} for {n} buses")
    batch_shape = p.shape[:-1]
    p, q = p.reshape(-1, n), q.reshape(-1, n)
    batch = p.shape[0]
    vm = np.empty((batch, n))
    va = np.empty((batch, n))
    conv = np.empty(batch, np.int32)
    iters = np.empty(batch, np.int32)
    ip = ctypes.POINTER(ctypes.c_int32)
    get_lib().mapdn_nr_solve_batch(
        _dp(g), _dp(b), n, _dp(p), _dp(q), batch, float(slack_vm), float(tol),
        int(max_iter), _dp(vm), _dp(va), conv.ctypes.data_as(ip),
        iters.ctypes.data_as(ip))
    shp = batch_shape + (n,)
    return (vm.reshape(shp), va.reshape(shp), conv.reshape(batch_shape).astype(bool),
            iters.reshape(batch_shape))
