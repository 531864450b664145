"""Build the port's hand-written CUDA kernels at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds.  Libraries land in
``build/mapdn_torch_kernels/`` at the repository root, named by a hash of
the source and flags, so an edited source is never served a stale binary.

Full-precision float32 only: no ``--use_fast_math`` (keeps IEEE division
and the precise ``sinf``/``cosf``/``sincosf``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "mapdn_torch_kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}
BUILD_LOG = {}   # name -> {"seconds": float, "ptxas": str}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from csrc/ at first use")


def _lib_path(name):
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(name):
    """Compile the kernel ``csrc/<name>.cu`` unless it is built already;
    raise with the compiler's output if it fails."""
    src, out = _lib_path(name)
    if os.path.exists(out):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout}
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: {name} (nvcc exit "
                           f"{proc.returncode})\n{proc.stdout}")
    os.replace(tmp, out)


def load(name):
    """The ``ctypes`` library of one kernel, built on first use."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(_lib_path(name)[1])
    return _LIBS[name]
