"""Build the port's hand-written CUDA kernels at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds.  Libraries land in
``build/mapdn_torch_kernels/`` at the repository root, named by a hash of
the flags, the source and the csrc/ files it includes, so an edited source
or header is never served a stale binary.

Full-precision float32 only: no ``--use_fast_math`` (keeps IEEE division
and the precise ``sinf``/``cosf``/``sincosf``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "mapdn_torch_kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every kernel source of csrc/; the first load builds them all, in parallel
KERNELS = ("nr_small", "nr_large", "policy_gru")
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path, seen):
    """``path`` and every file it includes with ``#include "..."`` that
    exists beside it, recursively, each once."""
    path = os.path.normpath(path)
    if path in seen:
        return
    seen.append(path)
    with open(path, "rb") as fh:
        text = fh.read()
    for inc in _INCLUDE.findall(text):
        dep = os.path.join(os.path.dirname(path), inc.decode())
        if os.path.isfile(dep):
            _sources(dep, seen)


def _lib_path(name):
    """The source of kernel ``name`` and its library's path, named by a hash
    of the flags, the source and every file of csrc/ it includes."""
    src = os.path.join(CSRC, f"{name}.cu")
    files = []
    _sources(src, files)
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for path in files:
        with open(path, "rb") as fh:
            h.update(os.path.relpath(path, CSRC).encode() + b"\0" + fh.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(*names):
    """Compile the kernels ``csrc/<name>.cu`` that are not built yet, one
    ``nvcc`` process per source, all started together; raise with the
    compiler's output if any fails."""
    jobs = []
    for name in names:
        src, out = _lib_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tmp, out, proc, time.perf_counter()))
    failed = []
    for name, tmp, out, proc, t0 in jobs:
        log = proc.communicate()[0]
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"CUDA kernel build failed: {name} (nvcc exit "
                          f"{proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name):
    """The ``ctypes`` library of one kernel; the first load builds every
    kernel of :data:`KERNELS` not built yet, together."""
    if name not in _LIBS:
        build(*KERNELS)
        _LIBS[name] = ctypes.CDLL(_lib_path(name)[1])
    return _LIBS[name]
