"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`.  The build
runs at first use, never at import, into ``build/cuda/`` at the repository
root (listed in ``.gitignore``), and is redone when the source is newer than
the library.  No ``--use_fast_math``: the tile-density membership test must
stay bit-exact and ``expf`` keeps its IEEE rounding.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}          # name -> ctypes.CDLL, loaded once per process
BUILD_LOG: dict = {}      # name -> {"seconds": float, "ptxas": str}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "coulomb_gmg_tpu_torch need the CUDA toolkit")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``build/cuda/lib<name>.so`` if it is
    missing or stale; returns the library path."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    fresh = lambda: (os.path.isfile(so)
                     and os.path.getmtime(so) >= os.path.getmtime(src))
    if fresh():
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one process builds while the others wait; a library appears whole
    # (os.replace), never half-written
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.time()
        p = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{p.stderr}")
        os.replace(tmp, so)
    BUILD_LOG[name] = {"seconds": time.time() - t0, "ptxas": p.stderr}
    return so


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use.

    ``signatures`` maps each exported C function to its ctypes argtypes;
    every function returns the ``cudaError_t`` of its launch as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")
