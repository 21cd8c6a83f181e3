"""ctypes bridge to the native host engine (csrc/forest_engine.cpp).

Builds the shared library on first use (g++, into ``build/native/<host>/``
at the repository root, redone when the source is newer) and exposes its
two primitives, the atom-cell locality lists (:func:`atom_lists`) and the
CSR to sliced-ELL conversion (:func:`csr_to_sliced`); each returns None
without the engine and its caller takes a numpy path, so the framework
runs identically with or without a compiler.  The library
is built with ``-march=native``, so ``<host>`` names what that resolves to
on this machine: a library built on another CPU is never loaded.  A failed
build or load prints one warning and takes the numpy path;
``CGMG_NO_NATIVE=1`` takes it silently.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "forest_engine.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
            "-shared"]


def host_key() -> str:
    """The machine and a digest of the target options ``-march=native``
    selects here (``g++ -Q --help=target``)."""
    opts = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    return (f"{platform.machine()}-"
            f"{hashlib.sha256(opts.encode()).hexdigest()[:16]}")


def library_path() -> str:
    return os.path.join(_BUILD_DIR, host_key(), "libforest_engine.so")


def _build(so: str) -> None:
    """Compile the engine unless an up-to-date library exists; a file lock
    lets one of several processes build while the others wait."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.isfile(so)
                and os.path.getmtime(so) >= os.path.getmtime(_SRC)):
            return
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("CGMG_NO_NATIVE"):
            return None
        try:
            so = library_path()
            _build(so)
            lib = ctypes.CDLL(so)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.cgmg_atom_lists.restype = None
            lib.cgmg_atom_lists.argtypes = [
                f64p, f64p, ctypes.c_int64, ctypes.c_int64,
                f64p, i64p, i64p, i64p, f64p,
                ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
                ctypes.c_void_p, i64p]
            lib.cgmg_csr_to_sliced.restype = None
            lib.cgmg_csr_to_sliced.argtypes = [
                i64p, i64p, u8p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, i64p, i32p, u8p]
            _LIB = lib
        except Exception as e:
            err = getattr(e, "stderr", None)        # g++'s, when it failed
            if isinstance(err, bytes):
                err = err.decode(errors="replace")
            why = (err or str(e)).strip().splitlines() or [type(e).__name__]
            print(f"[native] forest engine unavailable, host topology takes "
                  f"the numpy path: {why[-1]}", file=sys.stderr, flush=True)
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def atom_lists(lower: np.ndarray, h: np.ndarray, sorted_pos: np.ndarray,
               aorder: np.ndarray, bstarts: np.ndarray, bshape: np.ndarray,
               borigin: np.ndarray, pitch: float, cutoff: float):
    """Native atom-cell locality lists (None if the engine is unavailable).

    Returns the compact lists ``(ptr (m + 1,) int64, atoms (ptr[-1],)
    int32)``: cell c's atoms are ``atoms[ptr[c]:ptr[c + 1]]``.  Inputs are
    the spatial-hash tables of ops.neighbors.build_atom_buckets.
    """
    lib = _load()
    if lib is None:
        return None
    lower = np.ascontiguousarray(lower, np.float64)
    h = np.ascontiguousarray(h, np.float64)
    sorted_pos = np.ascontiguousarray(sorted_pos, np.float64)
    aorder = np.ascontiguousarray(aorder, np.int64)
    bstarts = np.ascontiguousarray(bstarts, np.int64)
    bshape = np.ascontiguousarray(bshape, np.int64)
    borigin = np.ascontiguousarray(borigin, np.float64)
    m, dim = lower.shape
    counts = np.empty(m, dtype=np.int64)
    args = (lower, h, m, dim, sorted_pos, aorder, bstarts, bshape, borigin,
            float(pitch), float(cutoff))
    lib.cgmg_atom_lists(*args, None, None, counts)
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    atoms = np.empty(int(ptr[-1]), dtype=np.int32)
    lib.cgmg_atom_lists(*args, ptr.ctypes.data, atoms.ctypes.data, counts)
    return ptr, atoms


def csr_to_sliced(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                  c: int, off: np.ndarray):
    """(scols int32, svals data.dtype), flat, zero-padded, of the sliced
    ELL whose slice offsets are ``off`` (ops/ell.py:SlicedELL).  None if
    the native engine is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    data = np.ascontiguousarray(data)
    off = np.ascontiguousarray(off, np.int64)
    scols = np.zeros(int(off[-1]), np.int32)
    svals = np.zeros(int(off[-1]), data.dtype)
    lib.cgmg_csr_to_sliced(indptr, indices, data.view(np.uint8).reshape(-1),
                           data.dtype.itemsize, len(indptr) - 1, c, off,
                           scols, svals.view(np.uint8))
    return scols, svals
