"""ctypes bridge to the native topology engine (csrc/forest_engine.cpp).

Builds the shared library on first use (g++, into ``build/native/<host>/``
at the repository root, redone when the source is newer) and exposes the
key primitives behind numpy-compatible signatures with a numpy path, so
the framework runs identically with or without a compiler.  The library
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
            lib.cgmg_sort_unique_inverse.restype = ctypes.c_int64
            lib.cgmg_sort_unique_inverse.argtypes = [
                i64p, ctypes.c_int64, i64p, i64p]
            lib.cgmg_searchsorted.restype = None
            lib.cgmg_searchsorted.argtypes = [
                i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
            lib.cgmg_lookup.restype = None
            lib.cgmg_lookup.argtypes = [
                i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
            lib.cgmg_pattern.restype = ctypes.c_int64
            lib.cgmg_pattern.argtypes = [
                i64p, ctypes.c_int64, ctypes.c_int64,
                i64p, i64p, ctypes.c_int64,
                ctypes.c_int64, i64p, i64p, i64p]
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.cgmg_atom_lists.restype = None
            lib.cgmg_atom_lists.argtypes = [
                f64p, f64p, ctypes.c_int64, ctypes.c_int64,
                f64p, i64p, i64p, i64p, f64p,
                ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                i32p, i64p]
            lib.cgmg_scatter_add.restype = None
            lib.cgmg_scatter_add.argtypes = [
                i64p, f64p, ctypes.c_int64, f64p, ctypes.c_int64]
            lib.cgmg_gather_blocks.restype = None
            lib.cgmg_gather_blocks.argtypes = [
                f64p, i64p, ctypes.c_int64, ctypes.c_int64, f64p]
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.cgmg_gather_rows_bytes.restype = None
            lib.cgmg_gather_rows_bytes.argtypes = [
                u8p, i64p, ctypes.c_int64, ctypes.c_int64, u8p]
            lib.cgmg_csr_to_sliced.restype = None
            lib.cgmg_csr_to_sliced.argtypes = [
                i64p, i64p, u8p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, i64p, i32p, u8p]
            lib.cgmg_cross_gather.restype = None
            lib.cgmg_cross_gather.argtypes = [
                i64p, ctypes.c_int64, i64p, i64p, f64p, i64p,
                i64p, i64p, i64p, f64p, i64p, i64p]
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


def sort_unique_inverse(keys: np.ndarray):
    """(unique_sorted, inverse) — np.unique(keys, return_inverse=True)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
    lib = _load()
    if lib is None or len(keys) < (1 << 15):
        return np.unique(keys, return_inverse=True)
    out = np.empty_like(keys)
    inverse = np.empty_like(keys)
    n_u = lib.cgmg_sort_unique_inverse(keys, len(keys), out, inverse)
    return out[:n_u].copy(), inverse


def pattern(cell2dof_clean: np.ndarray, extra_rows: np.ndarray,
            extra_cols: np.ndarray, n: int):
    """Fused CSR pattern + inverse positions.

    Enumerated pair order: all (cell, i, j) cross products of
    ``cell2dof_clean`` (cell-major, i-major, j-minor), then the explicit
    (extra_rows, extra_cols) pairs.  Returns (indptr, indices, inverse)
    where inverse[p] is the CSR data position of enumerated pair p.
    Numpy fallback when the native engine is unavailable.
    """
    c2d = np.ascontiguousarray(cell2dof_clean, dtype=np.int64)
    er = np.ascontiguousarray(extra_rows, dtype=np.int64).reshape(-1)
    ec = np.ascontiguousarray(extra_cols, dtype=np.int64).reshape(-1)
    m, nb = c2d.shape if c2d.ndim == 2 else (0, 1)
    total = m * nb * nb + len(er)
    lib = _load()
    if lib is not None and total >= (1 << 15):
        indptr = np.empty(n + 1, dtype=np.int64)
        indices = np.empty(max(total, 1), dtype=np.int64)
        inverse = np.empty(max(total, 1), dtype=np.int64)
        nnz = lib.cgmg_pattern(c2d, m, nb, er, ec, len(er), n,
                               indptr, indices, inverse)
        return indptr, indices[:nnz].copy(), inverse[:total]
    # fallback: materialize keys and np.unique
    ii = np.repeat(np.arange(nb), nb)
    jj = np.tile(np.arange(nb), nb)
    rows = np.concatenate([c2d[:, ii].reshape(-1), er])
    cols = np.concatenate([c2d[:, jj].reshape(-1), ec])
    keys = rows * np.int64(n) + cols
    uniq, inverse = sort_unique_inverse(keys)
    rows_u = (uniq // n).astype(np.int64)
    indices = (uniq % n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows_u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, indices, inverse


def atom_lists(lower: np.ndarray, h: np.ndarray, sorted_pos: np.ndarray,
               aorder: np.ndarray, bstarts: np.ndarray, bshape: np.ndarray,
               borigin: np.ndarray, pitch: float, cutoff: float):
    """Native atom-cell locality lists (None if the engine is unavailable).

    Returns (lists (m, K) int32 -1-padded, counts (m,)).  Inputs are the
    spatial-hash tables of ops.neighbors.build_atom_buckets.
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
    dummy = np.empty(1, dtype=np.int32)
    lib.cgmg_atom_lists(lower, h, m, dim, sorted_pos, aorder, bstarts,
                        bshape, borigin, float(pitch), float(cutoff), 0,
                        dummy, counts)
    K = max(int(counts.max()) if m else 0, 1)
    lists = np.full((m, K), -1, dtype=np.int32)
    lib.cgmg_atom_lists(lower, h, m, dim, sorted_pos, aorder, bstarts,
                        bshape, borigin, float(pitch), float(cutoff), K,
                        lists, counts)
    return lists, counts


def scatter_add(pos: np.ndarray, weights: np.ndarray, n_out: int,
                out: np.ndarray = None) -> np.ndarray:
    """Threaded ``np.bincount(pos, weights, minlength=n_out)``.

    Deterministic (fixed slice/reduction order) but NOT bit-identical to
    the sequential bincount for bins whose entries span thread slices —
    callers on the float64 golden-parity path decide whether last-bit
    reassociation is acceptable (fem/assembly.py documents why it is).

    The native kernel accumulates per-thread PARTIAL arrays (T x n_out
    float64) and reduces — a win only while those partials are cheap
    relative to the entry stream.  Measured on the 2-core host: 1.8x at
    n_out=500k / 2M entries, but SLOWER than numpy at n_out=48M (the
    partial zero+reduce traffic dominates), so wide outputs fall back."""
    pos = np.ascontiguousarray(pos, np.int64).reshape(-1)
    weights = np.ascontiguousarray(weights, np.float64).reshape(-1)
    lib = _load()
    if out is None:
        out = np.zeros(n_out, np.float64)
    if lib is None or len(pos) < (1 << 18) or n_out > (len(pos) >> 2) \
            or n_out > (1 << 23):
        out += np.bincount(pos, weights=weights, minlength=n_out)
        return out
    lib.cgmg_scatter_add(pos, weights, len(pos), out, n_out)
    return out


def gather_blocks(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Threaded ``src[idx]`` for (n, ...) float64 row blocks."""
    src = np.ascontiguousarray(src, np.float64)
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    lib = _load()
    if lib is None or len(idx) * src[0].size < (1 << 20):
        return src[idx]
    out = np.empty((len(idx),) + src.shape[1:], np.float64)
    lib.cgmg_gather_blocks(src, idx, len(idx), src[0].size if src.ndim > 1
                           else 1, out)
    return out


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


def cross_gather(cell_off: np.ndarray, exp_i: np.ndarray,
                 exp_w: np.ndarray, exp_dof: np.ndarray):
    """Per-segment cartesian-product expansion of constraint-expanded
    (dof, weight, local-i) triples into the six dirty matrix-entry arrays
    (m_cell LOCAL, m_i, m_j, m_w, m_row, m_col).  None if the native
    engine is unavailable (caller falls back to the numpy construction)."""
    lib = _load()
    if lib is None:
        return None
    cell_off = np.ascontiguousarray(cell_off, np.int64)
    exp_i = np.ascontiguousarray(exp_i, np.int64)
    exp_w = np.ascontiguousarray(exp_w, np.float64)
    exp_dof = np.ascontiguousarray(exp_dof, np.int64)
    n_seg = len(cell_off) - 1
    seg_len = np.diff(cell_off)
    pair_start = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(seg_len * seg_len, out=pair_start[1:])
    total = int(pair_start[-1])
    m_cell = np.empty(total, np.int64)
    m_i = np.empty(total, np.int64)
    m_j = np.empty(total, np.int64)
    m_w = np.empty(total, np.float64)
    m_row = np.empty(total, np.int64)
    m_col = np.empty(total, np.int64)
    if total:
        lib.cgmg_cross_gather(cell_off, n_seg, pair_start, exp_i, exp_w,
                              exp_dof, m_cell, m_i, m_j, m_w, m_row, m_col)
    return m_cell, m_i, m_j, m_w, m_row, m_col


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Threaded ``src[idx]`` for (n, ...) rows of ANY dtype (raw-byte
    memcpy rows) — per-cell atom lists are multi-GB int32 at 64k atoms."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    row_bytes = src.dtype.itemsize * (src[0].size if src.ndim > 1 else 1)
    lib = _load()
    if lib is None or len(idx) * row_bytes < (1 << 22):
        return src[idx]
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    lib.cgmg_gather_rows_bytes(
        src.view(np.uint8).reshape(-1), idx, len(idx), row_bytes,
        out.view(np.uint8).reshape(-1))
    return out


def searchsorted(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    sorted_keys = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    q = np.ascontiguousarray(queries, dtype=np.int64).reshape(-1)
    lib = _load()
    if lib is None or len(q) < (1 << 15):
        return np.searchsorted(sorted_keys, queries)
    out = np.empty(len(q), dtype=np.int64)
    lib.cgmg_searchsorted(sorted_keys, len(sorted_keys), q, len(q), out)
    return out.reshape(np.shape(queries))


def lookup(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Positions of queries in sorted unique keys, -1 where absent."""
    sorted_keys = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    q = np.ascontiguousarray(queries, dtype=np.int64).reshape(-1)
    lib = _load()
    if lib is None or len(q) < (1 << 15):
        pos = np.searchsorted(sorted_keys, q)
        pos = np.clip(pos, 0, max(len(sorted_keys) - 1, 0))
        if len(sorted_keys) == 0:
            return np.full(np.shape(queries), -1, dtype=np.int64)
        hit = sorted_keys[pos] == q
        return np.where(hit, pos, -1).reshape(np.shape(queries))
    out = np.empty(len(q), dtype=np.int64)
    lib.cgmg_lookup(sorted_keys, len(sorted_keys), q, len(q), out)
    return out.reshape(np.shape(queries))
