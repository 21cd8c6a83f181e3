"""ELL sparse matrix-vector products, in a padded and a sliced layout.

Counterpart of coulomb_gmg_tpu/ops/ell.py (the Pallas ``_ell_kernel``) and
of ``_ell_mv_t`` in coulomb_gmg_tpu/solver/tpu_gmg.py: ``y[i] = sum_k
vals[k, i] * x[cols[k, i]]``, padding slots holding value 0.  Every level,
interface, transfer and constraint-expansion apply of the solve goes through
:func:`ell_mv`; on a CUDA tensor that is a hand kernel of
``csrc/ell_spmv.cu``.  An operator reaches it as a pair ``(cols, vals)`` in
one of two layouts:

- padded: ``cols`` an int32 (K, n_rows) tensor and ``vals`` (K, n_rows),
  every row K slots.  The operators that ops/stencil.py builds on the
  device (K = 27) and those carried over from a JAX tree (convert.py).
- sliced: ``cols`` a :class:`Slices` and ``vals`` flat.  Every operator
  built on the host from a CSR or COO (:class:`SlicedELL`): each slice of
  ``SLICE`` consecutive rows has its own width, the length of its longest
  row, so the few long hanging-node rows of a refined mesh no longer pad
  every other row to their length.

Both kernels sum a row's slots in k order as one FMA chain, and a row's
real slots come first in both layouts, so on finite inputs the two give the
same values.  :class:`ELL` is the host format of the JAX module (rows x K,
numpy) with its CSR and COO conversions; its :meth:`ELL.device` pair, or
:meth:`Slices.padded`, is the padded form the checks hold the sliced kernel
to.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from coulomb_gmg_tpu_torch import kernels

# Rows of a slice: one warp of the sliced kernel, a compile-time constant
# there (csrc/ell_spmv.cu).  Slices of 8 rows read fewer bytes but ran
# slower on most operators on the H100 (PERF.md).
SLICE = 32
_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}
_FN_SLICED = {torch.float32: "ell_sliced_f32",
              torch.float64: "ell_sliced_f64"}
_SIGS = {**{f: [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_void_p]
            for f in _FN.values()},
         **{f: [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
            for f in _FN_SLICED.values()}}


class Slices:
    """The index half of a sliced ELL on one device.  Slot k of row
    ``C s + j`` (C = ``SLICE``) is at ``off[s] + C k + j`` of ``cols`` (and
    of the flat values); slice s holds ``(off[s + 1] - off[s]) / C`` slots
    a row, the first ones a row's entries in CSR order, the rest value 0
    and column 0.  The rows past ``n_rows`` that fill the last slice hold
    padding only."""

    def __init__(self, off: torch.Tensor, cols: torch.Tensor, n_rows: int,
                 width: int):
        self.off = off          # (n_slices + 1,) int64
        self.cols = cols        # (n_slots,) int32
        self.n_rows, self.width = n_rows, width
        self._dest = None

    def dest(self) -> torch.Tensor:
        """Each slot's place ``k n_rows + row`` in the padded (width,
        n_rows) layout; the slots of the rows that fill the last slice go
        to ``width n_rows``, one past its end.  Built at first use, for the
        plain version and the checks; the kernel needs none of it."""
        if self._dest is None:
            dev, c, n = self.cols.device, SLICE, self.n_rows
            per = self.off[1:] - self.off[:-1]
            s = torch.repeat_interleave(
                torch.arange(len(per), device=dev), per)
            local = torch.arange(len(self.cols), device=dev) - self.off[s]
            row = c * s + local % c
            self._dest = torch.where(row < n, local // c * n + row,
                                     self.width * n)
        return self._dest

    def padded(self, vals: torch.Tensor):
        """(cols int32, vals), both (width, n_rows): the padded pair of the
        same operator, as :meth:`ELL.device` gives it.  For the checks."""
        return tuple(
            a.new_zeros(self.width * self.n_rows + 1).index_copy_(
                0, self.dest(), a)[:-1].view(self.width, self.n_rows)
            for a in (self.cols, vals))


def _check_dtypes(vals: torch.Tensor, x: torch.Tensor) -> None:
    if vals.dtype not in _FN or x.dtype != vals.dtype:
        raise TypeError(f"ell_mv: unsupported dtypes {vals.dtype}/{x.dtype}")


def ell_mv_plain(cols, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, multiply, and a per-row sum over the
    padded (K, n_rows) layout.  A sliced operator's products are placed
    there first, so both layouts of one operator give the same bits."""
    if isinstance(cols, Slices):
        prod = vals * x[cols.cols]
        return prod.new_zeros(cols.width * cols.n_rows + 1).index_copy_(
            0, cols.dest(), prod)[:-1].view(cols.width,
                                            cols.n_rows).sum(0)
    return (vals * x[cols]).sum(0)


def _sliced_cuda(sl: Slices, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    _check_dtypes(vals, x)
    if sl.cols.dtype != torch.int32 or sl.off.dtype != torch.int64:
        raise TypeError(f"ell_mv: sliced cols must be int32 and offsets "
                        f"int64, got {sl.cols.dtype}/{sl.off.dtype}")
    if (vals.dim() != 1 or x.dim() != 1 or vals.shape != sl.cols.shape
            or sl.off.shape != (-(-sl.n_rows // SLICE) + 1,)):
        raise ValueError(f"ell_mv: sliced shapes off {tuple(sl.off.shape)}, "
                         f"cols {tuple(sl.cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}, "
                         f"{sl.n_rows} rows in slices of {SLICE}")
    if not (sl.off.is_contiguous() and sl.cols.is_contiguous()
            and vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_mv_cuda: operands must be contiguous")
    if not (sl.off.is_cuda and sl.cols.is_cuda and vals.is_cuda
            and x.is_cuda):
        raise ValueError("ell_mv_cuda: every operand must be on the card")
    y = torch.empty(sl.n_rows, dtype=x.dtype, device=x.device)
    lib = kernels.library("ell_spmv", _SIGS)
    kernels.launch(getattr(lib, _FN_SLICED[x.dtype]), x.device, "ell_spmv",
                   sl.off.data_ptr(), sl.cols.data_ptr(), vals.data_ptr(),
                   x.data_ptr(), y.data_ptr(), sl.n_rows, sl.width)
    return y


def _padded_cuda(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    _check_dtypes(vals, x)
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_mv: cols must be int32, got {cols.dtype}")
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"ell_mv: shapes cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    if not (cols.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_mv_cuda: operands must be contiguous")
    if not (cols.is_cuda and vals.is_cuda and x.is_cuda):
        raise ValueError("ell_mv_cuda: every operand must be on the card")
    K, n = cols.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    lib = kernels.library("ell_spmv", _SIGS)
    kernels.launch(getattr(lib, _FN[x.dtype]), x.device, "ell_spmv",
                   cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                   y.data_ptr(), K, n)
    return y


def ell_mv_cuda(cols, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of the operator's layout on the current stream (no
    fall back)."""
    if isinstance(cols, Slices):
        y = _sliced_cuda(cols, vals, x)
    else:
        y = _padded_cuda(cols, vals, x)
    ell_mv.launches += 1
    if x.dtype == torch.float64:
        ell_mv.launches_f64 += 1
    return y


def ell_mv(cols, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A x`` for an ELL operator in either layout; the CUDA kernel on
    the card, the plain version only for CPU tensors."""
    if x.device.type == "cpu":
        return ell_mv_plain(cols, vals, x)
    return ell_mv_cuda(cols, vals, x)


ell_mv.launches = 0       # kernel launches (CUDA path only), both layouts
ell_mv.launches_f64 = 0   # the float64 ones among them


@dataclass
class SlicedELL:
    """Host-built sliced ELL (see :class:`Slices`): ``off`` (n_slices + 1,)
    int64, ``cols`` int32 and ``vals`` flat (n_slots,), padding slots value
    0 and column 0.  Built from the CSR's ``indptr`` without a padded
    array, once; :meth:`device` copies it to the card."""

    n_rows: int
    n_cols: int
    off: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def width(self) -> int:
        """The widest slice's slots a row (the padded layout's K)."""
        return int(np.diff(self.off).max()) // SLICE if len(self.off) > 1 \
            else 0

    @staticmethod
    def from_csr(indptr, indices, data, n_cols: int = None,
                 pad_rows_to: int = None) -> "SlicedELL":
        """``pad_rows_to`` adds zero rows (width-0 slices, or padding of the
        last slice)."""
        from coulomb_gmg_tpu_torch.utils import native
        indptr = np.asarray(indptr, np.int64)
        data = np.asarray(data)
        n_rows = len(indptr) - 1
        n_pad = n_rows if pad_rows_to is None else max(n_rows, pad_rows_to)
        c = SLICE
        n_sl = -(-n_pad // c)
        counts = np.zeros(n_sl * c, np.int64)
        counts[:n_rows] = np.diff(indptr)
        off = np.zeros(n_sl + 1, np.int64)
        np.cumsum(c * counts.reshape(n_sl, c).max(1), out=off[1:])
        out = (native.csr_to_sliced(indptr, indices, data, c, off)
               if len(data) >= (1 << 16) else None)
        if out is None:
            rowids = np.repeat(np.arange(n_rows), counts[:n_rows])
            t = (off[rowids // c] + c * (np.arange(len(rowids))
                                         - indptr[rowids]) + rowids % c)
            out = (np.zeros(off[-1], np.int32), np.zeros(off[-1], data.dtype))
            out[0][t] = indices
            out[1][t] = data
        return SlicedELL(n_rows=n_pad, n_cols=n_cols or n_rows, off=off,
                         cols=out[0], vals=out[1])

    @staticmethod
    def from_coo(rowids, cols, data, n_rows: int, n_cols: int = None,
                 pad_rows_to: int = None) -> "SlicedELL":
        """Entries of a row in their COO order (a stable sort by row)."""
        rowids = np.asarray(rowids)
        cols = np.asarray(cols)
        data = np.asarray(data)
        if len(rowids) and (np.diff(rowids) < 0).any():
            order = np.argsort(rowids, kind="stable")
            rowids, cols, data = rowids[order], cols[order], data[order]
        indptr = np.zeros(n_rows + 1, np.int64)
        np.cumsum(np.bincount(rowids, minlength=n_rows), out=indptr[1:])
        return SlicedELL.from_csr(indptr, cols, data, n_cols or n_rows,
                                  pad_rows_to)

    def device(self, device, dtype: torch.dtype = None):
        """(:class:`Slices`, flat vals) on ``device``: the operand pair of
        :func:`ell_mv`."""
        put = lambda a: torch.from_numpy(a).to(device)
        vals = put(self.vals)
        return (Slices(put(self.off), put(self.cols), self.n_rows,
                       self.width),
                vals if dtype is None else vals.to(dtype))


@dataclass
class ELL:
    """Host-built padded ELL matrix (coulomb_gmg_tpu/ops/ell.py:ELL):
    ``cols`` / ``vals`` are (n_rows, K); padding slots have value 0 and
    column 0.  The port's operators take the sliced layout
    (:class:`SlicedELL`); this one is the JAX module's, for the checks."""

    n_rows: int
    n_cols: int
    K: int
    cols: np.ndarray   # (n_rows, K) int32
    vals: np.ndarray   # (n_rows, K) float

    @staticmethod
    def from_coo(rowids, cols, data, n_rows: int, n_cols: int = None,
                 pad_rows_to: int = None, pad_k_to: int = None) -> "ELL":
        rowids = np.asarray(rowids)
        cols = np.asarray(cols)
        data = np.asarray(data)
        if len(rowids) and (np.diff(rowids) < 0).any():
            order = np.argsort(rowids, kind="stable")
            rowids, cols, data = rowids[order], cols[order], data[order]
        counts = np.bincount(rowids, minlength=n_rows)
        K = int(counts.max()) if len(counts) and counts.max() > 0 else 1
        if pad_k_to is not None:
            K = max(K, pad_k_to)
        n_pad = n_rows if pad_rows_to is None else max(n_rows, pad_rows_to)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rowids)) - first[rowids]
        ecols = np.zeros((n_pad, K), dtype=np.int32)
        evals = np.zeros((n_pad, K), dtype=data.dtype)
        ecols[rowids, slot] = cols
        evals[rowids, slot] = data
        return ELL(n_rows=n_pad, n_cols=n_cols or n_rows, K=K,
                   cols=ecols, vals=evals)

    @staticmethod
    def from_csr(indptr, indices, data, n_cols: int = None,
                 pad_rows_to: int = None, pad_k_to: int = None) -> "ELL":
        n_rows = len(indptr) - 1
        counts = np.diff(indptr)
        K = int(counts.max()) if n_rows and counts.max() > 0 else 1
        if pad_k_to is not None:
            K = max(K, pad_k_to)
        rowids = np.repeat(np.arange(n_rows), counts)
        return ELL.from_coo(rowids, indices, data, n_rows, n_cols,
                            pad_rows_to=pad_rows_to, pad_k_to=K)

    def device(self, device, dtype: torch.dtype = None):
        """(cols int32, vals) in the padded kernel's transposed (K, n_rows)
        layout on ``device``."""
        cols = torch.from_numpy(np.ascontiguousarray(self.cols.T)).to(device)
        vals = torch.from_numpy(np.ascontiguousarray(self.vals.T)).to(device)
        return cols, vals if dtype is None else vals.to(dtype)
