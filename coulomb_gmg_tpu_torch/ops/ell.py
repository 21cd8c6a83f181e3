"""ELL sparse matrix-vector product in the transposed ``(K, n_rows)`` layout.

Counterpart of coulomb_gmg_tpu/ops/ell.py (the Pallas ``_ell_kernel``) and
of ``_ell_mv_t`` in coulomb_gmg_tpu/solver/tpu_gmg.py: ``y[i] = sum_k
vals[k, i] * x[cols[k, i]]``, padding slots holding value 0.  Every level,
interface, transfer and constraint-expansion apply of the solve goes through
:func:`ell_mv`; on a CUDA tensor that is the hand kernel in
``csrc/ell_spmv.cu`` (unrolled for K = 27, streaming loads of ``cols`` and
``vals``; the same FMA chain in k order, so the same bits, for every K).

:class:`ELL` is the host format of the JAX module (rows x K, numpy) with
its CSR and COO conversions; :meth:`ELL.device` hands it to the kernel in
the transposed layout.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from coulomb_gmg_tpu_torch import kernels

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p]
_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}


def ell_mv_plain(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, multiply, reduce over K."""
    return (vals * x[cols]).sum(0)


def ell_mv_cuda(cols: torch.Tensor, vals: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no fall back)."""
    if vals.dtype not in _FN or x.dtype != vals.dtype:
        raise TypeError(f"ell_mv: unsupported dtypes {vals.dtype}/{x.dtype}")
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
    lib = kernels.library("ell_spmv", {f: _SIG for f in _FN.values()})
    kernels.launch(getattr(lib, _FN[x.dtype]), x.device, "ell_spmv",
                   cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                   y.data_ptr(), K, n)
    ell_mv.launches += 1
    if x.dtype == torch.float64:
        ell_mv.launches_f64 += 1
    return y


def ell_mv(cols: torch.Tensor, vals: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """``y = A x`` for an ELL operator; the CUDA kernel on the card, the
    plain version only for CPU tensors."""
    if x.device.type == "cpu":
        return ell_mv_plain(cols, vals, x)
    return ell_mv_cuda(cols, vals, x)


ell_mv.launches = 0       # kernel launches (CUDA path only)
ell_mv.launches_f64 = 0   # the float64 ones among them


@dataclass
class ELL:
    """Host-built ELL matrix (coulomb_gmg_tpu/ops/ell.py:ELL): ``cols`` /
    ``vals`` are (n_rows, K); padding slots have value 0 and column 0."""

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
        n_pad = n_rows if pad_rows_to is None else max(n_rows, pad_rows_to)
        from coulomb_gmg_tpu_torch.utils import native
        if n_rows * K >= (1 << 20):
            out = native.csr_to_ell(indptr, indices, np.asarray(data),
                                    n_pad, K)
            if out is not None:
                return ELL(n_rows=n_pad, n_cols=n_cols or n_rows, K=K,
                           cols=out[0], vals=out[1])
        rowids = np.repeat(np.arange(n_rows), counts)
        return ELL.from_coo(rowids, indices, data, n_rows, n_cols,
                            pad_rows_to=pad_rows_to, pad_k_to=K)

    def device(self, device, dtype: torch.dtype = None):
        """(cols int32, vals) in the kernel's transposed (K, n_rows)
        layout on ``device``."""
        cols = torch.from_numpy(np.ascontiguousarray(self.cols.T)).to(device)
        vals = torch.from_numpy(np.ascontiguousarray(self.vals.T)).to(device)
        return cols, vals if dtype is None else vals.to(dtype)
